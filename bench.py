#!/usr/bin/env python
"""Rollout-fleet benchmark: env-steps/s of random-action rollouts on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "env-steps/s", "vs_baseline": N,
   "runs": N, "min": N, "max": N, "spread_pct": N, "layout": ...,
   "steps": T, "device": {"platform", "kind", "count"}}

Timing: one call compiles and warms the rollout; then ``BENCH_ITERS`` calls of
a ``BENCH_STEPS``-step rollout over ``BENCH_ENVS`` envs, each ended with
``block_until_ready``. ``value`` is the median rate, ``min``/``max`` and
``spread_pct`` describe the runs.

``BENCH_LAYOUT`` picks the engine; the default is the one
``ops.packed_fused.rollout_layout`` picks for the GPU (the whole-rollout
kernel). The script refuses to run without a GPU: a rate measured on the CPU
is not a device number.

``vs_baseline`` compares against the reference implementation's single-env
CPU stepping rate, measured here directly (the reference publishes no
numbers — BASELINE.md) and cached in BASELINE_MEASURED.json after the first
run.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B = int(os.environ.get("BENCH_ENVS", 16384))
ITERS = int(os.environ.get("BENCH_ITERS", 5))
# steps per timed run: long enough for ~50-100 ms of device time per run
_DEFAULT_STEPS = {"packed_fused": 262144, "packed": 2048}
_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "BASELINE_MEASURED.json")


def measure_reference_steps_per_s(n_steps: int = 3000) -> float:
    """Single-env stepping rate of the reference implementation (CPU)."""
    if os.path.exists(_CACHE):
        with open(_CACHE) as f:
            return json.load(f)["reference_single_env_steps_per_s"]
    import numpy as np

    from gym_craftingworld_tpu.parity import oracle

    if not oracle.reference_available():
        return float("nan")
    env = oracle.make_reference_env("ray", seed=0)
    env.reset()
    rng = np.random.RandomState(0)
    actions = rng.randint(6, size=n_steps)
    t0 = time.time()
    for a in actions:
        _, _, done, _ = env.step(int(a))
        if done:
            env.reset()
    rate = n_steps / (time.time() - t0)
    with open(_CACHE, "w") as f:
        json.dump({"reference_single_env_steps_per_s": rate,
                   "n_steps": n_steps}, f)
    return rate


def _make_engine(layout, cfg, state):
    """Returns (roll(state, key, T) -> (state, checksum_int_array), state)."""
    import jax

    from gym_craftingworld_tpu.core import slots as sm

    if layout in ("packed_fused", "packed"):
        import jax.numpy as jnp

        from gym_craftingworld_tpu.ops.packed_fused import rollout_random_bench

        def roll(st, key, n):
            seed = jax.random.randint(key, (), 0, 2**31 - 1, jnp.int32)
            return rollout_random_bench(cfg, st, seed, n, layout)

        return roll, sm.from_env_state(state)
    if layout.startswith("obs_"):  # obs_ray | obs_altobs | obs_onehot
        from gym_craftingworld_tpu.ops import obs_rollout as obr

        obs_mode = layout[4:]
        return (lambda st, key, n: obr.rollout_obs_random(
            cfg, st, key, n, obs_mode)), sm.from_env_state(state)
    if layout == "transposed":
        from gym_craftingworld_tpu.ops import transposed_rollout as tr

        def roll(st, key, n):
            st, out = tr.rollout_t_random(cfg, st, key, n)
            return st, out.reward.sum()

        return roll, sm.from_env_state(state)
    if layout == "slots":
        def roll(st, key, n):
            st, out = sm.rollout_slots_random(cfg, st, key, n)
            return st, out.reward.sum()

        return roll, sm.from_env_state(state)
    if layout == "grid":
        from gym_craftingworld_tpu import rollout_random

        def roll(st, key, n):
            st, out = rollout_random(cfg, st, key, n)
            return st, out.reward.sum()

        return roll, state
    raise SystemExit(f"unknown BENCH_LAYOUT {layout!r}")


def main():
    from gym_craftingworld_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")

    from gym_craftingworld_tpu import ray_config, reset_from_seed
    from gym_craftingworld_tpu.ops.packed_fused import rollout_layout

    baseline = measure_reference_steps_per_s()
    layout = os.environ.get("BENCH_LAYOUT") or rollout_layout()
    T = int(os.environ.get("BENCH_STEPS", _DEFAULT_STEPS.get(layout, 256)))
    cfg = ray_config()
    key = jax.random.PRNGKey(0)
    roll, state = _make_engine(layout, cfg, reset_from_seed(cfg, 0, B))
    # split and unstack the keys before timing: no eager op compiles inside
    keys = jax.block_until_ready(list(jax.random.split(key, ITERS + 1)))

    state, checksum = roll(state, keys[0], T)  # compile + warm
    jax.block_until_ready(checksum)
    rates = []
    for k in keys[1:]:
        t0 = time.perf_counter()
        state, checksum = roll(state, k, T)
        jax.block_until_ready(checksum)
        rates.append(B * T / (time.perf_counter() - t0))
    rates.sort()
    value = rates[len(rates) // 2]

    metric = (f"env_steps_with_{layout[4:]}_obs_per_s_{B // 1024}k_envs"
              if layout.startswith("obs_")
              else f"env_steps_per_s_{B // 1024}k_envs")
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": "env-steps/s",
        "vs_baseline": value / baseline if baseline == baseline else None,
        "runs": len(rates),
        "min": rates[0],
        "max": rates[-1],
        "spread_pct": 100 * (rates[-1] - rates[0]) / value,
        "layout": layout,
        "steps": T,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
    }))


if __name__ == "__main__":
    main()
