"""Throughput/learning sweep over fast-PPO update hyperparameters.

Measures the fast trainer's (epochs, minibatches) choices as a
throughput/learning trade-off and writes docs/fast_ppo_sweep.json:

  * **throughput** — full-loop env-steps/s at the headline
    config (16k envs, 21x21 stacked) for each candidate;
  * **learning** — success-per-step trajectories on the benchmark PPO
    actually solves (single-task 8x8, the tests/test_fast_ppo.py setting,
    scaled to 4096 envs) for each candidate over matched seeds, so curve
    equivalence is judged on identical env-step budgets.

    python tools/fast_ppo_sweep.py          # full sweep on the GPU
"""

import json
import os
import sys
import time
import dataclasses

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from gym_craftingworld_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()

import numpy as np  # noqa: E402

from gym_craftingworld_tpu import flat_config, ray_config  # noqa: E402
from gym_craftingworld_tpu.train import fast_ppo as fp  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "fast_ppo_sweep.json")

CANDIDATES = {
    "2ep_8mb (default)": dict(update_epochs=2, num_minibatches=8),
    "1ep_8mb": dict(update_epochs=1, num_minibatches=8),
    "1ep_4mb": dict(update_epochs=1, num_minibatches=4),
    "1ep_8mb_h384": dict(update_epochs=1, num_minibatches=8, hidden=384),
    "1ep_8mb_h256": dict(update_epochs=1, num_minibatches=8, hidden=256),
}

B_BENCH = 16384
B_LEARN = 4096
LEARN_UPDATES = 192
SEEDS = (0, 1)


def throughput(fppo) -> float:
    """Full-loop rate at the headline config, timed over one long on-device
    run (64 updates per dispatch, ended with block_until_ready)."""
    cfg = ray_config()
    key = jax.random.PRNGKey(0)
    ts = fp.init_fast_train_state(key, cfg, fppo)
    env = fp.fresh_packed_batch(cfg, jax.random.fold_in(key, 1), B_BENCH)
    N = 64

    def run(n):
        # train_many_fast donates ts (donate_argnums=(2,)): on a GPU the call
        # deletes its buffers, so each timing rep gets a fresh copy to keep
        # identical starting params across reps.
        ts_rep = jax.tree.map(lambda x: x.copy(), ts)
        ts2, env2, key2, m = fp.train_many_fast(cfg, fppo, ts_rep, env, n,
                                                jax.random.PRNGKey(7))
        return float(m["loss"][-1])  # host transfer = real sync

    run(N)  # compile + warm
    best = min(_timed(run, N) for _ in range(3))
    return B_BENCH * fppo.rollout_steps * N / best


def _timed(run, n):
    t0 = time.time()
    run(n)
    return time.time() - t0


def learning_curve(fppo, seed, n_updates=None) -> list:
    """success-per-step trajectory on single-task 8x8 at B_LEARN envs.

    ``n_updates`` defaults to LEARN_UPDATES; pass a larger count for
    wall-clock-matched comparisons (a config that runs k x faster gets k x
    the updates of the baseline in the same wall time).
    """
    cfg = dataclasses.replace(flat_config(), stacking=False)
    ts = fp.init_fast_train_state(jax.random.PRNGKey(100 + seed), cfg, fppo)
    env = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(200 + seed), B_LEARN)
    ts, env, key, m = fp.train_many_fast(cfg, fppo, ts, env,
                                         n_updates or LEARN_UPDATES,
                                         jax.random.PRNGKey(300 + seed))
    return [float(x) for x in np.asarray(m["success_per_step"])]


def main():
    results = {}
    base_rate = None
    for name, kw in CANDIDATES.items():
        fppo = fp.FastPPOConfig(**kw)
        t0 = time.time()
        rate = throughput(fppo)
        if base_rate is None:  # first candidate is the default baseline
            base_rate = rate
        print(f"{name}: {rate:.3e} env-steps/s full loop "
              f"({time.time() - t0:.0f}s)", flush=True)
        # wall-clock-matched update budget: a config k x faster than the
        # default gets k x the default's LEARN_UPDATES in the same wall time
        n_wall = max(LEARN_UPDATES, int(round(LEARN_UPDATES * rate
                                              / base_rate)))
        curves = {}
        for seed in SEEDS:
            c = learning_curve(fppo, seed, n_updates=n_wall)
            curves[f"seed{seed}"] = c
            tail = float(np.mean(c[LEARN_UPDATES - 32:LEARN_UPDATES]))
            tail_w = float(np.mean(c[-32:]))
            print(f"  learn seed{seed}: success/step last32 {tail:.5f} "
                  f"(matched env-steps) / {tail_w:.5f} (matched wall-clock, "
                  f"{n_wall} updates)", flush=True)
        results[name] = {
            "throughput_env_steps_per_s": rate,
            "wall_clock_updates": n_wall,
            "curves_success_per_step": curves,
            "tail_mean_success_per_step": {
                s: float(np.mean(v[LEARN_UPDATES - 32:LEARN_UPDATES]))
                for s, v in curves.items()
            },
            "tail_mean_success_per_step_wall_clock": {
                s: float(np.mean(v[-32:])) for s, v in curves.items()
            },
        }
    doc = {
        "config": {
            "bench": {"envs": B_BENCH, "grid": "21x21 stacked",
                      "timing": "absolute, 64 updates/dispatch, best of 3"},
            "learning": {"envs": B_LEARN, "grid": "8x8 single-task",
                         "updates": LEARN_UPDATES, "seeds": list(SEEDS)},
        },
        "candidates": results,
    }
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
