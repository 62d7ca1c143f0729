"""Per-phase timing breakdown of one fast-PPO iteration.

Each phase runs as its own jitted K-iteration scan, timed warm with
``block_until_ready`` (median of 5 runs, divided by K). Phases:

  pool     — fresh_packed_batch(2B): world + task sampling for auto-reset
  collect  — rollout scan (policy fwd + packed step + autoreset + storage)
  gae      — last_value + advantage scan
  update   — block shuffle + epochs x minibatches of grads + adam
  full     — train_step_fast (everything, = train_many_fast body)

    python tools/fast_ppo_prof.py [ENVS] [K] [throughput]
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
K = int(sys.argv[2]) if len(sys.argv) > 2 else 12

import jax  # noqa: E402

from gym_craftingworld_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()

import jax.numpy as jnp  # noqa: E402

from gym_craftingworld_tpu import ray_config  # noqa: E402
from gym_craftingworld_tpu.train import fast_ppo as fp  # noqa: E402

cfg = ray_config()
fppo = (fp.FastPPOConfig.throughput() if "throughput" in sys.argv[3:]
        else fp.FastPPOConfig())
key = jax.random.PRNGKey(0)
ts = fp.init_fast_train_state(key, cfg, fppo)
env = fp.fresh_packed_batch(cfg, jax.random.fold_in(key, 1), B)
pool = fp.fresh_packed_batch(cfg, jax.random.fold_in(key, 2), 2 * B)


@partial(jax.jit, static_argnums=(0,))
def prof_pool(n, key):
    def body(acc, k):
        p = fp.fresh_packed_batch(cfg, k, 2 * B)
        return acc + p.agent_r.astype(jnp.int32).sum(), None

    acc, _ = jax.lax.scan(body, jnp.int32(0), jax.random.split(key, n))
    return acc


@partial(jax.jit, static_argnums=(0,))
def prof_collect(n, params, env, key):
    def body(carry, k):
        env, acc = carry
        env, traj = fp._collect(cfg, fppo, params, env, pool, k)
        return (env, acc + traj.raw_reward.sum()), None

    (env, acc), _ = jax.lax.scan(
        body, (env, jnp.int32(0)), jax.random.split(key, n)
    )
    return acc


@partial(jax.jit, static_argnums=(0,))
def prof_collect_nopolicy(n, env, key):
    """Collect with constant logits: isolates engine+autoreset from the MLP."""

    def body(carry, k):
        env, acc = carry

        def step(st, inp):
            k_act, t = inp
            action, _ = fp._sample_action(
                k_act, jnp.zeros((6, B), jnp.float32)
            )
            st2, res = fp._step_p_unrolled(cfg, st, action.astype(jnp.int16))
            off = (t * jnp.int32(12007)) % jnp.int32(B)
            st2 = fp._autoreset(st2, fp._pool_slice(pool, off, B), res.done)
            return st2, res.reward

        keys = jax.random.split(k, fppo.rollout_steps)
        steps = jnp.arange(fppo.rollout_steps, dtype=jnp.int32)
        env, rews = jax.lax.scan(step, env, (keys, steps))
        return (env, acc + rews.sum()), None

    (env, acc), _ = jax.lax.scan(
        body, (env, jnp.int32(0)), jax.random.split(key, n)
    )
    return acc


def _one_traj(params, env, k):
    _, traj = fp._collect(cfg, fppo, params, env, pool, k)
    last_value = fp.apply_policy(params, fp.features(cfg, env))[1]
    return traj, last_value


@partial(jax.jit, static_argnums=(0,))
def prof_gae(n, traj, last_value):
    def body(acc, _):
        adv, ret = fp._gae(fppo, traj, last_value)
        return acc + adv.sum() + ret.sum(), None

    acc, _ = jax.lax.scan(body, jnp.float32(0), None, length=n)
    return acc


@partial(jax.jit, static_argnums=(0,))
def prof_update(n, ts, traj, last_value, key):
    """The whole post-collect phase: GAE + shuffle + epochs, n times
    (the shared fast_ppo._update_phase, batch-major activations)."""

    def body(carry, k):
        ts, acc = carry
        adv, ret = fp._gae(fppo, traj, last_value)
        params, opt_state, losses, _ = fp._update_phase(
            fppo, ts, traj, adv, ret, k
        )
        return (fp.FastTrainState(params, opt_state, ts.update_idx),
                acc + losses.sum()), None

    (ts, acc), _ = jax.lax.scan(body, (ts, jnp.float32(0)),
                                jax.random.split(key, n))
    return acc


def time_phase(label, fn, *args, iters=5):
    """Median warm wall time of K iterations in one dispatch, per iteration."""
    jax.block_until_ready(fn(K, *args))  # compile + warm
    ts_ = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(K, *args))
        ts_.append(time.perf_counter() - t0)
    ts_.sort()
    ms = 1e3 * ts_[len(ts_) // 2] / K
    print(f"{label:>14}: {ms:7.3f} ms/iter")
    return ms


if __name__ == "__main__":
    d = jax.devices()[0]
    print(f"device {d.platform} {d.device_kind}")
    print(f"B={B} rollout_steps={fppo.rollout_steps} hidden={fppo.hidden} "
          f"epochs={fppo.update_epochs} minibatches={fppo.num_minibatches}")
    traj, last_value = jax.jit(_one_traj)(ts.params, env, key)
    jax.block_until_ready(traj.feat)

    t_pool = time_phase("pool", prof_pool, key)
    t_col = time_phase("collect", prof_collect, ts.params, env, key)
    t_eng = time_phase("collect-noMLP", prof_collect_nopolicy, env, key)
    t_gae = time_phase("gae", prof_gae, traj, last_value)
    t_upd = time_phase("gae+update", prof_update, ts, traj, last_value, key)

    @partial(jax.jit, static_argnums=(0,))
    def prof_full(n, ts, env, key):
        ts, env, key, metrics = fp.train_many_fast(cfg, fppo, ts, env, n, key)
        return metrics["loss"][-1]

    t_full = time_phase("FULL step", prof_full, ts, env, key)
    steps = B * fppo.rollout_steps
    print(f"\nfull-loop: {steps / t_full * 1e3:.3e} env-steps/s "
          f"(collect alone {steps / t_col * 1e3:.3e}; "
          f"engine-only {steps / t_eng * 1e3:.3e})")
    print(f"accounted: pool {t_pool:.1f} + collect {t_col:.1f} + "
          f"update {t_upd:.1f} = {t_pool + t_col + t_upd:.1f} "
          f"vs full {t_full:.1f} ms")
