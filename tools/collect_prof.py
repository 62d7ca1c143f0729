"""Fine-grained collect-phase breakdown for fast PPO.

Times scan variants with pieces knocked out, each as its own K-iteration
jitted scan:

  full        — the production _collect (policy + sample + step + reset + store)
  nostore     — same but per-step outputs reduced to scalars (no [T,F,B] HBM)
  noreset     — no pool slice / autoreset select
  nosample    — greedy argmax instead of Gumbel sampling (no per-step PRNG)
  policyonly  — policy fwd on a FIXED feature matrix, no env step
  steponly    — packed step + autoreset, constant actions, no policy

    python tools/collect_prof.py [ENVS] [K]
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
fppo = fp.FastPPOConfig()
key = jax.random.PRNGKey(0)
ts = fp.init_fast_train_state(key, cfg, fppo)
env0 = fp.fresh_packed_batch(cfg, jax.random.fold_in(key, 1), B)
pool = fp.fresh_packed_batch(cfg, jax.random.fold_in(key, 2), 2 * B)
T = fppo.rollout_steps


def outer(scan_body):
    """Wrap a single-rollout fn into an n-iteration jitted scan."""

    @partial(jax.jit, static_argnums=(0,))
    def run(n, params, env, k):
        def body(carry, kk):
            env, acc = carry
            env, a = scan_body(params, env, kk)
            return (env, acc + a), None

        (env, acc), _ = jax.lax.scan(
            body, (env, jnp.float32(0)), jax.random.split(k, n))
        return acc

    return run


def collect_full(params, env, k):
    env, traj = fp._collect(cfg, fppo, params, env, pool, k)
    return env, traj.feat.astype(jnp.float32).sum() + traj.log_prob.sum()


def collect_nostore(params, env, k):
    def body(carry, inp):
        st = carry
        k_act, t = inp
        feat = fp.features(cfg, st)
        logits, value = fp.apply_policy(params, feat)
        action, log_prob = fp._sample_action(k_act, logits)
        st2, res = fp._step_p_unrolled(cfg, st, action.astype(jnp.int16))
        off = (t * jnp.int32(12007)) % jnp.int32(B)
        st2 = fp._autoreset(st2, fp._pool_slice(pool, off, B), res.done)
        return st2, log_prob.sum() + value.sum()

    keys = jax.random.split(k, T)
    steps = jnp.arange(T, dtype=jnp.int32)
    env, accs = jax.lax.scan(body, env, (keys, steps))
    return env, accs.sum()


def collect_noreset(params, env, k):
    def body(carry, k_act):
        st = carry
        feat = fp.features(cfg, st)
        logits, value = fp.apply_policy(params, feat)
        action, log_prob = fp._sample_action(k_act, logits)
        st2, res = fp._step_p_unrolled(cfg, st, action.astype(jnp.int16))
        return st2, log_prob.sum() + res.reward.sum()

    env, accs = jax.lax.scan(body, env, jax.random.split(k, T))
    return env, accs.sum().astype(jnp.float32)


def collect_nosample(params, env, k):
    def body(carry, inp):
        st = carry
        _, t = inp
        feat = fp.features(cfg, st)
        logits, value = fp.apply_policy(params, feat)
        action = jnp.argmax(logits, axis=0).astype(jnp.int32)
        st2, res = fp._step_p_unrolled(cfg, st, action.astype(jnp.int16))
        off = (t * jnp.int32(12007)) % jnp.int32(B)
        st2 = fp._autoreset(st2, fp._pool_slice(pool, off, B), res.done)
        return st2, value.sum()

    keys = jax.random.split(k, T)
    steps = jnp.arange(T, dtype=jnp.int32)
    env, accs = jax.lax.scan(body, env, (keys, steps))
    return env, accs.sum()


def policyonly(params, env, k):
    feat0 = fp.features(cfg, env)

    def body(acc, k_act):
        logits, value = fp.apply_policy(params, feat0)
        action, log_prob = fp._sample_action(k_act, logits)
        return acc + log_prob.sum() + value.sum(), None

    acc, _ = jax.lax.scan(body, jnp.float32(0), jax.random.split(k, T))
    return env, acc


def steponly(params, env, k):
    def body(carry, inp):
        st = carry
        _, t = inp
        action = (st.agent_r.astype(jnp.int32) + t) % 6
        st2, res = fp._step_p_unrolled(cfg, st, action.astype(jnp.int16))
        off = (t * jnp.int32(12007)) % jnp.int32(B)
        st2 = fp._autoreset(st2, fp._pool_slice(pool, off, B), res.done)
        return st2, res.reward.sum()

    keys = jax.random.split(k, T)
    steps = jnp.arange(T, dtype=jnp.int32)
    env, accs = jax.lax.scan(body, env, (keys, steps))
    return env, accs.sum().astype(jnp.float32)


def time_variant(label, fn, iters=5):
    """Median warm wall time of K rollouts in one dispatch, per rollout."""
    run = outer(fn)
    float(run(K, ts.params, env0, key))  # compile + warm
    vals = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(run(K, ts.params, env0, key))
        vals.append(time.perf_counter() - t0)
    vals.sort()
    ms = 1e3 * vals[len(vals) // 2] / K
    rate = B * T / ms * 1e3
    print(f"{label:>11}: {ms:7.2f} ms/rollout  ({rate:.3e} env-steps/s)",
          flush=True)
    return ms


if __name__ == "__main__":
    print(f"B={B} T={T} hidden={fppo.hidden}")
    for label, fn in [
        ("full", collect_full),
        ("nostore", collect_nostore),
        ("noreset", collect_noreset),
        ("nosample", collect_nosample),
        ("policyonly", policyonly),
        ("steponly", steponly),
    ]:
        time_variant(label, fn)
