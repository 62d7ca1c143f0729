#!/usr/bin/env python
"""Smoke test of the main paths on the GPU, through the normal entry points.

    python chip_smoke.py          # one GPU: phases 0-4
    python chip_smoke.py --four   # four GPUs: the sharded paths only

Phases (one process; a JAX process reserves most of a card's memory):

  0  device: the card's name and power limit; no GPU, no run.
  1  env semantics on the card vs the CPU backend, bit for bit: grid reset +
     random rollout and the packed scan (ray and flat configs, 2048 envs,
     300 steps), and the Ray / AltObs / OneHot renders.
  2  rollout fleet at 16,384 envs, 21x21: the whole-rollout kernel equals the
     packed scan fed the kernel's reference action stream, bit for bit;
     compile time, memory and env-steps/s of both engines.
  3  fast PPO at 16,384 envs: 3 updates at FastPPOConfig() and at
     FastPPOConfig.throughput(); one minibatch's gradient on the card vs the
     CPU.
  4  user API: api.make("craftingworld-v3") and a 4096-env vector env.

``--four`` runs the sharded packed scan and the sharded kernel at 65,536
envs against one card, and two sharded fast-PPO steps against one card.

A failed check raises, so the script exits non-zero. The last line of
standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Relative L2 error allowed per gradient leaf, card vs CPU running the same
# bf16-operand program. The products are exact in f32, but the two backends
# sum in another order and round the bf16 activations and cotangents at
# other points of their fused elementwise chains, so single elements
# legitimately differ by one bf16 ulp (2^-8 ~ 3.9e-3 relative); measured
# 2.1e-3 at most on the H100. 1e-2 allows ~2.5 ulp and still catches an
# error at the percent level (a float32 product run as TF32, a dropped term).
GRAD_TOL_BACKENDS = 1e-2
# bf16 program vs a float32 reference (precision "highest"): bf16 keeps 8
# significant bits (unit roundoff 2^-9 ~ 2e-3), and about ten roundings of
# weights, activations and cotangents lie between the loss and w1; measured
# up to 2.1e-2 on the CPU at these shapes, 4.4e-3 on the H100. A wrong
# gradient is O(1) off.
GRAD_TOL_F32 = 5e-2
# Sharded vs one-card PPO loss (--four), absolute: the same program on the
# same data, except that the gradient all-reduce and the loss means sum in
# another order (~1e-7 relative on O(1) terms: entropy ~ log 6, value loss
# of O(1) returns), and that a sample whose two best gumbel-perturbed logits
# tie to within rounding may draw another action, which changes that env's
# next steps (~1e-6 of the samples).
LOSS_ATOL_SHARDED = 1e-3


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(out.stdout.strip().splitlines())  # one line per card


def assert_trees_equal(a, b, what):
    import jax

    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: leaf {i} differs "
                                 f"({int((x != y).sum())} of {x.size})")
    return len(la)


def median_time(fn, n=5):
    """Median warm wall time of ``fn()``, which must block."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def compile_aot(jitted, *args):
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def phase1_semantics(gpu, B=2048, T=300):
    import jax
    import jax.numpy as jnp

    from gym_craftingworld_tpu import (
        flat_config, ray_config, reset_from_seed, rollout_random,
    )
    from gym_craftingworld_tpu.core import slots as sm
    from gym_craftingworld_tpu.ops.packed_rollout import rollout_p
    from gym_craftingworld_tpu.render import raster

    cpu = jax.devices("cpu")[0]

    def run(cfg, device):
        with jax.default_device(device):
            st = reset_from_seed(cfg, 0, B)
            st, out = rollout_random(cfg, st, jax.random.PRNGKey(1), T)
            actions = jax.random.randint(jax.random.PRNGKey(2), (T, B), 0, 6,
                                         jnp.int32)
            sl, pout = rollout_p(cfg, sm.from_env_state(
                reset_from_seed(cfg, 3, B)), actions, T)
            renders = (raster.state_images_ray(st),
                       raster.state_images_altobs(st),
                       raster.state_obs_onehot(st))
            assert st.objects.devices() == {device}, st.objects.devices()
            return jax.device_get({"grid": (st, out), "packed": (sl, pout),
                                   "renders": renders})

    for name, cfg in (("ray", ray_config()), ("flat", flat_config())):
        card, host = run(cfg, gpu), run(cfg, cpu)
        n = {k: assert_trees_equal(card[k], host[k], f"{name} {k}")
             for k in card}
        log(1, f"{name}: B={B} T={T} card == cpu bit for bit "
               f"(grid {n['grid']} arrays, packed scan {n['packed']}, "
               f"renders {n['renders']})")


def phase2_rollout_fleet(B=16384, T=1000, scan_steps=2048,
                         kernel_steps=262144):
    import jax
    import jax.numpy as jnp

    from gym_craftingworld_tpu import ray_config, reset_from_seed
    from gym_craftingworld_tpu.core import slots as sm
    from gym_craftingworld_tpu.ops import packed_fused as pf
    from gym_craftingworld_tpu.ops import packed_rollout as pr

    cfg = ray_config()
    sl = sm.from_env_state(reset_from_seed(cfg, 0, B))
    st_k, acc_k = pf.fused_rollout_packed_bench(cfg, sl, 7, T)
    st_s, out = pr.rollout_p(cfg, sl, pf.reference_actions(7, B, T), T)
    acc_s = int(np.asarray(out.reward).sum(dtype=np.int64).astype(np.int32))
    assert int(acc_k) == acc_s, (int(acc_k), acc_s)
    n = assert_trees_equal(st_k, st_s, "kernel vs scan final state")
    log(2, f"kernel == scan on the reference stream: B={B} T={T}, "
           f"checksum {int(acc_k)}, {n} state arrays bit for bit")

    seed, key = jnp.int32(3), jax.random.PRNGKey(3)
    rates = {}
    for name, jitted, args, steps in (
            ("scan", pr.rollout_p_bench, (cfg, sl, key), scan_steps),
            ("kernel", pf.fused_rollout_packed_bench, (cfg, sl, seed),
             kernel_steps)):
        compiled, secs = compile_aot(jitted, *args, steps)
        run = lambda: jax.block_until_ready(compiled(*args[1:]))
        run()
        med, times = median_time(run)
        rates[name] = B * steps / med
        log(2, f"{name}: compile {secs:.2f} s, T={steps}, "
               f"{rates[name]:.6e} env-steps/s (median of 5, runs "
               f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms)")
        log(2, f"{name}: memory {compiled.memory_analysis()}")
    log(2, f"kernel block {pf.BLOCK} envs, {pf.NUM_WARPS} warps; "
           f"kernel / scan = {rates['kernel'] / rates['scan']:.2f}")


def _grad_batch(cfg, n_rows):
    import jax
    import jax.numpy as jnp

    from gym_craftingworld_tpu.train import fast_ppo as fp

    kb = jax.random.split(jax.random.PRNGKey(12), 5)
    return (
        jax.random.normal(kb[0], (n_rows, fp.feature_rows(cfg)), jnp.bfloat16),
        jax.random.randint(kb[1], (n_rows,), 0, 6, jnp.int32),
        jnp.full((n_rows,), -np.log(6.0), jnp.float32),
        jax.random.normal(kb[2], (n_rows,), jnp.float32),
        jax.random.normal(kb[3], (n_rows,), jnp.float32),
        jax.random.normal(kb[4], (n_rows,), jnp.float32),
    )


def phase3_fast_ppo(gpu, B=16384, U=3):
    import jax
    import jax.numpy as jnp

    from gym_craftingworld_tpu import ray_config
    from gym_craftingworld_tpu.train import fast_ppo as fp

    cfg = ray_config()
    for name, fppo in (("default", fp.FastPPOConfig()),
                       ("throughput", fp.FastPPOConfig.throughput())):
        ts = fp.init_fast_train_state(jax.random.PRNGKey(0), cfg, fppo)
        w1 = np.asarray(ts.params.w1)
        env = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(1), B)
        key = jax.random.PRNGKey(2)
        compiled, secs = compile_aot(fp.train_many_fast, cfg, fppo, ts, env,
                                     U, key)
        ts, env, key, m = compiled(ts, env, key)
        loss = np.asarray(m["loss"])
        assert loss.shape == (U,) and np.isfinite(loss).all(), loss
        moved = float(np.abs(np.asarray(ts.params.w1) - w1).max())
        assert moved > 0, "params did not move"
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ts, env, key, m = compiled(ts, env, key)
            jax.block_until_ready(m["loss"])
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        steps = B * fppo.rollout_steps * U
        log(3, f"{name}: {U} updates, losses {loss.tolist()}, max |dw1| "
               f"{moved:.3e}; compile {secs:.2f} s; {1e3 * med / U:.3f} "
               f"ms/update, {steps / med:.6e} env-steps/s (median of 3)")
        log(3, f"{name}: memory {compiled.memory_analysis()}")

    # one default-config minibatch (64 x 16384 / 8 rows) of _loss_bm grads
    fppo = fp.FastPPOConfig()
    cpu = jax.devices("cpu")[0]
    n_rows = fppo.rollout_steps * B // fppo.num_minibatches

    def grads(device, dtype):
        with jax.default_device(device):
            params = fp.init_params(jax.random.PRNGKey(11), cfg, fppo)
            batch = _grad_batch(cfg, n_rows)
            g = jax.jit(jax.grad(
                lambda p: fp._loss_bm(fppo, p, batch, dtype)[0]))(params)
            return jax.device_get(g)

    g_card = grads(gpu, jnp.bfloat16)
    g_cpu = grads(cpu, jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        g_f32 = grads(cpu, jnp.float32)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    e_cpu = [rel(a, b) for a, b in zip(jax.tree.leaves(g_card),
                                       jax.tree.leaves(g_cpu))]
    e_f32 = [rel(a, b) for a, b in zip(jax.tree.leaves(g_card),
                                       jax.tree.leaves(g_f32))]
    log(3, f"grads of one minibatch ({n_rows} rows): rel L2 error per leaf "
           f"card vs cpu max {max(e_cpu):.3e} (tol {GRAD_TOL_BACKENDS}), "
           f"card vs float32 max {max(e_f32):.3e} (tol {GRAD_TOL_F32})")
    assert max(e_cpu) <= GRAD_TOL_BACKENDS, e_cpu
    assert max(e_f32) <= GRAD_TOL_F32, e_f32


def phase4_user_api(platform, n=4096):
    import jax

    from gym_craftingworld_tpu import api

    env = api.make("craftingworld-v3", seed=0)
    obs = env.reset()
    for a in range(6):
        obs, reward, done, info = env.step(a)
    img = np.asarray(obs["observation"])
    assert img.shape == (84, 84, 3) and img.dtype == np.uint8, img.shape
    assert isinstance(reward, int) and isinstance(done, bool)
    log(4, f"api.make('craftingworld-v3'): reset + 6 steps, obs {img.shape}, "
           f"last reward {reward}")

    venv = api.CraftingWorldVectorEnv(n, seed=0)
    obs, _ = venv.reset()
    rng = np.random.RandomState(0)
    for _ in range(5):
        obs, rew, term, trunc, _ = venv.step(rng.randint(0, 6, n))
    jax.block_until_ready(obs)
    assert obs.shape == (n, 21, 21, 12) and rew.shape == (n,), obs.shape
    assert next(iter(obs.devices())).platform == platform
    log(4, f"CraftingWorldVectorEnv({n}): reset + 5 steps, obs {obs.shape} "
           f"on {next(iter(obs.devices()))}")


def four_cards(B=65536, n_devices=4):
    import jax
    import jax.numpy as jnp

    from gym_craftingworld_tpu import ray_config, reset_from_seed
    from gym_craftingworld_tpu.core import slots as sm
    from gym_craftingworld_tpu.ops import packed_fused as pf
    from gym_craftingworld_tpu.ops.packed_rollout import rollout_p
    from gym_craftingworld_tpu.parallel import sharded_engine as se
    from gym_craftingworld_tpu.parallel.mesh import make_env_mesh, replicated
    from gym_craftingworld_tpu.train import fast_ppo as fp

    assert len(jax.devices()) == n_devices, jax.devices()
    mesh, mesh1 = make_env_mesh(n_devices), make_env_mesh(1)
    cfg = ray_config()
    slots = sm.from_env_state(reset_from_seed(cfg, 0, B))

    T = 256
    actions = jax.random.randint(jax.random.PRNGKey(1), (T, B), 0, 6,
                                 jnp.int32)
    ref = rollout_p(cfg, slots, actions, T)
    got = se.rollout_p_sharded(cfg, se.shard_slots(slots, mesh), actions, T,
                               mesh)
    n = assert_trees_equal(got, ref, "sharded scan vs one card")
    assert len(got[0].agent.sharding.device_set) == n_devices
    log("four", f"sharded packed scan: B={B} T={T} over {n_devices} cards == one card "
                f"({n} arrays bit for bit)")

    T = 4096
    sl4 = se.shard_slots(slots, mesh)
    ref = pf.fused_rollout_packed_bench(cfg, slots, 5, T)
    got = se.fused_rollout_packed_bench_sharded(cfg, sl4, 5, T, mesh=mesh)
    n = assert_trees_equal(got, ref, "sharded kernel vs one card")
    assert len(got[0].agent.sharding.device_set) == n_devices
    one = lambda: jax.block_until_ready(
        pf.fused_rollout_packed_bench(cfg, slots, 6, T))
    four = lambda: jax.block_until_ready(
        se.fused_rollout_packed_bench_sharded(cfg, sl4, 6, T, mesh=mesh))
    one(), four()
    r1, r4 = B * T / median_time(one)[0], B * T / median_time(four)[0]
    log("four", f"sharded kernel: B={B} T={T} over {n_devices} cards == one card "
                f"({n} arrays bit for bit, checksum {int(got[1])}); "
                f"{r1:.6e} env-steps/s on one card, {r4:.6e} on {n_devices} "
                f"(x{r4 / r1:.2f})")

    fppo = fp.FastPPOConfig()
    env0 = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(4), B)
    ts0 = fp.init_fast_train_state(jax.random.PRNGKey(5), cfg, fppo)
    copy = lambda t: jax.tree.map(jnp.copy, t)
    _, _, _, m1 = se.fast_train_step_sharded(cfg, fppo, mesh1)(
        copy(ts0), se.shard_packed(env0, mesh1), jax.random.PRNGKey(6))
    loss1 = float(m1["loss"])
    step = se.fast_train_step_sharded(cfg, fppo, mesh)
    ts = jax.device_put(copy(ts0), replicated(mesh))
    env, key, losses = se.shard_packed(env0, mesh), jax.random.PRNGKey(6), []
    for _ in range(2):
        ts, env, key, m = step(ts, env, key)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all(), losses
    assert len(env.slot_key.sharding.device_set) == n_devices
    assert len(env.agent_r.sharding.device_set) == n_devices
    diff = abs(losses[0] - loss1)
    log("four", f"fast PPO B={B}: 2 sharded steps, losses {losses}; "
                f"one-card first loss {loss1} (diff {diff:.3e}, tol "
                f"{LOSS_ATOL_SHARDED}); env batch on "
                f"{len(env.slot_key.sharding.device_set)} cards")
    assert diff <= LOSS_ATOL_SHARDED, (losses[0], loss1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, over 4 GPUs")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        sys.exit(2)

    from gym_craftingworld_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    log(0, f"compile cache {enable_compilation_cache()}")
    log(0, f"{gpu_name_and_power()} | jax {jax.__version__} | "
           f"{dev.device_kind} x {len(jax.devices())}")
    t0 = time.perf_counter()
    if args.four:
        four_cards()
    else:
        phase1_semantics(dev)
        phase2_rollout_fleet()
        phase3_fast_ppo(dev)
        phase4_user_api(dev.platform)
    log("end", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
