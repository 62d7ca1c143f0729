"""Device-mesh construction and env-batch sharding.

The reference has no parallelism of any kind (single env object mutating numpy
in place). The scaling axis is the *env batch*: every EnvState leaf
carries the batch on axis 0, so sharding the whole pytree with
``NamedSharding(P('env'))`` partitions the world across chips with **zero**
cross-chip communication in the stepping path — env stepping is embarrassingly
parallel; collectives appear only in the learner (gradient psum over the same
axis, see train/ppo.py).

Multi-host: call :func:`initialize_distributed` first (``jax.distributed``),
then meshes span all processes' devices and ``reset_sharded`` lays the batch
out so each host touches only its local shard.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.reset import reset as _core_reset
from gym_craftingworld_tpu.core.state import EnvState

ENV_AXIS = "env"


def initialize_distributed(**kwargs):
    """Multi-host bring-up (no-op when single-process)."""
    if jax.process_count() == 1 and not kwargs:
        return
    jax.distributed.initialize(**kwargs)


def make_env_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the env axis (data parallel over the batch)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for batched leaves: partition axis 0 over the env axis."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state: EnvState, mesh: Mesh) -> EnvState:
    """Lay an existing batched state out over the mesh."""
    s = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), state)


def reset_sharded(cfg: EnvConfig, seed: int, batch_size: int, mesh: Mesh) -> EnvState:
    """Batched reset whose *output* is already sharded over the mesh.

    The per-env keys are placed with the target sharding before the jitted
    reset runs, so XLA computes each shard on its own device — no gather, no
    replicated work, and trajectories are independent of the mesh layout
    (per-env keys are derived from the seed alone).
    """
    if batch_size % mesh.size != 0:
        raise ValueError(
            f"batch_size {batch_size} must divide evenly over {mesh.size} devices"
        )
    keys = jax.random.split(jax.random.PRNGKey(seed), batch_size)
    keys = jax.device_put(jax.random.key_data(keys), env_sharding(mesh))
    # out_shardings pinned explicitly: sharding propagation from inputs to
    # outputs is a compiler *choice*, and newer XLA partitioners replicate
    # small reset outputs — the env batch must stay distributed regardless.
    reset_fn = jax.jit(partial(_core_reset, cfg),
                       out_shardings=env_sharding(mesh))
    return reset_fn(keys)


def ppo_train_step_sharded(cfg: EnvConfig, ppo, mesh: Mesh):
    """train/ppo.train_step with output shardings pinned to the mesh.

    Input→output sharding propagation is a compiler *choice* — newer XLA
    partitioners replicate small outputs, silently collapsing the distributed
    env batch. This wrapper makes the layout a contract: env batch stays
    ``P('env')``, train state / key / metrics replicated.

    Returns ``step(ts, env_state, key) -> (ts, env_state, key, metrics)``
    (``ts`` donated, same as the unsharded path).
    """
    from gym_craftingworld_tpu.train.ppo import train_step

    es, rep = env_sharding(mesh), replicated(mesh)
    return jax.jit(
        partial(train_step, cfg, ppo),
        donate_argnums=(0,),
        out_shardings=(rep, es, rep, rep),
    )


def _time_engine(run, iters: int = 3) -> float:
    """Median wall time of ``run()`` (which must block) after one warmup."""
    import time

    run()
    times = []
    for _ in range(iters):
        t0 = time.time()
        run()
        times.append(time.time() - t0)
    return float(np.median(times))


def scaling_report(cfg: EnvConfig, batch_per_device: int, num_steps: int = 64,
                   engines=("grid", "packed_scan"), iters: int = 3) -> dict:
    """env-steps/s at 1 device vs all devices, per engine.

    Engines: ``grid`` (core/rollout.rollout_random over EnvState),
    ``packed_scan`` (the int16 packed scan via
    parallel/sharded_engine.rollout_p_sharded), ``fused`` (the rollout kernel
    via fused_rollout_packed_bench_sharded; compiled, so GPU only).

    Returns {engine: {"n1": rate, "nN": rate, "devices": N, "efficiency": e}}
    where e = rate(N) / (N * rate(1)). Stepping is communication-free, so
    e ≈ 1 up to compiler/runtime overheads.
    """
    import jax.numpy as jnp

    from gym_craftingworld_tpu.core import slots as sm
    from gym_craftingworld_tpu.core.rollout import rollout_random
    from gym_craftingworld_tpu.parallel import sharded_engine as se

    n_max = jax.device_count()
    report = {}
    for engine in engines:
        rates = {}
        for n in sorted({1, n_max}):
            mesh = make_env_mesh(n)
            B = batch_per_device * n
            if engine == "grid":
                state = reset_sharded(cfg, 0, B, mesh)
                key = jax.random.PRNGKey(1)

                def run(state=state, key=key):
                    # rollout_random donates its input: hand it a fresh copy
                    # (device-side, negligible next to the rollout itself)
                    st = jax.tree.map(jnp.copy, state)
                    _, out = rollout_random(cfg, st, key, num_steps)
                    jax.block_until_ready(out.reward)

            elif engine == "packed_scan":
                slots = sm.from_env_state(reset_sharded(cfg, 0, B, mesh))
                actions = jax.random.randint(
                    jax.random.PRNGKey(2), (num_steps, B), 0, 6, jnp.int32
                )

                def run(slots=slots, actions=actions, mesh=mesh):
                    _, out = se.rollout_p_sharded(
                        cfg, slots, actions, num_steps, mesh
                    )
                    jax.block_until_ready(out.reward)

            elif engine == "fused":
                slots = sm.from_env_state(reset_sharded(cfg, 0, B, mesh))
                slots = se.shard_slots(slots, mesh)

                def run(slots=slots, mesh=mesh):
                    _, acc = se.fused_rollout_packed_bench_sharded(
                        cfg, slots, 3, num_steps, mesh=mesh
                    )
                    jax.block_until_ready(acc)

            else:
                raise ValueError(f"unknown engine {engine!r}")
            rates[n] = B * num_steps / _time_engine(run, iters)
        report[engine] = {
            "n1": rates[1],
            f"n{n_max}": rates[n_max],
            "devices": n_max,
            "efficiency": rates[n_max] / (n_max * rates[1]),
        }
    return report
