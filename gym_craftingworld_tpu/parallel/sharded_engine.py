"""Mesh sharding for the throughput engines (packed scan + rollout kernel).

The slot/packed layouts put the env batch on the *last* axis ([8, B] slot
arrays, [B] scalars), so the sharding story differs from the grid path's
leading-axis ``P('env')``:

* ``SlotState`` leaves are batch-leading → ``P('env')`` (same as EnvState);
  inside ``rollout_p`` the transpose to [8, B] propagates to ``P(None,'env')``
  automatically, and stepping remains communication-free (bit-exactness under
  sharding is pinned by tests/test_sharded_engine.py).
* The rollout kernel (ops/packed_fused.py) is wrapped in ``shard_map``: each
  device runs it over its local batch shard with ``env_offset`` set to the
  shard's first global env index. The kernel's action stream is a hash of
  the global env index, so every env draws the same actions as on one
  device. The only collective is one scalar ``psum`` for the reward
  checksum.

Scaling is embarrassingly parallel: no cross-device bytes move during
stepping, so env-steps/s is linear in devices by construction (the reference
has no parallelism at all — craftingworld_ray.py steps one env per process).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.slots import SlotState
from gym_craftingworld_tpu.ops import packed_fused as pf
from gym_craftingworld_tpu.ops.packed_fused import _SLOT_FIELDS
from gym_craftingworld_tpu.ops.packed_rollout import PackedState, rollout_p
from gym_craftingworld_tpu.parallel.mesh import ENV_AXIS, env_sharding


def shard_slots(slots: SlotState, mesh: Mesh) -> SlotState:
    """Lay a SlotState batch out over the mesh (all leaves batch-leading)."""
    s = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), slots)


def packed_lane_sharding(mesh: Mesh):
    """Per-field shardings for a PackedState batch (batch on the LAST axis).

    Slot arrays are [8, B] → ``P(None, 'env')``; per-env scalars [B] →
    ``P('env')``.
    """
    return PackedState(**{
        f: NamedSharding(
            mesh, P(None, ENV_AXIS) if f in _SLOT_FIELDS else P(ENV_AXIS)
        )
        for f in PackedState._fields
    })


def shard_packed(env, mesh: Mesh):
    """Lay a PackedState batch out over the mesh (lane-axis sharding)."""
    return jax.tree.map(jax.device_put, env, packed_lane_sharding(mesh))


def fast_train_step_sharded(cfg: EnvConfig, fppo, mesh: Mesh):
    """train/fast_ppo.train_step_fast with output shardings pinned.

    Same rationale as ``parallel.mesh.ppo_train_step_sharded``: the env
    batch's lane-axis sharding must survive the step regardless of what the
    partitioner would choose. Returns ``step(ts, env, key)``.
    """
    from gym_craftingworld_tpu.train.fast_ppo import train_step_fast

    rep = NamedSharding(mesh, P())
    return jax.jit(
        partial(train_step_fast, cfg, fppo),
        donate_argnums=(0,),
        out_shardings=(rep, packed_lane_sharding(mesh), rep, rep),
    )


def pixel_train_step_sharded(cfg: EnvConfig, pppo, mesh: Mesh):
    """train/fast_pixel_ppo.train_step_pixel with output shardings pinned."""
    from gym_craftingworld_tpu.train.fast_pixel_ppo import train_step_pixel

    rep = NamedSharding(mesh, P())
    return jax.jit(
        partial(train_step_pixel, cfg, pppo),
        donate_argnums=(0,),
        out_shardings=(rep, packed_lane_sharding(mesh), rep, rep),
    )


def rollout_p_sharded(cfg: EnvConfig, slots: SlotState, actions,
                      num_steps: int, mesh: Mesh):
    """Packed scan rollout over a sharded batch.

    ``actions`` is int[T, B]; it is constrained to ``P(None, 'env')`` so each
    device steps only its local envs. Results are bit-identical to the
    single-device rollout (same per-env algebra, no collectives).
    """
    actions = jax.lax.with_sharding_constraint(
        actions, NamedSharding(mesh, P(None, ENV_AXIS))
    )
    return rollout_p(cfg, slots, actions, num_steps)


@partial(jax.jit, static_argnums=(0, 3),
         static_argnames=("mesh", "interpret", "block"))
def fused_rollout_packed_bench_sharded(cfg: EnvConfig, slots: SlotState, seed,
                                       num_steps: int, *, mesh: Mesh,
                                       interpret: bool = False,
                                       block: int | None = None):
    """shard_map the rollout kernel: each device steps its local envs.

    Each shard passes its first global env index as ``env_offset``, so the
    action streams — and therefore the final state and the reward checksum —
    are identical to ``fused_rollout_packed_bench`` on one device with the
    same global B.
    """
    local_B = slots.agent.shape[0] // mesh.size

    def local(slots_l, seed_arr):
        offset = jax.lax.axis_index(ENV_AXIS) * local_B
        st, acc = pf.fused_rollout_packed_bench(
            cfg, slots_l, seed_arr[0], num_steps, env_offset=offset,
            interpret=interpret, block=block,
        )
        return st, jax.lax.psum(acc, ENV_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(ENV_AXIS), P()),
        out_specs=(P(ENV_AXIS), P()),
        check_vma=False,  # pallas_call outputs carry no vma metadata
    )(slots, jnp.asarray([seed], jnp.int32))
