"""Headline engines under mesh sharding (8 virtual CPU devices).

The layouts the benchmark advertises ([8, B] slot arrays, batch on the last
axis) must be proven multi-device correct, not just the grid PPO path."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from gym_craftingworld_tpu import ray_config, reset_from_seed
from gym_craftingworld_tpu.core import slots as sm
from gym_craftingworld_tpu.ops import packed_fused as pf
from gym_craftingworld_tpu.ops import packed_rollout as pr
from gym_craftingworld_tpu.parallel import sharded_engine as se
from gym_craftingworld_tpu.parallel.mesh import make_env_mesh


def _slots(cfg, seed, B):
    return sm.from_env_state(reset_from_seed(cfg, seed, B))


def test_rollout_p_sharded_bit_exact():
    """P('env')-sharded packed rollout == single-device, and outputs stay
    sharded (no silent gather to one device)."""
    cfg = ray_config()
    B, T = 64, 200
    mesh = make_env_mesh(8)
    actions = jax.random.randint(jax.random.PRNGKey(2), (T, B), 0, 6, jnp.int32)

    sl_ref, out_ref = pr.rollout_p(cfg, _slots(cfg, 0, B), actions, T)

    sl_sh = se.shard_slots(_slots(cfg, 0, B), mesh)
    assert sl_sh.agent.sharding.spec == P("env")
    sl_out, out_sh = se.rollout_p_sharded(cfg, sl_sh, actions, T, mesh)

    np.testing.assert_array_equal(np.asarray(out_sh.reward),
                                  np.asarray(out_ref.reward))
    np.testing.assert_array_equal(np.asarray(out_sh.done),
                                  np.asarray(out_ref.done))
    for f in ["slot_type", "slot_stat", "agent", "achieved", "step_num"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(sl_out, f)), np.asarray(getattr(sl_ref, f)),
            err_msg=f,
        )
    # the final state must still be distributed over the mesh
    assert len(sl_out.agent.sharding.device_set) == 8


# the rollout kernel runs in the Pallas interpreter on CPU
_KW = dict(interpret=True, block=64)


def test_fused_actions_sharded_matches_unsharded():
    """The sharded kernel steps each env with the reference stream of its
    *global* index: it equals the sharded scan fed ``reference_actions``."""
    cfg = ray_config()
    B, T = 1024, 48  # 8 shards x 128 envs = two kernel blocks per shard
    mesh = make_env_mesh(8)
    actions = pf.reference_actions(5, B, T)

    sl_ref, out_ref = se.rollout_p_sharded(
        cfg, se.shard_slots(_slots(cfg, 1, B), mesh), actions, T, mesh)
    sl_sh, acc_sh = se.fused_rollout_packed_bench_sharded(
        cfg, se.shard_slots(_slots(cfg, 1, B), mesh), 5, T, mesh=mesh, **_KW)

    assert int(acc_sh) == int(np.asarray(out_ref.reward).sum())
    for f in ["slot_type", "slot_stat", "agent", "achieved", "step_num"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(sl_sh, f)), np.asarray(getattr(sl_ref, f)),
            err_msg=f,
        )
    assert len(sl_sh.agent.sharding.device_set) == 8


def test_fused_bench_sharded_matches_unsharded():
    """Same seed ⇒ same checksum and final state on 8 shards as on one
    device: each shard's env offset reproduces the global env indexing."""
    cfg = ray_config()
    B, T = 1024, 32
    mesh = make_env_mesh(8)

    st_ref, acc_ref = pf.fused_rollout_packed_bench(cfg, _slots(cfg, 2, B), 9,
                                                    T, **_KW)
    st_sh, acc_sh = se.fused_rollout_packed_bench_sharded(
        cfg, se.shard_slots(_slots(cfg, 2, B), mesh), 9, T, mesh=mesh, **_KW)

    assert int(acc_sh) == int(acc_ref)
    np.testing.assert_array_equal(np.asarray(st_sh.agent),
                                  np.asarray(st_ref.agent))
    np.testing.assert_array_equal(np.asarray(st_sh.step_num),
                                  np.asarray(st_ref.step_num))


def test_fast_ppo_train_step_sharded():
    """The fast trainer runs with its env batch sharded over the mesh's lane
    axis and still produces finite metrics / replicatable params."""
    from jax.sharding import NamedSharding

    from gym_craftingworld_tpu.train import fast_ppo as fp

    cfg = ray_config()
    mesh = make_env_mesh(8)
    fppo = fp.FastPPOConfig(rollout_steps=8, num_minibatches=2,
                            update_epochs=1, hidden=64)
    env = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(0), 1024)
    lane_sharded = lambda x: jax.device_put(
        x, NamedSharding(mesh, P(*([None] * (x.ndim - 1) + ["env"]))))
    env = jax.tree.map(lane_sharded, env)
    assert env.slot_key.sharding.spec == P(None, "env")
    ts = fp.init_fast_train_state(jax.random.PRNGKey(1), cfg, fppo)
    ts, env, key, metrics = fp.train_step_fast(cfg, fppo, ts, env,
                                               jax.random.PRNGKey(2))
    assert np.isfinite(float(metrics["loss"]))
    assert len(env.slot_key.sharding.device_set) == 8


def test_fast_train_step_sharded_pins_out_shardings():
    """The sharded wrapper pins its outputs: the env batch keeps its
    lane-axis sharding and params come back replicated."""
    from gym_craftingworld_tpu.train import fast_ppo as fp

    cfg = ray_config()
    mesh = make_env_mesh(8)
    fppo = fp.FastPPOConfig(rollout_steps=8, num_minibatches=2,
                            update_epochs=1, hidden=64)
    env = se.shard_packed(
        fp.fresh_packed_batch(cfg, jax.random.PRNGKey(0), 1024), mesh)
    ts = fp.init_fast_train_state(jax.random.PRNGKey(1), cfg, fppo)
    step = se.fast_train_step_sharded(cfg, fppo, mesh)
    ts, env, _, metrics = step(ts, env, jax.random.PRNGKey(2))
    assert np.isfinite(float(metrics["loss"]))
    assert env.slot_key.sharding.spec == P(None, "env")
    assert env.agent_r.sharding.spec == P("env")
    assert ts.params.w1.sharding.is_fully_replicated
