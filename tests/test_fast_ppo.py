"""Fast (packed-engine) PPO: reset-pool distribution, auto-reset mechanics,
train-step integrity, and a small end-to-end learning check."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu import flat_config, ray_config
from gym_craftingworld_tpu.core import slots as sm
from gym_craftingworld_tpu.ops import packed_rollout as pr
from gym_craftingworld_tpu.ops.transposed_rollout import transpose_in
from gym_craftingworld_tpu.train import fast_ppo as fp


def test_fresh_packed_batch_distribution():
    cfg = ray_config()
    n = 2048
    batch = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(0), n)
    sk = np.asarray(batch.slot_key)
    ak = np.asarray(batch.init_agent_key)
    allk = np.concatenate([sk, ak[None]], axis=0)  # [9, n]
    assert (allk >= 0).all() and (allk < cfg.n_cells).all()
    for b in range(0, n, 97):
        assert len(set(allk[:, b])) == 9, "placed cells must be distinct"
    # agent cell ~ uniform over the grid: every cell hit at least once and no
    # cell grossly over-represented (expected n/441 ≈ 4.6 hits)
    counts = np.bincount(ak, minlength=cfg.n_cells)
    assert counts.max() < 25
    # desired masks: 1..number_of_tasks bits set
    des = np.asarray(batch.desired)
    bits = np.unpackbits(des.astype(">u2").view(np.uint8).reshape(-1, 2),
                         axis=1).sum(axis=1)
    assert bits.min() >= 1 and bits.max() <= cfg.number_of_tasks
    # k = popcount distribution should cover the full 1..num_tasks range
    assert len(np.unique(bits)) == cfg.number_of_tasks


def test_fresh_packed_batch_matches_reset_fields():
    """fresh_packed_batch must be a *valid* packed state: stepping it through
    the packed engine equals stepping the same state via the scan entry path
    (pack ∘ transpose_in ∘ SlotState round trip)."""
    cfg = ray_config()
    n, T = 128, 60
    batch = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(3), n)
    # round-trip through SlotState: unpack → transpose_out → rollout_p re-packs
    init_rows = (
        (batch.init_key // cfg.width).astype(jnp.int32),
        (batch.init_key % cfg.width).astype(jnp.int32),
        batch.init_type.astype(jnp.int32),
        (batch.init_agent_key // cfg.width).astype(jnp.int32),
        (batch.init_agent_key % cfg.width).astype(jnp.int32),
    )
    desired_rows = (
        (batch.desired.astype(jnp.int32)[None, :] >> jnp.arange(9)[:, None]) & 1
    )
    slots = pr.transpose_out(
        pr.unpack(cfg, batch, desired_rows, init_rows),
        jnp.zeros((n, 2), jnp.uint32),
    )
    actions = jax.random.randint(jax.random.PRNGKey(4), (T, n), 0, 6, jnp.int32)
    _, out_scan = pr.rollout_p(cfg, slots, actions, T)

    def direct(carry, a):
        st, r = pr._step_p(cfg, carry, a)
        return st, (r.reward, r.done)

    _, (r_d, d_d) = jax.lax.scan(direct, batch, actions.astype(jnp.int16))
    np.testing.assert_array_equal(np.asarray(out_scan.reward),
                                  np.asarray(r_d.astype(jnp.int32)))
    np.testing.assert_array_equal(np.asarray(out_scan.done), np.asarray(d_d))


def test_autoreset_pulls_fresh_state():
    cfg = flat_config()  # max_steps=100
    B = 64
    env = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(0), B)
    env = env._replace(step_num=jnp.full((B,), cfg.max_steps - 1, jnp.int16))
    pool = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(1), 128)
    st, res = pr._step_p(cfg, env, jnp.zeros((B,), jnp.int16))  # all hit done
    assert bool(res.done.all())
    idx = jax.random.randint(jax.random.PRNGKey(2), (B,), 0, 128)
    st = fp._autoreset(st, fp._pool_take(pool, idx), res.done)
    assert int(np.asarray(st.step_num).max()) == 0
    np.testing.assert_array_equal(np.asarray(st.achieved), 0)
    np.testing.assert_array_equal(
        np.asarray(st.slot_key), np.asarray(pool.slot_key)[:, np.asarray(idx)]
    )


def test_train_step_fast_runs_and_updates():
    cfg = ray_config()
    fppo = fp.FastPPOConfig(rollout_steps=8, num_minibatches=2,
                            update_epochs=1, hidden=64)
    env = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(0), 128)
    ts = fp.init_fast_train_state(jax.random.PRNGKey(1), cfg, fppo)
    w0 = np.asarray(ts.params.w1).copy()
    ts, env, key, metrics = fp.train_step_fast(cfg, fppo, ts, env,
                                               jax.random.PRNGKey(2))
    for k in ["loss", "reward_mean", "episode_done_frac", "success_rate",
              "entropy", "pg_loss", "v_loss"]:
        assert np.isfinite(float(metrics[k])), k
    assert not np.allclose(w0, np.asarray(ts.params.w1))
    assert int(ts.update_idx) == 1
    # entropy starts near uniform log 6
    assert abs(float(metrics["entropy"]) - np.log(6)) < 0.05


def test_fast_ppo_learns_single_task():
    """On single-task 8x8 worlds the policy must beat its own first updates
    within a short budget (sanity that gradients flow end to end)."""
    cfg = dataclasses.replace(flat_config(), stacking=False)
    fppo = fp.FastPPOConfig(rollout_steps=32, num_minibatches=4,
                            update_epochs=2, hidden=128, lr=1e-3, ent_coef=0.003)
    env = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(0), 512)
    ts = fp.init_fast_train_state(jax.random.PRNGKey(1), cfg, fppo)
    ts, env, key, m = fp.train_many_fast(cfg, fppo, ts, env, 64,
                                         jax.random.PRNGKey(2))
    rm = np.asarray(m["reward_mean"])
    sps = np.asarray(m["success_per_step"])
    assert np.isfinite(rm).all()
    early, late = rm[:16].mean(), rm[-16:].mean()
    assert late > early, f"no improvement: first16={early:.4f} last16={late:.4f}"
    assert sps[-16:].mean() > 1.2 * sps[:16].mean(), (
        f"success/step did not rise: {sps[:16].mean():.5f} → "
        f"{sps[-16:].mean():.5f}"
    )


def test_throughput_preset_trains():
    """FastPPOConfig.throughput() (1 epoch, hidden 384) runs the full step.

    The preset's learning/wall-clock trade-off is recorded in
    docs/fast_ppo_sweep.json; this pins that it constructs and trains.
    """
    import dataclasses

    import jax
    import numpy as np

    from gym_craftingworld_tpu import flat_config
    from gym_craftingworld_tpu.train import fast_ppo as fp

    cfg = dataclasses.replace(flat_config(), stacking=False)
    fppo = fp.FastPPOConfig.throughput(rollout_steps=8, num_minibatches=2,
                                       hidden=48)
    assert fppo.update_epochs == 1
    ts = fp.init_fast_train_state(jax.random.PRNGKey(0), cfg, fppo)
    env = fp.fresh_packed_batch(cfg, jax.random.PRNGKey(1), 256)
    ts, env, key, m = fp.train_step_fast(cfg, fppo, ts, env,
                                         jax.random.PRNGKey(2))
    assert np.isfinite(float(m["loss"]))


def test_shuffle_block_keeps_minibatches_mixed():
    """shuffle_block must give each minibatch >= 8 independently permuted
    blocks whenever the shapes allow — a single contiguous (timestep,
    env-span) slab per minibatch would correlate advantage normalization
    over consecutive timesteps (round-5 review finding)."""
    from gym_craftingworld_tpu.train.fast_ppo import shuffle_block

    # production default: 64 * 16384 / 8 = 131072 rows/minibatch -> 2048
    assert shuffle_block(64, 16384, 8) == 2048
    # small config that used to collapse to one 2048-row slab per minibatch
    blk = shuffle_block(64, 256, 8)  # 2048 rows/minibatch
    assert blk * 8 <= 2048
    # tiny minibatches fall back to the smallest tiling block
    assert shuffle_block(16, 64, 2) == 128  # 512 rows/minibatch
    with pytest.raises(ValueError):
        shuffle_block(3, 5, 1)


@pytest.mark.parametrize("hidden,rows", [(64, 2048), (512, 8192)])
def test_loss_bm_grads_match_float32_reference(hidden, rows):
    """(k) Autodiff of the bf16-operand loss vs the same loss in float32 at
    matmul precision "highest": relative L2 error per leaf below 5e-2.

    bf16 keeps 8 significant bits (unit roundoff 2^-9 ~ 2e-3) and about ten
    roundings of weights, activations and cotangents lie between the loss
    and w1, so ~2e-2 is expected (measured up to 2.1e-2); a wrong gradient
    term is O(1) off."""
    cfg = ray_config()
    fppo = fp.FastPPOConfig(hidden=hidden)
    params = fp.init_params(jax.random.PRNGKey(1), cfg, fppo)
    kb = jax.random.split(jax.random.PRNGKey(2), 5)
    batch = (
        jax.random.normal(kb[0], (rows, fp.feature_rows(cfg)), jnp.bfloat16),
        jax.random.randint(kb[1], (rows,), 0, 6, jnp.int32),
        jnp.full((rows,), -np.log(6.0), jnp.float32),
        jax.random.normal(kb[2], (rows,), jnp.float32),
        jax.random.normal(kb[3], (rows,), jnp.float32),
        jax.random.normal(kb[4], (rows,), jnp.float32),
    )

    def grads(dtype):
        return jax.jit(jax.grad(
            lambda p: fp._loss_bm(fppo, p, batch, dtype)[0]))(params)

    g = grads(jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        ref = grads(jnp.float32)
    for name, a, b in zip(fp.MLPParams._fields, g, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), name
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 5e-2, (name, rel)
