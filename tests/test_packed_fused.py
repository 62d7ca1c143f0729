"""The packed rollout kernel (Pallas interpreter on CPU) vs the packed scan,
and its counter-hash action stream vs the plain-jnp reference."""

import jax
import numpy as np
import pytest

from gym_craftingworld_tpu import flat_config, ray_config, reset_from_seed
from gym_craftingworld_tpu.core import slots as sm
from gym_craftingworld_tpu.core.state import EnvState
from gym_craftingworld_tpu.core.validate import assert_valid_state
from gym_craftingworld_tpu.ops import packed_fused as pf
from gym_craftingworld_tpu.ops import packed_rollout as pr

_KW = dict(interpret=True, block=64)
_FIELDS = ["slot_type", "slot_stat", "agent", "achieved", "step_num"]


def _slots(cfg, seed, B):
    return sm.from_env_state(reset_from_seed(cfg, seed, B))


def _assert_same_state(a, b):
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    live = np.asarray(b.slot_stat) != sm.REMOVED
    np.testing.assert_array_equal(np.asarray(a.slot_pos)[live],
                                  np.asarray(b.slot_pos)[live])


@pytest.mark.parametrize("cfg,seed", [(ray_config(), 0), (flat_config(), 1)])
def test_packed_fused_actions_equals_packed_scan(cfg, seed):
    """Checksum and final state equal the scan fed the reference stream."""
    B, T = 256, 64
    sl_k, acc = pf.fused_rollout_packed_bench(cfg, _slots(cfg, seed, B), 11,
                                              T, **_KW)
    actions = pf.reference_actions(11, B, T)
    sl_s, out = pr.rollout_p(cfg, _slots(cfg, seed, B), actions, T)
    assert int(acc) == int(np.asarray(out.reward).sum())
    _assert_same_state(sl_k, sl_s)


def test_packed_fused_bench_checksum_consistent():
    """Deterministic for a fixed seed, different for another, and the final
    state satisfies every world invariant."""
    cfg = ray_config()
    B, T = 128, 32
    st = reset_from_seed(cfg, 0, B)
    s1, c1 = pf.fused_rollout_packed_bench(cfg, sm.from_env_state(st), 7, T,
                                           **_KW)
    s2, c2 = pf.fused_rollout_packed_bench(cfg, sm.from_env_state(st), 7, T,
                                           **_KW)
    s3, _ = pf.fused_rollout_packed_bench(cfg, sm.from_env_state(st), 8, T,
                                          **_KW)
    assert int(c1) == int(c2)
    np.testing.assert_array_equal(np.asarray(s1.agent), np.asarray(s2.agent))
    assert not np.array_equal(np.asarray(s1.agent), np.asarray(s3.agent))
    assert np.asarray(s1.step_num).min() == T
    obj, agent, hold = sm.to_grid(s1, cfg)
    assert_valid_state(cfg, EnvState(
        objects=obj, agent=agent, holding=hold, desired=s1.desired,
        achieved=s1.achieved, init_objects=st.init_objects,
        init_agent=s1.init_agent, goal_objects=obj, goal_agent=agent,
        step_num=s1.step_num, rng=s1.rng,
    ))


@pytest.mark.parametrize("B,block,offset", [(256, 64, 0), (96, 32, 1000)])
def test_in_kernel_stream_equals_reference(B, block, offset):
    """(a) The stream drawn inside the kernel is the jnp hash, bit for bit."""
    T = 40
    got = pf.fused_action_stream(B, 123, T, env_offset=offset,
                                 interpret=True, block=block)
    want = pf.reference_actions(123, B, T, env_offset=offset)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_stream_uniform_over_actions():
    """(b) Chi-square over the 6 actions: 5 d.o.f., 0.1% critical value
    20.5, at 2^20 draws."""
    acts = np.asarray(pf.reference_actions(2024, 4096, 256)).ravel()
    assert acts.min() >= 0 and acts.max() < 6
    counts = np.bincount(acts, minlength=6)
    expected = acts.size / 6
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 20.5, (chi2, counts)


@pytest.mark.parametrize("axis", ["seed", "env", "step"])
def test_stream_independent_along(axis):
    """(c) Two seeds, two envs or two steps draw streams that agree only at
    chance level (1/6, binomial sigma ~0.002 at 32k draws)."""
    n = 32768
    i = np.arange(n, dtype=np.int32)
    a = {"seed": lambda: (pf.action_stream(1, i, 5), pf.action_stream(2, i, 5)),
         "env": lambda: (pf.action_stream(9, 3, i), pf.action_stream(9, 4, i)),
         "step": lambda: (pf.action_stream(9, i, 0), pf.action_stream(9, i, 1)),
         }[axis]()
    agree = float((np.asarray(a[0]) == np.asarray(a[1])).mean())
    assert abs(agree - 1 / 6) < 0.012, agree


@pytest.mark.parametrize("block", [32, 128])
def test_stream_and_rollout_independent_of_block(block):
    """(d) The stream hashes the global env index, so the block size changes
    neither the actions nor the rollout."""
    cfg = ray_config()
    B, T = 256, 24
    ref_stream = pf.fused_action_stream(B, 5, T, interpret=True, block=64)
    got_stream = pf.fused_action_stream(B, 5, T, interpret=True, block=block)
    np.testing.assert_array_equal(np.asarray(got_stream),
                                  np.asarray(ref_stream))
    s_ref, c_ref = pf.fused_rollout_packed_bench(cfg, _slots(cfg, 4, B), 5, T,
                                                 interpret=True, block=64)
    s_got, c_got = pf.fused_rollout_packed_bench(cfg, _slots(cfg, 4, B), 5, T,
                                                 interpret=True, block=block)
    assert int(c_got) == int(c_ref)
    _assert_same_state(s_got, s_ref)


@pytest.mark.parametrize("B", [1, 100])
def test_batch_not_multiple_of_block_is_padded(B):
    """(f) The wrapper pads to whole blocks and slices the padding off: the
    result and the checksum cover exactly the B real envs."""
    cfg = flat_config()
    T = 32
    sl_k, acc = pf.fused_rollout_packed_bench(cfg, _slots(cfg, 3, B), 2, T,
                                              **_KW)
    assert sl_k.agent.shape == (B, 2)
    sl_s, out = pr.rollout_p(cfg, _slots(cfg, 3, B),
                             pf.reference_actions(2, B, T), T)
    assert out.reward.shape == (T, B)
    assert int(acc) == int(np.asarray(out.reward).sum())
    _assert_same_state(sl_k, sl_s)


def test_block_must_be_power_of_two():
    cfg = ray_config()
    with pytest.raises(ValueError, match="power of two"):
        pf.fused_rollout_packed_bench(cfg, _slots(cfg, 0, 96), 0, 4,
                                      interpret=True, block=96)


def test_switch_picks_scan_on_cpu():
    """(g) One switch: the scan on this (CPU) backend, the kernel on a GPU."""
    assert jax.default_backend() == "cpu"
    assert pf.rollout_layout() == "packed"
    assert pf.rollout_layout("gpu") == "packed_fused"
    cfg = ray_config()
    B, T = 64, 16
    st, acc = pf.rollout_random_bench(cfg, _slots(cfg, 0, B), 3, T)
    st_ref, acc_ref = pr.rollout_p_bench(cfg, _slots(cfg, 0, B),
                                         jax.random.PRNGKey(3), T)
    assert int(acc) == int(acc_ref)
    np.testing.assert_array_equal(np.asarray(st.agent), np.asarray(st_ref.agent))


def test_compiled_kernel_on_cpu_raises():
    """(g) The compiled kernel is never silently replaced on a CPU."""
    cfg = ray_config()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        pf.fused_rollout_packed_bench(cfg, _slots(cfg, 0, 64), 0, 4)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        pf.fused_action_stream(64, 0, 4)
