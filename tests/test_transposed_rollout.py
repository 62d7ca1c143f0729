"""Transposed slot layout: exact equivalence with the standard scan path."""

import importlib

import jax
import numpy as np

from gym_craftingworld_tpu import flat_config, ray_config, reset_from_seed
from gym_craftingworld_tpu.core import slots as sm

tr = importlib.import_module("gym_craftingworld_tpu.ops.transposed_rollout")


def test_transposed_rollout_matches_scan():
    for cfg, seed in [(ray_config(), 0), (flat_config(), 1)]:
        B, T = 24, 128
        st = reset_from_seed(cfg, seed, B)
        sl = sm.from_env_state(st)
        sl2 = sm.from_env_state(reset_from_seed(cfg, seed, B))
        key = jax.random.PRNGKey(5)
        ref_out = sm.rollout_slots_random(cfg, sl, key, T)
        t_out = tr.rollout_t_random(cfg, sl2, key, T)
        ref_sl, ref_res = ref_out
        t_sl, t_res = t_out
        np.testing.assert_array_equal(np.asarray(t_res.reward),
                                      np.asarray(ref_res.reward))
        np.testing.assert_array_equal(np.asarray(t_res.done),
                                      np.asarray(ref_res.done))
        for field in ["slot_type", "slot_stat", "agent", "achieved", "step_num"]:
            np.testing.assert_array_equal(
                np.asarray(getattr(t_sl, field)),
                np.asarray(getattr(ref_sl, field)),
                err_msg=field,
            )
