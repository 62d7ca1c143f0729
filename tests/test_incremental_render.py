"""Incremental single-env render fast path (reference render_edit).

The reference maintains the observation image incrementally, repainting only
the cells a step changed (craftingworld_ray.py:522-557). The batched device
design full-renders on device; ``incremental_render=True`` restores the
reference's fast path for interactive single-env use. These tests pin the
fast path byte-exact against the full render.
"""

import numpy as np
import pytest

from gym_craftingworld_tpu.api.gym_env import (
    CraftingWorldEnvAltObs,
    CraftingWorldEnvFlat,
    CraftingWorldEnvOneHot,
    CraftingWorldEnvRay,
)
from gym_craftingworld_tpu.render import raster


def test_render_edit_repaints_full_image():
    """Repainting *every* cell must reproduce the full device render."""
    env = CraftingWorldEnvRay(size=(8, 8), seed=3)
    env.reset()
    for a in [0, 1, 1, 4, 2, 2, 3, 5, 0]:
        env.step(a)
    st = env.state
    full = np.asarray(raster.render_ray(st.objects, st.agent, st.holding))[0]
    objects = np.asarray(st.objects[0])
    agent = tuple(int(x) for x in np.asarray(st.agent[0]))
    holding = int(st.holding[0])
    img = np.zeros_like(full)
    cells = [(r, c) for r in range(8) for c in range(8)]
    raster.render_edit(img, objects, agent, holding, cells)
    np.testing.assert_array_equal(img, full)


@pytest.mark.parametrize("cls", [CraftingWorldEnvRay, CraftingWorldEnvFlat])
def test_incremental_episode_byte_exact(cls):
    """Lock-step episodes: incremental env == full-render env, every step,
    across an episode boundary."""
    kwargs = dict(size=(8, 8), max_steps=40, seed=11)
    env_full = cls(**kwargs)
    env_inc = cls(**kwargs, incremental_render=True)
    rng = np.random.RandomState(0)

    def compare(o_full, o_inc):
        if isinstance(o_full, dict):
            assert o_full.keys() == o_inc.keys()
            for k in o_full:
                np.testing.assert_array_equal(o_full[k], o_inc[k], err_msg=k)
        else:
            np.testing.assert_array_equal(o_full, o_inc)

    compare(env_full.reset(), env_inc.reset())
    for episode in range(2):
        for _ in range(45):  # past max_steps → exercises the done boundary
            a = int(rng.randint(6))
            of, rf, df, _ = env_full.step(a)
            oi, ri, di, _ = env_inc.step(a)
            assert (rf, df) == (ri, di)
            compare(of, oi)
            if df:
                break
        compare(env_full.reset(), env_inc.reset())


def test_incremental_rejects_unsupported():
    with pytest.raises(ValueError):
        CraftingWorldEnvRay(size=(8, 8), batch_size=2, incremental_render=True)
    with pytest.raises(ValueError):
        CraftingWorldEnvOneHot(size=(8, 8), incremental_render=True)
    with pytest.raises(ValueError):
        CraftingWorldEnvAltObs(size=(8, 8), incremental_render=True)
