"""Flat policy features of the grid state (plain jnp, no model library).

The vector env's ``obs_mode="features"`` and the flax policies in
``models/`` both read these.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.core.state import EnvState
from gym_craftingworld_tpu.render.raster import render_onehot


def obs_features(state: EnvState) -> jax.Array:
    """Policy features: flat one-hot grid + desired + achieved bits, f32[B, D]."""
    B = state.objects.shape[0]
    grid = render_onehot(state.objects, state.agent, state.holding)
    return jnp.concatenate(
        [
            grid.reshape(B, -1).astype(jnp.float32),
            state.desired.astype(jnp.float32),
            state.achieved.astype(jnp.float32),
        ],
        axis=-1,
    )


def feature_dim(height: int, width: int) -> int:
    return height * width * C.N_CHANNELS + 2 * C.N_TASKS


def obs_features_init(state: EnvState) -> jax.Array:
    """:func:`obs_features` ++ the flattened init-grid one-hot (9 channels:
    8 objects + the agent's reset cell).

    The Move*/GoToHouse evaluation compares the live grid against
    INIT_OBS_VECTOR (craftingworld_ray.py:670-702): stepping on an item's
    *origin* cell while carrying it clears its Move* bit — but origin cells
    are empty in the current grid, so a policy without the init view cannot
    route around them (the reference carries ``init_observation`` in its
    observation dict for exactly this reason, :183-187). Required by the CPV
    family for compositions involving Move*/GoToHouse.
    """
    B = state.objects.shape[0]
    init = state.init_objects.astype(jnp.int32)
    init_oh = jax.nn.one_hot(init - 1, C.N_OBJECTS + 1, dtype=jnp.float32)
    # channels 0-7: object origins; channel 8: agent reset cell
    return jnp.concatenate(
        [
            obs_features(state),
            init_oh.reshape(B, -1),
        ],
        axis=-1,
    )


def feature_dim_init(height: int, width: int) -> int:
    return feature_dim(height, width) + height * width * (C.N_OBJECTS + 1)
