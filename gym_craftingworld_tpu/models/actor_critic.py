"""Flagship policy network: goal-conditioned actor-critic.

The policy consumes the compact one-hot state encoding (H*W*12 ≈ 5.3k
features at 21x21) concatenated with the desired/achieved goal bits — large
batched dense layers in bfloat16, instead of convolving tiny 84x84 pixel
renders. The features live in render/features.py, which needs no flax.
"""

from __future__ import annotations

import jax.numpy as jnp
from flax import linen as nn

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.render.features import (  # noqa: F401  (re-export)
    feature_dim,
    feature_dim_init,
    obs_features,
    obs_features_init,
)


class ActorCritic(nn.Module):
    """Shared-torso MLP actor-critic (bf16 compute, f32 params/heads)."""

    hidden: int = 512
    n_actions: int = C.N_ACTIONS

    @nn.compact
    def __call__(self, obs):
        x = obs.astype(jnp.bfloat16)
        x = nn.Dense(self.hidden, dtype=jnp.bfloat16, name="torso0")(x)
        x = nn.relu(x)
        x = nn.Dense(self.hidden // 2, dtype=jnp.bfloat16, name="torso1")(x)
        x = nn.relu(x)
        logits = nn.Dense(self.n_actions, dtype=jnp.float32, name="policy")(x)
        value = nn.Dense(1, dtype=jnp.float32, name="value")(x)
        return logits, value.squeeze(-1)


def init_params(key, height: int = 21, width: int = 21, hidden: int = 512):
    model = ActorCritic(hidden=hidden)
    dummy = jnp.zeros((1, feature_dim(height, width)), jnp.float32)
    return model, model.init(key, dummy)
