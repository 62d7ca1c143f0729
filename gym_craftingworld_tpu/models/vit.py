"""Grid-attention (ViT-style) actor-critic family.

Third policy family alongside the MLP (one-hot features) and CNN (pixel
renders): each grid cell is a token — its 12-channel one-hot embedded with a
learned 2-D positional code — and a goal token carrying the desired/achieved
bits attends over the board through a small pre-LN transformer. All matmuls
are bf16 and batched over envs, so the whole forward is matmul work; there is no
pixel render in the loop at all.

The reference has no learned models (SURVEY §5: nothing to scale); this
family exists for users who want relational/attention inductive bias over the
board instead of the MLP's flat features.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from flax import linen as nn

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.core.state import EnvState
from gym_craftingworld_tpu.render.raster import render_onehot


class _Block(nn.Module):
    """Pre-LN transformer block, bf16 compute."""

    dim: int
    heads: int

    @nn.compact
    def __call__(self, x):
        h = nn.LayerNorm(dtype=jnp.bfloat16)(x)
        h = nn.MultiHeadDotProductAttention(
            num_heads=self.heads, dtype=jnp.bfloat16
        )(h, h)
        x = x + h
        h = nn.LayerNorm(dtype=jnp.bfloat16)(x)
        h = nn.Dense(4 * self.dim, dtype=jnp.bfloat16)(h)
        h = nn.gelu(h)
        h = nn.Dense(self.dim, dtype=jnp.bfloat16)(h)
        return x + h


class GridActorCritic(nn.Module):
    """Cell tokens + goal token -> transformer -> policy/value heads.

    ``hidden`` is the token embedding dim (kept modest: the board is only
    H*W+1 tokens, so attention cost is tiny next to the env batch dim).
    """

    hidden: int = 128
    depth: int = 2
    heads: int = 4
    n_actions: int = C.N_ACTIONS

    @nn.compact
    def __call__(self, cells, goal_bits):
        # cells: f32/u8[B, H*W, 12] one-hot tokens; goal_bits: f32[B, 18]
        B, N, _ = cells.shape
        x = nn.Dense(self.hidden, dtype=jnp.bfloat16, name="embed")(
            cells.astype(jnp.bfloat16)
        )
        pos = self.param(
            "pos", nn.initializers.normal(0.02), (1, N, self.hidden)
        )
        x = x + pos.astype(jnp.bfloat16)
        goal_tok = nn.Dense(self.hidden, dtype=jnp.bfloat16, name="goal")(
            goal_bits.astype(jnp.bfloat16)
        )
        x = jnp.concatenate([goal_tok[:, None, :], x], axis=1)
        for i in range(self.depth):
            x = _Block(dim=self.hidden, heads=self.heads, name=f"block{i}")(x)
        x = nn.LayerNorm(dtype=jnp.bfloat16)(x)
        h = x[:, 0, :]  # goal token summarises the board
        logits = nn.Dense(self.n_actions, dtype=jnp.float32, name="policy")(h)
        value = nn.Dense(1, dtype=jnp.float32, name="value")(h)
        return logits, value.squeeze(-1)


def grid_tokens(state: EnvState):
    """(cells u8[B, H*W, 12], goal_bits f32[B, 18]) for the ViT family."""
    B, H, W = state.objects.shape
    grid = render_onehot(state.objects, state.agent, state.holding)
    cells = grid.reshape(B, H * W, C.N_CHANNELS)
    goal_bits = jnp.concatenate(
        [state.desired.astype(jnp.float32), state.achieved.astype(jnp.float32)],
        axis=-1,
    )
    return cells, goal_bits


def init_params(key, height: int = 21, width: int = 21, hidden: int = 128):
    model = GridActorCritic(hidden=hidden)
    dummy_cells = jnp.zeros((1, height * width, C.N_CHANNELS), jnp.uint8)
    dummy_goal = jnp.zeros((1, 2 * C.N_TASKS), jnp.float32)
    return model, model.init(key, dummy_cells, dummy_goal)
