"""Packed batched environment state and its bijection to the reference one-hot.

The reference stores each cell as a 12-wide one-hot vector
(`craftingworld_ray.py:94-98`): channels 0-7 object, 8 agent, 9-11 held item
(held item lives *in the agent's cell*, craftingworld_ray.py:407-408).

Here the same information is packed for device residency:

  objects  int8[B, H, W]   0 empty, 1..8 object code (= reference channel + 1)
  agent    int32[B, 2]     (row, col)
  holding  int32[B]        0 none, 1..3 = sticks/axe/hammer

plus goal/episode bookkeeping. Everything is a flat pytree of fixed-shape
arrays, so the whole batch shards trivially along axis 0 of every leaf.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnvState:
    """Batched CraftingWorld state. All leaves have leading batch axis B."""

    # Live world.
    objects: jax.Array  # int8[B, H, W]
    agent: jax.Array  # int32[B, 2]
    holding: jax.Array  # int32[B]

    # Goal bookkeeping (reference desired/achieved_goal_vector, shape (1,9) there).
    desired: jax.Array  # int8[B, 9]
    achieved: jax.Array  # int8[B, 9]

    # Frozen reset-time snapshot (reference INIT_OBS_VECTOR), needed by the
    # Move{Sticks,Axe,Hammer} evaluation (craftingworld_ray.py:670-702).
    # Cell codes as `objects`, plus 9 = agent's initial cell.
    init_objects: jax.Array  # int8[B, H, W]
    init_agent: jax.Array  # int32[B, 2]

    # Imagined goal state (reference imagine_obs, craftingworld_ray.py:220-299):
    # stored packed and rendered on demand instead of materialising goal images.
    goal_objects: jax.Array  # int8[B, H, W]
    goal_agent: jax.Array  # int32[B, 2]

    # Episode clock.
    step_num: jax.Array  # int32[B]

    # Per-env PRNG key (used by auto-reset rollouts).
    rng: jax.Array  # uint32[B, 2] (jax key data)

    def replace(self, **updates) -> "EnvState":
        return dataclasses.replace(self, **updates)

    @property
    def batch_size(self) -> int:
        return self.objects.shape[0]

    @property
    def grid_hw(self):
        return self.objects.shape[1], self.objects.shape[2]


def zeros_state(cfg: EnvConfig, batch_size: int) -> EnvState:
    """An all-empty state of the right shapes (useful as a shape template)."""
    B, H, W = batch_size, cfg.height, cfg.width
    return EnvState(
        objects=jnp.zeros((B, H, W), jnp.int8),
        agent=jnp.zeros((B, 2), jnp.int32),
        holding=jnp.zeros((B,), jnp.int32),
        desired=jnp.zeros((B, C.N_TASKS), jnp.int8),
        achieved=jnp.zeros((B, C.N_TASKS), jnp.int8),
        init_objects=jnp.zeros((B, H, W), jnp.int8),
        init_agent=jnp.zeros((B, 2), jnp.int32),
        goal_objects=jnp.zeros((B, H, W), jnp.int8),
        goal_agent=jnp.zeros((B, 2), jnp.int32),
        step_num=jnp.zeros((B,), jnp.int32),
        rng=jnp.zeros((B, 2), jnp.uint32),
    )


# ---------------------------------------------------------------------------
# Bijection to/from the reference (H, W, 12) one-hot — used by the parity
# harness and the Gym-compatible API shim. Host-side numpy; not jitted.
# ---------------------------------------------------------------------------


def onehot_from_packed(
    objects: np.ndarray, agent: np.ndarray, holding: int
) -> np.ndarray:
    """Packed single-env state → reference ``(H, W, 12)`` int one-hot."""
    H, W = objects.shape
    out = np.zeros((H, W, C.N_CHANNELS), dtype=int)
    obj = np.asarray(objects, dtype=np.int64)
    mask = obj > 0
    rr, cc = np.nonzero(mask)
    out[rr, cc, obj[rr, cc] - 1] = 1
    ar, ac = int(agent[0]), int(agent[1])
    out[ar, ac, C.N_OBJECTS] = 1
    if holding != C.HOLD_NONE:
        out[ar, ac, C.N_OBJECTS + int(holding)] = 1
    return out


def packed_from_onehot(onehot: np.ndarray):
    """Reference ``(H, W, 12)`` one-hot → (objects int8[H,W], agent (r,c), holding)."""
    onehot = np.asarray(onehot)
    obj_ch = onehot[:, :, : C.N_OBJECTS]
    objects = np.where(
        obj_ch.any(axis=2), obj_ch.argmax(axis=2) + 1, 0
    ).astype(np.int8)
    ar, ac = [int(v[0]) for v in np.nonzero(onehot[:, :, C.N_OBJECTS])]
    hold_ch = onehot[ar, ac, C.N_OBJECTS + 1 :]
    holding = int(hold_ch.argmax() + 1) if hold_ch.any() else C.HOLD_NONE
    return objects, np.array([ar, ac], dtype=np.int32), holding


def init_codes_from_onehot(onehot: np.ndarray) -> np.ndarray:
    """Reference INIT one-hot → init-cell codes (0 empty, 1..8 object, 9 agent).

    Reset-time states never carry a held item (sample_state places only
    objects + agent, craftingworld_ray.py:599-628), so the agent's cell maps
    to the AGENT_INIT_MARK code.
    """
    onehot = np.asarray(onehot)
    obj_ch = onehot[:, :, : C.N_OBJECTS]
    codes = np.where(obj_ch.any(axis=2), obj_ch.argmax(axis=2) + 1, 0)
    codes = np.where(
        (codes == 0) & (onehot[:, :, C.N_OBJECTS] == 1), C.AGENT_INIT_MARK, codes
    )
    return codes.astype(np.int8)


def state_from_reference(
    cfg: EnvConfig,
    obs_one_hot: np.ndarray,
    init_obs_vector: np.ndarray,
    desired: np.ndarray,
    achieved: np.ndarray,
    goal_one_hot: np.ndarray | None = None,
    step_num: int = 0,
) -> EnvState:
    """Build a B=1 EnvState that mirrors a live reference env (parity harness)."""
    objects, agent, holding = packed_from_onehot(obs_one_hot)
    init_codes = init_codes_from_onehot(init_obs_vector)
    _, init_agent, _ = packed_from_onehot(init_obs_vector)
    if goal_one_hot is not None:
        g_obj, g_agent, _ = packed_from_onehot(goal_one_hot)
    else:
        g_obj, g_agent = objects, agent
    return EnvState(
        objects=jnp.asarray(objects)[None],
        agent=jnp.asarray(agent)[None],
        holding=jnp.asarray([holding], jnp.int32),
        desired=jnp.asarray(np.reshape(desired, (1, C.N_TASKS)).astype(np.int8)),
        achieved=jnp.asarray(np.reshape(achieved, (1, C.N_TASKS)).astype(np.int8)),
        init_objects=jnp.asarray(init_codes)[None],
        init_agent=jnp.asarray(init_agent)[None],
        goal_objects=jnp.asarray(g_obj)[None],
        goal_agent=jnp.asarray(g_agent)[None],
        step_num=jnp.asarray([step_num], jnp.int32),
        rng=jnp.zeros((1, 2), jnp.uint32),
    )


def reference_onehot_from_state(state: EnvState, b: int = 0) -> np.ndarray:
    """EnvState (one env of the batch) → reference ``(H, W, 12)`` one-hot."""
    objects = np.asarray(state.objects[b])
    agent = np.asarray(state.agent[b])
    holding = int(state.holding[b])
    return onehot_from_packed(objects, agent, holding)
