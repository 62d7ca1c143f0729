"""On-device goal-state synthesis ("imagine_obs").

The reference builds the hypothetical *final* state from the init state by
applying each desired task's effect, with RNG choices for which bread / stick /
house / empty cell (`craftingworld_ray.py:220-299`). The application order is
task-index order 0,1,3,8,2,4,5,6,7 (MakeBread, EatBread, ChopTree, MoveSticks,
BuildHouse, ChopRock, GoToHouse, MoveAxe, MoveHammer) and that order is
preserved here because later edits see earlier edits' objects (e.g. EatBread may
eat the bread MakeBread just created).

Quirks preserved:
  - MakeBread / ChopTree / ChopRock / MoveAxe / MoveHammer act on the *first*
    matching cell in row-major order (``np.where(...)[0][0]`` in the reference);
  - MoveSticks searches empty cells over channels ``[:9]`` (excludes the agent's
    cell) but MoveAxe/MoveHammer over ``[:8]`` (the agent's cell is eligible) —
    craftingworld_ray.py:252 vs :282,:293;
  - GoToHouse moves the agent (+held channels) onto a random house
    (craftingworld_ray.py:269-276).

Everything is fixed-shape masked arithmetic on the flat ``[H*W]`` grid: "pick
the first matching cell" is an argmax over a boolean mask, "pick a uniformly
random matching cell" is an argmax over masked uniform scores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gym_craftingworld_tpu import constants as C


def _first_cell(mask: jax.Array) -> jax.Array:
    """Smallest row-major linear index where mask is True (mask must be nonempty)."""
    return jnp.argmax(mask)


def _random_cell(key: jax.Array, mask: jax.Array) -> jax.Array:
    """Uniformly random linear index among True cells (mask must be nonempty)."""
    scores = jax.random.uniform(key, mask.shape)
    return jnp.argmax(jnp.where(mask, scores, -1.0))


def _cond_set(cond, flat, idx, val):
    """flat[idx] <- val, only when ``cond``; fixed-shape either way.

    A dense compare-select rather than ``flat.at[idx].set``: data-dependent
    scatters inside large vmapped programs have miscompiled at big batch
    sizes (see core/step.py), and the dense form is a few hundred elements
    either way.
    """
    hit = jnp.arange(flat.shape[0], dtype=jnp.int32) == idx
    return jnp.where(cond & hit, val, flat)


def imagine_goal(
    key: jax.Array,
    init_objects_flat: jax.Array,  # int8[H*W], 0/1..8 codes (no agent mark)
    agent_idx: jax.Array,  # int32 linear index of the agent's init cell
    desired: jax.Array,  # int8[9]
):
    """Single-env goal synthesis.

    Returns ``(goal_objects_flat int8[H*W], goal_agent_idx int32)``.
    """
    keys = jax.random.split(key, 6)
    g = init_objects_flat.astype(jnp.int32)
    a_idx = agent_idx.astype(jnp.int32)
    d = desired.astype(jnp.bool_)

    # MakeBread: first wheat cell → bread (craftingworld_ray.py:226-231).
    c = _first_cell(g == C.WHEAT)
    g = _cond_set(d[C.T_MAKE_BREAD], g, c, C.BREAD)

    # EatBread: random bread cell (possibly the one just made) → empty (:232-237).
    c = _random_cell(keys[0], g == C.BREAD)
    g = _cond_set(d[C.T_EAT_BREAD], g, c, C.EMPTY)

    # ChopTree: first tree cell → sticks (:238-243).
    c = _first_cell(g == C.TREE)
    g = _cond_set(d[C.T_CHOP_TREE], g, c, C.STICKS)

    # MoveSticks: random stick → random empty cell, where "empty" excludes the
    # agent's cell (channels [:9] in the reference, :244-257).
    src = _random_cell(keys[1], g == C.STICKS)
    n_cells = g.shape[0]
    not_agent = jnp.arange(n_cells) != a_idx
    dst = _random_cell(keys[2], (g == C.EMPTY) & not_agent)
    moved = _cond_set(d[C.T_MOVE_STICKS], g, src, C.EMPTY)
    g = _cond_set(d[C.T_MOVE_STICKS], moved, dst, C.STICKS)

    # BuildHouse: random stick cell → house, in place (:258-264).
    c = _random_cell(keys[3], g == C.STICKS)
    g = _cond_set(d[C.T_BUILD_HOUSE], g, c, C.HOUSE)

    # ChopRock: first rock cell → empty (:265-268).
    c = _first_cell(g == C.ROCK)
    g = _cond_set(d[C.T_CHOP_ROCK], g, c, C.EMPTY)

    # GoToHouse: agent (+held channels) relocate onto a random house (:269-276).
    house = _random_cell(keys[4], g == C.HOUSE)
    a_idx = jnp.where(d[C.T_GO_TO_HOUSE], house.astype(jnp.int32), a_idx)

    # MoveAxe: first axe → random empty cell over channels [:8] — the agent's
    # cell *is* eligible here (:277-286).
    src = _first_cell(g == C.AXE)
    dst = _random_cell(keys[5], g == C.EMPTY)
    moved = _cond_set(d[C.T_MOVE_AXE], g, src, C.EMPTY)
    g = _cond_set(d[C.T_MOVE_AXE], moved, dst, C.AXE)

    # MoveHammer: same pattern (:287-297). Reference draws its randint *after*
    # MoveAxe's, so use a fresh subkey derived the same way.
    key_h = jax.random.fold_in(keys[5], 1)
    src = _first_cell(g == C.HAMMER)
    dst = _random_cell(key_h, g == C.EMPTY)
    moved = _cond_set(d[C.T_MOVE_HAMMER], g, src, C.EMPTY)
    g = _cond_set(d[C.T_MOVE_HAMMER], moved, dst, C.HAMMER)

    return g.astype(jnp.int8), a_idx
