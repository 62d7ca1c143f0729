"""Pure, batched, branch-free CraftingWorld step.

Reproduces the reference semantics exactly, as one fixed dataflow of masked
selects/gathers/scatters per step (no data-dependent Python control flow):

  * action decode + movement clamp  (craftingworld_ray.py:301-313, coordinates.py:22-25)
  * pickup / drop                   (craftingworld_ray.py:314-341)
  * movement blocking + crafting    (craftingworld_ray.py:380-440, §"__move_agent")
  * incremental task evaluation     (craftingworld_ray.py:646-703, "eval_task_edit")
  * reward / done                   (craftingworld_ray.py:361-367, 747-767)

Semantic traps faithfully preserved:
  - task evaluation runs on *every* move action (even blocked / edge no-ops),
    but never on pickup/drop (craftingworld_ray.py:343-346);
  - GoToHouse and Move{Sticks,Axe,Hammer} bits are recomputed (can un-latch),
    the other five latch (craftingworld_ray.py:657-702);
  - a no-op step yields reward -1 even if goals are already met
    (craftingworld_ray.py:362-363);
  - drop requires all 8 object channels empty while pickup only checks the 3
    pickupable channels (craftingworld_ray.py:317,334);
  - MoveSticks exempts "initial tree cell whose tree was already chopped"
    (craftingworld_ray.py:680-682).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.state import EnvState


class StepResult(NamedTuple):
    reward: jax.Array  # int32[B]
    done: jax.Array  # bool[B]
    changed: jax.Array  # bool[B] — reference `changed_state`


def compute_reward(
    cfg: EnvConfig, achieved: jax.Array, desired: jax.Array
) -> jax.Array:
    """Batched reward: MAX_STEPS on success else -1 (craftingworld_ray.py:757-767)."""
    if cfg.reward_equal:
        success = jnp.all(achieved == desired, axis=-1)
    else:
        success = jnp.all(desired <= achieved, axis=-1)
    return jnp.where(success, cfg.max_steps, -1).astype(jnp.int32)


def _step_one(cfg: EnvConfig, state: EnvState, action: jax.Array):
    """Single-env step on unbatched leaves; vmapped by :func:`step`.

    Deliberately free of data-dependent gathers/scatters: every grid read is
    a one-hot masked reduction and every grid write a dense compare-select
    over the H x W board. Besides streaming the whole 21x21 grid in
    elementwise passes, this sidesteps a compiler bug seen on the
    accelerator this engine was first built for, where the fused per-env
    double scatter of the original formulation silently dropped the
    object-effect write at batch >= ~1024 (full-batch vs split-batch stepping
    diverged; CPU agreed with split). chip_smoke.py phase 1 checks the GPU's
    reset and rollout against the CPU's, bit for bit, at B = 2048.
    """
    H, W = cfg.height, cfg.width
    objects, agent, holding = state.objects, state.agent, state.holding
    achieved = state.achieved

    action = action.astype(jnp.int32)
    deltas = jnp.asarray(C.ACTION_DELTAS)
    delta = deltas[action]
    is_move = action < C.ACTION_PICKUP

    # -- movement target (edge-clamped; a clamped-to-self move is a no-op) --
    limits = jnp.array([H - 1, W - 1], jnp.int32)
    new_rc = jnp.clip(agent + delta, 0, limits)
    moved_pos = jnp.any(new_rc != agent)

    rows = jnp.arange(H, dtype=jnp.int32)[:, None]
    cols = jnp.arange(W, dtype=jnp.int32)[None, :]
    at_here = (rows == agent[0]) & (cols == agent[1])  # bool[H, W]
    at_there = (rows == new_rc[0]) & (cols == new_rc[1])

    obj_i32 = objects.astype(jnp.int32)
    obj_here = jnp.sum(obj_i32 * at_here)
    obj_there = jnp.sum(obj_i32 * at_there)

    # Rock blocks unless holding hammer; tree blocks unless holding axe
    # (craftingworld_ray.py:401-405).
    blocked = ((obj_there == C.ROCK) & (holding != C.HOLD_HAMMER)) | (
        (obj_there == C.TREE) & (holding != C.HOLD_AXE)
    )
    move_ok = is_move & moved_pos & ~blocked

    # -- pickup / drop (mutually exclusive with movement) --
    can_pickup = (
        (action == C.ACTION_PICKUP)
        & (obj_here >= C.STICKS)
        & (obj_here <= C.HAMMER)
        & (holding == C.HOLD_NONE)
    )
    can_drop = (
        (action == C.ACTION_DROP) & (holding != C.HOLD_NONE) & (obj_here == C.EMPTY)
    )

    here_val = jnp.where(
        can_pickup,
        C.EMPTY,
        jnp.where(can_drop, holding, obj_here),
    ).astype(jnp.int8)
    new_holding = jnp.where(
        can_pickup, obj_here, jnp.where(can_drop, C.HOLD_NONE, holding)
    ).astype(jnp.int32)

    # -- crafting effects on the object now underfoot (craftingworld_ray.py:416-438) --
    eff = obj_there
    eff = jnp.where(obj_there == C.ROCK, C.EMPTY, eff)  # ChopRock
    eff = jnp.where(obj_there == C.TREE, C.STICKS, eff)  # ChopTree → sticks
    eff = jnp.where(obj_there == C.BREAD, C.EMPTY, eff)  # EatBread
    eff = jnp.where(
        (obj_there == C.STICKS) & (holding == C.HOLD_HAMMER), C.HOUSE, eff
    )  # BuildHouse
    eff = jnp.where(
        (obj_there == C.WHEAT) & (holding == C.HOLD_AXE), C.BREAD, eff
    )  # MakeBread

    # -- write back the (at most two) touched cells, as dense selects --
    # move_ok implies the two cells are distinct; for pickup/drop the second
    # select is inert, so the agent-cell write always lands.
    objects = jnp.where(at_here, here_val, objects)
    objects = jnp.where(at_there & move_ok, eff.astype(jnp.int8), objects)

    new_agent = jnp.where(move_ok, new_rc, agent)

    # -- incremental task evaluation: move actions only (craftingworld_ray.py:343-346) --
    # Latching bits (craftingworld_ray.py:657-665, 686-688, 695-697).
    eat = move_ok & (obj_there == C.BREAD)
    chop_rock = move_ok & (obj_there == C.ROCK)
    chop_tree = move_ok & (obj_there == C.TREE)
    make_bread = move_ok & (obj_there == C.WHEAT) & (holding == C.HOLD_AXE)
    build_house = move_ok & (obj_there == C.STICKS) & (holding == C.HOLD_HAMMER)

    a = achieved.astype(jnp.int32)
    a_eat = a[C.T_EAT_BREAD] | eat
    a_crock = a[C.T_CHOP_ROCK] | chop_rock
    a_ctree = a[C.T_CHOP_TREE] | chop_tree  # updated value feeds MoveSticks below
    a_mbread = a[C.T_MAKE_BREAD] | make_bread
    a_bhouse = a[C.T_BUILD_HOUSE] | build_house

    # Non-latching bits, recomputed from the agent's (possibly unmoved) cell.
    cell_final = jnp.where(move_ok, eff, obj_here)
    a_house = (cell_final == C.HOUSE).astype(jnp.int32)

    at_new = jnp.where(move_ok, at_there, at_here)
    icode = jnp.sum(state.init_objects.astype(jnp.int32) * at_new)
    init_empty = icode == C.EMPTY
    # MoveSticks: un-achieved on the sticks origin, and on a chopped tree's
    # origin (craftingworld_ray.py:674-684). Any other original content
    # (including the agent's own start cell) counts as moved.
    ms = jnp.where(
        init_empty,
        1,
        jnp.where(
            icode == C.STICKS,
            0,
            jnp.where((icode == C.TREE) & (a_ctree == 1), 0, 1),
        ),
    )
    ma = jnp.where(init_empty, 1, jnp.where(icode == C.AXE, 0, 1))
    mh = jnp.where(init_empty, 1, jnp.where(icode == C.HAMMER, 0, 1))

    hold_sticks = holding == C.HOLD_STICKS
    hold_axe = holding == C.HOLD_AXE
    hold_hammer = holding == C.HOLD_HAMMER

    upd = a
    upd = upd.at[C.T_EAT_BREAD].set(a_eat)
    upd = upd.at[C.T_CHOP_ROCK].set(a_crock)
    upd = upd.at[C.T_CHOP_TREE].set(a_ctree)
    upd = upd.at[C.T_GO_TO_HOUSE].set(a_house)
    upd = upd.at[C.T_MAKE_BREAD].set(jnp.where(hold_axe, a_mbread, a[C.T_MAKE_BREAD]))
    upd = upd.at[C.T_BUILD_HOUSE].set(
        jnp.where(hold_hammer, a_bhouse, a[C.T_BUILD_HOUSE])
    )
    upd = upd.at[C.T_MOVE_STICKS].set(
        jnp.where(hold_sticks, ms, a[C.T_MOVE_STICKS])
    )
    upd = upd.at[C.T_MOVE_AXE].set(jnp.where(hold_axe, ma, a[C.T_MOVE_AXE]))
    upd = upd.at[C.T_MOVE_HAMMER].set(jnp.where(hold_hammer, mh, a[C.T_MOVE_HAMMER]))

    achieved = jnp.where(is_move, upd, a).astype(jnp.int8)

    # -- reward / done (craftingworld_ray.py:361-367) --
    changed = move_ok | can_pickup | can_drop
    reward = jnp.where(
        changed,
        compute_reward(cfg, achieved, state.desired.astype(jnp.int8)),
        jnp.int32(-1),
    )
    step_num = jnp.minimum(state.step_num + 1, cfg.max_steps)
    done = (step_num >= cfg.max_steps) | (reward == cfg.max_steps)

    new_state = state.replace(
        objects=objects,
        agent=new_agent,
        holding=new_holding,
        achieved=achieved,
        step_num=step_num,
    )
    return new_state, StepResult(reward=reward, done=done, changed=changed)


@partial(jax.jit, static_argnums=0, donate_argnums=1)
def step(cfg: EnvConfig, state: EnvState, action: jax.Array):
    """Batched step: ``(state[B], action int32[B]) -> (state[B], StepResult[B])``.

    The input state buffers are donated — under jit the grid is updated
    in place on device.
    """
    per_env = jax.vmap(partial(_step_one, cfg), in_axes=(0, 0))
    # vmap over every leaf's batch axis except nothing is shared: all leaves
    # of EnvState carry the batch dim, and action is [B].
    return per_env(state, action)
