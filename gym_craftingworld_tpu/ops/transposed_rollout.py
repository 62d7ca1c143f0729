"""Transposed slot layout: slot axis first, batch last (``[8, B]``).

The straightforward slot layout puts the 8-entity axis last, so every
``[B, 8]`` vector op runs along an axis of length 8. Storing the state
transposed as ``[8, B]`` puts the long batch axis minor, and slot reductions
become sums of 8 rows.

This module provides a scan rollout over the transposed layout. Entry/exit
transposes cost two small copies per rollout; per-step semantics are identical
to core/slots.py (equivalence-tested).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.slots import HELD, ON_GRID, REMOVED, SlotState
from gym_craftingworld_tpu.core.step import StepResult


class TSlotState(NamedTuple):
    """Transposed slot state: slot axis first ([8, B]), scalars [B]."""

    slot_type: jax.Array  # int32[8, B]
    slot_pos_r: jax.Array  # int32[8, B]
    slot_pos_c: jax.Array  # int32[8, B]
    slot_stat: jax.Array  # int32[8, B]
    agent_r: jax.Array  # int32[B]
    agent_c: jax.Array  # int32[B]
    desired: jax.Array  # int32[9, B]
    achieved: jax.Array  # int32[9, B]
    init_type: jax.Array  # int32[8, B]
    init_pos_r: jax.Array  # int32[8, B]
    init_pos_c: jax.Array  # int32[8, B]
    init_agent_r: jax.Array  # int32[B]
    init_agent_c: jax.Array  # int32[B]
    step_num: jax.Array  # int32[B]


def transpose_in(slots: SlotState) -> TSlotState:
    i32t = lambda x: x.astype(jnp.int32).T
    return TSlotState(
        slot_type=i32t(slots.slot_type),
        slot_pos_r=i32t(slots.slot_pos[..., 0]),
        slot_pos_c=i32t(slots.slot_pos[..., 1]),
        slot_stat=i32t(slots.slot_stat),
        agent_r=slots.agent[:, 0].astype(jnp.int32),
        agent_c=slots.agent[:, 1].astype(jnp.int32),
        desired=i32t(slots.desired),
        achieved=i32t(slots.achieved),
        init_type=i32t(slots.init_type),
        init_pos_r=i32t(slots.init_pos[..., 0]),
        init_pos_c=i32t(slots.init_pos[..., 1]),
        init_agent_r=slots.init_agent[:, 0].astype(jnp.int32),
        init_agent_c=slots.init_agent[:, 1].astype(jnp.int32),
        step_num=slots.step_num.astype(jnp.int32),
    )


def transpose_out(t: TSlotState, rng) -> SlotState:
    return SlotState(
        slot_type=t.slot_type.T,
        slot_pos=jnp.stack([t.slot_pos_r.T, t.slot_pos_c.T], axis=-1),
        slot_stat=t.slot_stat.T,
        agent=jnp.stack([t.agent_r, t.agent_c], axis=-1),
        desired=t.desired.T.astype(jnp.int8),
        achieved=t.achieved.T.astype(jnp.int8),
        init_type=t.init_type.T,
        init_pos=jnp.stack([t.init_pos_r.T, t.init_pos_c.T], axis=-1),
        init_agent=jnp.stack([t.init_agent_r, t.init_agent_c], axis=-1),
        step_num=t.step_num,
        rng=rng,
    )


def _step_t(cfg: EnvConfig, s: TSlotState, action: jax.Array):
    """One batched step in the transposed layout; ``action`` int32[B]."""
    i32 = jnp.int32
    dr = (action == C.ACTION_DOWN).astype(i32) - (action == C.ACTION_UP).astype(i32)
    dc = (action == C.ACTION_RIGHT).astype(i32) - (action == C.ACTION_LEFT).astype(i32)
    is_move = action < C.ACTION_PICKUP  # [B]

    new_r = jnp.clip(s.agent_r + dr, 0, cfg.height - 1)
    new_c = jnp.clip(s.agent_c + dc, 0, cfg.width - 1)
    moved_pos = (new_r != s.agent_r) | (new_c != s.agent_c)

    on = s.slot_stat == ON_GRID  # [8, B]
    held = s.slot_stat == HELD
    holding = jnp.sum(held * s.slot_type, axis=0)  # [B]

    at_here = on & (s.slot_pos_r == s.agent_r) & (s.slot_pos_c == s.agent_c)
    at_there = on & (s.slot_pos_r == new_r) & (s.slot_pos_c == new_c)
    obj_here = jnp.sum(at_here * s.slot_type, axis=0)
    obj_there = jnp.sum(at_there * s.slot_type, axis=0)

    blocked = ((obj_there == C.ROCK) & (holding != C.HOLD_HAMMER)) | (
        (obj_there == C.TREE) & (holding != C.HOLD_AXE)
    )
    move_ok = is_move & moved_pos & ~blocked  # [B]

    can_pickup = (
        (action == C.ACTION_PICKUP)
        & (obj_here >= C.STICKS)
        & (obj_here <= C.HAMMER)
        & (holding == C.HOLD_NONE)
    )
    can_drop = (
        (action == C.ACTION_DROP)
        & (holding != C.HOLD_NONE)
        & (obj_here == C.EMPTY)
    )

    t = s.slot_type
    eff_type = t
    eff_type = jnp.where(t == C.TREE, C.STICKS, eff_type)
    eff_type = jnp.where((t == C.STICKS) & (holding == C.HOLD_HAMMER), C.HOUSE,
                         eff_type)
    eff_type = jnp.where((t == C.WHEAT) & (holding == C.HOLD_AXE), C.BREAD,
                         eff_type)
    eff_removed = (t == C.ROCK) | (t == C.BREAD)

    hit = at_there & move_ok  # [8, B] & [B] broadcasts over the slot axis
    slot_type = jnp.where(hit, eff_type, t)
    slot_stat = jnp.where(hit & eff_removed, REMOVED, s.slot_stat)

    slot_stat = jnp.where(can_pickup & at_here, HELD, slot_stat)
    dropping = can_drop & held
    slot_stat = jnp.where(dropping, ON_GRID, slot_stat)
    slot_pos_r = jnp.where(dropping, s.agent_r, s.slot_pos_r)
    slot_pos_c = jnp.where(dropping, s.agent_c, s.slot_pos_c)

    agent_r = jnp.where(move_ok, new_r, s.agent_r)
    agent_c = jnp.where(move_ok, new_c, s.agent_c)

    # ---- task evaluation (same boolean algebra as core/slots.py) ----
    eat = move_ok & (obj_there == C.BREAD)
    chop_rock = move_ok & (obj_there == C.ROCK)
    chop_tree = move_ok & (obj_there == C.TREE)
    make_bread = move_ok & (obj_there == C.WHEAT) & (holding == C.HOLD_AXE)
    build_house = move_ok & (obj_there == C.STICKS) & (holding == C.HOLD_HAMMER)

    a = s.achieved  # [9, B]
    a_eat = a[C.T_EAT_BREAD] | eat
    a_crock = a[C.T_CHOP_ROCK] | chop_rock
    a_ctree = a[C.T_CHOP_TREE] | chop_tree
    a_mbread = a[C.T_MAKE_BREAD] | make_bread
    a_bhouse = a[C.T_BUILD_HOUSE] | build_house

    eff_there = jnp.sum(hit * jnp.where(eff_removed, 0, eff_type), axis=0)
    cell_final = jnp.where(move_ok, eff_there, obj_here)
    a_house = (cell_final == C.HOUSE).astype(jnp.int32)

    at_init = (s.init_pos_r == agent_r) & (s.init_pos_c == agent_c)
    icode = jnp.sum(at_init * s.init_type, axis=0)
    icode = jnp.where(
        (icode == 0) & (s.init_agent_r == agent_r) & (s.init_agent_c == agent_c),
        C.AGENT_INIT_MARK,
        icode,
    )
    init_empty = icode == C.EMPTY
    ms = jnp.where(
        init_empty, 1,
        jnp.where(icode == C.STICKS, 0,
                  jnp.where((icode == C.TREE) & (a_ctree == 1), 0, 1)),
    )
    ma = jnp.where(init_empty, 1, jnp.where(icode == C.AXE, 0, 1))
    mh = jnp.where(init_empty, 1, jnp.where(icode == C.HAMMER, 0, 1))

    hold_sticks = holding == C.HOLD_STICKS
    hold_axe = holding == C.HOLD_AXE
    hold_hammer = holding == C.HOLD_HAMMER

    rows = [
        jnp.where(hold_axe, a_mbread, a[C.T_MAKE_BREAD]),       # 0
        a_eat,                                                  # 1
        jnp.where(hold_hammer, a_bhouse, a[C.T_BUILD_HOUSE]),   # 2
        a_ctree,                                                # 3
        a_crock,                                                # 4
        a_house,                                                # 5
        jnp.where(hold_axe, ma, a[C.T_MOVE_AXE]),               # 6
        jnp.where(hold_hammer, mh, a[C.T_MOVE_HAMMER]),         # 7
        jnp.where(hold_sticks, ms, a[C.T_MOVE_STICKS]),         # 8
    ]
    upd = jnp.stack(rows, axis=0).astype(jnp.int32)  # [9, B]
    achieved = jnp.where(is_move, upd, a)

    changed = move_ok | can_pickup | can_drop
    if cfg.reward_equal:
        success = jnp.all(achieved == s.desired, axis=0)
    else:
        success = jnp.all(s.desired <= achieved, axis=0)
    reward = jnp.where(changed & success, cfg.max_steps, -1).astype(jnp.int32)
    step_num = jnp.minimum(s.step_num + 1, cfg.max_steps)
    done = (step_num >= cfg.max_steps) | (reward == cfg.max_steps)

    new_s = s._replace(
        slot_type=slot_type,
        slot_pos_r=slot_pos_r,
        slot_pos_c=slot_pos_c,
        slot_stat=slot_stat,
        agent_r=agent_r,
        agent_c=agent_c,
        achieved=achieved,
        step_num=step_num,
    )
    return new_s, StepResult(reward=reward, done=done, changed=changed)


@partial(jax.jit, static_argnums=(0, 3))
def rollout_t_random(cfg: EnvConfig, slots: SlotState, key, num_steps: int):
    """T random-action steps in the transposed layout; returns a SlotState."""
    B = slots.agent.shape[0]
    rng = slots.rng
    ts = transpose_in(slots)
    actions = jax.random.randint(key, (num_steps, B), 0, 6, dtype=jnp.int32)

    def body(carry, action_t):
        st, res = _step_t(cfg, carry, action_t)
        return st, res

    ts, out = jax.lax.scan(body, ts, actions)
    return transpose_out(ts, rng), out
