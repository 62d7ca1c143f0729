"""Packed-key slot layout: the minimum-vector-op stepping engine.

The transposed scan (ops/transposed_rollout.py) spends ~100 vector ops per
step over [8, B] arrays, most of them position/status
compares and 9-row task bookkeeping. This engine collapses that algebra:

* Each slot's (status, row, col) packs into ONE int16 key::

      key = row * W + col        while the object sits on the grid
      key = H*W                  while held by the agent
      key = H*W + 1              once removed from the world

  The agent's cell key is always ``r*W + c < H*W``, so a single ``==``
  against the agent key simultaneously tests "on grid AND at this cell" —
  what previously took four [8, B] ops (status + row + col compares + ands).

* The object code and reset-cell code at the agent's *current* cell are
  carried as scalars (``obj_here``/``icode_here``): nothing can change the
  cell under the agent except the agent's own move/pickup/drop (objects never
  move on their own and crafting only fires on the cell being entered,
  craftingworld_ray.py:416-438), so they update from values the step already
  computed. Only the *destination* cell needs a slot reduction::

      sum_slots(at_there * type + 16 * at_init_there * init_type)

  Codes are < 10 so the 4-bit fields never collide (at most one slot matches —
  the one-object-per-cell invariant, see core/slots.py).

* Crafting effects are computed on the scalar codes (obj_there x holding), not
  per slot; each slot update is a single predicated select.

* ``achieved``/``desired`` live as 9-bit masks in one int16 per env, so the
  whole task-evaluation block (reference eval_task_edit,
  craftingworld_ray.py:646-703) is scalar bit algebra, and the reward compare
  (craftingworld_ray.py:757-767) is one integer equality instead of a 9-row
  reduction.

* Everything is int16: all values fit (keys < H*W+2, codes < 16, masks 9 bits,
  step counter <= max_steps), and halving the element width halves the
  scan-carry traffic through device memory.

Per-step semantics are bit-identical to core/slots.py / the transposed scan
(equivalence-tested in tests/test_packed_rollout.py); holding is carried as a
scalar (it only changes on pickup/drop and at most one slot is ever held).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.slots import HELD, ON_GRID, REMOVED, SlotState
from gym_craftingworld_tpu.core.step import StepResult
from gym_craftingworld_tpu.ops.transposed_rollout import (
    TSlotState,
    transpose_in,
    transpose_out,
)

i16 = jnp.int16

_BITS = np.arange(9, dtype=np.int16)


class PackedState(NamedTuple):
    """Transposed packed state: slot arrays int16[8, B], scalars int16[B]."""

    slot_key: jax.Array  # int16[8, B] — r*W+c | H*W (held) | H*W+1 (removed)
    slot_type: jax.Array  # int16[8, B]
    init_key: jax.Array  # int16[8, B] — reset cell of each slot (always on-grid)
    init_type: jax.Array  # int16[8, B]
    agent_r: jax.Array  # int16[B]
    agent_c: jax.Array  # int16[B]
    holding: jax.Array  # int16[B] — 0 none, 1..3 = sticks/axe/hammer
    obj_here: jax.Array  # int16[B] — object code at the agent's cell
    icode_here: jax.Array  # int16[B] — reset-cell code at the agent's cell
    achieved: jax.Array  # int16[B] — 9-bit task mask
    desired: jax.Array  # int16[B] — 9-bit task mask
    init_agent_key: jax.Array  # int16[B]
    step_num: jax.Array  # int16[B]


def pack(cfg: EnvConfig, ts: TSlotState) -> PackedState:
    if cfg.height * cfg.width + 1 > 32767:  # pragma: no cover
        raise ValueError("grid too large for the int16 packed engine")
    W = cfg.width
    held_key = cfg.height * W
    key = jnp.where(
        ts.slot_stat == ON_GRID,
        ts.slot_pos_r * W + ts.slot_pos_c,
        jnp.where(ts.slot_stat == HELD, held_key, held_key + 1),
    ).astype(i16)
    holding = jnp.sum((ts.slot_stat == HELD) * ts.slot_type, axis=0)
    init_key = (ts.init_pos_r * W + ts.init_pos_c).astype(i16)
    cur_key = (ts.agent_r * W + ts.agent_c).astype(i16)
    obj_here = jnp.sum((key == cur_key) * ts.slot_type, axis=0)
    icode_here = jnp.sum((init_key == cur_key) * ts.init_type, axis=0)
    to_mask = lambda v: jnp.sum(v.astype(i16) << _BITS[:, None], axis=0,
                                dtype=i16)
    c16 = lambda x: x.astype(i16)
    return PackedState(
        slot_key=key,
        slot_type=c16(ts.slot_type),
        init_key=init_key,
        init_type=c16(ts.init_type),
        agent_r=c16(ts.agent_r),
        agent_c=c16(ts.agent_c),
        holding=c16(holding),
        obj_here=c16(obj_here),
        icode_here=c16(icode_here),
        achieved=to_mask(ts.achieved),
        desired=to_mask(ts.desired),
        init_agent_key=(ts.init_agent_r * W + ts.init_agent_c).astype(i16),
        step_num=c16(ts.step_num),
    )


def unpack(cfg: EnvConfig, p: PackedState, desired_rows, init_rows) -> TSlotState:
    """Packed → transposed slot state.

    ``desired_rows``/``init_rows`` carry the original [9, B] desired rows and
    (init_pos_r, init_pos_c, init_type, init_agent_r, init_agent_c) — they are
    invariant through a rollout, so the caller passes them through.
    """
    W = cfg.width
    held_key = cfg.height * W
    key = p.slot_key.astype(jnp.int32)
    on = key < held_key
    held = key == held_key
    # strongly typed, so a rollout's output state feeds the next call
    # without a retrace
    stat = jnp.where(on, ON_GRID, jnp.where(held, HELD, REMOVED)).astype(
        jnp.int32)
    pos_r = jnp.where(on, key // W, 0)
    pos_c = jnp.where(on, key % W, 0)
    ach = p.achieved.astype(jnp.int32)
    achieved_rows = (ach[None, :] >> _BITS.astype(np.int32)[:, None]) & 1
    init_pos_r, init_pos_c, init_type, init_agent_r, init_agent_c = init_rows
    return TSlotState(
        slot_type=p.slot_type.astype(jnp.int32),
        slot_pos_r=pos_r,
        slot_pos_c=pos_c,
        slot_stat=stat,
        agent_r=p.agent_r.astype(jnp.int32),
        agent_c=p.agent_c.astype(jnp.int32),
        desired=desired_rows,
        achieved=achieved_rows,
        init_type=init_type,
        init_pos_r=init_pos_r,
        init_pos_c=init_pos_c,
        init_agent_r=init_agent_r,
        init_agent_c=init_agent_c,
        step_num=p.step_num.astype(jnp.int32),
    )


def _step_p(cfg: EnvConfig, s: PackedState, action: jax.Array, dtype=i16):
    """One batched step; ``action`` int[B]. Mirrors transposed_rollout._step_t.

    ``dtype`` selects the integer element type (all values fit in int16; the
    scan engine uses int16 to halve its carry traffic, while the GPU kernel
    passes int32, the width of a register). The algebra is
    dtype-independent, so results are bit-identical:
    every field is bounded (keys < H*W+2, codes < 16, masks 9 bits) and the
    step counter saturates at ``max_steps``, so no value ever exceeds int16
    range at any rollout length.
    """
    i16 = dtype  # shadows the module alias for every cast below
    W = i16(cfg.width)
    held_key = i16(cfg.height * cfg.width)
    one = i16(1)

    dr = (action == C.ACTION_DOWN).astype(i16) - (action == C.ACTION_UP).astype(i16)
    dc = (action == C.ACTION_RIGHT).astype(i16) - (action == C.ACTION_LEFT).astype(i16)
    is_move = action < C.ACTION_PICKUP  # [B]

    new_r = jnp.clip(s.agent_r + dr, 0, i16(cfg.height - 1))
    new_c = jnp.clip(s.agent_c + dc, 0, i16(cfg.width - 1))
    moved_pos = (new_r != s.agent_r) | (new_c != s.agent_c)

    cur_key = s.agent_r * W + s.agent_c  # [B]
    new_key = new_r * W + new_c  # [B]

    # ---- the one fused slot reduction: codes at the destination cell --------
    at_here = s.slot_key == cur_key  # [8, B] — needed for the pickup update
    at_there = s.slot_key == new_key
    at_init_there = (s.init_key == new_key).astype(i16)
    # unrolled 8-way tree add over the slot axis: bit-identical to
    # jnp.sum(axis=0), and the same add order as _step_p_unrolled
    v = at_there.astype(i16) * s.slot_type + (at_init_there * s.init_type << 4)
    codes = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]))
    obj_here = s.obj_here
    obj_there = codes & i16(15)
    icode_there = (codes >> 4) & i16(15)

    holding = s.holding
    blocked = ((obj_there == C.ROCK) & (holding != C.HOLD_HAMMER)) | (
        (obj_there == C.TREE) & (holding != C.HOLD_AXE)
    )
    move_ok = is_move & moved_pos & ~blocked

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

    # ---- crafting effects on the scalar code (craftingworld_ray.py:416-438) --
    eff = obj_there
    eff = jnp.where(obj_there == C.TREE, i16(C.STICKS), eff)
    eff = jnp.where((obj_there == C.STICKS) & (holding == C.HOLD_HAMMER),
                    i16(C.HOUSE), eff)
    eff = jnp.where((obj_there == C.WHEAT) & (holding == C.HOLD_AXE),
                    i16(C.BREAD), eff)
    removed = (obj_there == C.ROCK) | (obj_there == C.BREAD)

    # ---- slot updates (each a single predicated select over [8, B]) ---------
    hit = at_there & move_ok
    slot_type = jnp.where(hit, eff, s.slot_type)
    slot_key = jnp.where(hit & removed, held_key + one, s.slot_key)
    slot_key = jnp.where(can_pickup & at_here, held_key, slot_key)
    dropping = can_drop & (s.slot_key == held_key)
    slot_key = jnp.where(dropping, cur_key, slot_key)

    agent_r = jnp.where(move_ok, new_r, s.agent_r)
    agent_c = jnp.where(move_ok, new_c, s.agent_c)
    new_holding = jnp.where(can_pickup, obj_here,
                            jnp.where(can_drop, i16(C.HOLD_NONE), holding))

    # ---- task evaluation as bit algebra (craftingworld_ray.py:646-703) ------
    a = s.achieved
    eat = move_ok & (obj_there == C.BREAD)
    chop_rock = move_ok & (obj_there == C.ROCK)
    chop_tree = move_ok & (obj_there == C.TREE)
    make_bread = move_ok & (obj_there == C.WHEAT) & (holding == C.HOLD_AXE)
    build_house = move_ok & (obj_there == C.STICKS) & (holding == C.HOLD_HAMMER)

    b = lambda m: m.astype(i16)
    latched = a | (
        (b(make_bread) << C.T_MAKE_BREAD)
        | (b(eat) << C.T_EAT_BREAD)
        | (b(build_house) << C.T_BUILD_HOUSE)
        | (b(chop_tree) << C.T_CHOP_TREE)
        | (b(chop_rock) << C.T_CHOP_ROCK)
    )

    # GoToHouse: recomputed from the cell the agent ends the move on
    cell_final = jnp.where(move_ok, jnp.where(removed, i16(0), eff), obj_here)
    house = cell_final == C.HOUSE

    # Move{Axe,Hammer,Sticks}: carried item away from its reset cell
    icode = jnp.where(move_ok, icode_there, s.icode_here)
    final_key = jnp.where(move_ok, new_key, cur_key)
    marked = jnp.where((icode == 0) & (final_key == s.init_agent_key),
                       i16(C.AGENT_INIT_MARK), icode)
    a_ctree = ((latched >> C.T_CHOP_TREE) & one) == 1
    init_empty = marked == C.EMPTY
    ms = init_empty | ~((marked == C.STICKS) | ((marked == C.TREE) & a_ctree))
    ma = init_empty | (marked != C.AXE)
    mh = init_empty | (marked != C.HAMMER)

    hold_sticks = holding == C.HOLD_STICKS
    hold_axe = holding == C.HOLD_AXE
    hold_hammer = holding == C.HOLD_HAMMER

    clear = (
        i16(1 << C.T_GO_TO_HOUSE)
        | (b(hold_axe) << C.T_MOVE_AXE)
        | (b(hold_hammer) << C.T_MOVE_HAMMER)
        | (b(hold_sticks) << C.T_MOVE_STICKS)
    )
    setb = (
        (b(house) << C.T_GO_TO_HOUSE)
        | (b(hold_axe & ma) << C.T_MOVE_AXE)
        | (b(hold_hammer & mh) << C.T_MOVE_HAMMER)
        | (b(hold_sticks & ms) << C.T_MOVE_STICKS)
    )
    upd = (latched & ~clear) | setb
    achieved = jnp.where(is_move, upd, a)

    # carried here-codes: the agent's new cell is the move destination, or the
    # same cell with the object removed (pickup) / re-placed (drop)
    new_obj_here = jnp.where(
        move_ok, cell_final,
        jnp.where(can_pickup, i16(0),
                  jnp.where(can_drop, holding, obj_here)))
    new_icode_here = jnp.where(move_ok, icode_there, s.icode_here)

    changed = move_ok | can_pickup | can_drop
    if cfg.reward_equal:
        success = achieved == s.desired
    else:
        success = (s.desired & ~achieved) == 0
    reward = jnp.where(changed & success, i16(cfg.max_steps), i16(-1))
    # saturate at max_steps: done only needs the threshold, episodes always
    # reset at done, and saturation keeps arbitrarily long no-reset bench
    # rollouts safe in int16 (no wrap past 32767)
    step_num = jnp.minimum(s.step_num + one, i16(cfg.max_steps))
    done = (step_num >= cfg.max_steps) | (reward == cfg.max_steps)

    new_s = s._replace(
        slot_key=slot_key,
        slot_type=slot_type,
        agent_r=agent_r,
        agent_c=agent_c,
        holding=new_holding,
        obj_here=new_obj_here,
        icode_here=new_icode_here,
        achieved=achieved,
        step_num=step_num,
    )
    return new_s, StepResult(reward=reward.astype(jnp.int32), done=done,
                             changed=changed)


# --------------------------------------------------------------------------
# Slot-unrolled step: same algebra with the slot axis unrolled and each
# slot's statically-known transition structure applied.
#
# Slot k starts as object code k+1 (core/slots.py reset layout), and the
# effect table (craftingworld_ray.py:416-438) only ever transforms
# tree→sticks, sticks→house, wheat→bread and removes rock/bread. Hence:
#
#   slot 0 sticks  — type can change (→house); pickupable
#   slot 1 axe     — type constant; pickupable
#   slot 2 hammer  — type constant; pickupable
#   slot 3 rock    — type constant; removable only, never held
#   slot 4 tree    — type can change (→sticks→house); pickupable once sticks
#   slot 5 bread   — type constant; removable only
#   slot 6 house   — fully constant (never transforms, moves, or leaves)
#   slot 7 wheat   — type can change (→bread); removable once bread
#
# Skipping the statically-impossible updates is bit-identical to _step_p:
# every skipped select's predicate is provably false there (one-object-per-
# cell ⇒ a hit slot's type equals obj_there, so removal can only fire on
# slots that can be rock/bread, pickup/drop only on slots that can carry a
# pickupable type). Equivalence is pinned exhaustively in
# tests/test_packed_rollout.py::test_unrolled_step_bit_identical.
# --------------------------------------------------------------------------

_DYNTYPE_SLOTS = (0, 4, 7)  # sticks→house, tree→sticks→house, wheat→bread
_REMOVABLE_SLOTS = (3, 5, 7)  # rock, bread, wheat(→bread)
_PICKUP_SLOTS = (0, 1, 2, 4)  # sticks, axe, hammer, tree(→sticks)


def _step_p_unrolled(cfg: EnvConfig, s: PackedState, action: jax.Array,
                     dtype=i16):
    """Slot-unrolled `_step_p` (same signature, bit-identical results).

    ~30% fewer vector ops per step: the destination-cell reduction selects
    compile-time type constants for the 5 fixed-type slots, the init-code
    reduction uses per-slot constants with no pack/unpack shifts, and the
    slot-update selects run only on the slots whose class allows the update.

    The slot fields may also be tuples of 8 per-slot ``[B]`` rows; the new
    slot fields then come back as tuples too. The GPU kernel
    (ops/packed_fused.py) steps that form, since Triton can neither slice a
    register tensor nor stack rows into one.
    """
    i16 = dtype
    W = i16(cfg.width)
    held_key = i16(cfg.height * cfg.width)
    one = i16(1)

    dr = (action == C.ACTION_DOWN).astype(i16) - (action == C.ACTION_UP).astype(i16)
    dc = (action == C.ACTION_RIGHT).astype(i16) - (action == C.ACTION_LEFT).astype(i16)
    is_move = action < C.ACTION_PICKUP

    new_r = jnp.clip(s.agent_r + dr, 0, i16(cfg.height - 1))
    new_c = jnp.clip(s.agent_c + dc, 0, i16(cfg.width - 1))

    cur_key = s.agent_r * W + s.agent_c
    new_key = new_r * W + new_c
    # (row, col) ↔ key is a bijection, so one key compare replaces the
    # two-coordinate moved check
    moved_pos = new_key != cur_key

    key = [s.slot_key[i] for i in range(8)]
    typ = [s.slot_type[i] for i in range(8)]
    ikey = [s.init_key[i] for i in range(8)]

    # destination-cell codes: two separate 8-way tree adds (no 4-bit packing)
    at_there = [key[i] == new_key for i in range(8)]
    zero = i16(0)
    v = [
        jnp.where(at_there[i], typ[i] if i in _DYNTYPE_SLOTS else i16(i + 1),
                  zero)
        for i in range(8)
    ]
    obj_there = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]))
    iv = [jnp.where(ikey[i] == new_key, i16(i + 1), zero) for i in range(8)]
    icode_there = ((iv[0] + iv[1]) + (iv[2] + iv[3])) + (
        (iv[4] + iv[5]) + (iv[6] + iv[7])
    )

    obj_here = s.obj_here
    holding = s.holding
    blocked = ((obj_there == C.ROCK) & (holding != C.HOLD_HAMMER)) | (
        (obj_there == C.TREE) & (holding != C.HOLD_AXE)
    )
    move_ok = is_move & moved_pos & ~blocked

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

    # crafting effects on the scalar code (craftingworld_ray.py:416-438)
    eff = obj_there
    eff = jnp.where(obj_there == C.TREE, i16(C.STICKS), eff)
    eff = jnp.where((obj_there == C.STICKS) & (holding == C.HOLD_HAMMER),
                    i16(C.HOUSE), eff)
    eff = jnp.where((obj_there == C.WHEAT) & (holding == C.HOLD_AXE),
                    i16(C.BREAD), eff)
    removed = (obj_there == C.ROCK) | (obj_there == C.BREAD)

    # slot updates, restricted to each slot's statically-possible transitions
    new_typ = list(typ)
    new_keys = list(key)
    for i in _DYNTYPE_SLOTS:
        new_typ[i] = jnp.where(at_there[i] & move_ok, eff, typ[i])
    for i in _REMOVABLE_SLOTS:
        new_keys[i] = jnp.where(at_there[i] & move_ok & removed,
                                held_key + one, key[i])
    for i in _PICKUP_SLOTS:
        new_keys[i] = jnp.where(can_pickup & (key[i] == cur_key), held_key,
                                new_keys[i])
        new_keys[i] = jnp.where(can_drop & (key[i] == held_key), cur_key,
                                new_keys[i])

    agent_r = jnp.where(move_ok, new_r, s.agent_r)
    agent_c = jnp.where(move_ok, new_c, s.agent_c)
    new_holding = jnp.where(can_pickup, obj_here,
                            jnp.where(can_drop, i16(C.HOLD_NONE), holding))

    # task evaluation as bit algebra (identical to _step_p)
    a = s.achieved
    eat = move_ok & (obj_there == C.BREAD)
    chop_rock = move_ok & (obj_there == C.ROCK)
    chop_tree = move_ok & (obj_there == C.TREE)
    make_bread = move_ok & (obj_there == C.WHEAT) & (holding == C.HOLD_AXE)
    build_house = move_ok & (obj_there == C.STICKS) & (holding == C.HOLD_HAMMER)

    b = lambda m: m.astype(i16)
    latched = a | (
        (b(make_bread) << C.T_MAKE_BREAD)
        | (b(eat) << C.T_EAT_BREAD)
        | (b(build_house) << C.T_BUILD_HOUSE)
        | (b(chop_tree) << C.T_CHOP_TREE)
        | (b(chop_rock) << C.T_CHOP_ROCK)
    )

    cell_final = jnp.where(move_ok, jnp.where(removed, i16(0), eff), obj_here)
    house = cell_final == C.HOUSE

    icode = jnp.where(move_ok, icode_there, s.icode_here)
    final_key = jnp.where(move_ok, new_key, cur_key)
    marked = jnp.where((icode == 0) & (final_key == s.init_agent_key),
                       i16(C.AGENT_INIT_MARK), icode)
    a_ctree = ((latched >> C.T_CHOP_TREE) & one) == 1
    init_empty = marked == C.EMPTY
    ms = init_empty | ~((marked == C.STICKS) | ((marked == C.TREE) & a_ctree))
    ma = init_empty | (marked != C.AXE)
    mh = init_empty | (marked != C.HAMMER)

    hold_sticks = holding == C.HOLD_STICKS
    hold_axe = holding == C.HOLD_AXE
    hold_hammer = holding == C.HOLD_HAMMER

    clear = (
        i16(1 << C.T_GO_TO_HOUSE)
        | (b(hold_axe) << C.T_MOVE_AXE)
        | (b(hold_hammer) << C.T_MOVE_HAMMER)
        | (b(hold_sticks) << C.T_MOVE_STICKS)
    )
    setb = (
        (b(house) << C.T_GO_TO_HOUSE)
        | (b(hold_axe & ma) << C.T_MOVE_AXE)
        | (b(hold_hammer & mh) << C.T_MOVE_HAMMER)
        | (b(hold_sticks & ms) << C.T_MOVE_STICKS)
    )
    upd = (latched & ~clear) | setb
    achieved = jnp.where(is_move, upd, a)

    new_obj_here = jnp.where(
        move_ok, cell_final,
        jnp.where(can_pickup, i16(0),
                  jnp.where(can_drop, holding, obj_here)))
    new_icode_here = jnp.where(move_ok, icode_there, s.icode_here)

    changed = move_ok | can_pickup | can_drop
    if cfg.reward_equal:
        success = achieved == s.desired
    else:
        success = (s.desired & ~achieved) == 0
    reward = jnp.where(changed & success, i16(cfg.max_steps), i16(-1))
    step_num = jnp.minimum(s.step_num + one, i16(cfg.max_steps))
    done = (step_num >= cfg.max_steps) | (reward == cfg.max_steps)

    rows = tuple if isinstance(s.slot_key, tuple) else jnp.stack
    new_s = s._replace(
        slot_key=rows(new_keys),
        slot_type=rows(new_typ),
        agent_r=agent_r,
        agent_c=agent_c,
        holding=new_holding,
        obj_here=new_obj_here,
        icode_here=new_icode_here,
        achieved=achieved,
        step_num=step_num,
    )
    return new_s, StepResult(reward=reward.astype(jnp.int32), done=done,
                             changed=changed)


@partial(jax.jit, static_argnums=(0, 3))
def rollout_p(cfg: EnvConfig, slots: SlotState, actions, num_steps: int):
    """Step ``actions`` int[T, B] through the packed engine; SlotState I/O."""
    del num_steps
    ts = transpose_in(slots)
    p = pack(cfg, ts)
    init_rows = (ts.init_pos_r, ts.init_pos_c, ts.init_type,
                 ts.init_agent_r, ts.init_agent_c)

    def body(carry, action_t):
        st, res = _step_p(cfg, carry, action_t)
        return st, res

    p, out = jax.lax.scan(body, p, actions.astype(i16))
    return transpose_out(unpack(cfg, p, ts.desired, init_rows), slots.rng), out


@partial(jax.jit, static_argnums=(0, 3))
def rollout_p_random(cfg: EnvConfig, slots: SlotState, key, num_steps: int):
    """T uniform-random-action steps in the packed engine; full outputs."""
    B = slots.agent.shape[0]
    actions = jax.random.randint(key, (num_steps, B), 0, 6, dtype=jnp.int16)
    return rollout_p(cfg, slots, actions, num_steps)


@partial(jax.jit, static_argnums=(0, 3))
def rollout_p_bench(cfg: EnvConfig, slots: SlotState, key, num_steps: int):
    """Bench driver: T random steps, returning only (state, total reward).

    Skipping the [T, B] per-step outputs keeps HBM writes out of the loop so
    the measurement is pure stepping throughput; the reward checksum still
    depends on every step of every env, so nothing can be dead-code-eliminated.
    """
    B = slots.agent.shape[0]
    ts = transpose_in(slots)
    p = pack(cfg, ts)
    init_rows = (ts.init_pos_r, ts.init_pos_c, ts.init_type,
                 ts.init_agent_r, ts.init_agent_c)
    actions = jax.random.randint(key, (num_steps, B), 0, 6, dtype=jnp.int16)

    def body(carry, action_t):
        st, acc = carry
        st, res = _step_p(cfg, st, action_t)
        return (st, acc + jnp.sum(res.reward)), None

    (p, acc), _ = jax.lax.scan(body, (p, jnp.zeros((), jnp.int32)), actions)
    state = transpose_out(unpack(cfg, p, ts.desired, init_rows), slots.rng)
    return state, acc
