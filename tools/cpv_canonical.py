"""CPV compositional matrix at CANONICAL scale: 21x21, all pairs AND triples.

The round-4 CPV measurement ran on an 8x8 toy world with 32-episode cells and
6 of 84 triples (docs/cpv_matrix.json history). This tool runs the same
protocol — train on SINGLE-task expert data only, measure zero-shot stacked
execution — at the reference's canonical setting (21x21, max_steps 300,
craftingworld_ray.py:43-46), over every unordered pair (36) and every triple
(84), with one episode per fixed-pool world per cell (256 worlds → 256
deterministic-argmax episodes per cell; a 16-world pool cannot support a
256-episode claim — under argmax there are only |pool| distinct outcomes).

Protocol (unchanged from the 8x8 tool, see tools/cpv_matrix.py):
  * fixed world pool shared between training and evaluation (paper-style
    fixed env set; the train/test novelty is the task COMPOSITION);
  * training data = single-task episodes + "handoff" episodes (one task
    executed from a world whose lower-rank predecessors are pre-applied,
    agent position/held-tool randomized to cover real handoff states) +
    pending-bit relabels + on-policy DAgger over the same single-task
    handoff episodes (policy actions, expert labels);
  * no trajectory ever completes more than one task — the composition
    itself is never demonstrated.

Model: models/cpv.CPVGridPolicy — conv torso over world planes, goal
conditioning ONLY through the residual plan vector (desired - achieved) @ E,
the Plan-Arithmetic construction (reference README.md:8).

Run phases (device process; expert labeling is host-side):
    python tools/cpv_canonical.py            # full pipeline → docs/cpv_matrix.json
    python tools/cpv_canonical.py --smoke    # tiny CPU-friendly end-to-end check
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from gym_craftingworld_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()

import jax.numpy as jnp  # noqa: E402

from gym_craftingworld_tpu import constants as C  # noqa: E402
from gym_craftingworld_tpu.config import EnvConfig  # noqa: E402
from gym_craftingworld_tpu.core.reset import generate_pool  # noqa: E402
from gym_craftingworld_tpu.core.state import EnvState  # noqa: E402
from gym_craftingworld_tpu.core.step import step as core_step  # noqa: E402
from gym_craftingworld_tpu.core.step import _step_one  # noqa: E402
from gym_craftingworld_tpu.models.cpv import init_cpv_grid  # noqa: E402
from gym_craftingworld_tpu.models.grid_policy import (  # noqa: E402
    planes_from_state,
    snap_columns_from_state,
)
from gym_craftingworld_tpu.train import dagger  # noqa: E402
from gym_craftingworld_tpu.train.demos import (  # noqa: E402
    NumpyExpert,
    SnapDataset,
    bits_to_mask,
    init_keys_from_grids,
    label_snapshot,
    occupancy_from_grids,
)

# expert execution order (agents/expert._TASK_ORDER): predecessors are
# always lower-rank, so handoff states match the order a stacked run visits
_ORDER = [
    C.T_MAKE_BREAD, C.T_EAT_BREAD, C.T_CHOP_ROCK, C.T_CHOP_TREE,
    C.T_MOVE_STICKS, C.T_BUILD_HOUSE, C.T_MOVE_AXE, C.T_MOVE_HAMMER,
    C.T_GO_TO_HOUSE,
]
_RANK = {t: i for i, t in enumerate(_ORDER)}

_EFFECT = {  # task → (consumed object, produced object); world edit of the
    # crafting effect table (craftingworld_ray.py:416-438)
    C.T_MAKE_BREAD: (C.WHEAT, C.BREAD),
    C.T_EAT_BREAD: (C.BREAD, C.EMPTY),
    C.T_BUILD_HOUSE: (C.STICKS, C.HOUSE),
    C.T_CHOP_TREE: (C.TREE, C.STICKS),
    C.T_CHOP_ROCK: (C.ROCK, C.EMPTY),
}
_MOVE_ITEM = {C.T_MOVE_AXE: C.AXE, C.T_MOVE_HAMMER: C.HAMMER,
              C.T_MOVE_STICKS: C.STICKS}
_TOOL_OF = {C.T_MAKE_BREAD: C.AXE, C.T_CHOP_TREE: C.AXE,
            C.T_CHOP_ROCK: C.HAMMER, C.T_BUILD_HOUSE: C.HAMMER,
            **_MOVE_ITEM}
_MOVE_BIT = {C.STICKS: C.T_MOVE_STICKS, C.AXE: C.T_MOVE_AXE,
             C.HAMMER: C.T_MOVE_HAMMER}
_DELTAS = C.ACTION_DELTAS[:4]

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "cpv_matrix.json")


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# start states: pool worlds + optional pre-applied predecessors
# ---------------------------------------------------------------------------


def make_pool(cfg: EnvConfig, seed: int, n: int):
    objects, agent = generate_pool(cfg, jax.random.PRNGKey(seed), n)
    return np.asarray(objects), np.asarray(agent)


def apply_predecessors_np(objects, achieved, agent, holding, S, rng):
    """In-place world edit putting ``objects`` into the post-S handoff state.

    Mirrors tools/cpv_matrix.apply_predecessors on bare numpy arrays: each
    completed predecessor's world effect is applied to the LIVE grid (never
    to the init grid, which the runtime Move* evaluation still compares
    against — craftingworld_ray.py:670-702); its achieved bit is set; the
    most recent tool task leaves its tool in hand 70% of the time (success
    fires mid-carry, :361-367) which keeps that tool's Move* bit latched;
    the agent relocates to a random empty cell half the time (real handoffs
    end wherever the previous task finished). Returns False if an effect's
    source object is missing (cannot happen from a fresh pool world with
    rank-ordered S, but guarded anyway).
    """
    for i in S:
        if i in _EFFECT:
            src, dst = _EFFECT[i]
            hits = np.argwhere(objects == src)
            if not len(hits):
                return False, agent, holding
            objects[tuple(hits[rng.randint(len(hits))])] = dst
        else:  # Move*: relocate the item to a random empty cell
            item = _MOVE_ITEM[i]
            hits = np.argwhere(objects == item)
            empties = np.argwhere(objects == C.EMPTY)
            if not len(hits) or not len(empties):
                return False, agent, holding
            objects[tuple(hits[rng.randint(len(hits))])] = C.EMPTY
            objects[tuple(empties[rng.randint(len(empties))])] = item
        achieved[i] = 1
    if rng.rand() < 0.5:
        empties = np.argwhere(objects == C.EMPTY)
        if len(empties):
            r, c = empties[rng.randint(len(empties))]
            agent = (int(r), int(c))
    if S:
        tool = _TOOL_OF.get(S[-1])
        if tool is not None and rng.rand() < 0.7:
            hits = np.argwhere(objects == tool)
            if len(hits):
                objects[tuple(hits[rng.randint(len(hits))])] = C.EMPTY
                holding = tool  # object codes 1..3 == holding codes
                achieved[_MOVE_BIT[tool]] = 1
    return True, agent, holding


def build_start_states(cfg: EnvConfig, pool_objects, pool_agent, widx,
                       pending, preds, rng):
    """Host-built EnvState batch: world widx[b], desired = preds[b]∪{pending[b]},
    achieved = preds[b] bits, predecessors pre-applied. ``preds[b]`` is a
    rank-sorted list (possibly empty). Returns (EnvState, task per env)."""
    B = len(widx)
    H, W = cfg.height, cfg.width
    objects = pool_objects[widx].copy()  # int8[B, H, W]
    agents = pool_agent[widx].copy()  # int32[B, 2]
    holding = np.zeros(B, np.int32)
    desired = np.zeros((B, C.N_TASKS), np.int8)
    achieved = np.zeros((B, C.N_TASKS), np.int8)
    init_objects = objects.copy()
    for b in range(B):
        r, c = agents[b]
        init_objects[b, r, c] = C.AGENT_INIT_MARK
        ok, ag, hold = apply_predecessors_np(
            objects[b], achieved[b], (int(r), int(c)), 0, preds[b], rng
        )
        assert ok, (widx[b], preds[b])
        agents[b] = ag
        holding[b] = hold
        desired[b, list(preds[b]) + [int(pending[b])]] = 1
    return EnvState(
        objects=jnp.asarray(objects),
        agent=jnp.asarray(agents, jnp.int32),
        holding=jnp.asarray(holding, jnp.int32),
        desired=jnp.asarray(desired),
        achieved=jnp.asarray(achieved),
        init_objects=jnp.asarray(init_objects),
        init_agent=jnp.asarray(pool_agent[widx], jnp.int32),
        goal_objects=jnp.asarray(init_objects),
        goal_agent=jnp.asarray(agents, jnp.int32),
        step_num=jnp.zeros(B, jnp.int32),
        rng=jax.random.key_data(
            jax.random.split(jax.random.PRNGKey(int(rng.randint(2**31))), B)
        ),
    ), np.asarray(pending, np.int32)


def draw_handoff_batch(cfg, pool_objects, pool_agent, B, rng, max_preds=2,
                       task_weights=None):
    """Random (world, pending task, rank-lower predecessor set) batch.

    Predecessors are drawn uniformly half the time and from the ADJACENT
    lower ranks half the time: the hard compositions are exactly
    adjacent-rank pairs (GoToHouse with the tool-Move tasks just below it,
    EatBread with MakeBread) because their handoff states involve mid-carry
    non-latching bits — uniform pred draws under-sample them 7:1.
    """
    P = len(pool_objects)
    widx = rng.randint(P, size=B)
    if task_weights is None:
        pending = rng.randint(C.N_TASKS, size=B)
    else:
        pending = rng.choice(C.N_TASKS, size=B, p=task_weights)
    preds = []
    for b in range(B):
        lower = [t for t in range(C.N_TASKS) if _RANK[t] < _RANK[pending[b]]]
        lower.sort(key=lambda t: _RANK[t])
        k = rng.randint(0, min(max_preds, len(lower)) + 1)
        if k and rng.rand() < 0.5:
            S = lower[-k:]  # the k adjacent lower ranks
        else:
            S = rng.choice(lower, k, replace=False).tolist() if k else []
        preds.append(sorted(S, key=lambda t: _RANK[t]))
    return build_start_states(cfg, pool_objects, pool_agent, widx, pending,
                              preds, rng)


# ---------------------------------------------------------------------------
# lockstep expert collection from given start states
# ---------------------------------------------------------------------------


def collect_expert_from(cfg: EnvConfig, state: EnvState, tasks, seed,
                        noise_eps=0.05, only_successful=True):
    """Expert episodes from a prepared start-state batch → (SnapDataset, task
    per row). One batched core_step dispatch per lockstep step; expert labels
    per live env on the host (train/demos.collect_expert_demos pattern)."""
    B = state.objects.shape[0]
    wrng = np.random.RandomState(seed ^ 0x5EED)
    experts = [NumpyExpert() for _ in range(B)]
    init_flat = np.asarray(state.init_objects).reshape(B, -1)
    init_key, init_agent_key = init_keys_from_grids(init_flat)
    desired_bits = np.asarray(state.desired)
    desired_mask = bits_to_mask(desired_bits)
    init_objects_np = [np.asarray(state.init_objects[b]) for b in range(B)]

    done = np.zeros(B, bool)
    success = np.zeros(B, bool)
    rec = {k: [] for k in ("occ_key", "occ_code", "agent_key", "holding",
                           "achieved", "action", "live")}
    for _t in range(cfg.max_steps):
        objects = np.asarray(state.objects)
        agent = np.asarray(state.agent)
        holding = np.asarray(state.holding)
        achieved_bits = np.asarray(state.achieved)
        flat = objects.reshape(B, -1)
        occ_key, occ_code = occupancy_from_grids(flat, cfg.n_cells)
        agent_key = (agent[:, 0] * cfg.width + agent[:, 1]).astype(np.int16)

        actions = np.zeros(B, np.int32)
        labels = np.zeros(B, np.int8)
        for b in np.nonzero(~done)[0]:
            lab = label_snapshot(
                experts[b], objects[b], agent[b], holding[b],
                init_objects_np[b], desired_bits[b], achieved_bits[b],
            )
            labels[b] = lab
            actions[b] = lab
            if noise_eps and wrng.rand() < noise_eps:
                d = wrng.randint(4)
                nr = min(max(agent[b, 0] + _DELTAS[d, 0], 0), cfg.height - 1)
                nc = min(max(agent[b, 1] + _DELTAS[d, 1], 0), cfg.width - 1)
                if (nr, nc) != (agent[b, 0], agent[b, 1]) and objects[
                    b, nr, nc
                ] == C.EMPTY:
                    actions[b] = d

        rec["occ_key"].append(occ_key)
        rec["occ_code"].append(occ_code)
        rec["agent_key"].append(agent_key)
        rec["holding"].append(holding.astype(np.int8))
        rec["achieved"].append(bits_to_mask(achieved_bits))
        rec["action"].append(labels)
        rec["live"].append(~done)

        state, res = core_step(cfg, state, jnp.asarray(actions))
        res_done = np.asarray(res.done)
        res_rew = np.asarray(res.reward)
        newly = res_done & ~done
        success |= newly & (res_rew == cfg.max_steps)
        done |= res_done
        if done.all():
            break

    live = np.stack(rec["live"])  # [T, B]
    keep_env = success if only_successful else np.ones(B, bool)
    sel = live & keep_env[None, :]
    ep_ids = np.cumsum(keep_env) - 1
    take = lambda k: np.concatenate(
        [rec[k][t][sel[t]] for t in range(sel.shape[0])]
    )
    t_idx, b_idx = np.nonzero(sel)
    snaps = SnapDataset(
        occ_key=take("occ_key"),
        occ_code=take("occ_code"),
        init_key=init_key[b_idx],
        init_agent_key=init_agent_key[b_idx],
        agent_key=take("agent_key"),
        holding=take("holding"),
        desired=desired_mask[b_idx],
        achieved=take("achieved"),
        action=take("action"),
        episode=ep_ids[b_idx].astype(np.int32),
    )
    return snaps, np.asarray(tasks)[b_idx], float(success.mean())


def augment_pending(snaps: SnapDataset, tasks, seed):
    """Row copies with 1-2 HIGHER-rank pending bits added to desired —
    the relabel for 'act on the current task while later tasks are pending'
    (latching semantics make the expert's action independent of pending
    bits; Move-origin avoidance is conservative either way). Half the rows
    take the ADJACENT higher ranks (the under-sampled hard compositions —
    see draw_handoff_batch), half draw uniformly."""
    rng = np.random.RandomState(seed)
    desired = snaps.desired.copy().astype(np.int64)
    keep = np.zeros(len(tasks), bool)
    for r, j in enumerate(tasks):
        higher = [t for t in range(C.N_TASKS)
                  if _RANK[t] > _RANK[j] and not (desired[r] >> t) & 1]
        if not higher:
            continue
        higher.sort(key=lambda t: _RANK[t])
        k = 1 + rng.randint(min(2, len(higher)))
        if rng.rand() < 0.5:
            chosen = higher[:k]  # the k adjacent higher ranks
        else:
            chosen = rng.choice(higher, k, replace=False)
        for t in chosen:
            desired[r] |= 1 << int(t)
        keep[r] = True
    out = snaps._replace(desired=desired.astype(snaps.desired.dtype))
    return SnapDataset(*[np.asarray(col)[keep] for col in out])


# ---------------------------------------------------------------------------
# on-policy rollouts from given start states (DAgger + evaluation)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1, 5))
def _rollout_from(cfg: EnvConfig, model, params, state: EnvState, key,
                  mode: str):
    """Roll the policy from ``state``; returns (cols [T,B], live, success).

    mode: 'argmax' greedy, 'sample' softmax draws (BC from a multi-modal
    expert leaves near-ties whose argmax can limit-cycle; both are
    measured), 'argmax_eps' greedy + 5% random moves — the DAgger driver:
    greedy execution visits exactly the limit-cycle orbit states the argmax
    evaluation fails on, and the eps moves kick the rollout off the orbit so
    later frames sample the surrounding basin too.
    """
    B = state.objects.shape[0]
    T = cfg.max_steps

    def body(carry, k_t):
        st, done, reward = carry
        cols = snap_columns_from_state(cfg, st)
        planes, extras = planes_from_state(cfg, st)
        logits, _ = model.apply(params, planes, extras)
        if mode == "sample":
            action = jax.random.categorical(k_t, logits, axis=-1).astype(
                jnp.int32)
        else:
            action = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        if mode == "argmax_eps":
            k_u, k_a = jax.random.split(jax.random.fold_in(k_t, 1))
            rnd = jax.random.randint(k_a, (B,), 0, 4)
            action = jnp.where(
                jax.random.uniform(k_u, (B,)) < 0.05, rnd, action)
        st2, res = jax.vmap(partial(_step_one, cfg))(st, action)
        st2 = jax.tree.map(
            lambda new, old: jnp.where(
                done.reshape((-1,) + (1,) * (new.ndim - 1)), old, new
            ),
            st2, st,
        )
        reward = jnp.where(done, reward, res.reward)
        live = ~done
        done = done | res.done
        return (st2, done, reward), (cols, live)

    (state, done, reward), (cols, live) = jax.lax.scan(
        body, (state, jnp.zeros(B, bool), jnp.full(B, -1, jnp.int32)),
        jax.random.split(key, T),
    )
    return cols, live, reward == cfg.max_steps


@partial(jax.jit, static_argnums=(0, 1, 5))
def _success_from(cfg: EnvConfig, model, params, state: EnvState, key,
                  mode: str):
    """Evaluation-only rollout (no snapshot recording, early exit)."""
    B = state.objects.shape[0]

    def body(carry):
        st, done, reward, k = carry
        k, k_t = jax.random.split(k)
        planes, extras = planes_from_state(cfg, st)
        logits, _ = model.apply(params, planes, extras)
        if mode == "sample":
            action = jax.random.categorical(k_t, logits, axis=-1).astype(
                jnp.int32)
        else:
            action = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        st2, res = jax.vmap(partial(_step_one, cfg))(st, action)
        st2 = jax.tree.map(
            lambda new, old: jnp.where(
                done.reshape((-1,) + (1,) * (new.ndim - 1)), old, new
            ),
            st2, st,
        )
        reward = jnp.where(done, reward, res.reward)
        done = done | res.done
        return st2, done, reward, k

    state, done, reward, _ = jax.lax.while_loop(
        lambda c: ~jnp.all(c[1]), body,
        (state, jnp.zeros(B, bool), jnp.full(B, -1, jnp.int32), key),
    )
    return reward == cfg.max_steps, state.achieved


def dagger_collect(cfg, model, params, state, tasks, seed,
                   mode="argmax_eps"):
    """Policy rollout from handoff starts; expert labels on all salvageable
    live states (train/dagger.collect_policy_states semantics, custom
    starts). Returns (SnapDataset labeled, task per row, success rate)."""
    cols, live, success = _rollout_from(
        cfg, model, params, state, jax.random.PRNGKey(seed), mode
    )
    live = np.asarray(live)
    ach = np.asarray(cols["achieved"]).astype(np.int64)
    des = np.asarray(cols["desired"]).astype(np.int64)
    salvageable = (ach & ~des & dagger._LATCH_MASK) == 0
    sel = (live & salvageable).reshape(-1)
    host = {k: np.asarray(v).reshape((-1,) + v.shape[2:])[sel]
            for k, v in cols.items()}
    task_rows = np.broadcast_to(
        np.asarray(tasks)[None, :], live.shape
    ).reshape(-1)[sel]
    labeled = dagger.expert_relabel(cfg, host)
    return labeled, task_rows, float(np.asarray(success).mean())


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------


def eval_cell(cfg, model, params, pool_objects, pool_agent, task_set, seed,
              episodes):
    """One episode per pool world (cycled if episodes > pool), desired =
    exactly the cell's task bits, fresh start. Returns (argmax, sampled)."""
    P = len(pool_objects)
    widx = np.arange(episodes) % P
    rng = np.random.RandomState(seed)
    pending = [max(task_set, key=lambda t: _RANK[t])] * episodes
    preds = [[]] * episodes
    state, _ = build_start_states(cfg, pool_objects, pool_agent, widx,
                                  pending, preds, rng)
    # desired = the full cell mask (exactly these bits, achieved = 0)
    des = np.zeros((episodes, C.N_TASKS), np.int8)
    des[:, list(task_set)] = 1
    state = state.replace(desired=jnp.asarray(des))
    out = {}
    for mode in ("argmax", "sample"):
        succ, _ = _success_from(cfg, model, params, state,
                                jax.random.PRNGKey(seed + 17), mode)
        out[mode] = float(np.asarray(succ).mean())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--singles-per-task", type=int, default=512)
    ap.add_argument("--handoff-episodes", type=int, default=4096)
    ap.add_argument("--bc-epochs", type=int, default=16)
    ap.add_argument("--dagger-rounds", type=int, default=12)
    ap.add_argument("--dagger-episodes", type=int, default=3072)
    ap.add_argument("--dagger-epochs", type=int, default=3)
    ap.add_argument("--cell-episodes", type=int, default=256)
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU end-to-end check")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--save-params", default="runs/cpv_canonical")
    args = ap.parse_args()

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
        args = ap.parse_args([
            "--smoke", "--pool", "8", "--singles-per-task", "2",
            "--handoff-episodes", "8", "--bc-epochs", "1",
            "--dagger-rounds", "1", "--dagger-episodes", "4",
            "--dagger-epochs", "1", "--cell-episodes", "4",
            "--channels", "8", "--hidden", "32", "--batch", "64",
            "--out", "/tmp/cpv_smoke.json", "--save-params", "/tmp/cpv_smoke",
        ])
        cfg = EnvConfig(height=8, width=8, max_steps=60)
    else:
        from gym_craftingworld_tpu import ray_config

        cfg = ray_config()

    names = list(C.TASK_LIST)
    rng = np.random.RandomState(args.seed)
    pool_objects, pool_agent = make_pool(cfg, args.seed, args.pool)
    log(f"pool: {args.pool} worlds at {cfg.height}x{cfg.width}")

    # ---- phase 1: expert data (singles + handoffs) -------------------------
    cache = (os.path.join(args.save_params, "phase1.npz")
             if args.save_params else None)
    if cache and os.path.exists(cache) and not args.smoke:
        z = np.load(cache)
        data = SnapDataset(**{f: z[f] for f in SnapDataset._fields})
        tasks_all = z["tasks"]
        log(f"phase-1 data loaded from {cache}: {data.num_rows} rows")
        aug = augment_pending(data, tasks_all, args.seed + 999)
        data = SnapDataset.concat(data, aug)
        log(f"dataset: {data.num_rows} rows incl. {aug.num_rows} relabels")
        t0 = time.time()
        parts = None
    else:
        parts = []
    t0 = time.time()
    part_tasks = []
    for j in (range(C.N_TASKS) if parts is not None else ()):
        B = args.singles_per_task
        widx = np.arange(B) % args.pool
        state, tasks = build_start_states(
            cfg, pool_objects, pool_agent, widx, [j] * B, [[]] * B, rng)
        snaps, trows, sr = collect_expert_from(
            cfg, state, tasks, args.seed + j, noise_eps=0.05)
        parts.append(snaps)
        part_tasks.append(trows)
        log(f"singles[{names[j]}]: {snaps.num_episodes} eps "
            f"({snaps.num_rows} rows, expert sr {sr:.3f})")
    chunk = 512
    done_eps = 0
    while parts is not None and done_eps < args.handoff_episodes:
        B = min(chunk, args.handoff_episodes - done_eps)
        state, tasks = draw_handoff_batch(
            cfg, pool_objects, pool_agent, B, rng)
        snaps, trows, sr = collect_expert_from(
            cfg, state, tasks, args.seed + 100 + done_eps, noise_eps=0.05)
        parts.append(snaps)
        part_tasks.append(trows)
        done_eps += B
        log(f"handoff {done_eps}/{args.handoff_episodes}: +{snaps.num_rows} "
            f"rows (expert sr {sr:.3f})")
    if parts is not None:
        data = SnapDataset.concat(*parts)
        tasks_all = np.concatenate(part_tasks)
        if cache and not args.smoke:
            os.makedirs(args.save_params, exist_ok=True)
            np.savez(cache, tasks=tasks_all,
                     **{f: getattr(data, f) for f in SnapDataset._fields})
            log(f"phase-1 data cached → {cache}")
        aug = augment_pending(data, tasks_all, args.seed + 999)
        data = SnapDataset.concat(data, aug)
        log(f"dataset: {data.num_rows} rows (incl. {aug.num_rows} pending "
            f"relabels) in {time.time() - t0:.0f}s")

    # ---- phase 2: BC -------------------------------------------------------
    model, params = init_cpv_grid(jax.random.PRNGKey(args.seed + 1), cfg,
                                  channels=args.channels, hidden=args.hidden)
    ts = dagger.BCTrainState(params, dagger._make_tx(1e-3).init(params))
    model, ts, _ = dagger.bc_train_snaps(
        cfg, data, jax.random.PRNGKey(args.seed + 2),
        model_and_state=(model, ts), epochs=args.bc_epochs,
        batch_size=args.batch, lr=1e-3, log=log)

    # ---- phase 3: DAgger over handoff starts -------------------------------
    for r in range(args.dagger_rounds):
        t0 = time.time()
        # weight pending-task draws toward the non-latching / resource-
        # conflict tasks where limit cycles concentrate
        w = np.ones(C.N_TASKS)
        for t in (C.T_BUILD_HOUSE, C.T_MOVE_AXE,
                  C.T_MOVE_HAMMER, C.T_MOVE_STICKS):
            w[t] = 3.0
        w[C.T_GO_TO_HOUSE] = 5.0  # the weak-cell common factor
        w[C.T_EAT_BREAD] = 2.0  # MakeBread+EatBread adjacency
        state, tasks = draw_handoff_batch(
            cfg, pool_objects, pool_agent, args.dagger_episodes, rng,
            task_weights=w / w.sum())
        # alternate drivers: greedy+eps rounds correct the argmax limit
        # cycles; sampled rounds cover the softmax execution's distribution
        mode = "argmax_eps" if r % 2 == 0 else "sample"
        labeled, trows, sr = dagger_collect(
            cfg, model, ts.params, state, tasks, args.seed + 300 + r,
            mode=mode)
        aug = augment_pending(labeled, trows, args.seed + 600 + r)
        data = SnapDataset.concat(data, labeled, aug)
        log(f"dagger {r} [{mode}]: policy sr {sr:.3f}, "
            f"+{labeled.num_rows} rows (+{aug.num_rows} relabels) → "
            f"{data.num_rows} ({time.time() - t0:.0f}s)")
        lr = 5e-4 if r < args.dagger_rounds // 2 else 3e-4
        model, ts, _ = dagger.bc_train_snaps(
            cfg, data, jax.random.PRNGKey(args.seed + 400 + r),
            model_and_state=(model, ts), epochs=args.dagger_epochs,
            batch_size=args.batch, lr=lr, log=log)

    if args.save_params:
        os.makedirs(args.save_params, exist_ok=True)
        with open(os.path.join(args.save_params, "params.npz"), "wb") as f:
            flat, _ = jax.tree_util.tree_flatten_with_path(ts.params)
            np.savez(f, **{jax.tree_util.keystr(k): np.asarray(v)
                           for k, v in flat})

    # ---- phase 4: the matrix ----------------------------------------------
    results = {
        "config": {
            "grid": f"{cfg.height}x{cfg.width}", "max_steps": cfg.max_steps,
            "world_pool": args.pool, "cell_episodes": args.cell_episodes,
            "singles_per_task": args.singles_per_task,
            "handoff_episodes": args.handoff_episodes,
            "dagger_rounds": args.dagger_rounds,
            "dagger_episodes": args.dagger_episodes,
            "model": f"CPVGridPolicy(channels={args.channels}, "
                     f"hidden={args.hidden}) — goal via residual plan "
                     f"vector only",
            "protocol": (
                "fixed world pool shared between training and evaluation "
                "(paper-style fixed env set); evaluation rolls one episode "
                "per pool world per cell with desired = exactly the cell's "
                "task bits. Training data = single-task expert episodes + "
                "handoff episodes (one task executed from a world whose "
                "lower-rank predecessors are pre-applied; agent position / "
                "held tool randomized) + pending-bit relabels + on-policy "
                "DAgger over the same single-task handoff episodes (policy "
                "actions, expert labels); no trajectory ever completes more "
                "than one task — the composition itself is never "
                "demonstrated"
            ),
        },
        "execution": (
            "headline pairs/triples execute the policy's own softmax "
            "distribution ('sample'); argmax recorded alongside — BC from a "
            "multi-modal expert leaves near-ties whose argmax limit-cycles"
        ),
        "singles": {}, "singles_argmax": {},
        "pairs": {}, "pairs_argmax": {},
        "triples": {}, "triples_argmax": {},
    }

    for j, name in enumerate(names):
        r = eval_cell(cfg, model, ts.params, pool_objects, pool_agent, (j,),
                      args.seed + 7001 + j, args.cell_episodes)
        results["singles"][name] = r["sample"]
        results["singles_argmax"][name] = r["argmax"]
        log(f"single {name}: {r['sample']:.3f} sampled / "
            f"{r['argmax']:.3f} argmax")

    for i, j in itertools.combinations(range(C.N_TASKS), 2):
        key = f"{names[i]}+{names[j]}"
        r = eval_cell(cfg, model, ts.params, pool_objects, pool_agent,
                      (i, j), args.seed + 8001 + 10 * i + j,
                      args.cell_episodes)
        results["pairs"][key] = r["sample"]
        results["pairs_argmax"][key] = r["argmax"]
        log(f"pair {key}: {r['sample']:.3f} / {r['argmax']:.3f}")

    for tri in itertools.combinations(range(C.N_TASKS), 3):
        if args.smoke and tri != (0, 1, 2):
            continue
        key = "+".join(names[t] for t in tri)
        r = eval_cell(cfg, model, ts.params, pool_objects, pool_agent, tri,
                      args.seed + 9001 + sum(10**k * t for k, t in
                                             enumerate(tri)),
                      args.cell_episodes)
        results["triples"][key] = r["sample"]
        results["triples_argmax"][key] = r["argmax"]
        log(f"triple {key}: {r['sample']:.3f} / {r['argmax']:.3f}")

    for kind in ("pairs", "triples"):
        for suffix in ("", "_argmax"):
            vals = list(results[kind + suffix].values())
            if vals:
                results[f"{kind[:-1]}_mean{suffix}"] = float(np.mean(vals))
                results[f"{kind[:-1]}_min{suffix}"] = float(np.min(vals))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
    log(f"pair mean {results.get('pair_mean', 0):.3f} min "
        f"{results.get('pair_min', 0):.3f}; triple mean "
        f"{results.get('triple_mean', 0):.3f} min "
        f"{results.get('triple_min', 0):.3f} → {args.out}")


if __name__ == "__main__":
    main()
