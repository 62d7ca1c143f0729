"""Distill the canonical grid policy into an IMAGES-ONLY pixel policy.

Pixels are the reference's primary observation mode
(craftingworld_ray.py:84-92), so the framework should demonstrate a
pixel-input policy actually solving the canonical 21x21 stacked setting.
This tool BC-distills the 97.2% GridPolicy teacher
(docs/canonical_policy.json) into models/cnn.PixelDistillStudent, which
consumes exactly the reference observation content — the current frame, the
imagined desired-goal frame, and the init frame, as rendered RGB — and
nothing else (no goal bits, no achieved vector, no step counter).

DAgger-style loop, fully on device except bookkeeping:
  round 0   roll the TEACHER greedily on fresh canonical resets, record
            ~40-byte state snapshots (+ the episode's imagined-goal
            occupancy so goal frames can be re-rendered at train time);
  round 1+  roll the STUDENT (eps-greedy) — its own visitation
            distribution — and label every visited state with the teacher;
  train     minibatches re-render (current, goal, init) frames from the
            snapshot columns on device and fit cross-entropy to the
            teacher's action.

Output: docs/pixel_canonical.json gains a "distilled_student" section with
the final canonical stacked exact-match evaluation.

    python tools/pixel_distill.py [--rounds 4] [--episodes 8192]
"""

from __future__ import annotations

import argparse
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
import optax  # noqa: E402
from flax import serialization  # noqa: E402

from gym_craftingworld_tpu import constants as C  # noqa: E402
from gym_craftingworld_tpu.config import EnvConfig  # noqa: E402
from gym_craftingworld_tpu.core.reset import reset as core_reset  # noqa: E402
from gym_craftingworld_tpu.core.step import _step_one  # noqa: E402
from gym_craftingworld_tpu.models.cnn import init_student  # noqa: E402
from gym_craftingworld_tpu.models.grid_policy import (  # noqa: E402
    init_grid_policy,
    planes_from_snaps,
    planes_from_state,
    snap_columns_from_state,
)
from gym_craftingworld_tpu.render.raster import render_ray  # noqa: E402
from gym_craftingworld_tpu.train import dagger as dagger_mod  # noqa: E402
from gym_craftingworld_tpu.train.evaluate import summarize  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "pixel_canonical.json")


def make_tx():
    """Single source of truth for the student optimizer — the opt_state is
    created in main() but consumed inside the jitted _student_epoch, so the
    two must be structurally identical."""
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(3e-4, weight_decay=1e-4))


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# device-side grid rebuild from occupancy columns
# ---------------------------------------------------------------------------


def grids_from_occ(cfg: EnvConfig, occ_key, occ_code):
    """(cell, code) slot pairs → int8 code grids [B, H, W] (scatter-free)."""
    HW = cfg.n_cells
    cells = jnp.arange(HW, dtype=jnp.int32)
    hit = occ_key.astype(jnp.int32)[:, :, None] == cells[None, None, :]
    flat = jnp.sum(hit * occ_code.astype(jnp.int32)[:, :, None], axis=1)
    return flat.astype(jnp.int8).reshape(-1, cfg.height, cfg.width)


def init_grids_from_keys(cfg: EnvConfig, init_key):
    """init_key[s] (slot s = object code s+1) → int8 grids [B, H, W]."""
    HW = cfg.n_cells
    cells = jnp.arange(HW, dtype=jnp.int32)
    hit = init_key.astype(jnp.int32)[:, :, None] == cells[None, None, :]
    codes = jnp.arange(1, C.N_OBJECTS + 1, dtype=jnp.int32)
    flat = jnp.sum(hit * codes[None, :, None], axis=1)
    return flat.astype(jnp.int8).reshape(-1, cfg.height, cfg.width)


def rc(cfg, key):
    key = key.astype(jnp.int32)
    return jnp.stack([key // cfg.width, key % cfg.width], axis=-1)


def images_from_cols(cfg: EnvConfig, cols: dict):
    """Snapshot columns → stacked (current, goal, init) frames uint8[B,...,9]."""
    cur = grids_from_occ(cfg, cols["occ_key"], cols["occ_code"])
    goal = grids_from_occ(cfg, cols["goal_occ_key"], cols["goal_occ_code"])
    init = init_grids_from_keys(cfg, cols["init_key"])
    zero = jnp.zeros(cur.shape[0], jnp.int32)
    img_c = render_ray(cur, rc(cfg, cols["agent_key"]),
                       cols["holding"].astype(jnp.int32))
    img_g = render_ray(goal, rc(cfg, cols["goal_agent_key"]), zero)
    img_i = render_ray(init, rc(cfg, cols["init_agent_key"]), zero)
    return jnp.concatenate([img_c, img_g, img_i], axis=-1)


def goal_columns_from_state(cfg: EnvConfig, state):
    """Imagined-goal occupancy columns (same argsort trick as
    snap_columns_from_state; goal grids hold <= 8 objects: imagination only
    transforms/removes/moves the reset set, core/imagine.py)."""
    B = state.goal_objects.shape[0]
    flat = state.goal_objects.reshape(B, cfg.n_cells).astype(jnp.int32)
    mask = flat > 0
    order = jnp.argsort(jnp.logical_not(mask), axis=1, stable=True)[
        :, : C.N_OBJECTS
    ]
    code = jnp.take_along_axis(flat, order, axis=1)
    occ_key = jnp.where(code > 0, order, cfg.n_cells + 1).astype(jnp.int16)
    gk = (state.goal_agent[:, 0] * cfg.width + state.goal_agent[:, 1]).astype(
        jnp.int16)
    return dict(goal_occ_key=occ_key, goal_occ_code=code.astype(jnp.int8),
                goal_agent_key=gk)


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1, 2, 7))
def _rollout_collect(cfg: EnvConfig, driver_kind: str, model, params, keys,
                     explore_key, eps: float, student_model=None,
                     student_params=None):
    """Roll teacher ('grid') or student ('pixel') from fresh canonical
    resets; record snapshot + goal columns per step."""
    state = core_reset(cfg, keys)
    B = keys.shape[0]
    goal_cols = goal_columns_from_state(cfg, state)
    zero = jnp.zeros(B, jnp.int32)
    img_g = render_ray(state.goal_objects, state.goal_agent, zero)
    init_nomark = jnp.where(
        state.init_objects == C.AGENT_INIT_MARK, 0, state.init_objects
    )
    img_i = render_ray(init_nomark, state.init_agent, zero)

    def body(carry, k_t):
        st, done, reward = carry
        cols = snap_columns_from_state(cfg, st)
        if driver_kind == "grid":
            planes, extras = planes_from_state(cfg, st)
            logits, _ = model.apply(params, planes, extras)
        else:
            img_c = render_ray(st.objects, st.agent, st.holding)
            images = jnp.concatenate([img_c, img_g, img_i], axis=-1)
            logits, _ = model.apply(params, images)
        action = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        k_u, k_a = jax.random.split(k_t)
        rnd = jax.random.randint(k_a, (B,), 0, 4)
        action = jnp.where(jax.random.uniform(k_u, (B,)) < eps, rnd, action)
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
        jax.random.split(explore_key, cfg.max_steps),
    )
    return cols, goal_cols, live, reward == cfg.max_steps


def collect_round(cfg, kind, model, params, episodes, seed, eps, chunk=2048,
                  fail_cap=None):
    """Host-side: chunked rollouts → flat snapshot column dict + success.

    ``fail_cap``: for UNSUCCESSFUL episodes keep at most this many frames
    (uniform over time) and only *salvageable* ones (no undesired latched
    achievement — frames past a fatal latch cannot reach exact match, and
    a failed 300-step episode is mostly redundant limit-cycle orbit
    frames; unfiltered they dominate the aggregate and drag training off
    the success path — the same pathology tools/targeted_dagger.py solved
    for the grid policy). Successful episodes keep every frame.
    """
    from gym_craftingworld_tpu.train.dagger import _LATCH_MASK

    parts = []
    succ = []
    for i in range(0, episodes, chunk):
        B = min(chunk, episodes - i)
        keys = jax.random.split(jax.random.PRNGKey(seed + i), B)
        cols, goal_cols, live, success = _rollout_collect(
            cfg, kind, model, params, jax.random.key_data(keys),
            jax.random.PRNGKey(seed ^ (7 + i)), eps)
        live = np.asarray(live)  # [T, B]
        success = np.asarray(success)
        if fail_cap is not None:
            ach = np.asarray(cols["achieved"]).astype(np.int64)
            des = np.asarray(cols["desired"]).astype(np.int64)
            salvage = (ach & ~des & _LATCH_MASK) == 0
            keep = live & (success[None, :] | salvage)
            rng = np.random.RandomState(seed + 13 * i)
            for b in np.nonzero(~success)[0]:
                rows = np.nonzero(keep[:, b])[0]
                if len(rows) > fail_cap:
                    drop = rng.choice(rows, len(rows) - fail_cap,
                                      replace=False)
                    keep[drop, b] = False
            live = keep
        sel = live.reshape(-1)
        host = {k: np.asarray(v).reshape((-1,) + v.shape[2:])[sel]
                for k, v in cols.items()}
        T = live.shape[0]
        for k, v in goal_cols.items():
            vb = np.broadcast_to(
                np.asarray(v)[None], (T,) + v.shape
            ).reshape((-1,) + v.shape[1:])[sel]
            host[k] = vb
        parts.append(host)
        succ.append(success)
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return out, float(np.concatenate(succ).mean())


# ---------------------------------------------------------------------------
# teacher labeling + student training
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1))
def _teacher_label(cfg, model, params, cols):
    planes, extras = planes_from_snaps(
        cfg, cols["occ_key"], cols["occ_code"], cols["init_key"],
        cols["init_agent_key"], cols["agent_key"], cols["holding"],
        cols["desired"], cols["achieved"],
    )
    logits, _ = model.apply(params, planes, extras)
    return jnp.argmax(logits, axis=-1).astype(jnp.int8), logits


def teacher_label(cfg, model, params, cols, chunk=65536):
    """Teacher argmax labels AND full logits: distillation fits the SOFT
    targets — hard argmax labels carry no margin information, so the
    student develops its own near-ties whose greedy execution limit-cycles
    (observed: 99% hard-label accuracy, 4% greedy episode success); the
    teacher's logit margins are consistent along its trajectories
    (97.2% greedy success — no cycles), and KL transfer carries them."""
    n = len(cols["agent_key"])
    labels = np.zeros(n, np.int8)
    tlogits = np.zeros((n, 6), np.float16)
    for i in range(0, n, chunk):
        sl = {k: jnp.asarray(v[i:i + chunk]) for k, v in cols.items()
              if k not in ("goal_occ_key", "goal_occ_code", "goal_agent_key")}
        lab, lg = _teacher_label(cfg, model, params, sl)
        labels[i:i + chunk] = np.asarray(lab)
        tlogits[i:i + chunk] = np.asarray(lg, np.float16)
    return labels, tlogits


_IMG_COLS = ("occ_key", "occ_code", "agent_key", "holding", "init_key",
             "init_agent_key", "goal_occ_key", "goal_occ_code",
             "goal_agent_key")

# action index remaps under vertical / horizontal world flips
# (0 up, 1 right, 2 down, 3 left, 4 pickup, 5 drop)
_PERM_H = np.array([2, 1, 0, 3, 4, 5], np.int32)
_PERM_W = np.array([0, 3, 2, 1, 4, 5], np.int32)


def _flip_key(cfg, key, fh, fw):
    """Flip flat cell keys; out-of-grid pad values pass through."""
    k = key.astype(jnp.int32)
    valid = (k >= 0) & (k < cfg.n_cells)
    r, c = k // cfg.width, k % cfg.width
    shape = (-1,) + (1,) * (k.ndim - 1)
    r = jnp.where(fh.reshape(shape), cfg.height - 1 - r, r)
    c = jnp.where(fw.reshape(shape), cfg.width - 1 - c, c)
    return jnp.where(valid, r * cfg.width + c, k).astype(key.dtype)


def augment_flips(cfg, mb, key):
    """D4-flip augmentation in COLUMN space (then re-rendered, so images
    stay exactly on the render distribution): CraftingWorld dynamics are
    symmetric under vertical/horizontal world flips with the move actions
    relabeled — free 4x data diversity against the memorization gap
    (held-out state agreement was 79.5% vs 99.7% train without it)."""
    B = mb["label"].shape[0]
    kh, kw = jax.random.split(key)
    fh = jax.random.bernoulli(kh, 0.5, (B,))
    fw = jax.random.bernoulli(kw, 0.5, (B,))
    out = dict(mb)
    for k in ("occ_key", "agent_key", "init_key", "init_agent_key",
              "goal_occ_key", "goal_agent_key"):
        out[k] = _flip_key(cfg, mb[k], fh, fw)
    ph = jnp.asarray(_PERM_H)
    pw = jnp.asarray(_PERM_W)
    lab = mb["label"].astype(jnp.int32)
    lab = jnp.where(fh, ph[lab], lab)
    lab = jnp.where(fw, pw[lab], lab)
    out["label"] = lab
    lg = mb["tlogits"]
    lg = jnp.where(fh[:, None], lg[:, ph], lg)
    lg = jnp.where(fw[:, None], lg[:, pw], lg)
    out["tlogits"] = lg
    return out


@partial(jax.jit, static_argnums=(0, 1, 2), donate_argnums=(3,))
def _student_epoch(cfg, model, batch_size, ts, data, perm, aug_key):
    tx = make_tx()
    steps = perm.shape[0] // batch_size

    def minibatch(ts, i):
        params, opt_state = ts
        idx = jax.lax.dynamic_slice_in_dim(perm, i * batch_size, batch_size)
        mb = jax.tree.map(lambda a: a[idx], data)
        mb = augment_flips(cfg, mb, jax.random.fold_in(aug_key, i))
        images = images_from_cols(cfg, mb)

        def loss_fn(p):
            logits, _ = model.apply(p, images)
            logp = jax.nn.log_softmax(logits)
            # core rows (soft=1): CE against the TEACHER's softmax — margin
            # transfer on the teacher's own distribution. Student-visited
            # rows (soft=0): hard CE against the scripted EXPERT's label —
            # ground truth everywhere (the learned teacher's logits are
            # meaningless off its own visitation distribution; labeling
            # student states with them collapsed execution in run 3).
            pt = jax.nn.softmax(mb["tlogits"].astype(jnp.float32))
            soft_ce = -(pt * logp).sum(-1)
            hard_ce = -jnp.take_along_axis(
                logp, mb["label"][:, None].astype(jnp.int32), axis=1
            )[:, 0]
            flag = mb["soft"].astype(jnp.float32)
            loss = (flag * (0.9 * soft_ce + 0.1 * hard_ce)
                    + (1 - flag) * hard_ce).mean()
            acc = (jnp.argmax(logits, -1) == mb["label"]).mean()
            return loss, acc

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), (loss, acc)

    ts, (losses, accs) = jax.lax.scan(
        minibatch, ts, jnp.arange(steps, dtype=jnp.int32))
    return ts, losses.mean(), accs.mean()


# ---------------------------------------------------------------------------
# student evaluation (canonical stacked exact match)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1, 4))
def _eval_student(cfg, model, params, keys, mode="argmax"):
    state = core_reset(cfg, keys)
    B = keys.shape[0]
    zero = jnp.zeros(B, jnp.int32)
    img_g = render_ray(state.goal_objects, state.goal_agent, zero)
    init_nomark = jnp.where(
        state.init_objects == C.AGENT_INIT_MARK, 0, state.init_objects
    )
    img_i = render_ray(init_nomark, state.init_agent, zero)
    k0 = jax.random.wrap_key_data(keys[0])

    def body(carry):
        st, done, reward, k = carry
        k, k_t = jax.random.split(k)
        img_c = render_ray(st.objects, st.agent, st.holding)
        images = jnp.concatenate([img_c, img_g, img_i], axis=-1)
        logits, _ = model.apply(params, images)
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
        (state, jnp.zeros(B, bool), jnp.full(B, -1, jnp.int32), k0),
    )
    return {
        "success": reward == cfg.max_steps,
        "steps": state.step_num,
        "desired": state.desired,
        "achieved": state.achieved,
    }


def eval_student(cfg, model, params, episodes, seed, chunk=2048,
                 mode="argmax"):
    outs = []
    for i in range(0, episodes, chunk):
        B = min(chunk, episodes - i)
        keys = jax.random.split(jax.random.PRNGKey(seed + 31 * i), B)
        outs.append(jax.tree.map(
            np.asarray,
            _eval_student(cfg, model, params, jax.random.key_data(keys),
                          mode)))
    return summarize({k: np.concatenate([o[k] for o in outs])
                      for k in outs[0]})


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--teacher", default="runs/canonical_big/"
                    "params_targeted_c_final.msgpack")
    ap.add_argument("--teacher-channels", type=int, default=96)
    ap.add_argument("--teacher-hidden", type=int, default=1536)
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--hidden", type=int, default=1536)
    ap.add_argument("--stem", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--fail-cap", type=int, default=40,
                    help="max frames kept per failed student episode")
    ap.add_argument("--episodes", type=int, default=8192)
    ap.add_argument("--episodes0", type=int, default=24576)
    ap.add_argument("--epochs0", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--eval-episodes", type=int, default=2048)
    ap.add_argument("--final-eval-episodes", type=int, default=8192)
    ap.add_argument("--max-rows", type=int, default=5_000_000)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--save", default="runs/pixel_distill")
    ap.add_argument("--init-student", default="",
                    help="resume student params from a msgpack")
    args = ap.parse_args()

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
        args = ap.parse_args([
            "--smoke", "--rounds", "2", "--episodes", "8", "--epochs0", "1",
            "--epochs", "1", "--batch", "32", "--eval-episodes", "8",
            "--final-eval-episodes", "8", "--channels", "8", "--hidden",
            "32", "--stem", "8", "--teacher-channels", "8",
            "--teacher-hidden", "32", "--teacher", "",
            "--out", "/tmp/pixel_smoke.json", "--save", "/tmp/pixel_smoke",
        ])
        cfg = EnvConfig(height=8, width=8, max_steps=40)
    else:
        from gym_craftingworld_tpu import ray_config

        cfg = ray_config()

    t_model, t_params = init_grid_policy(
        jax.random.PRNGKey(0), cfg, args.teacher_channels,
        args.teacher_hidden)
    if args.teacher:
        with open(args.teacher, "rb") as f:
            t_params = serialization.from_bytes(t_params, f.read())
        log(f"teacher loaded from {args.teacher}")

    s_model, s_params = init_student(
        jax.random.PRNGKey(args.seed), cfg, channels=args.channels,
        hidden=args.hidden, stem=args.stem)
    if args.init_student:
        with open(args.init_student, "rb") as f:
            s_params = serialization.from_bytes(s_params, f.read())
        log(f"student resumed from {args.init_student}")
    tx = make_tx()
    ts = (s_params, tx.init(s_params))

    core = None  # round-0 teacher-path rows: the known-good distribution
    student_data = None  # filtered on-policy student rows
    history = []
    for r in range(args.rounds):
        t0 = time.time()
        if r == 0:
            core, sr = collect_round(
                cfg, "grid", t_model, t_params, args.episodes0,
                args.seed + 100, eps=0.02)
            log(f"round 0: teacher rollouts sr {sr:.3f}, "
                f"{len(core['agent_key'])} rows ({time.time() - t0:.0f}s)")
            core["label"], core["tlogits"] = teacher_label(
                cfg, t_model, t_params, core)
            core["soft"] = np.ones(len(core["label"]), np.float16)
        else:
            cols, sr = collect_round(
                cfg, "pixel", s_model, ts[0], args.episodes,
                args.seed + 100 * r, eps=0.02, fail_cap=args.fail_cap)
            log(f"round {r}: STUDENT rollouts sr {sr:.3f}, "
                f"{len(cols['agent_key'])} filtered rows "
                f"({time.time() - t0:.0f}s)")
            t0l = time.time()
            labeled = dagger_mod.expert_relabel(
                cfg, {k: cols[k] for k in dagger_mod._COL_FIELDS})
            cols["label"] = labeled.action
            cols["tlogits"] = np.zeros((len(cols["label"]), 6), np.float16)
            cols["soft"] = np.zeros(len(cols["label"]), np.float16)
            log(f"  expert labels: {len(cols['label'])} rows "
                f"({time.time() - t0l:.0f}s)")
            student_data = cols if student_data is None else {
                k: np.concatenate([student_data[k], cols[k]]) for k in cols}
            if len(student_data["label"]) > args.max_rows:
                keep = np.random.RandomState(args.seed + r).choice(
                    len(student_data["label"]), args.max_rows, replace=False)
                student_data = {k: v[keep] for k, v in student_data.items()}
        n0 = len(core["label"])
        if student_data is None:
            data = core
            idx_all = np.arange(n0)
        else:
            data = {k: np.concatenate([core[k], student_data[k]])
                    for k in core}
            n1 = len(student_data["label"])
            # 50/50 mixture batches (targeted_dagger recipe): upsample the
            # teacher-path core so on-policy rows never exceed half the mass
            reps = max(1, int(round(n1 / n0)))
            idx_all = np.concatenate(
                [np.tile(np.arange(n0), reps), n0 + np.arange(n1)])
        dev = {k: jnp.asarray(v) for k, v in data.items()
               if k in _IMG_COLS + ("label", "tlogits", "soft")}
        n = len(idx_all)
        epochs = args.epochs0 if r == 0 else args.epochs
        for ep in range(epochs):
            order = np.random.RandomState(
                args.seed + 17 * r + ep).permutation(n)
            perm = jnp.asarray(idx_all[order], jnp.int32)
            ts, loss, acc = _student_epoch(
                cfg, s_model, args.batch, ts, dev, perm,
                jax.random.PRNGKey(args.seed + 1000 * r + ep))
            log(f"  train ep {ep}: loss {float(loss):.4f} "
                f"acc {float(acc):.4f} ({n} mixture rows, core share "
                f"{1 - (0 if student_data is None else n1 / n):.2f})")
        res = eval_student(cfg, s_model, ts[0], args.eval_episodes,
                           args.seed + 900 + r)
        res_s = eval_student(cfg, s_model, ts[0], args.eval_episodes,
                             args.seed + 900 + r, mode="sample")
        log(f"round {r} eval: {res['success_rate']:.4f} argmax / "
            f"{res_s['success_rate']:.4f} sampled over {res['episodes']} eps")
        history.append({"round": r, "rollout_sr": sr, **res,
                        "success_rate_sampled": res_s["success_rate"]})

    res = eval_student(cfg, s_model, ts[0], args.final_eval_episodes, 31337)
    res_sample = eval_student(cfg, s_model, ts[0], args.final_eval_episodes,
                              31337, mode="sample")
    log(f"FINAL student eval: {res['success_rate']:.4f} argmax / "
        f"{res_sample['success_rate']:.4f} sampled over "
        f"{res['episodes']} eps")

    os.makedirs(args.save, exist_ok=True)
    with open(os.path.join(args.save, "student.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(jax.device_get(ts[0])))

    try:
        with open(args.out) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        doc = {}
    doc["distilled_student"] = {
        "final_eval": res,
        "final_eval_sampled": res_sample,
        "history": history,
        "observation": (
            "images ONLY: current frame + imagined desired-goal frame + "
            "init frame (the reference's pixel observation content, "
            "craftingworld_ray.py:84-92); no goal bits, no achieved "
            "vector, no step counter"
        ),
        "model": f"PixelDistillStudent(stem={args.stem}, "
                 f"channels={args.channels}, hidden={args.hidden})",
        "teacher": "GridPolicy(96, 1536) @ 97.2% "
                   "(docs/canonical_policy.json)",
        "protocol": (
            f"DAgger distillation: round 0 teacher rollouts, later rounds "
            f"student rollouts, all states labeled by the teacher; "
            f"{args.rounds} rounds x {args.episodes} episodes"
        ),
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    log(f"→ {args.out}")


if __name__ == "__main__":
    main()
