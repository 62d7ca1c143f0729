"""Train a learned policy to solve canonical 21x21 stacked CraftingWorld.

BC from expert snapshot demos (tools/collect_canonical_demos.py) + DAgger
rounds (train/dagger.py), evaluated exactly as train/evaluate.py defines
success: greedy policy, fresh stacked resets, reward == MAX_STEPS
(exact-match achieved == desired, craftingworld_ray.py:757-767).

Runs on the GPU; expert relabeling is host numpy. The device dataset lives in
a fixed-capacity buffer so every training dispatch reuses one compiled
program across DAgger growth.

    python tools/train_canonical.py --demos data/demos_canonical.npz \
        --out runs/canonical --dagger-rounds 8
"""

import argparse
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gym_craftingworld_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()

from flax import serialization  # noqa: E402

from gym_craftingworld_tpu.config import EnvConfig  # noqa: E402
from gym_craftingworld_tpu.train import dagger  # noqa: E402
from gym_craftingworld_tpu.train.demos import SnapDataset  # noqa: E402

CFG = EnvConfig(height=21, width=21, max_steps=300, stacking=True)


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def pad_columns(snaps: SnapDataset, capacity: int) -> dict:
    cols = dagger.device_columns(snaps)
    n = snaps.num_rows
    assert n <= capacity, (n, capacity)
    return {
        k: jnp.zeros((capacity,) + v.shape[1:], v.dtype).at[:n].set(v)
        for k, v in cols.items()
    }


def append_columns(data: dict, labeled: SnapDataset, n_valid: int) -> int:
    new = dagger.device_columns(labeled)
    m = labeled.num_rows
    for k in data:
        data[k] = jax.lax.dynamic_update_slice_in_dim(
            data[k], new[k].astype(data[k].dtype), n_valid, 0
        )
    return n_valid + m


def train_chunk(model, ts, data, n_valid: int, steps: int, batch: int,
                lr: float, key):
    """`steps` SGD steps on uniformly sampled rows (fixed shapes)."""
    idx = jax.random.randint(key, (steps * batch,), 0, n_valid)
    ts, stats = dagger._bc_epoch(CFG, model, lr, ts, data, idx, batch)
    return ts, {k: float(v) for k, v in stats.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--demos", default="data/demos_canonical.npz")
    ap.add_argument("--out", default="runs/canonical")
    ap.add_argument("--capacity", type=int, default=6_000_000)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--bc-steps", type=int, default=4000)
    ap.add_argument("--bc-lr", type=float, default=1e-3)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--dagger-rounds", type=int, default=8)
    ap.add_argument("--dagger-episodes", type=int, default=768)
    ap.add_argument("--dagger-max-states", type=int, default=300_000)
    ap.add_argument("--dagger-steps", type=int, default=1500)
    ap.add_argument("--dagger-lr", type=float, default=3e-4)
    ap.add_argument("--eval-episodes", type=int, default=512)
    ap.add_argument("--final-eval-episodes", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-params", default=None,
                    help="resume from a saved params msgpack")
    ap.add_argument("--round-base", type=int, default=0,
                    help="offset for DAgger round numbering/seeds on resume")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    mf = open(metrics_path, "a")

    def emit(rec):
        rec["t"] = time.time()
        mf.write(json.dumps(rec) + "\n")
        mf.flush()

    t0 = time.time()
    jnp.zeros(()).block_until_ready()
    log(f"device claim: {time.time() - t0:.0f}s ({jax.devices()})")
    t0 = time.time()
    snaps = SnapDataset.load(args.demos)
    log(f"demos loaded: {snaps.num_episodes} episodes, {snaps.num_rows} rows "
        f"({time.time() - t0:.0f}s)")
    import glob as _glob

    prior = sorted(_glob.glob(os.path.join(args.out, "dagger*.npz")))
    if prior:
        extras = [SnapDataset.load(p) for p in prior]
        snaps = SnapDataset.concat(snaps, *extras)
        log(f"reloaded {len(prior)} prior DAgger round(s): "
            f"+{sum(e.num_rows for e in extras)} rows → {snaps.num_rows}")
    t0 = time.time()
    data = pad_columns(snaps, args.capacity)
    jax.block_until_ready(data)
    log(f"device dataset ready ({time.time() - t0:.0f}s)")
    n_valid = snaps.num_rows

    key = jax.random.PRNGKey(args.seed)
    key, k_init = jax.random.split(key)
    from gym_craftingworld_tpu.models.grid_policy import init_grid_policy

    model, params = init_grid_policy(k_init, CFG, args.channels, args.hidden)
    if args.init_params:
        with open(args.init_params, "rb") as f:
            params = serialization.from_bytes(params, f.read())
        log(f"resumed params from {args.init_params}")
    ts = dagger.BCTrainState(params, dagger._make_tx(args.bc_lr).init(params))

    def save_params(tag):
        path = os.path.join(args.out, f"params_{tag}.msgpack")
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(jax.device_get(ts.params)))
        return path

    def evaluate(tag, n_eps, seed):
        t0 = time.time()
        res = dagger.evaluate_grid_policy(CFG, model, ts.params, n_eps, seed)
        log(f"eval[{tag}] success {res['success_rate']:.3f} over "
            f"{res['episodes']} eps (mean steps "
            f"{res['mean_episode_steps']:.0f}, {time.time() - t0:.0f}s)")
        emit({"phase": "eval", "tag": tag, **res})
        return res

    # ---- BC phase ----------------------------------------------------------
    done_steps = 0
    while done_steps < args.bc_steps:
        steps = min(args.chunk, args.bc_steps - done_steps)
        key, k = jax.random.split(key)
        t0 = time.time()
        ts, stats = train_chunk(
            model, ts, data, n_valid, steps, args.batch, args.bc_lr, k
        )
        done_steps += steps
        log(f"bc {done_steps}/{args.bc_steps}: loss {stats['loss']:.4f} "
            f"acc {stats['accuracy']:.4f} ({time.time() - t0:.0f}s)")
        emit({"phase": "bc", "steps": done_steps, **stats})
        if done_steps % (args.chunk * 4) == 0:
            evaluate(f"bc{done_steps}", args.eval_episodes, seed=900)
    save_params("bc")
    evaluate("bc_final", args.eval_episodes, seed=901)

    # ---- DAgger rounds -----------------------------------------------------
    for r in range(args.dagger_rounds):
        t0 = time.time()
        cols, sr = dagger.collect_policy_states(
            CFG, model, ts.params, args.dagger_episodes,
            seed=1000 + args.round_base + r, explore_eps=0.02,
            max_states=args.dagger_max_states,
        )
        log(f"dagger {r}: rollout success {sr:.3f}, "
            f"{len(cols['agent_key'])} states ({time.time() - t0:.0f}s)")
        t0 = time.time()
        labeled = dagger.expert_relabel(CFG, cols)
        log(f"dagger {r}: labeled in {time.time() - t0:.0f}s")
        if n_valid + labeled.num_rows > args.capacity:
            labeled = SnapDataset(*[a[: args.capacity - n_valid]
                                    for a in labeled])
        labeled.save(os.path.join(args.out, f"dagger{args.round_base + r}.npz"))
        n_valid = append_columns(data, labeled, n_valid)
        emit({"phase": "dagger_collect", "round": r, "rollout_success": sr,
              "rows": int(labeled.num_rows), "n_valid": int(n_valid)})
        done = 0
        while done < args.dagger_steps:
            steps = min(args.chunk, args.dagger_steps - done)
            key, k = jax.random.split(key)
            ts, stats = train_chunk(
                model, ts, data, n_valid, steps, args.batch, args.dagger_lr, k
            )
            done += steps
            log(f"dagger {r} train {done}/{args.dagger_steps}: "
                f"loss {stats['loss']:.4f} acc {stats['accuracy']:.4f}")
            emit({"phase": "dagger_train", "round": r, "steps": done, **stats})
        save_params(f"dagger{r}")
        evaluate(f"dagger{r}", args.eval_episodes, seed=902 + r)

    # ---- final evaluation --------------------------------------------------
    res = evaluate("final", args.final_eval_episodes, seed=31337)
    path = save_params("final")
    log(f"final params → {path}")
    emit({"phase": "done", "success_rate": res["success_rate"]})
    mf.close()


if __name__ == "__main__":
    main()
