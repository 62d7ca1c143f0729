"""Targeted failure-DAgger: close the canonical 21x21 stacked setting.

Vanilla DAgger (tools/train_canonical.py) plateaus ~94%: with rollout success
already ~95%, its aggregated dataset is dominated by states the policy
handles, so the ~20:1 dilution starves the failure modes of gradient signal.
This tool puts the training mass exactly on the failure distribution:

  * collect states ONLY from failed greedy episodes (train/dagger.py
    ``failures_only``), keeping just the *salvageable* prefix of each — the
    frames before any undesired latched achievement (after a fatal latch the
    expert's labels are noise, exact-match success is unreachable);
  * relabel with the scripted expert and append to the aggregate dataset;
  * train with MIXTURE sampling: a configurable fraction of every batch
    drawn from the appended failure rows, the rest uniform over the full
    aggregate (replay against forgetting);
  * evaluate greedily (the train/evaluate.py measurement) every round and
    write the final docs/canonical_policy.json artifact (8,192 episodes,
    held-out seed) with per-skill and per-task-count breakdowns.

    python tools/targeted_dagger.py --out runs/canonical \
        --init-params runs/canonical/params_final.msgpack --rounds 6
"""

import argparse
import glob
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

from gym_craftingworld_tpu import constants as C  # noqa: E402
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
    for k in data:
        data[k] = jax.lax.dynamic_update_slice_in_dim(
            data[k], new[k].astype(data[k].dtype), n_valid, 0
        )
    return n_valid + labeled.num_rows


def mixed_train_chunk(model, ts, data, n_valid, fail_lo, steps, batch, lr,
                      frac_fail, key):
    """SGD steps with ``frac_fail`` of each batch from the failure rows."""
    n = steps * batch
    k1, k2, k3 = jax.random.split(key, 3)
    uni = jax.random.randint(k1, (n,), 0, n_valid)
    if fail_lo < n_valid and frac_fail > 0:
        fail = jax.random.randint(k2, (n,), fail_lo, n_valid)
        pick = jax.random.uniform(k3, (n,)) < frac_fail
        idx = jnp.where(pick, fail, uni)
    else:
        idx = uni
    ts, stats = dagger._bc_epoch(CFG, model, lr, ts, data, idx, batch)
    return ts, {k: float(v) for k, v in stats.items()}


def full_eval_artifact(model, params, episodes, seed):
    """The docs/canonical_policy.json payload (per-skill, per-task-count)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), episodes)
    out = dagger._eval_batch_grid(CFG, model, params,
                                  jax.random.key_data(keys))
    success = np.asarray(out["success"])
    steps = np.asarray(out["steps"])
    desired = np.asarray(out["desired"]).astype(bool)
    achieved = np.asarray(out["achieved"]).astype(bool)
    n_tasks = desired.sum(1)
    by_k = {}
    for k in range(1, C.N_TASKS + 1):
        sel = n_tasks == k
        if sel.any():
            by_k[str(k)] = {"episodes": int(sel.sum()),
                            "success": float(success[sel].mean())}
    per_skill = {}
    for i, name in enumerate(C.TASK_LIST):
        sel = desired[:, i]
        per_skill[name] = float(achieved[sel, i].mean())
    return {
        "episodes": int(episodes),
        "eval_seed": int(seed),
        "mean_episode_steps": float(steps.mean()),
        "setting": ("canonical 21x21, stacked 1-9 task exact-match goals "
                    "(reference defaults)"),
        "skill_completion_when_desired": per_skill,
        "success_by_num_tasks": by_k,
        "success_rate": float(success.mean()),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/canonical")
    ap.add_argument("--demos", default="data/demos_canonical.npz")
    ap.add_argument("--init-params", default=None,
                    help="resume from a params msgpack; when absent a fresh "
                         "model is BC-trained on the aggregate first")
    ap.add_argument("--bc-steps", type=int, default=6000)
    ap.add_argument("--bc-lr", type=float, default=1e-3)
    ap.add_argument("--capacity", type=int, default=6_000_000)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--episodes", type=int, default=6144,
                    help="greedy episodes rolled per round (failures kept)")
    ap.add_argument("--steps", type=int, default=1200,
                    help="SGD steps per round")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--frac-fail", type=float, default=0.5)
    ap.add_argument("--eval-episodes", type=int, default=2048)
    ap.add_argument("--final-eval-episodes", type=int, default=8192)
    ap.add_argument("--final-eval-seed", type=int, default=424242)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--target", type=float, default=0.975,
                    help="stop early when round eval reaches this")
    ap.add_argument("--policy-json", default="docs/canonical_policy.json")
    ap.add_argument("--tag", default="",
                    help="suffix for round files/checkpoints (avoids "
                         "clobbering when reusing an out dir)")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    mf = open(os.path.join(args.out, "targeted_metrics.jsonl"), "a")

    def emit(rec):
        rec["t"] = time.time()
        mf.write(json.dumps(rec) + "\n")
        mf.flush()

    t0 = time.time()
    jnp.zeros(()).block_until_ready()
    log(f"device claim: {time.time() - t0:.0f}s ({jax.devices()})")

    snaps = SnapDataset.load(args.demos)
    prior = sorted(glob.glob(os.path.join(args.out, "dagger*.npz")))
    prior += sorted(glob.glob(os.path.join(args.out, "targeted*.npz")))
    if prior:
        extras = [SnapDataset.load(p) for p in prior]
        snaps = SnapDataset.concat(snaps, *extras)
        log(f"loaded {len(prior)} prior round file(s) → {snaps.num_rows} rows")
    data = pad_columns(snaps, args.capacity)
    jax.block_until_ready(data["agent_key"])
    n_valid = snaps.num_rows
    fail_lo = n_valid  # mixture window: every row appended from here on
    log(f"device dataset ready: {n_valid} rows")

    from gym_craftingworld_tpu.models.grid_policy import init_grid_policy

    key = jax.random.PRNGKey(args.seed)
    key, k_init = jax.random.split(key)
    model, params = init_grid_policy(k_init, CFG, args.channels, args.hidden)
    if args.init_params:
        with open(args.init_params, "rb") as f:
            params = serialization.from_bytes(params, f.read())
        log(f"resumed params from {args.init_params}")
        ts = dagger.BCTrainState(params, dagger._make_tx(args.lr).init(params))
    else:
        ts = dagger.BCTrainState(params,
                                 dagger._make_tx(args.bc_lr).init(params))
        done = 0
        while done < args.bc_steps:
            steps = min(500, args.bc_steps - done)
            key, k = jax.random.split(key)
            ts, stats = mixed_train_chunk(
                model, ts, data, n_valid, 0, steps, args.batch,
                args.bc_lr, 0.0, k,
            )
            done += steps
            log(f"bc {done}/{args.bc_steps}: loss {stats['loss']:.4f} "
                f"acc {stats['accuracy']:.4f}")
            emit({"phase": "bc", "steps": done, **stats})
        t0 = time.time()
        res = dagger.evaluate_grid_policy(CFG, model, ts.params,
                                          args.eval_episodes, seed=4899)
        log(f"bc eval: success {res['success_rate']:.4f} "
            f"({time.time() - t0:.0f}s)")
        emit({"phase": "eval", "round": -1, **res})
        save_params_early = os.path.join(args.out, "params_bc_big.msgpack")
        with open(save_params_early, "wb") as f:
            f.write(serialization.to_bytes(jax.device_get(ts.params)))

    def save_params(tag):
        path = os.path.join(args.out, f"params_{tag}.msgpack")
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(jax.device_get(ts.params)))
        return path

    best = (-1.0, None)
    for r in range(args.rounds):
        t0 = time.time()
        cols, sr = dagger.collect_policy_states(
            CFG, model, ts.params, args.episodes,
            seed=31000 + args.seed + r, explore_eps=0.0, failures_only=True,
        )
        n_new = len(cols["agent_key"])
        log(f"round {r}: greedy success {sr:.4f}, {n_new} salvageable "
            f"failure states ({time.time() - t0:.0f}s)")
        t0 = time.time()
        labeled = dagger.expert_relabel(CFG, cols)
        log(f"round {r}: relabeled in {time.time() - t0:.0f}s")
        if n_valid + labeled.num_rows > args.capacity:
            labeled = SnapDataset(*[a[: args.capacity - n_valid]
                                    for a in labeled])
        labeled.save(os.path.join(args.out, f"targeted{args.tag}{r}.npz"))
        n_valid = append_columns(data, labeled, n_valid)
        emit({"phase": "collect", "round": r, "rollout_success": sr,
              "rows": int(labeled.num_rows), "n_valid": int(n_valid)})

        done = 0
        while done < args.steps:
            steps = min(400, args.steps - done)
            key, k = jax.random.split(key)
            ts, stats = mixed_train_chunk(
                model, ts, data, n_valid, fail_lo, steps, args.batch,
                args.lr, args.frac_fail, k,
            )
            done += steps
            log(f"round {r} train {done}/{args.steps}: "
                f"loss {stats['loss']:.4f} acc {stats['accuracy']:.4f}")
            emit({"phase": "train", "round": r, "steps": done, **stats})

        t0 = time.time()
        res = dagger.evaluate_grid_policy(CFG, model, ts.params,
                                          args.eval_episodes, seed=4900 + r)
        log(f"round {r} eval: success {res['success_rate']:.4f} "
            f"({time.time() - t0:.0f}s)")
        emit({"phase": "eval", "round": r, **res})
        save_params(f"targeted{args.tag}{r}")
        if res["success_rate"] > best[0]:
            best = (res["success_rate"], f"targeted{args.tag}{r}")
        if res["success_rate"] >= args.target:
            log(f"round {r}: target {args.target} reached")
            break

    log(f"best round checkpoint: {best[1]} ({best[0]:.4f})")
    # reload best checkpoint for the final artifact
    with open(os.path.join(args.out, f"params_{best[1]}.msgpack"), "rb") as f:
        params = serialization.from_bytes(ts.params, f.read())
    ts = ts._replace(params=params)
    t0 = time.time()
    artifact = full_eval_artifact(
        model, ts.params, args.final_eval_episodes, args.final_eval_seed)
    artifact["policy"] = (
        f"GridPolicy(channels={args.channels}, hidden={args.hidden}), "
        f"greedy argmax")
    log(f"final eval: success {artifact['success_rate']:.4f} over "
        f"{args.final_eval_episodes} eps ({time.time() - t0:.0f}s)")
    emit({"phase": "final", **{k: v for k, v in artifact.items()
                               if not isinstance(v, dict)}})
    save_params(f"targeted{args.tag}_final")
    if artifact["success_rate"] >= 0.97:
        with open(args.policy_json, "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
        log(f"wrote {args.policy_json}")
    else:
        side = args.policy_json.replace(".json", "_candidate.json")
        with open(side, "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
        log(f"below 0.97 — wrote {side} (docs artifact unchanged)")
    mf.close()


if __name__ == "__main__":
    main()
