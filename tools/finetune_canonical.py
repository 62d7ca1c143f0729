"""RL fine-tune of the canonical policy under the exact-match reward.

The 97.2% canonical policy plateaued under BC + targeted
DAgger (every recipe re-run confirmed ~97.2%); attack the plateau with a
DIFFERENT optimizer — PPO against the true exact-match reward, starting from
the trained GridPolicy. The failure mass sits on the un-latch skills
(GoToHouse 0.968, MoveSticks 0.986): ordering mistakes that imitation of a
single expert ordering cannot fix but a return signal can.

Recipe:
  * batched canonical env (core reset incl. goal imagination + vmapped
    step), auto-reset from a fresh keyed pool each update;
  * reward shaping as train/fast_ppo: +1 on exact match, -1/max_steps
    otherwise (the reference's MAX_STEPS/-1 reward rescaled);
  * value-head warmup (policy gradients zeroed) before joint PPO — the BC
    checkpoint has an untrained value head;
  * low LR + per-eval best-checkpoint keeping: fine-tuning must never ship
    a regression (greedy eval stays the reference-exact measurement).

Writes docs/canonical_finetune.json (curve + final eval) and — only if the
final eval beats the BC policy — updates runs/canonical_big params.

    python tools/finetune_canonical.py [--updates 120]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial
from typing import NamedTuple

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

from gym_craftingworld_tpu.config import EnvConfig  # noqa: E402
from gym_craftingworld_tpu.core.reset import reset as core_reset  # noqa: E402
from gym_craftingworld_tpu.core.step import _step_one  # noqa: E402
from gym_craftingworld_tpu.models.grid_policy import (  # noqa: E402
    init_grid_policy,
    planes_from_snaps,
    planes_from_state,
    snap_columns_from_state,
)
from gym_craftingworld_tpu.train import dagger  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "canonical_finetune.json")


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


class FTConfig(NamedTuple):
    rollout_steps: int = 128
    num_minibatches: int = 16
    update_epochs: int = 1
    gamma: float = 0.999
    gae_lambda: float = 0.95
    clip_eps: float = 0.1
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    lr: float = 2e-5
    max_grad_norm: float = 0.5


class FTState(NamedTuple):
    params: dict
    opt_state: optax.OptState


def _tx(cfg_ft: FTConfig):
    return optax.chain(
        optax.clip_by_global_norm(cfg_ft.max_grad_norm),
        optax.adam(cfg_ft.lr),
    )


@partial(jax.jit, static_argnums=(0, 1, 2, 6), donate_argnums=(3, 4))
def train_step(cfg: EnvConfig, ft: FTConfig, model, ts: FTState, env, key,
               value_only: bool):
    """One PPO iteration of the GridPolicy on the real canonical env."""
    key, k_pool, k_roll, k_perm = jax.random.split(key, 4)
    B = env.objects.shape[0]
    # 2*B pool + per-timestep stride window (the fast_ppo._collect recipe):
    # a slot-indexed B-pool would hand an env that finishes twice in one
    # rollout the identical replacement world, duplicating correlated
    # episodes in the PPO batch.
    pool = core_reset(cfg,
                      jax.random.key_data(jax.random.split(k_pool, 2 * B)))

    def body(carry, inp):
        st, t = carry, inp[0]
        k_act = inp[1]
        planes, extras = planes_from_state(cfg, st)
        logits, value = model.apply(ts.params, planes, extras)
        action = jax.random.categorical(k_act, logits, axis=-1).astype(
            jnp.int32)
        logp = jnp.take_along_axis(
            jax.nn.log_softmax(logits), action[:, None], axis=1)[:, 0]
        st2, res = jax.vmap(partial(_step_one, cfg))(st, action)
        reward = jnp.where(
            res.reward == cfg.max_steps, 1.0, -1.0 / cfg.max_steps
        ).astype(jnp.float32)
        # auto-reset from a stride-offset window of the 2*B pool
        off = (t * jnp.int32(12007)) % jnp.int32(B)  # odd stride, full period
        fresh = jax.tree.map(
            lambda f: jax.lax.dynamic_slice_in_dim(f, off, B, axis=0), pool)
        st2 = jax.tree.map(
            lambda f, s: jnp.where(
                res.done.reshape((-1,) + (1,) * (s.ndim - 1)), f, s
            ),
            fresh, st2,
        )
        # store ~60-byte snapshot columns, NOT the 43 KB feature planes —
        # planes are rebuilt per minibatch (the [T, B, H, W, 49] tensor is
        # ~11 GB at production shapes and sank the compile)
        out = dict(cols=snap_columns_from_state(cfg, st),
                   action=action, logp=logp, value=value, reward=reward,
                   done=res.done, raw=res.reward)
        return st2, out

    steps = jnp.arange(ft.rollout_steps, dtype=jnp.int32)
    env, traj = jax.lax.scan(
        body, env, (steps, jax.random.split(k_roll, ft.rollout_steps)))

    planes, extras = planes_from_state(cfg, env)
    _, last_value = model.apply(ts.params, planes, extras)

    def gae_body(carry, tr):
        gae, next_value = carry
        nd = 1.0 - tr["done"].astype(jnp.float32)
        delta = tr["reward"] + ft.gamma * next_value * nd - tr["value"]
        gae = delta + ft.gamma * ft.gae_lambda * nd * gae
        return (gae, tr["value"]), gae

    (_, _), adv = jax.lax.scan(
        gae_body, (jnp.zeros_like(last_value), last_value), traj,
        reverse=True)
    ret = adv + traj["value"]

    T = ft.rollout_steps
    N = T * B
    flat = {
        "cols": {k: v.reshape((N,) + v.shape[2:])
                 for k, v in traj["cols"].items()},
        "action": traj["action"].reshape(N),
        "logp": traj["logp"].reshape(N),
        "value": traj["value"].reshape(N),
        "adv": adv.reshape(N),
        "ret": ret.reshape(N),
    }
    tx = _tx(ft)
    mb = N // ft.num_minibatches

    def epoch(carry, k_e):
        params, opt_state = carry
        perm = jax.random.permutation(k_e, N)

        def minibatch(carry, i):
            params, opt_state = carry
            idx = jax.lax.dynamic_slice_in_dim(perm, i * mb, mb)
            b = jax.tree.map(lambda a: a[idx], flat)
            adv_n = (b["adv"] - b["adv"].mean()) / (b["adv"].std() + 1e-8)
            c = b["cols"]
            planes, extras = planes_from_snaps(
                cfg, c["occ_key"], c["occ_code"], c["init_key"],
                c["init_agent_key"], c["agent_key"], c["holding"],
                c["desired"], c["achieved"])

            def loss_fn(p):
                logits, value = model.apply(p, planes, extras)
                logsm = jax.nn.log_softmax(logits)
                logp = jnp.take_along_axis(
                    logsm, b["action"][:, None], axis=1)[:, 0]
                ratio = jnp.exp(logp - b["logp"])
                pg = -jnp.minimum(
                    ratio * adv_n,
                    jnp.clip(ratio, 1 - ft.clip_eps, 1 + ft.clip_eps) * adv_n,
                ).mean()
                vc = b["value"] + jnp.clip(
                    value - b["value"], -ft.clip_eps, ft.clip_eps)
                v_loss = 0.5 * jnp.maximum(
                    (value - b["ret"]) ** 2, (vc - b["ret"]) ** 2).mean()
                ent = -(jnp.exp(logsm) * logsm).sum(-1).mean()
                if value_only:
                    loss = ft.vf_coef * v_loss
                else:
                    loss = pg + ft.vf_coef * v_loss - ft.ent_coef * ent
                return loss, (pg, v_loss, ent)

            (loss, aux), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), (loss,) + aux

        return jax.lax.scan(minibatch, (params, opt_state),
                            jnp.arange(ft.num_minibatches))

    (params, opt_state), stats = jax.lax.scan(
        epoch, (ts.params, ts.opt_state),
        jax.random.split(k_perm, ft.update_epochs))

    successes = (traj["raw"] == cfg.max_steps).sum()
    metrics = {
        "loss": stats[0].mean(),
        "pg": stats[1].mean(),
        "v_loss": stats[2].mean(),
        "entropy": stats[3].mean(),
        "success_rate": successes / jnp.maximum(traj["done"].sum(), 1),
        "done_frac": traj["done"].mean(),
    }
    return FTState(params, opt_state), env, key, metrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-params", default="runs/canonical_big/"
                    "params_targeted_c_final.msgpack")
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--hidden", type=int, default=1536)
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--updates", type=int, default=120)
    ap.add_argument("--warmup", type=int, default=15,
                    help="value-only updates before joint PPO")
    ap.add_argument("--eval-every", type=int, default=15)
    ap.add_argument("--eval-episodes", type=int, default=4096)
    ap.add_argument("--final-eval-episodes", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--ent-coef", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
        args = ap.parse_args([
            "--smoke", "--init-params", "", "--channels", "8", "--hidden",
            "32", "--envs", "16", "--updates", "2", "--warmup", "1",
            "--eval-every", "1", "--eval-episodes", "8",
            "--final-eval-episodes", "8", "--out", "/tmp/ft_smoke.json",
        ])
        cfg = EnvConfig(height=8, width=8, max_steps=40)
    else:
        from gym_craftingworld_tpu import ray_config

        cfg = ray_config()

    model, params = init_grid_policy(
        jax.random.PRNGKey(0), cfg, args.channels, args.hidden)
    if args.init_params:
        with open(args.init_params, "rb") as f:
            params = serialization.from_bytes(params, f.read())
        log(f"loaded {args.init_params}")

    ft = FTConfig(lr=args.lr, ent_coef=args.ent_coef)
    ts = FTState(params, _tx(ft).init(params))
    env = core_reset(cfg, jax.random.key_data(
        jax.random.split(jax.random.PRNGKey(args.seed), args.envs)))
    key = jax.random.PRNGKey(args.seed + 1)

    def evaluate(tag, n, seed):
        res = dagger.evaluate_grid_policy(cfg, model, ts.params, n, seed)
        log(f"eval[{tag}]: {res['success_rate']:.4f} over {n} eps")
        return res

    base = evaluate("start", args.eval_episodes, 900)
    best = (base["success_rate"], jax.device_get(ts.params), "start")
    curve = [{"update": 0, "eval": base["success_rate"]}]

    for u in range(1, args.updates + 1):
        value_only = u <= args.warmup
        ts, env, key, m = train_step(cfg, ft, model, ts, env, key,
                                     value_only)
        if u % 5 == 0 or u <= 2:
            log(f"update {u}{' (value-only)' if value_only else ''}: "
                f"train sr {float(m['success_rate']):.4f} "
                f"v_loss {float(m['v_loss']):.4f} "
                f"ent {float(m['entropy']):.3f}")
        if u % args.eval_every == 0 and u > args.warmup:
            res = evaluate(f"u{u}", args.eval_episodes, 900 + u)
            curve.append({"update": u, "eval": res["success_rate"]})
            if res["success_rate"] > best[0]:
                best = (res["success_rate"], jax.device_get(ts.params),
                        f"u{u}")

    ts = FTState(jax.device_put(best[1]), ts.opt_state)
    log(f"best checkpoint: {best[2]} ({best[0]:.4f} on the running eval)")
    final = evaluate("final(best)", args.final_eval_episodes, 31337)

    doc = {
        "config": {"envs": args.envs, "updates": args.updates,
                   "warmup_value_only": args.warmup, "lr": args.lr,
                   "ppo": ft._asdict(),
                   "init": args.init_params or "fresh (smoke)"},
        "baseline_eval": base, "final_eval": final,
        "best_checkpoint": best[2], "curve": curve,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    log(f"→ {args.out}")
    if not args.smoke and final["success_rate"] > base["success_rate"]:
        path = "runs/canonical_big/params_rl_finetuned.msgpack"
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(best[1]))
        log(f"improved policy saved → {path}")


if __name__ == "__main__":
    main()
