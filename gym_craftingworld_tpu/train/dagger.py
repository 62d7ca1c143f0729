"""BC + DAgger at scale: the trainer behind the canonical-setting policy.

train/bc.py is the small-data imitation path (flat features in host memory).
This module is the large-data path used to solve the canonical 21x21 stacked
setting with a *learned* policy:

  * the dataset lives on device as SnapDataset integer columns
    (train/demos.py) and policy features are rebuilt per minibatch
    (models/grid_policy.py), so millions of transitions train at matmul speed
    with whole epochs running as one fused scan per dispatch;
  * evaluation is a fully on-device batched greedy rollout over the real
    reset/step core — the measurement train/evaluate.py defines, at
    thousands of parallel episodes;
  * DAgger (Ross et al., AISTATS 2011): roll the *current* policy on device,
    pull only the ~40-byte snapshot rows of visited states, relabel them
    with the scripted expert on the host (train/demos.NumpyExpert), fold
    them into the dataset and keep training. This closes the covariate-shift
    gap that plain BC leaves over 300-step episodes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
import optax

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.reset import reset as core_reset
from gym_craftingworld_tpu.core.step import _step_one
from gym_craftingworld_tpu.models.grid_policy import (
    GridPolicy,
    init_grid_policy,
    planes_from_snaps,
    planes_from_state,
    snap_columns_from_state,
)
from gym_craftingworld_tpu.train.demos import (
    NumpyExpert,
    SnapDataset,
    grids_from_snaps,
    label_snapshot,
    mask_to_bits,
)

_COL_FIELDS = (
    "occ_key", "occ_code", "init_key", "init_agent_key", "agent_key",
    "holding", "desired", "achieved",
)


def device_columns(snaps: SnapDataset) -> dict:
    """Upload the feature columns + labels once; ~40 bytes/row."""
    cols = {k: jnp.asarray(getattr(snaps, k)) for k in _COL_FIELDS}
    cols["action"] = jnp.asarray(snaps.action.astype(np.int32))
    return cols


def _batch_planes(cfg: EnvConfig, cols: dict):
    return planes_from_snaps(
        cfg, cols["occ_key"], cols["occ_code"], cols["init_key"],
        cols["init_agent_key"], cols["agent_key"], cols["holding"],
        cols["desired"], cols["achieved"],
    )


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


class BCTrainState(NamedTuple):
    params: dict
    opt_state: optax.OptState


def _make_tx(lr: float):
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))


@partial(jax.jit, static_argnums=(0, 1, 2, 6), donate_argnums=(3,))
def _bc_epoch(cfg: EnvConfig, model: GridPolicy, lr: float, ts: BCTrainState,
              data: dict, perm: jax.Array, batch_size: int):
    """One epoch: fused scan over shuffled minibatches. Returns (ts, stats)."""
    tx = _make_tx(lr)
    steps = perm.shape[0] // batch_size

    def minibatch(ts, i):
        idx = jax.lax.dynamic_slice_in_dim(perm, i * batch_size, batch_size)
        mb = jax.tree.map(lambda a: a[idx], data)
        planes, extras = _batch_planes(cfg, mb)

        def loss_fn(p):
            logits, _ = model.apply(p, planes, extras)
            logp = jax.nn.log_softmax(logits)
            ce = -jnp.take_along_axis(
                logp, mb["action"][:, None], axis=1
            ).mean()
            acc = (jnp.argmax(logits, -1) == mb["action"]).mean()
            return ce, acc

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            ts.params
        )
        updates, opt_state = tx.update(grads, ts.opt_state)
        params = optax.apply_updates(ts.params, updates)
        return BCTrainState(params, opt_state), (loss, acc)

    ts, (losses, accs) = jax.lax.scan(
        minibatch, ts, jnp.arange(steps, dtype=jnp.int32)
    )
    return ts, {"loss": losses.mean(), "accuracy": accs.mean()}


def bc_train_snaps(cfg: EnvConfig, snaps: SnapDataset, key,
                   model_and_state=None, epochs: int = 10,
                   batch_size: int = 4096, lr: float = 1e-3,
                   channels: int = 64, hidden: int = 1024, log=None):
    """Clone the expert from snapshot demos. Returns (model, ts, history).

    Pass ``model_and_state=(model, BCTrainState)`` to continue training (the
    DAgger rounds do); otherwise a fresh GridPolicy is initialised.
    """
    key, k_init = jax.random.split(jax.random.PRNGKey(key) if isinstance(
        key, int) else key)
    if model_and_state is None:
        model, params = init_grid_policy(k_init, cfg, channels, hidden)
        ts = BCTrainState(params, _make_tx(lr).init(params))
    else:
        model, ts = model_and_state
    data = device_columns(snaps)
    n = snaps.num_rows
    batch_size = min(batch_size, n)
    history = []
    for ep in range(epochs):
        key, k_perm = jax.random.split(key)
        perm = jax.random.permutation(k_perm, n)
        ts, stats = _bc_epoch(cfg, model, lr, ts, data, perm, batch_size)
        stats = {k: float(v) for k, v in stats.items()}
        history.append(stats)
        if log:
            log(f"epoch {ep + 1}/{epochs}: loss {stats['loss']:.4f} "
                f"acc {stats['accuracy']:.4f}")
    return model, ts, history


# ---------------------------------------------------------------------------
# on-device evaluation (the train/evaluate.py measurement, GridPolicy family)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1))
def _eval_batch_grid(cfg: EnvConfig, model: GridPolicy, params, keys):
    state = core_reset(cfg, keys)

    def body(carry):
        st, done, reward = carry
        planes, extras = planes_from_state(cfg, st)
        logits, _ = model.apply(params, planes, extras)
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
        return st2, done, reward

    B = keys.shape[0]
    state, done, reward = jax.lax.while_loop(
        lambda c: ~jnp.all(c[1]), body,
        (state, jnp.zeros(B, bool), jnp.full(B, -1, jnp.int32)),
    )
    return {
        "success": reward == cfg.max_steps,
        "steps": state.step_num,
        "desired": state.desired,
        "achieved": state.achieved,
    }


def evaluate_grid_policy(cfg: EnvConfig, model: GridPolicy, params,
                         num_episodes: int, seed: int = 0) -> dict:
    """Greedy exact-match evaluation over ``num_episodes`` parallel episodes."""
    from gym_craftingworld_tpu.train.evaluate import summarize

    keys = jax.random.split(jax.random.PRNGKey(seed), num_episodes)
    out = _eval_batch_grid(cfg, model, params, jax.random.key_data(keys))
    return summarize(out)


# ---------------------------------------------------------------------------
# DAgger: on-policy states, expert labels
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1))
def _rollout_states(cfg: EnvConfig, model: GridPolicy, params, keys,
                    explore_key, explore_eps: float):
    """Roll the policy greedily (+eps random moves); record snapshot columns.

    Returns ([T, B] column dict, live [T, B], success [B]).
    """
    state = core_reset(cfg, keys)
    B = keys.shape[0]
    T = cfg.max_steps

    def body(carry, k_t):
        st, done, reward = carry
        cols = snap_columns_from_state(cfg, st)
        planes, extras = planes_from_state(cfg, st)
        logits, _ = model.apply(params, planes, extras)
        action = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        # eps-mix random moves for coverage (eps == 0.0 → uniform < 0, no-op)
        k_u, k_a = jax.random.split(k_t)
        rnd = jax.random.randint(k_a, (B,), 0, 4)
        action = jnp.where(
            jax.random.uniform(k_u, (B,)) < explore_eps, rnd, action
        )
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
        jax.random.split(explore_key, T),
    )
    return cols, live, reward == cfg.max_steps


# achieved bits that latch forever once set (craftingworld_ray.py:657-665,
# 686-697): MakeBread, EatBread, BuildHouse, ChopTree, ChopRock. An episode
# holding an undesired latched bit can never reach exact-match success.
_LATCH_MASK = (
    (1 << C.T_MAKE_BREAD) | (1 << C.T_EAT_BREAD) | (1 << C.T_BUILD_HOUSE)
    | (1 << C.T_CHOP_TREE) | (1 << C.T_CHOP_ROCK)
)


def collect_policy_states(cfg: EnvConfig, model: GridPolicy, params,
                          num_episodes: int, seed: int = 0,
                          explore_eps: float = 0.0,
                          max_states: int | None = None,
                          failures_only: bool = False):
    """Visited-state snapshot rows from on-policy rollouts (host arrays).

    ``failures_only`` keeps only states from episodes that end unsuccessful,
    and of those only *salvageable* states (no undesired latched achievement
    yet) — the frames after a fatal latch cannot lead to exact-match success,
    so expert labels there are noise. This is the targeted-DAgger collection
    mode: all training mass lands on the failure distribution.

    Returns ``(cols dict of [N, ...] numpy arrays, success_rate)``.
    """
    keys = jax.random.split(jax.random.PRNGKey(seed), num_episodes)
    cols, live, success = _rollout_states(
        cfg, model, params, jax.random.key_data(keys),
        jax.random.PRNGKey(seed ^ 0xDA66E4), float(explore_eps),
    )
    live = np.asarray(live)
    if failures_only:
        failed = ~np.asarray(success)  # [B]
        live = live & failed[None, :]
        ach = np.asarray(cols["achieved"]).astype(np.int64)  # [T, B]
        des = np.asarray(cols["desired"]).astype(np.int64)
        salvageable = (ach & ~des & _LATCH_MASK) == 0
        live = live & salvageable
    live = live.reshape(-1)
    host = {k: np.asarray(v).reshape((-1,) + v.shape[2:])[live]
            for k, v in cols.items()}
    if max_states is not None and len(host["agent_key"]) > max_states:
        idx = np.random.RandomState(seed).choice(
            len(host["agent_key"]), max_states, replace=False
        )
        host = {k: v[idx] for k, v in host.items()}
    return host, float(np.asarray(success).mean())


def expert_relabel(cfg: EnvConfig, cols: dict) -> SnapDataset:
    """Label snapshot rows with the scripted expert → a SnapDataset."""
    n = len(cols["agent_key"])
    snaps = SnapDataset(
        action=np.zeros(n, np.int8),
        episode=np.zeros(n, np.int32),
        **{k: cols[k] for k in _COL_FIELDS},
    )
    objects, init_objects = grids_from_snaps(cfg, snaps, np.arange(n))
    des_bits = mask_to_bits(snaps.desired)
    ach_bits = mask_to_bits(snaps.achieved)
    W = cfg.width
    expert = NumpyExpert()
    labels = np.zeros(n, np.int8)
    for i in range(n):
        ak = int(snaps.agent_key[i])
        labels[i] = label_snapshot(
            expert, objects[i], (ak // W, ak % W), int(snaps.holding[i]),
            init_objects[i], des_bits[i], ach_bits[i],
        )
    return snaps._replace(action=labels)


def dagger_round(cfg: EnvConfig, model, ts: BCTrainState,
                 dataset: SnapDataset, round_idx: int, key,
                 num_episodes: int = 512, max_states: int = 200_000,
                 epochs: int = 3, batch_size: int = 4096, lr: float = 3e-4,
                 explore_eps: float = 0.02, log=None):
    """One DAgger iteration: rollout → relabel → aggregate → train.

    Returns (ts, dataset, info).
    """
    cols, sr = collect_policy_states(
        cfg, model, ts.params, num_episodes, seed=1000 + round_idx,
        explore_eps=explore_eps, max_states=max_states,
    )
    labeled = expert_relabel(cfg, cols)
    dataset = SnapDataset.concat(dataset, labeled)
    if log:
        log(f"dagger round {round_idx}: rollout success {sr:.3f}, "
            f"+{labeled.num_rows} rows → {dataset.num_rows} total")
    model, ts, hist = bc_train_snaps(
        cfg, dataset, key, model_and_state=(model, ts), epochs=epochs,
        batch_size=batch_size, lr=lr, log=log,
    )
    return ts, dataset, {"rollout_success": sr, "history": hist}
