"""PPO over the packed-key engine — the throughput training path.

The reference-parity PPO (train/ppo.py) steps the grid engine and runs a full
fresh reset (including goal imagination) for *every* env *every* step of the
rollout scan. This trainer redesigns the loop around a large device batch:

* **Engine**: rollouts step ``ops/packed_rollout._step_p_unrolled`` — the
  slot-unrolled packed int16 slot engine behind the rollout benchmark —
  inside the collect scan. Policy inference runs in the same transposed
  layout: features are built as ``[F, B]`` and every matmul is
  ``W[h, F] @ feat[F, B]`` with bf16 inputs and fp32 accumulation.

* **Two-phase auto-reset**: finished envs pull a fresh world from an
  on-device pool of 2B pre-placed states — a contiguous slice through a
  per-step rotating window — and the pool itself is regenerated from the
  step key once per update, outside the scan. Placement
  uses the same ordered-top-k-of-iid-uniforms trick as core/reset.sample_world
  (provably the reference's sample_state distribution,
  craftingworld_ray.py:599-628), and tasks are drawn per pool entry with
  core/reset.sample_desired (:169-176). Pulling pre-generated worlds at reset
  is the reference's own ``fixed_init_state`` semantics (:630-644) — with the
  pool refreshed every update, so worlds do not repeat across updates. Goal
  *images* are never materialised: the slot policy conditions on the desired
  task bits directly, which carry strictly more information than the rendered
  goal (render/raster.py reconstructs the image from exactly these bits plus
  the init state).

* **Storage**: rollouts store the bf16 feature matrix itself (``[T, F, B]``,
  ~124 MB at 16k envs x 64 steps) rather than observations — the same tensor
  the update consumes, so minibatching is a pure column gather and the policy
  sees bit-identical inputs in collect and update.

Measured rates on the H100 are in PERF.md; ``chip_smoke.py`` and
``tools/fast_ppo_bench.py`` time ``train_many_fast``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.reset import sample_desired
from gym_craftingworld_tpu.ops.packed_rollout import (
    PackedState,
    _step_p_unrolled,
)

i16 = jnp.int16
bf16 = jnp.bfloat16
_BITS9 = np.arange(9, dtype=np.int32)


class FastPPOConfig(NamedTuple):
    rollout_steps: int = 64
    update_epochs: int = 2
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 512

    @classmethod
    def throughput(cls, **overrides) -> "FastPPOConfig":
        """The wall-clock preset: 1 epoch, hidden 384.

        Half the update work of the default per iteration. On an earlier
        accelerator's sweep it learned as fast per second of wall clock as
        the default (tail success/step 0.0099 vs 0.0101, within seed noise);
        the default wins per *env-step*, i.e. when samples are the scarce
        resource. Its rate on the H100 is in PERF.md.
        """
        return cls(update_epochs=1, hidden=384)._replace(**overrides)


# ---------------------------------------------------------------------------
# fresh worlds, directly in the packed layout
# ---------------------------------------------------------------------------


def fresh_packed_batch(cfg: EnvConfig, key: jax.Array, n: int) -> PackedState:
    """Sample ``n`` freshly-reset worlds straight into PackedState columns.

    Equivalent in distribution to reset() minus the goal image: one of each
    of the 8 objects + the agent on distinct uniform cells (ordered top-k of
    iid uniforms == the reference's diag-shuffle, craftingworld_ray.py:605-613)
    and a task mask from sample_desired (:169-176). The agent's spawn cell
    holds no object, so obj_here=0 and icode_here=AGENT_INIT_MARK exactly.
    """
    k_place, k_task = jax.random.split(key)
    scores = jax.random.uniform(k_place, (n, cfg.n_cells))
    _, idx = jax.lax.top_k(scores, C.N_OBJECTS + 1)  # [n, 9] distinct cells
    slot_key = idx[:, : C.N_OBJECTS].T.astype(i16)  # [8, n]
    agent_key = idx[:, C.N_OBJECTS].astype(i16)  # [n]
    types = jnp.broadcast_to(
        jnp.arange(1, C.N_OBJECTS + 1, dtype=i16)[:, None], (C.N_OBJECTS, n)
    )
    desired_rows = jax.vmap(partial(sample_desired, cfg))(
        jax.random.split(k_task, n)
    )  # [n, 9] int8
    desired = jnp.sum(
        desired_rows.astype(jnp.int32) << _BITS9[None, :], axis=1
    ).astype(i16)
    zeros = jnp.zeros((n,), i16)
    W = i16(cfg.width)
    return PackedState(
        slot_key=slot_key,
        slot_type=types,
        init_key=slot_key,
        init_type=types,
        agent_r=agent_key // W,
        agent_c=agent_key % W,
        holding=zeros,
        obj_here=zeros,
        icode_here=jnp.full((n,), C.AGENT_INIT_MARK, i16),
        achieved=zeros,
        desired=desired,
        init_agent_key=agent_key,
        step_num=zeros,
    )


def _pool_take(pool: PackedState, idx: jax.Array) -> PackedState:
    """Gather pool columns ``idx`` int[B] → a PackedState batch of B."""
    return jax.tree.map(lambda x: x[..., idx], pool)


def _pool_slice(pool: PackedState, off, B: int) -> PackedState:
    """Contiguous B-column window of the pool starting at ``off``.

    A dynamic slice moves the same bytes as a random per-env gather of pool
    columns, in one contiguous copy instead of a minor-axis gather. The window
    offset rotates by an odd stride per step, so an env resetting at two
    different steps draws two different worlds, and two envs never share a
    world within a step. Pool entries are iid, so which entry an env gets
    carries no information.
    """
    return jax.tree.map(
        lambda x: jax.lax.dynamic_slice_in_dim(x, off, B, axis=x.ndim - 1),
        pool,
    )


def _autoreset(state: PackedState, fresh: PackedState, done) -> PackedState:
    return jax.tree.map(lambda f, s: jnp.where(done, f, s), fresh, state)


# ---------------------------------------------------------------------------
# policy: feature-major MLP (params fp32, matmuls bf16 -> fp32)
# ---------------------------------------------------------------------------


def feature_rows(cfg: EnvConfig) -> int:
    return 5 * C.N_OBJECTS + 27


def features(cfg: EnvConfig, s: PackedState) -> jax.Array:
    """Packed state → bf16[F, B] policy features (batch on the minor axis)."""
    HW = cfg.height * cfg.width
    key = s.slot_key.astype(jnp.int32)  # [8, B]
    on = key < HW
    held = key == HW
    r = jnp.where(on, key // cfg.width, 0)
    c = jnp.where(on, key % cfg.width, 0)
    f = bf16
    hold = s.holding.astype(jnp.int32)
    des = s.desired.astype(jnp.int32)
    ach = s.achieved.astype(jnp.int32)
    rows = [
        s.slot_type.astype(f) * f(1 / 8),  # 8
        r.astype(f) * f(1 / cfg.height),  # 8
        c.astype(f) * f(1 / cfg.width),  # 8
        on.astype(f),  # 8
        held.astype(f),  # 8
        s.agent_r.astype(f)[None] * f(1 / cfg.height),  # 1
        s.agent_c.astype(f)[None] * f(1 / cfg.width),  # 1
        jnp.stack([(hold == h).astype(f) for h in range(4)]),  # 4
        ((des[None, :] >> _BITS9[:, None]) & 1).astype(f),  # 9
        ((ach[None, :] >> _BITS9[:, None]) & 1).astype(f),  # 9
        s.obj_here.astype(f)[None] * f(1 / 8),  # 1
        s.icode_here.astype(f)[None] * f(1 / 10),  # 1
        s.step_num.astype(f)[None] * f(1 / cfg.max_steps),  # 1
    ]
    return jnp.concatenate(rows, axis=0)  # [F, B]


class MLPParams(NamedTuple):
    w1: jax.Array  # [H, F]
    b1: jax.Array  # [H]
    w2: jax.Array  # [H, H]
    b2: jax.Array  # [H]
    wl: jax.Array  # [6, H]
    bl: jax.Array  # [6]
    wv: jax.Array  # [1, H]
    bv: jax.Array  # [1]


def init_params(key, cfg: EnvConfig, fppo: FastPPOConfig) -> MLPParams:
    F, H = feature_rows(cfg), fppo.hidden
    k1, k2, k3, k4 = jax.random.split(key, 4)
    he = lambda k, shp, fan: jax.random.normal(k, shp) * np.sqrt(2.0 / fan)
    return MLPParams(
        w1=he(k1, (H, F), F),
        b1=jnp.zeros((H,)),
        w2=he(k2, (H, H), H),
        b2=jnp.zeros((H,)),
        wl=0.01 * he(k3, (C.N_ACTIONS, H), H),
        bl=jnp.zeros((C.N_ACTIONS,)),
        wv=he(k4, (1, H), H),
        bv=jnp.zeros((1,)),
    )


def _mm(w, x):
    """bf16 matmul, fp32 accumulation: [h, F] @ [F, B] -> f32[h, B]."""
    return jax.lax.dot_general(
        w.astype(bf16), x.astype(bf16),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def apply_policy(p: MLPParams, feat: jax.Array):
    """feat [F, B] → (logits f32[6, B], value f32[B])."""
    h = jax.nn.relu(_mm(p.w1, feat) + p.b1[:, None])
    h = jax.nn.relu(_mm(p.w2, h) + p.b2[:, None])
    logits = _mm(p.wl, h) + p.bl[:, None]
    value = (_mm(p.wv, h) + p.bv[:, None])[0]
    return logits, value


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


class FastTrainState(NamedTuple):
    params: MLPParams
    opt_state: optax.OptState
    update_idx: jax.Array


class _Traj(NamedTuple):
    feat: jax.Array  # bf16[T, F, B]
    action: jax.Array  # int32[T, B]
    log_prob: jax.Array  # f32[T, B]
    value: jax.Array  # f32[T, B]
    reward: jax.Array  # f32[T, B]
    done: jax.Array  # bool[T, B]
    raw_reward: jax.Array  # int32[T, B] (reference-scale, for metrics)


def make_optimizer(fppo: FastPPOConfig):
    return optax.chain(
        optax.clip_by_global_norm(fppo.max_grad_norm),
        optax.adam(fppo.lr),
    )


def init_fast_train_state(key, cfg: EnvConfig,
                          fppo: FastPPOConfig) -> FastTrainState:
    params = init_params(key, cfg, fppo)
    return FastTrainState(
        params=params,
        opt_state=make_optimizer(fppo).init(params),
        update_idx=jnp.int32(0),
    )


def _sample_action(key, logits):
    """Gumbel-argmax over the action axis (axis 0); returns (action, log_prob)."""
    u = jax.random.uniform(key, logits.shape, minval=1e-7, maxval=1.0)
    g = logits - jnp.log(-jnp.log(u))
    action = jnp.argmax(g, axis=0).astype(jnp.int32)  # [B]
    logsm = jax.nn.log_softmax(logits, axis=0)
    onehot = (jnp.arange(logits.shape[0])[:, None] == action[None, :])
    log_prob = jnp.sum(onehot * logsm, axis=0)
    return action, log_prob


def _collect(cfg: EnvConfig, fppo: FastPPOConfig, params: MLPParams,
             env: PackedState, pool: PackedState, key):
    B = env.agent_r.shape[-1]

    def body(carry, inp):
        st = carry
        k_act, t = inp
        feat = features(cfg, st)
        logits, value = apply_policy(params, feat)
        action, log_prob = _sample_action(k_act, logits)
        st2, res = _step_p_unrolled(cfg, st, action.astype(i16))
        reward = jnp.where(
            res.reward == cfg.max_steps, 1.0, -1.0 / cfg.max_steps
        ).astype(jnp.float32)
        off = (t * jnp.int32(12007)) % jnp.int32(B)  # odd stride, full period
        st2 = _autoreset(st2, _pool_slice(pool, off, B), res.done)
        tr = _Traj(feat=feat, action=action, log_prob=log_prob, value=value,
                   reward=reward, done=res.done, raw_reward=res.reward)
        return st2, tr

    keys = jax.random.split(key, fppo.rollout_steps)
    steps = jnp.arange(fppo.rollout_steps, dtype=jnp.int32)
    return jax.lax.scan(body, env, (keys, steps))


def _gae(fppo: FastPPOConfig, traj: _Traj, last_value):
    def body(carry, tr):
        gae, next_value = carry
        not_done = 1.0 - tr.done.astype(jnp.float32)
        delta = tr.reward + fppo.gamma * next_value * not_done - tr.value
        gae = delta + fppo.gamma * fppo.gae_lambda * not_done * gae
        return (gae, tr.value), gae

    (_, _), adv = jax.lax.scan(
        body, (jnp.zeros_like(last_value), last_value), traj, reverse=True
    )
    return adv, adv + traj.value


def _mm_bm(x, w, dtype=bf16):
    """Batch-major bf16 matmul: x[N, K] contracted with w[H, K] -> f32[N, H].

    The update phase runs batch-major while the collect runs feature-major:
    with the batch minor ([F, B]) every weight gradient contracts over the
    minor axis, which XLA lowers through full activation transposes.
    Batch-major activations give the standard weight-gradient lowering
    (contraction over the major axis) at identical math.
    """
    return jax.lax.dot_general(
        x.astype(dtype), w.astype(dtype),
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def apply_policy_bm(p: MLPParams, feat: jax.Array, dtype=bf16):
    """feat [N, F] → (logits f32[6, N], value f32[N]); same math as
    :func:`apply_policy`. ``dtype`` is the operand and residual type:
    bf16 in training, float32 for a full-precision reference.

    Hybrid layout: the trunk is batch-major (efficient weight gradients),
    stored bf16 (every consumer casts to bf16 anyway, so only the residuals'
    storage precision changes, and it halves their memory traffic). The
    heads come out feature-major [6, N] / [1, N], so the loss's elementwise
    chains run over the long batch axis rather than over 6 actions.
    """
    # Cast the *pre-activation* to bf16: the f32 matmul accumulator then
    # lives only inside the fusion, so the stored residual and every big
    # backward cotangent are bf16 rather than f32 [131072, 512] arrays.
    h = jax.nn.relu((_mm_bm(feat, p.w1, dtype) + p.b1[None, :]).astype(dtype))
    h = jax.nn.relu((_mm_bm(h, p.w2, dtype) + p.b2[None, :]).astype(dtype))
    # [6, H] x [N, H] -> [6, N]: contraction over H, no transpose of h
    logits = jax.lax.dot_general(
        p.wl.astype(dtype), h, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) + p.bl[:, None]
    value = (
        jax.lax.dot_general(
            p.wv.astype(dtype), h, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        + p.bv[:, None]
    )[0]
    return logits, value


def _loss(fppo: FastPPOConfig, params: MLPParams, batch):
    feat, action, old_log_prob, old_value, adv, ret = batch
    logits, value = apply_policy(params, feat)  # feat [F, M]
    logsm = jax.nn.log_softmax(logits, axis=0)
    onehot = (jnp.arange(logits.shape[0])[:, None] == action[None, :])
    log_prob = jnp.sum(onehot * logsm, axis=0)
    ratio = jnp.exp(log_prob - old_log_prob)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg = -jnp.minimum(
        ratio * adv_n,
        jnp.clip(ratio, 1 - fppo.clip_eps, 1 + fppo.clip_eps) * adv_n,
    ).mean()
    v_clipped = old_value + jnp.clip(
        value - old_value, -fppo.clip_eps, fppo.clip_eps
    )
    v_loss = 0.5 * jnp.maximum(
        (value - ret) ** 2, (v_clipped - ret) ** 2
    ).mean()
    entropy = -(jnp.exp(logsm) * logsm).sum(0).mean()
    loss = pg + fppo.vf_coef * v_loss - fppo.ent_coef * entropy
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy}


def _loss_bm(fppo: FastPPOConfig, params: MLPParams, batch, dtype=bf16):
    """Batch-major-trunk clipped-surrogate loss; same math as :func:`_loss`.

    ``dtype`` as in :func:`apply_policy_bm`.
    """
    feat, action, old_log_prob, old_value, adv, ret = batch  # feat [N, F]
    logits, value = apply_policy_bm(params, feat, dtype)  # logits [6, N]
    logsm = jax.nn.log_softmax(logits, axis=0)
    onehot = (jnp.arange(logits.shape[0])[:, None] == action[None, :])
    log_prob = jnp.sum(onehot * logsm, axis=0)
    ratio = jnp.exp(log_prob - old_log_prob)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg = -jnp.minimum(
        ratio * adv_n,
        jnp.clip(ratio, 1 - fppo.clip_eps, 1 + fppo.clip_eps) * adv_n,
    ).mean()
    v_clipped = old_value + jnp.clip(
        value - old_value, -fppo.clip_eps, fppo.clip_eps
    )
    v_loss = 0.5 * jnp.maximum(
        (value - ret) ** 2, (v_clipped - ret) ** 2
    ).mean()
    entropy = -(jnp.exp(logsm) * logsm).sum(0).mean()
    loss = pg + fppo.vf_coef * v_loss - fppo.ent_coef * entropy
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy}


def shuffle_block(T: int, B: int, num_minibatches: int) -> int:
    """Shuffle-block rows: the largest power-of-two multiple of 128 (≤ 2048)
    that tiles every minibatch AND leaves ≥ 8 blocks per minibatch, so each
    minibatch mixes independently drawn (timestep, env) slabs rather than
    collapsing into 1-2 contiguous tiles at small T*B. At the default config
    (131k rows/minibatch) this returns 2048. Tiny minibatches that can't fit
    8 blocks get the smallest tiling block (most mixing available).
    """
    rows_mb = (T * B) // num_minibatches
    cands = [blk for blk in (2048, 1024, 512, 256, 128) if rows_mb % blk == 0]
    if not cands:
        raise ValueError(
            f"rollout_steps*batch/num_minibatches ({rows_mb}) must be a "
            f"multiple of 128 for block-shuffled minibatching"
        )
    for blk in cands:
        if blk * 8 <= rows_mb:
            return blk
    return cands[-1]


def _update_phase(fppo: FastPPOConfig, ts: FastTrainState, traj: "_Traj",
                  adv, ret, k_perm):
    """GAE-to-optimizer tail of one PPO iteration (shared with the profiler).

    Shuffle blocks are (timestep, env-span) tiles of :func:`shuffle_block`
    rows (2048 at production shapes). With envs iid and blocks drawn across
    all timesteps, minibatch mixing is preserved as long as each minibatch
    receives several independently drawn blocks — :func:`shuffle_block`
    guarantees ≥ 8 whenever the shapes allow. Gradients are autodiff of
    :func:`_loss_bm`.
    """
    T, B = traj.action.shape
    F = traj.feat.shape[1]
    BLK = shuffle_block(T, B, fppo.num_minibatches)
    NB = (T * B) // BLK
    featb = jnp.transpose(traj.feat, (0, 2, 1)).reshape(NB, BLK, F)
    blk = lambda x: x.reshape(NB, BLK)
    vecs = (
        blk(traj.action),
        blk(traj.log_prob),
        blk(traj.value),
        blk(adv),
        blk(ret),
    )
    optimizer = make_optimizer(fppo)
    nbm = NB // fppo.num_minibatches
    mb = nbm * BLK

    def epoch(carry, k_e):
        params, opt_state = carry
        perm = jax.random.permutation(k_e, NB)

        def minibatch(carry, i):
            params, opt_state = carry
            ids = jax.lax.dynamic_slice_in_dim(perm, i * nbm, nbm)
            batch = (featb[ids].reshape(mb, F),) + tuple(
                x[ids].reshape(mb) for x in vecs)
            (loss, aux), grads = jax.value_and_grad(
                lambda p: _loss_bm(fppo, p, batch), has_aux=True
            )(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), (loss, aux)

        return jax.lax.scan(
            minibatch, (params, opt_state), jnp.arange(fppo.num_minibatches)
        )

    (params, opt_state), (losses, auxes) = jax.lax.scan(
        epoch, (ts.params, ts.opt_state),
        jax.random.split(k_perm, fppo.update_epochs),
    )
    return params, opt_state, losses, auxes


@partial(jax.jit, static_argnums=(0, 1), donate_argnums=(2,))
def train_step_fast(cfg: EnvConfig, fppo: FastPPOConfig, ts: FastTrainState,
                    env: PackedState, key):
    """One PPO iteration on the packed engine. Returns (ts, env, key, metrics)."""
    key, k_pool, k_roll, k_perm = jax.random.split(key, 4)
    B_env = env.agent_r.shape[-1]
    pool = fresh_packed_batch(cfg, k_pool, 2 * B_env)
    env, traj = _collect(cfg, fppo, ts.params, env, pool, k_roll)
    _, last_value = apply_policy(ts.params, features(cfg, env))
    adv, ret = _gae(fppo, traj, last_value)

    T, B = traj.action.shape
    # Shuffle in blocks of rows, not per sample: permuting whole blocks along
    # the major axis is a contiguous copy instead of a fine-grained gather of
    # T*B single rows.
    shuffle_block(T, B, fppo.num_minibatches)  # raises if shapes don't tile
    params, opt_state, losses, auxes = _update_phase(
        fppo, ts, traj, adv, ret, k_perm
    )

    successes = (traj.raw_reward == cfg.max_steps).sum()
    metrics = {
        "loss": losses.mean(),
        "reward_mean": traj.reward.mean(),
        "episode_done_frac": traj.done.mean(),
        "success_rate": successes / jnp.maximum(traj.done.sum(), 1),
        "success_per_step": successes / (T * B),
        **{k: v.mean() for k, v in auxes.items()},
    }
    ts = FastTrainState(params=params, opt_state=opt_state,
                        update_idx=ts.update_idx + 1)
    return ts, env, key, metrics


@partial(jax.jit, static_argnums=(0, 1, 4), donate_argnums=(2,))
def train_many_fast(cfg: EnvConfig, fppo: FastPPOConfig, ts: FastTrainState,
                    env: PackedState, num_updates: int, key):
    """``num_updates`` fully-on-device PPO iterations in one dispatch.

    Metrics come back stacked [num_updates]; use this for throughput
    measurement (one dispatch, no host round trip per update) and long
    training runs.
    """

    def body(carry, _):
        ts, env, key = carry
        ts, env, key, metrics = train_step_fast(cfg, fppo, ts, env, key)
        return (ts, env, key), metrics

    (ts, env, key), metrics = jax.lax.scan(
        body, (ts, env, key), None, length=num_updates
    )
    return ts, env, key, metrics
