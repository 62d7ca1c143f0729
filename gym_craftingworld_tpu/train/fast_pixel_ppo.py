"""Fast PPO for policies that LOOK at the world: CNN over the one-hot grid.

The pixel/grid model families trained only through the
parity-grade trainer (~1e5 env-steps/s); this trainer gives an agent that
consumes the reference's spatial observation a throughput path. Same loop
shape as train/fast_ppo.py (packed engine, pool auto-reset, GAE, clipped
surrogate, block-shuffled minibatches), with two changes:

* **Storage = state, not features.** Rollouts store the ~80-byte PackedState
  columns per step instead of observations; the (B, H, W, 12) one-hot grid a
  pixel agent reads (render/raster.render_onehot semantics: channels 0-7
  object, 8 agent, 9-11 held item at the agent's cell — reference
  craftingworld_ray.py:94-98) is re-rendered on device from the stored state
  inside both the collect scan and every update minibatch. Rendering is 8
  compare-selects per cell (ops/obs_rollout.slots_to_codes design) — far
  cheaper than the HBM it would take to store T full observation batches
  (uint8[16384, 21, 21, 12] is 86 MB *per step*).

* **Policy = conv stem.** Strided 3x3 convs in bf16 NHWC over the grid, goal
  and holding bits fused at the dense layer. The default stem is sized so a
  16k-env update stays matmul-bound.

The observation the policy consumes equals the reference's
`observation_vector['observation']` one-hot (+ goal bits the reference
carries alongside, :354-360) — this is the "agent that actually looks at the
grid" path, at ~100x the parity trainer's rate.
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
from gym_craftingworld_tpu.ops.packed_rollout import (
    PackedState,
    _step_p_unrolled,
)
from gym_craftingworld_tpu.train.fast_ppo import (
    FastPPOConfig,
    _autoreset,
    _gae,
    _pool_slice,
    _sample_action,
    fresh_packed_batch,
    make_optimizer,
)

bf16 = jnp.bfloat16
i16 = jnp.int16
_BITS9 = np.arange(9, dtype=np.int32)


class PixelPPOConfig(NamedTuple):
    rollout_steps: int = 64
    update_epochs: int = 2
    num_minibatches: int = 16
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    conv1: int = 32
    conv2: int = 64
    hidden: int = 256
    stride1: int = 2  # first-conv stride; the throughput preset uses 3

    @classmethod
    def throughput(cls, **overrides) -> "PixelPPOConfig":
        """Wall-clock-leaning preset: 1 epoch, 8 minibatches, slimmer stem.

        Mirrors ``FastPPOConfig.throughput()``: when wall-clock (not sample
        count) is the scarce resource, cutting epochs/width buys more
        updates per second at matched-or-better learning per second on the
        single-task benchmark (docs/pixel_canonical.json records both
        configs' measured rates and curves).
        """
        return cls(update_epochs=1, num_minibatches=8, conv1=16, conv2=32,
                   hidden=192, stride1=3)._replace(**overrides)

    @property
    def as_fast(self) -> FastPPOConfig:
        """The shared-loop view (gae/optimizer/clipping knobs)."""
        return FastPPOConfig(
            rollout_steps=self.rollout_steps,
            update_epochs=self.update_epochs,
            num_minibatches=self.num_minibatches,
            gamma=self.gamma, gae_lambda=self.gae_lambda,
            clip_eps=self.clip_eps, vf_coef=self.vf_coef,
            ent_coef=self.ent_coef, lr=self.lr,
            max_grad_norm=self.max_grad_norm, hidden=self.hidden,
        )


# ---------------------------------------------------------------------------
# observation: packed state → one-hot grid + goal bits (on device, fused)
# ---------------------------------------------------------------------------


def render_grid_obs(cfg: EnvConfig, s: PackedState):
    """(grid bf16[B, H, W, 12], bits bf16[B, 22]) from packed columns.

    Grid matches render/raster.render_onehot: channels 0-7 object one-hot,
    8 agent, 9-11 held item in the agent's cell. Built with compare-selects
    (no scatters): each slot key is compared against the cell iota and its
    type select-summed into the object channels.
    """
    B = s.agent_r.shape[-1]
    HW = cfg.n_cells
    key = s.slot_key.astype(jnp.int32)  # [8, B]
    cells = jnp.arange(HW, dtype=jnp.int32)
    # Per-cell object CODE by fused compare-accumulate (one object per cell,
    # core/slots.py invariant), then one-hot channels. The previous
    # formulation materialized an [8, B, HW] bf16 on-cell tensor plus an
    # einsum — 8x the bytes of the output and a size-8 contraction;
    # this chain is 8 fused elementwise passes over [B, HW] and one
    # compare-expand, bit-identical results.
    typ = s.slot_type.astype(jnp.int32)
    code = jnp.zeros((B, HW), jnp.int32)
    for i in range(C.N_OBJECTS):
        code = code + typ[i][:, None] * (key[i][:, None] == cells[None, :])
    obj = (
        code[:, :, None] == jnp.arange(1, C.N_OBJECTS + 1)[None, None, :]
    ).astype(bf16)  # [B, HW, 8]
    agent_key = (
        s.agent_r.astype(jnp.int32) * cfg.width + s.agent_c.astype(jnp.int32)
    )
    agent = jax.nn.one_hot(agent_key, HW, dtype=bf16)[..., None]  # [B,HW,1]
    held_oh = jax.nn.one_hot(
        s.holding.astype(jnp.int32) - 1, 3, dtype=bf16
    )  # [B, 3]; 0 → zero row
    held = agent * held_oh[:, None, :]  # [B, HW, 3]
    grid = jnp.concatenate([obj, agent, held], axis=-1).reshape(
        B, cfg.height, cfg.width, C.N_CHANNELS
    )
    des = ((s.desired.astype(jnp.int32)[:, None] >> _BITS9) & 1).astype(bf16)
    ach = ((s.achieved.astype(jnp.int32)[:, None] >> _BITS9) & 1).astype(bf16)
    hold4 = jax.nn.one_hot(s.holding.astype(jnp.int32), 4, dtype=bf16)
    bits = jnp.concatenate([des, ach, hold4], axis=-1)  # [B, 22]
    return grid, bits


# ---------------------------------------------------------------------------
# the conv policy
# ---------------------------------------------------------------------------


class ConvParams(NamedTuple):
    k1: jax.Array  # [3, 3, 12, C1]
    b1: jax.Array
    k2: jax.Array  # [3, 3, C1, C2]
    b2: jax.Array
    w1: jax.Array  # [flat + 22, H]
    bd: jax.Array
    wl: jax.Array  # [H, 6]
    bl: jax.Array
    wv: jax.Array  # [H, 1]
    bv: jax.Array


def _flat_dim(cfg: EnvConfig, ppo: PixelPPOConfig) -> int:
    s1 = ppo.stride1
    h = (cfg.height + s1 - 1) // s1
    h = (h + 1) // 2
    w = (cfg.width + s1 - 1) // s1
    w = (w + 1) // 2
    return h * w * ppo.conv2


def init_pixel_params(key, cfg: EnvConfig, ppo: PixelPPOConfig) -> ConvParams:
    ks = jax.random.split(key, 5)
    he = lambda k, shp, fan: (
        jax.random.normal(k, shp) * np.sqrt(2.0 / fan)
    ).astype(jnp.float32)
    flat = _flat_dim(cfg, ppo)
    return ConvParams(
        k1=he(ks[0], (3, 3, C.N_CHANNELS, ppo.conv1), 9 * C.N_CHANNELS),
        b1=jnp.zeros((ppo.conv1,)),
        k2=he(ks[1], (3, 3, ppo.conv1, ppo.conv2), 9 * ppo.conv1),
        b2=jnp.zeros((ppo.conv2,)),
        w1=he(ks[2], (flat + 22, ppo.hidden), flat + 22),
        bd=jnp.zeros((ppo.hidden,)),
        wl=0.01 * he(ks[3], (ppo.hidden, C.N_ACTIONS), ppo.hidden),
        bl=jnp.zeros((C.N_ACTIONS,)),
        wv=he(ks[4], (ppo.hidden, 1), ppo.hidden),
        bv=jnp.zeros((1,)),
    )


def _conv(x, k, stride):
    # pure-bf16 conv (accumulated in f32 internally); a mixed
    # bf16-input/f32-output conv has no valid vjp in lax
    return jax.lax.conv_general_dilated(
        x.astype(bf16), k.astype(bf16), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


def apply_pixel_policy(p: ConvParams, grid, bits, stride1: int = 2):
    """(grid bf16[B,H,W,12], bits bf16[B,22]) → (logits f32[B,6], value f32[B])."""
    x = jax.nn.relu(_conv(grid, p.k1, stride1) + p.b1.astype(bf16))
    x = jax.nn.relu(_conv(x, p.k2, 2) + p.b2.astype(bf16))
    x = x.reshape(x.shape[0], -1)
    x = jnp.concatenate([x, bits], axis=-1)
    h = jax.nn.relu(
        jax.lax.dot_general(
            x, p.w1.astype(bf16), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        + p.bd
    ).astype(bf16)
    logits = h @ p.wl.astype(bf16) + p.bl
    value = (h @ p.wv.astype(bf16) + p.bv)[:, 0]
    return logits.astype(jnp.float32), value.astype(jnp.float32)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


class PixelTrainState(NamedTuple):
    params: ConvParams
    opt_state: optax.OptState
    update_idx: jax.Array


class _PTraj(NamedTuple):
    state: PackedState  # stacked [T, ...] packed columns (the stored "obs")
    action: jax.Array  # int32[T, B]
    log_prob: jax.Array
    value: jax.Array
    reward: jax.Array
    done: jax.Array
    raw_reward: jax.Array


def init_pixel_train_state(key, cfg: EnvConfig,
                           ppo: PixelPPOConfig) -> PixelTrainState:
    params = init_pixel_params(key, cfg, ppo)
    return PixelTrainState(
        params=params,
        opt_state=make_optimizer(ppo.as_fast).init(params),
        update_idx=jnp.int32(0),
    )


def _policy_tb(p: ConvParams, cfg: EnvConfig, st: PackedState,
               stride1: int = 2):
    """Policy on the lane-major packed state: logits [6, B], value [B]."""
    grid, bits = render_grid_obs(cfg, st)
    logits, value = apply_pixel_policy(p, grid, bits, stride1)
    return logits.T, value


def _collect_pixel(cfg: EnvConfig, ppo: PixelPPOConfig, params: ConvParams,
                   env: PackedState, pool: PackedState, key):
    B = env.agent_r.shape[-1]

    def body(carry, inp):
        st = carry
        k_act, t = inp
        logits, value = _policy_tb(params, cfg, st, ppo.stride1)
        action, log_prob = _sample_action(k_act, logits)
        st2, res = _step_p_unrolled(cfg, st, action.astype(i16))
        reward = jnp.where(
            res.reward == cfg.max_steps, 1.0, -1.0 / cfg.max_steps
        ).astype(jnp.float32)
        off = (t * jnp.int32(12007)) % jnp.int32(B)
        st2 = _autoreset(st2, _pool_slice(pool, off, B), res.done)
        tr = _PTraj(state=st, action=action, log_prob=log_prob, value=value,
                    reward=reward, done=res.done, raw_reward=res.reward)
        return st2, tr

    keys = jax.random.split(key, ppo.rollout_steps)
    steps = jnp.arange(ppo.rollout_steps, dtype=jnp.int32)
    return jax.lax.scan(body, env, (keys, steps))


def _pixel_loss(ppo: PixelPPOConfig, params: ConvParams, cfg: EnvConfig,
                batch):
    st, action, old_log_prob, old_value, adv, ret = batch
    grid, bits = render_grid_obs(cfg, st)
    logits, value = apply_pixel_policy(params, grid, bits,
                                       ppo.stride1)  # [M, 6], [M]
    logsm = jax.nn.log_softmax(logits, axis=-1)
    log_prob = jnp.take_along_axis(logsm, action[:, None], axis=1)[:, 0]
    ratio = jnp.exp(log_prob - old_log_prob)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg = -jnp.minimum(
        ratio * adv_n,
        jnp.clip(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * adv_n,
    ).mean()
    v_clipped = old_value + jnp.clip(
        value - old_value, -ppo.clip_eps, ppo.clip_eps
    )
    v_loss = 0.5 * jnp.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
    entropy = -(jnp.exp(logsm) * logsm).sum(-1).mean()
    loss = pg + ppo.vf_coef * v_loss - ppo.ent_coef * entropy
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy}


@partial(jax.jit, static_argnums=(0, 1), donate_argnums=(2,))
def train_step_pixel(cfg: EnvConfig, ppo: PixelPPOConfig,
                     ts: PixelTrainState, env: PackedState, key):
    """One PPO iteration of the grid-observation CNN policy."""
    key, k_pool, k_roll, k_perm = jax.random.split(key, 4)
    B = env.agent_r.shape[-1]
    pool = fresh_packed_batch(cfg, k_pool, 2 * B)
    env, traj = _collect_pixel(cfg, ppo, ts.params, env, pool, k_roll)
    _, last_value = _policy_tb(ts.params, cfg, env, ppo.stride1)
    adv, ret = _gae(ppo.as_fast, traj, last_value)

    T, Bb = traj.action.shape
    BLK = 128
    if (T * Bb) % (BLK * ppo.num_minibatches):
        raise ValueError(
            f"rollout_steps*batch ({T}*{Bb}) must be a multiple of "
            f"{BLK}*num_minibatches"
        )
    NB = (T * Bb) // BLK
    # state columns: [T, ..., B] → [..., NB, BLK] (lane-tile blocks)
    blk_state = jax.tree.map(
        lambda x: jnp.moveaxis(x, 0, -2).reshape(x.shape[1:-1] + (NB, BLK))
        if x.ndim == 3
        else x.reshape(NB, BLK),
        traj.state,
    )
    blk = lambda x: x.reshape(NB, BLK)
    rest = (blk(traj.action), blk(traj.log_prob), blk(traj.value),
            blk(adv), blk(ret))
    optimizer = make_optimizer(ppo.as_fast)

    def epoch(carry, k_e):
        params, opt_state = carry
        perm = jax.random.permutation(k_e, NB)
        shuf_state = jax.tree.map(
            lambda x: x[..., perm, :] if x.ndim == 3 else x[perm], blk_state
        )
        shuf_rest = tuple(x[perm] for x in rest)
        nbm = NB // ppo.num_minibatches
        mb = nbm * BLK

        def minibatch(carry, i):
            params, opt_state = carry
            st_mb = jax.tree.map(
                lambda x: jax.lax.dynamic_slice_in_dim(
                    x, i * nbm, nbm, axis=x.ndim - 2
                ).reshape(x.shape[:-2] + (mb,)),
                shuf_state,
            )
            rest_mb = tuple(
                jax.lax.dynamic_slice_in_dim(x, i * nbm, nbm).reshape(mb)
                for x in shuf_rest
            )
            batch = (st_mb,) + rest_mb
            (loss, aux), grads = jax.value_and_grad(
                lambda p: _pixel_loss(ppo, p, cfg, batch), has_aux=True
            )(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), (loss, aux)

        return jax.lax.scan(minibatch, (params, opt_state),
                            jnp.arange(ppo.num_minibatches))

    (params, opt_state), (losses, auxes) = jax.lax.scan(
        epoch, (ts.params, ts.opt_state),
        jax.random.split(k_perm, ppo.update_epochs),
    )

    successes = (traj.raw_reward == cfg.max_steps).sum()
    metrics = {
        "loss": losses.mean(),
        "reward_mean": traj.reward.mean(),
        "episode_done_frac": traj.done.mean(),
        "success_rate": successes / jnp.maximum(traj.done.sum(), 1),
        "success_per_step": successes / (T * Bb),
        **{k: v.mean() for k, v in auxes.items()},
    }
    ts = PixelTrainState(params=params, opt_state=opt_state,
                         update_idx=ts.update_idx + 1)
    return ts, env, key, metrics


@partial(jax.jit, static_argnums=(0, 1, 4), donate_argnums=(2,))
def train_many_pixel(cfg: EnvConfig, ppo: PixelPPOConfig,
                     ts: PixelTrainState, env: PackedState,
                     num_updates: int, key):
    """N fully-on-device updates in one dispatch (throughput measurement)."""

    def body(carry, _):
        ts, env, key = carry
        ts, env, key, metrics = train_step_pixel(cfg, ppo, ts, env, key)
        return (ts, env, key), metrics

    (ts, env, key), metrics = jax.lax.scan(
        body, (ts, env, key), None, length=num_updates
    )
    return ts, env, key, metrics
