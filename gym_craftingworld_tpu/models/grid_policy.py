"""Spatial grid policy: the model family for solving canonical CraftingWorld.

The flagship MLP (models/actor_critic.py) consumes a flat one-hot vector and
must *learn* spatial structure from scratch; the scripted expert
(agents/expert.py) it is cloned from is a planner whose decisions are
inherently spatial (BFS around forbidden cells) and goal-logical (task
ordering over desired/achieved bits + the init layout that the Move* tasks
compare against, craftingworld_ray.py:670-702). This family feeds all of
that in natural form:

  * 49 feature planes over the H x W grid — current objects (8), agent (1),
    init objects + init agent mark (9, the INIT_OBS_VECTOR the reference's
    task eval reads), and broadcast goal/holding scalars (31) so the conv
    stack can condition obstacle semantics on what is held and wanted;
  * a conv torso (3x3 stacks in bf16) for local obstacle
    geometry, flattened into dense layers for global route/target reasoning;
  * the same planes are built two ways — from stored snapshot columns
    (train/demos.py, minibatch time) and from a live EnvState (eval/PPO
    time) — and the two builders are bit-identical (tests/test_grid_policy.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.state import EnvState

bf16 = jnp.bfloat16

N_PLANES = 8 + 1 + 8 + 1 + 4 + 3 * C.N_TASKS  # 49
N_EXTRAS = 4 + 3 * C.N_TASKS + 2  # 33

_BITS9 = np.arange(C.N_TASKS, dtype=np.int32)


def _scalar_features(holding, desired_bits, achieved_bits):
    """(holding one-hot, desired, achieved, residual) → f[B, 31]."""
    hold_oh = jax.nn.one_hot(holding.astype(jnp.int32), 4, dtype=bf16)
    des = desired_bits.astype(bf16)
    ach = achieved_bits.astype(bf16)
    res = des * (1 - ach)
    return jnp.concatenate([hold_oh, des, ach, res], axis=-1)


def _assemble(cfg: EnvConfig, obj_p, agent_p, init_p, iagent_p, scal,
              agent_r, agent_c):
    """Shared tail: stack planes + broadcast scalars, build extras."""
    B = agent_p.shape[0]
    HW = cfg.n_cells
    scal_planes = jnp.broadcast_to(scal[:, None, :], (B, HW, scal.shape[-1]))
    planes = jnp.concatenate(
        [obj_p, agent_p, init_p, iagent_p, scal_planes], axis=-1
    ).reshape(B, cfg.height, cfg.width, N_PLANES)
    extras = jnp.concatenate(
        [
            scal,
            (agent_r.astype(bf16) / cfg.height)[:, None],
            (agent_c.astype(bf16) / cfg.width)[:, None],
        ],
        axis=-1,
    )
    return planes, extras


def mask_bits(mask) -> jax.Array:
    """int 9-bit masks [B] → 0/1 rows [B, 9]."""
    return ((mask.astype(jnp.int32)[:, None] >> _BITS9[None, :]) & 1)


def planes_from_snaps(cfg: EnvConfig, occ_key, occ_code, init_key,
                      init_agent_key, agent_key, holding, desired_mask,
                      achieved_mask):
    """Stored snapshot columns (train/demos.SnapDataset rows) → (planes, extras)."""
    HW = cfg.n_cells
    cell_oh = jax.nn.one_hot(occ_key.astype(jnp.int32), HW + 2, dtype=bf16)[
        ..., :HW
    ]  # [B, 8, HW]; padded slots land on the clipped tail → zero
    code_oh = jax.nn.one_hot(
        occ_code.astype(jnp.int32) - 1, C.N_OBJECTS, dtype=bf16
    )  # [B, 8, 8]; code 0 → all-zero row
    obj_p = jnp.einsum("bsh,bsc->bhc", cell_oh, code_oh)
    agent_key = agent_key.astype(jnp.int32)
    agent_p = jax.nn.one_hot(agent_key, HW, dtype=bf16)[..., None]
    init_p = jnp.moveaxis(
        jax.nn.one_hot(init_key.astype(jnp.int32), HW, dtype=bf16), 1, 2
    )  # slot s holds object code s+1 at reset
    iagent_p = jax.nn.one_hot(init_agent_key.astype(jnp.int32), HW,
                              dtype=bf16)[..., None]
    scal = _scalar_features(
        holding, mask_bits(desired_mask), mask_bits(achieved_mask)
    )
    return _assemble(
        cfg, obj_p, agent_p, init_p, iagent_p, scal,
        agent_key // cfg.width, agent_key % cfg.width,
    )


def planes_from_state(cfg: EnvConfig, state: EnvState):
    """Live EnvState → (planes, extras); bit-identical to planes_from_snaps."""
    B = state.objects.shape[0]
    HW = cfg.n_cells
    obj_p = jax.nn.one_hot(
        state.objects.reshape(B, HW).astype(jnp.int32) - 1, C.N_OBJECTS,
        dtype=bf16,
    )
    agent_key = (state.agent[:, 0] * cfg.width + state.agent[:, 1]).astype(
        jnp.int32
    )
    agent_p = jax.nn.one_hot(agent_key, HW, dtype=bf16)[..., None]
    init_flat = state.init_objects.reshape(B, HW).astype(jnp.int32)
    init_p = jax.nn.one_hot(init_flat - 1, C.N_OBJECTS, dtype=bf16)
    iagent_p = (init_flat == C.AGENT_INIT_MARK).astype(bf16)[..., None]
    scal = _scalar_features(state.holding, state.desired, state.achieved)
    return _assemble(
        cfg, obj_p, agent_p, init_p, iagent_p, scal,
        state.agent[:, 0], state.agent[:, 1],
    )


def snap_columns_from_state(cfg: EnvConfig, state: EnvState):
    """On-device snapshot extraction (the DAgger rollout recorder).

    Returns the same columns train/demos.py stores, as device arrays.
    """
    B = state.objects.shape[0]
    HW = cfg.n_cells
    flat = state.objects.reshape(B, HW).astype(jnp.int32)
    mask = flat > 0
    order = jnp.argsort(jnp.logical_not(mask), axis=1, stable=True)[
        :, : C.N_OBJECTS
    ]
    code = jnp.take_along_axis(flat, order, axis=1)
    occ_key = jnp.where(code > 0, order, HW + 1).astype(jnp.int16)
    init_flat = state.init_objects.reshape(B, HW).astype(jnp.int32)
    codes = jnp.arange(1, C.N_OBJECTS + 1, dtype=jnp.int32)
    init_key = jnp.argmax(
        init_flat[:, None, :] == codes[None, :, None], axis=-1
    ).astype(jnp.int16)
    init_agent_key = jnp.argmax(
        init_flat == C.AGENT_INIT_MARK, axis=-1
    ).astype(jnp.int16)
    bits = jnp.asarray(2 ** _BITS9, jnp.int32)
    to_mask = lambda b: (b.astype(jnp.int32) @ bits).astype(jnp.int16)
    return dict(
        occ_key=occ_key,
        occ_code=code.astype(jnp.int8),
        init_key=init_key,
        init_agent_key=init_agent_key,
        agent_key=(state.agent[:, 0] * cfg.width + state.agent[:, 1]).astype(
            jnp.int16
        ),
        holding=state.holding.astype(jnp.int8),
        desired=to_mask(state.desired),
        achieved=to_mask(state.achieved),
    )


class GridPolicy(nn.Module):
    """Conv torso over the 49 feature planes + dense global reasoning."""

    channels: int = 64
    hidden: int = 1024
    n_actions: int = C.N_ACTIONS

    @nn.compact
    def __call__(self, planes, extras):
        x = planes.astype(bf16)
        for i in range(3):
            x = nn.Conv(self.channels, (3, 3), dtype=bf16, name=f"conv{i}")(x)
            x = nn.relu(x)
        x = nn.Conv(32, (1, 1), dtype=bf16, name="squeeze")(x)
        x = nn.relu(x)
        x = x.reshape(x.shape[0], -1)
        x = jnp.concatenate([x, extras.astype(bf16)], axis=-1)
        x = nn.Dense(self.hidden, dtype=bf16, name="dense0")(x)
        x = nn.relu(x)
        x = nn.Dense(self.hidden // 2, dtype=bf16, name="dense1")(x)
        x = nn.relu(x)
        logits = nn.Dense(self.n_actions, dtype=jnp.float32, name="policy")(x)
        value = nn.Dense(1, dtype=jnp.float32, name="value")(x)
        return logits, value.squeeze(-1)


def init_grid_policy(key, cfg: EnvConfig, channels: int = 64,
                     hidden: int = 1024):
    model = GridPolicy(channels=channels, hidden=hidden)
    dummy_p = jnp.zeros((1, cfg.height, cfg.width, N_PLANES), bf16)
    dummy_e = jnp.zeros((1, N_EXTRAS), bf16)
    return model, model.init(key, dummy_p, dummy_e)


def apply_from_state(model: GridPolicy, params, cfg: EnvConfig,
                     state: EnvState):
    """(logits, value) for a live batched EnvState."""
    planes, extras = planes_from_state(cfg, state)
    return model.apply(params, planes, extras)
