"""Observation-interleaved rollout: env-steps/s *with* per-step observations.

The RL-relevant loop: the reference rebuilds its observation dict after every
effective step (craftingworld_ray.py:348-360), so raw stepping rate overstates
what a pixel-consuming agent can draw from the env. This rollout renders the
current observation every step — Ray 4x4 pixels, AltObs 3x3+strip tiles, or
the 12-channel one-hot — directly from the slot state, then steps the slot
engine on a uniform-random action, all inside one `lax.scan` on device.

Observations are consumed by an on-chip integer reduction into a running
checksum: every pixel of every step's observation is computed (nothing can be
dead-code-eliminated — the checksum is the rollout's return value), which is
exactly what a fused policy stem would read. Storing T full pixel batches to
HBM instead is impossible at any useful T (uint8[16384, 84, 84, 3] is 330 MB
per step) and is not what an RL consumer does either — fast_ppo likewise
consumes observations as features inside the collect scan.

Grid codes are reconstructed from slots without gathers or scatters: each of
the 8 slot position keys is compared against the cell-index iota and the
matching slot type is select-summed in (compares/selects instead of
scatters — same design as render/raster.py's palette).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.slots import (
    ON_GRID,
    SlotState,
    holding_of,
    step_slots,
)
from gym_craftingworld_tpu.render.raster import (
    render_altobs,
    render_onehot,
    render_ray,
)

_RENDER = {
    "ray": render_ray,
    "altobs": render_altobs,
    "onehot": render_onehot,
}


def slots_to_codes(cfg: EnvConfig, s: SlotState) -> jax.Array:
    """Packed object codes int32[B, H, W] from slots — gather/scatter-free.

    Equivalent to ``core.slots.to_grid(...)[0]`` (which uses a per-env
    8-element scatter) but built from 8 broadcast compares so it fuses into
    the downstream render instead of serialising on a scatter.
    """
    H, W = cfg.height, cfg.width
    on = s.slot_stat == ON_GRID  # [B, 8]
    lin = s.slot_pos[..., 0] * W + s.slot_pos[..., 1]  # [B, 8]
    key = jnp.where(on, lin, -1)
    cells = jnp.arange(H * W, dtype=lin.dtype)  # [HW]
    eq = key[:, :, None] == cells[None, None, :]  # [B, 8, HW]
    codes = (eq * s.slot_type[:, :, None]).sum(axis=1)  # [B, HW]
    return codes.reshape(-1, H, W)


@partial(jax.jit, static_argnums=(0, 3, 4), donate_argnums=1)
def rollout_obs_random(cfg: EnvConfig, slots: SlotState, key,
                       num_steps: int, obs_mode: str = "ray"):
    """T random-action steps, rendering the observation after every step.

    Action stream is identical to ``rollout_slots_random`` under the same key
    (same randint draw), so final states cross-check bit-exactly against the
    pure stepping rollout. Returns ``(final_slots, checksum)`` where
    ``checksum`` is the uint32 wrap-sum of every observation pixel plus the
    reward stream — reading it on the host synchronises the whole rollout.
    """
    render = _RENDER[obs_mode]
    B = slots.agent.shape[0]
    actions = jax.random.randint(key, (num_steps, B), 0, 6, dtype=jnp.int32)

    def body(carry, action_t):
        st, csum = carry
        st, res = step_slots(cfg, st, action_t)
        codes = slots_to_codes(cfg, st)
        img = render(codes, st.agent, holding_of(st))
        csum = csum + img.astype(jnp.uint32).sum()
        csum = csum + res.reward.astype(jnp.uint32).sum()
        return (st, csum), None

    (slots, checksum), _ = jax.lax.scan(
        body, (slots, jnp.uint32(0)), actions
    )
    return slots, checksum
