"""On-device batched rendering.

Reference renderers re-implemented as fixed-shape array programs:

  * Ray/Flat 4x4-px tiles (`craftingworld_ray.py:442-520`): per-cell palette
    gather + broadcast upsample (instead of ``np.repeat``), agent 2x2 white
    block at cell px [1:3,1:3], holding colour on the bottom row [2:3,1:3].
  * AltObs 3x3-px tiles + status strip (`craftingworld_altobs.py:489-595`):
    each of 9 channels maps to a fixed pixel slot in the tile
    (``OBJECT_ENCODING_M``/``COLORS_A_M``), held items add into slots 0-2 of
    the agent's tile (so a held item over the same object doubles the slot
    value — reference behaviour preserved), and a 3-px strip is appended at
    the bottom with px columns [3:6] set to 255 while holding.
  * OneHot (`carftingworld_onehot.py:84-103`): the raw 12-channel one-hot.

Output dtype is uint8 (values are 0..255); the reference emits int64 arrays —
parity tests compare after a cast.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.core.state import EnvState

# ---------------------------------------------------------------------------
# Ray / Flat: 4x4-px tiles
# ---------------------------------------------------------------------------


def _upsample_mats(H: int, W: int):
    """Constant 0/1 replication matrices for the separable 4x upsample.

    The naive upsample (``repeat``/broadcast+reshape) interleaves a middle
    axis, a relayout copy. Here it is two tiny matmuls over constant 0/1
    matrices instead, bit-exact: every output pixel is a single 0/1-weighted
    term, and palette values <=255 are exact in bf16 (chip_smoke.py phase 1
    checks the GPU's renders against the CPU's, pixel for pixel).

      Rc[3W, 12W]  column upsample in the merged minor layout, where output
                   column q = 12*cell + 3*px + ch (W and RGB fused into one
                   minor axis)
      Rr[4H, H]    row upsample
    """
    Rc = np.zeros((3 * W, 12 * W), np.float32)
    for cell in range(W):
        for px in range(4):
            for ch in range(3):
                Rc[cell * 3 + ch, cell * 12 + px * 3 + ch] = 1
    Rr = np.zeros((4 * H, H), np.float32)
    for cell in range(H):
        for px in range(4):
            Rr[cell * 4 + px, cell] = 1
    return jnp.asarray(Rc, jnp.bfloat16), jnp.asarray(Rr, jnp.bfloat16)


@partial(jax.jit)
def render_ray(objects, agent, holding):
    """Batched Ray-style pixels: uint8[B, 4H, 4W, 3].

    Fully branch-free and gather-free: per-cell colours by select-sum over
    the 9 palette entries, 4x upsample as two matmuls (see
    ``_upsample_mats``), then masked
    agent/holding overlays in the merged [B, 4H, 12W] layout — no per-env
    scatters, no relayout copies.
    """
    B, H, W = objects.shape
    palette = jnp.asarray(C.COLORS_N, jnp.uint8)  # [9, 3], index = packed code
    oi = objects.astype(jnp.int32)
    base = jnp.zeros((B, H, W, 3), jnp.uint8)
    for k in range(1, 9):
        base = jnp.where((oi == k)[..., None], palette[k], base)
    base = base.reshape(B, H, 3 * W).astype(jnp.bfloat16)

    Rc, Rr = _upsample_mats(H, W)
    up = jnp.einsum("bhc,cq->bhq", base, Rc)  # [B, H, 12W]
    up = jnp.einsum("rh,bhq->brq", Rr, up)  # [B, 4H, 12W]

    # overlay masks in merged pixel coords (q = 12*cell + 3*px + ch): white
    # 2x2 block at cell px [1:3, 1:3]; holding colour on its bottom row
    # (craftingworld_ray.py:483-486)
    pr = jnp.arange(4 * H)
    q = jnp.arange(12 * W)
    row_cell = (pr[None, :] // 4 == agent[:, 0:1])  # [B, 4H]
    col_cell = (q[None, :] // 12 == agent[:, 1:2])  # [B, 12W]
    pxc = (q // 3) % 4
    row_mid = row_cell & ((pr % 4 >= 1) & (pr % 4 <= 2))[None, :]
    col_mid = col_cell & ((pxc >= 1) & (pxc <= 2))[None, :]
    white = row_mid[:, :, None] & col_mid[:, None, :]
    row_bot = row_cell & (pr % 4 == 2)[None, :]
    hold_row = (
        row_bot[:, :, None]
        & col_mid[:, None, :]
        & (holding > 0)[:, None, None]
    )

    img = jnp.where(white, jnp.bfloat16(255), up)
    hold_color = palette[holding]  # [B, 3]
    hc = hold_color[:, q % 3].astype(jnp.bfloat16)  # [B, 12W]
    img = jnp.where(hold_row, hc[:, None, :], img)
    return img.astype(jnp.uint8).reshape(B, 4 * H, 4 * W, 3)


# ---------------------------------------------------------------------------
# Host-side incremental repaint (reference render_edit)
# ---------------------------------------------------------------------------

_PALETTE_NP = np.asarray(C.COLORS_N, np.uint8)  # [9, 3]; row 0 = black/empty


def render_edit(img, objects, agent, holding, cells):
    """Repaint only ``cells`` of a Ray-style image, in place (host numpy).

    The batched design re-renders the whole batch on device
    (:func:`render_ray`); this is the single-env *interactive* fast path
    mirroring the reference's incremental renderer
    (craftingworld_ray.py:522-557), which touches at most two 4x4-px tiles
    per step instead of the full frame. Byte-exact with ``render_ray`` on the
    repainted cells (tests/test_incremental_render.py).

    img:      uint8[4H, 4W, 3] — mutated in place and returned
    objects:  int[H, W] packed codes (0 = empty, 1..8 = object)
    agent:    (row, col) of the agent now
    holding:  packed held code 0..3
    cells:    iterable of (row, col) cell coordinates to repaint
    """
    ar, ac = int(agent[0]), int(agent[1])
    for r, c in cells:
        img[4 * r : 4 * r + 4, 4 * c : 4 * c + 4] = _PALETTE_NP[
            int(objects[r, c])
        ]
        if r == ar and c == ac:
            # white 2x2 agent block; held-item colour on its bottom row
            # (craftingworld_ray.py:483-486 / :545-557)
            img[4 * r + 1 : 4 * r + 3, 4 * c + 1 : 4 * c + 3] = 255
            if holding:
                img[4 * r + 2, 4 * c + 1 : 4 * c + 3] = _PALETTE_NP[int(holding)]
    return img


# ---------------------------------------------------------------------------
# AltObs: 3x3-px tiles + bottom status strip
# ---------------------------------------------------------------------------


@partial(jax.jit)
def render_altobs(objects, agent, holding):
    """Batched AltObs pixels: int16[B, (H+1)*3, 3W, 3]. Branch-free.

    int16, not uint8: a held item over the same object type doubles the tile
    slot value, so the reference emits pixel values up to 510 (2x255).
    """
    B, H, W = objects.shape
    # 9-channel per-cell activation: objects (codes 1..8 → channels 0..7),
    # agent → channel 8, held item adds into channels 0..2 of the agent cell
    # (craftingworld_altobs.py:530-533).
    ch = jax.nn.one_hot(objects.astype(jnp.int32) - 1, 9, dtype=jnp.int32)
    at_r = (jnp.arange(H)[None, :] == agent[:, 0:1])[:, :, None]
    at_c = (jnp.arange(W)[None, :] == agent[:, 1:2])[:, None, :]
    cell = (at_r & at_c)[..., None].astype(jnp.int32)  # [B, H, W, 1]
    e_agent = jax.nn.one_hot(8, 9, dtype=jnp.int32)  # channel 8
    held = jax.nn.one_hot(holding - 1, 9, dtype=jnp.int32)  # -1 → zero row
    ch = ch + cell * (e_agent[None, None, None, :] + held[:, None, None, :])

    # channel k renders at tile pixel (k // 3, k % 3) scaled by its colour
    vals = ch.reshape(B, H, W, 3, 3).transpose(0, 1, 3, 2, 4).reshape(
        B, 3 * H, 3 * W
    )
    tile_colors = jnp.asarray(np.tile(C.CPV_TILE_COLORS, (H, W, 1)), jnp.int32)
    img = vals[:, :, :, None] * tile_colors[None]

    # bottom status strip: zeros, px columns [3:6] = 255 while holding
    # (craftingworld_altobs.py:543,557-559)
    strip_cols = (jnp.arange(3 * W) >= 3) & (jnp.arange(3 * W) < 6)
    strip = jnp.where(
        (strip_cols[None, None, :, None]) & (holding > 0)[:, None, None, None],
        255,
        0,
    ) * jnp.ones((B, 3, 3 * W, 3), jnp.int32)
    return jnp.concatenate([img, strip], axis=1).astype(jnp.int16)


# ---------------------------------------------------------------------------
# OneHot: the 12-channel reference encoding
# ---------------------------------------------------------------------------


@partial(jax.jit)
def render_onehot(objects, agent, holding):
    """Batched one-hot obs: uint8[B, H, W, 12]. Branch-free masked build."""
    B, H, W = objects.shape
    obj = jax.nn.one_hot(objects.astype(jnp.int32) - 1, C.N_OBJECTS, dtype=jnp.uint8)
    at_r = (jnp.arange(H)[None, :] == agent[:, 0:1])[:, :, None]
    at_c = (jnp.arange(W)[None, :] == agent[:, 1:2])[:, None, :]
    cell = (at_r & at_c)[..., None]  # [B, H, W, 1]
    agent_ch = cell.astype(jnp.uint8)
    held = jax.nn.one_hot(holding - 1, len(C.PICKUPABLE), dtype=jnp.uint8)
    held_ch = cell.astype(jnp.uint8) * held[:, None, None, :]
    return jnp.concatenate([obj, agent_ch, held_ch], axis=-1)


# ---------------------------------------------------------------------------
# State-level helpers (current / init / goal views)
# ---------------------------------------------------------------------------


def _init_views(state: EnvState):
    """Strip the agent-init marker: init grid codes 9 → empty for rendering."""
    init_obj = jnp.where(
        state.init_objects == C.AGENT_INIT_MARK,
        jnp.int8(0),
        state.init_objects,
    )
    return init_obj, state.init_agent


def state_images_ray(state: EnvState):
    """The reference Ray observation dict, rendered on demand
    (craftingworld_ray.py:194-196,359-360): observation == achieved_goal."""
    zeros = jnp.zeros_like(state.holding)
    cur = render_ray(state.objects, state.agent, state.holding)
    init_obj, init_agent = _init_views(state)
    return {
        "observation": cur,
        "achieved_goal": cur,
        "desired_goal": render_ray(state.goal_objects, state.goal_agent, zeros),
        "init_observation": render_ray(init_obj, init_agent, zeros),
    }


def state_images_altobs(state: EnvState, stacked: bool = False):
    zeros = jnp.zeros_like(state.holding)
    cur = render_altobs(state.objects, state.agent, state.holding)
    init_obj, init_agent = _init_views(state)
    out = {
        "observation": cur,
        "achieved_goal": cur,
        "desired_goal": render_altobs(state.goal_objects, state.goal_agent, zeros),
        "init_observation": render_altobs(init_obj, init_agent, zeros),
    }
    if stacked:
        # (B, 4, ph, pw, 3) — reference stacks the four images on a new axis 0
        # for a single env (craftingworld_altobs.py:258-259,408-411).
        return jnp.stack(
            [out["observation"], out["desired_goal"], out["achieved_goal"],
             out["init_observation"]],
            axis=1,
        )
    return out


def state_obs_onehot(state: EnvState):
    """Reference OneHot observation dict (carftingworld_onehot.py:202-207):
    desired_goal is the imagined final one-hot *state*, not a render."""
    zeros = jnp.zeros_like(state.holding)
    cur = render_onehot(state.objects, state.agent, state.holding)
    init_obj, init_agent = _init_views(state)
    return {
        "observation": cur,
        "achieved_goal": cur,
        "desired_goal": render_onehot(state.goal_objects, state.goal_agent, zeros),
        "init_observation": render_onehot(init_obj, init_agent, zeros),
    }
