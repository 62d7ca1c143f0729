"""Whole-rollout GPU kernel for the packed engine (Pallas, Triton route).

The XLA packed scan (``packed_rollout.rollout_p_bench``) launches several
small kernels per step and writes its carry back to device memory every step.
At 16k envs one step is only a few microseconds of arithmetic, so the scan is
bound by launches and the loop. This kernel runs all T steps in one launch:
each program owns a 1-D block of ``BLOCK`` envs, one env per thread, and keeps
every env's state in registers for the whole rollout.

* **Step body**: ``packed_rollout._step_p_unrolled``, the same algebra as the
  scan, in int32. Each ``[8, B]`` slot array enters as 8 separate ``[BLOCK]``
  rows, because Triton cannot slice a register tensor.
* **Actions**: a counter-based 32-bit hash of (seed, global env index, step)
  (:func:`action_stream`), computed in the kernel. The same plain-``jnp``
  function is the reference stream that tests and ``chip_smoke.py`` feed the
  scan. The stream depends on the global env index, so it does not depend on
  the block size, and a shard passes its first env index as ``env_offset``.
* **Output**: the final state and one int32 reward sum per env, so no
  ``[T, B]`` array is written.

A batch that is not a multiple of the block is padded with copies of its last
env and sliced back. ``interpret=True`` runs the kernel in the Pallas
interpreter on any backend (the CPU tests). Otherwise it is compiled for the
GPU, and asking for that on another backend raises.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.slots import SlotState
from gym_craftingworld_tpu.ops.packed_rollout import (
    PackedState,
    _step_p_unrolled,
    pack,
    rollout_p_bench,
    unpack,
)
from gym_craftingworld_tpu.ops.transposed_rollout import transpose_in, transpose_out

KDT = jnp.int32  # element type inside the kernel: one register per value
# Envs per program, one per thread (PERF.md, "Kernel decisions": block sweep
# at 16k envs on the H100).
BLOCK = 128
NUM_WARPS = BLOCK // 32

# PackedState field partition: slot arrays [8, B], scalars [B]; the const
# fields never change during a rollout.
_SLOT_FIELDS = ("slot_key", "slot_type", "init_key", "init_type")
_CONST_FIELDS = ("init_key", "init_type", "desired", "init_agent_key")
_OUT_FIELDS = tuple(f for f in PackedState._fields if f not in _CONST_FIELDS)


# ---------------------------------------------------------------------------
# the action stream: one plain-jnp definition, used in and out of the kernel
# ---------------------------------------------------------------------------

_GOLDEN = np.uint32(0x9E3779B9)
_STEP_SALT = np.uint32(0x632BE5AB)


def _mix32(x):
    """The "lowbias32" integer finaliser (C. Wellons): a uint32 bijection."""
    x = x ^ (x >> 16)
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> 16)


def env_keys(seed, env):
    """Per-env stream keys for global env indices ``env`` (int)."""
    s = _mix32(jnp.asarray(seed).astype(jnp.uint32) ^ _GOLDEN)
    return _mix32(jnp.asarray(env).astype(jnp.uint32) * _GOLDEN + s)


def step_actions(keys, step):
    """Actions int32 in [0, 6) of envs with stream ``keys`` at ``step``."""
    s = _mix32(jnp.asarray(step).astype(jnp.uint32) ^ _STEP_SALT)
    h = _mix32(keys ^ s)
    return jax.lax.rem(h, np.uint32(C.N_ACTIONS)).astype(jnp.int32)


def action_stream(seed, env, step):
    """The kernel's action for (seed, global env index, step), broadcasting.

    ``hash % 6`` has a modulo bias of ~1e-9 per action, far below any test's
    resolution.
    """
    return step_actions(env_keys(seed, env), step)


def reference_actions(seed, batch: int, num_steps: int, env_offset=0):
    """The stream the kernel draws for envs ``env_offset + [0, batch)``,
    as int32[num_steps, batch]."""
    env = env_offset + jnp.arange(batch, dtype=jnp.int32)
    steps = jnp.arange(num_steps, dtype=jnp.int32)
    return action_stream(seed, env[None, :], steps[:, None])


# ---------------------------------------------------------------------------
# backend switch
# ---------------------------------------------------------------------------


def rollout_layout(backend: str | None = None) -> str:
    """The fastest random-rollout engine on ``backend`` (default: JAX's).

    ``"packed_fused"`` (this kernel) on a GPU, ``"packed"`` (the XLA scan)
    elsewhere. This is the one place that makes that choice.
    """
    backend = backend or jax.default_backend()
    return "packed_fused" if backend == "gpu" else "packed"


def rollout_random_bench(cfg: EnvConfig, slots: SlotState, seed,
                         num_steps: int, layout: str | None = None):
    """T random steps with the engine :func:`rollout_layout` picks.

    Returns (SlotState, int32 reward checksum). Both engines step uniform
    random actions; only the kernel's are the :func:`action_stream` hash.
    """
    layout = layout or rollout_layout()
    if layout == "packed_fused":
        return fused_rollout_packed_bench(cfg, slots, seed, num_steps)
    if layout == "packed":
        return rollout_p_bench(cfg, slots, jax.random.PRNGKey(seed), num_steps)
    raise ValueError(f"unknown rollout layout {layout!r}")


def _require_compiled_backend(interpret: bool):
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the compiled packed rollout kernel needs a GPU; pass "
            "interpret=True to run it in the Pallas interpreter"
        )


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _block_envs(meta_ref, block: int):
    """Global env indices of this program's block: offset + pid*block + i."""
    first = meta_ref[1] + pl.program_id(0) * block
    return first + jax.lax.broadcasted_iota(jnp.int32, (block,), 0)


def _load(ref, field):
    if field in _SLOT_FIELDS:
        return tuple(ref[i, :] for i in range(C.N_OBJECTS))
    return ref[...]


def _store(ref, field, value):
    if field in _SLOT_FIELDS:
        for i in range(C.N_OBJECTS):
            ref[i, :] = value[i]
    else:
        ref[...] = value


def _bench_kernel(cfg: EnvConfig, num_steps: int, block: int, meta_ref,
                  *refs):
    """T hashed-action steps; outputs the mutable fields + per-env reward sum."""
    n_in = len(PackedState._fields)
    in_refs, out_refs = refs[:n_in], refs[n_in:]
    state = {f: _load(r, f) for f, r in zip(PackedState._fields, in_refs)}
    const = {f: state[f] for f in _CONST_FIELDS}
    keys = env_keys(meta_ref[0], _block_envs(meta_ref, block))

    def body(t, carry):
        mut, acc = carry
        s, res = _step_p_unrolled(cfg, PackedState(**mut, **const),
                                  step_actions(keys, t), dtype=KDT)
        return {f: getattr(s, f) for f in _OUT_FIELDS}, acc + res.reward

    mut, acc = jax.lax.fori_loop(
        0, num_steps, body,
        ({f: state[f] for f in _OUT_FIELDS}, jnp.zeros((block,), jnp.int32)),
    )
    for ref, f in zip(out_refs, _OUT_FIELDS):
        _store(ref, f, mut[f])
    out_refs[-1][...] = acc


def _stream_kernel(num_steps: int, block: int, meta_ref, o_ref):
    keys = env_keys(meta_ref[0], _block_envs(meta_ref, block))

    def body(t, carry):
        o_ref[t, :] = step_actions(keys, t)
        return carry

    jax.lax.fori_loop(0, num_steps, body, 0)


def _spec(field: str | None, block: int, lead: int | None = None):
    if field in _SLOT_FIELDS or lead is not None:
        return pl.BlockSpec((lead or C.N_OBJECTS, block), lambda i: (0, i))
    return pl.BlockSpec((block,), lambda i: (i,))


def _meta(seed, env_offset):
    return jnp.stack([jnp.asarray(seed, jnp.int32),
                      jnp.asarray(env_offset, jnp.int32)])


def _call(kernel, n_blocks: int, block: int, interpret: bool, in_specs,
          out_specs, out_shape):
    _require_compiled_backend(interpret)
    return pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[pl.BlockSpec((2,), lambda i: (0,))] + in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),  # one env/thread
        interpret=interpret,
        name="packed_rollout",
    )


def _padded(B: int, block: int | None):
    block = block or BLOCK
    if block & (block - 1):
        raise ValueError(f"block {block} must be a power of two")
    return block, -(-B // block) * block


def _pad(x, Bp: int):
    B = x.shape[-1]
    if B == Bp:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, Bp - B)], mode="edge")


@partial(jax.jit, static_argnums=(0, 3),
         static_argnames=("interpret", "block"))
def fused_rollout_packed_bench(cfg: EnvConfig, slots: SlotState, seed,
                               num_steps: int, *, env_offset=0,
                               interpret: bool = False,
                               block: int | None = None):
    """T steps of :func:`action_stream` actions in one kernel launch.

    Returns (SlotState, int32 checksum: the sum of every env's rewards).
    Bit-identical to ``rollout_p`` fed ``reference_actions(seed, B, T,
    env_offset)``. ``block`` overrides the envs per program (default
    ``BLOCK``; always one env per thread).
    """
    B = slots.agent.shape[0]
    block, Bp = _padded(B, block)
    ts = transpose_in(slots)
    p = pack(cfg, ts)
    init_rows = (ts.init_pos_r, ts.init_pos_c, ts.init_type,
                 ts.init_agent_r, ts.init_agent_c)
    sds = jax.ShapeDtypeStruct
    outs = _call(
        partial(_bench_kernel, cfg, num_steps, block), Bp // block, block,
        interpret,
        in_specs=[_spec(f, block) for f in PackedState._fields],
        out_specs=[_spec(f, block) for f in _OUT_FIELDS] + [_spec(None, block)],
        out_shape=[sds((C.N_OBJECTS, Bp) if f in _SLOT_FIELDS else (Bp,), KDT)
                   for f in _OUT_FIELDS] + [sds((Bp,), jnp.int32)],
    )(_meta(seed, env_offset),
      *[_pad(getattr(p, f).astype(KDT), Bp) for f in PackedState._fields])
    outs = [o[..., :B] for o in outs]
    p_final = p._replace(**{f: o.astype(jnp.int16)
                            for f, o in zip(_OUT_FIELDS, outs)})
    state = transpose_out(unpack(cfg, p_final, ts.desired, init_rows),
                          slots.rng)
    return state, jnp.sum(outs[-1])


@partial(jax.jit, static_argnums=(0, 2),
         static_argnames=("interpret", "block"))
def fused_action_stream(batch: int, seed, num_steps: int, *, env_offset=0,
                        interpret: bool = False, block: int | None = None):
    """The actions the kernel draws in-kernel, as int32[num_steps, batch].

    Same env indexing and hash as :func:`fused_rollout_packed_bench`, so the
    tests can pin the in-kernel stream to :func:`reference_actions`.
    """
    block, Bp = _padded(batch, block)
    out = _call(
        partial(_stream_kernel, num_steps, block), Bp // block, block,
        interpret, in_specs=[],
        out_specs=_spec(None, block, lead=num_steps),
        out_shape=jax.ShapeDtypeStruct((num_steps, Bp), jnp.int32),
    )(_meta(seed, env_offset))
    return out[:, :batch]
