"""Batched CraftingWorld: a from-scratch JAX re-design of
`lauradarcy/gym-craftingworld`.

The entire env — state, step, reset, goal imagination, rendering — is a pure
batched array program: thousands of env instances live as packed int8/int32
device arrays and step in lockstep under ``jit``/``vmap``/``lax.scan``, shard
across device meshes via ``jax.sharding``, and feed learners without leaving
device memory.

Public surface:
  - :mod:`gym_craftingworld_tpu.core`     — packed state, step, reset, rollouts
  - :mod:`gym_craftingworld_tpu.render`   — on-device pixel/one-hot observations
  - :mod:`gym_craftingworld_tpu.api`      — the four reference env variants +
    a classic-Gym-compatible single-env shim and registry
  - :mod:`gym_craftingworld_tpu.parallel` — mesh construction & batch sharding
  - :mod:`gym_craftingworld_tpu.parity`   — the reference as bit-exactness oracle
  - :mod:`gym_craftingworld_tpu.train`    — PPO harness over the sharded batch
"""

from gym_craftingworld_tpu.config import EnvConfig, flat_config, ray_config
from gym_craftingworld_tpu.core.reset import reset, reset_from_seed
from gym_craftingworld_tpu.core.rollout import rollout, rollout_random
from gym_craftingworld_tpu.core.state import EnvState
from gym_craftingworld_tpu.core.step import StepResult, step

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "EnvState",
    "StepResult",
    "flat_config",
    "ray_config",
    "reset",
    "reset_from_seed",
    "rollout",
    "rollout_random",
    "step",
]
