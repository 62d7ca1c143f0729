"""Keyed, batched environment reset.

Reproduces the reference reset pipeline (`craftingworld_ray.py:156-218`) as a
pure function of a PRNG key:

  1. task sampling → desired goal bits   (:169-176)
  2. world sampling: exactly one of each of the 8 objects + the agent placed
     uniformly at random without collision (:599-628, "sample_state")
  3. goal imagination → packed goal state (:220-299, see core/imagine.py)

The reference's placement trick — scatter a 12x12 diagonal into the first rows
of the flattened grid and shuffle a full H*W permutation (:605-613) — is
equivalent to drawing a uniformly random *ordered* 9-tuple of distinct cells.
On device that is one ``top_k`` over iid uniform scores: iid continuous scores
rank the cells in a uniform permutation, and the top 9 in score order are a
uniform ordered 9-subset. No rejection loops, fixed shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.imagine import imagine_goal
from gym_craftingworld_tpu.core.state import EnvState


def sample_desired(cfg: EnvConfig, key: jax.Array) -> jax.Array:
    """Sample the desired-goal bit vector for one env (craftingworld_ray.py:169-176)."""
    k_num, k_perm = jax.random.split(key)
    n_sel = len(cfg.selected_task_indices)
    if cfg.stacking:
        k = jax.random.randint(k_num, (), 0, cfg.number_of_tasks) + 1
    else:
        k = jnp.int32(1)
    perm = jax.random.permutation(k_perm, n_sel)
    sel = jnp.asarray(cfg.selected_task_indices, jnp.int32)[perm]
    chosen = jnp.arange(n_sel) < k
    # Dense compare-select instead of a data-dependent scatter (core/step.py
    # documents the batched-scatter miscompile this family avoids).
    hit = (sel[None, :] == jnp.arange(C.N_TASKS, dtype=jnp.int32)[:, None]) & chosen[None, :]
    return jnp.any(hit, axis=1).astype(jnp.int8)


def sample_world(cfg: EnvConfig, key: jax.Array):
    """Place one of each object + the agent on distinct uniform cells.

    Returns ``(objects int8[H,W], agent int32[2], init_objects int8[H,W])``.
    """
    n = cfg.n_cells
    scores = jax.random.uniform(key, (n,))
    _, idx = jax.lax.top_k(scores, C.N_OBJECTS + 1)  # 9 distinct ordered cells
    cells = jnp.arange(n, dtype=jnp.int32)
    codes = jnp.arange(1, C.N_OBJECTS + 1, dtype=jnp.int32)  # sticks..wheat
    # Dense one-hot placement (scatter-free; see core/step.py on the why).
    place = cells[None, :] == idx[: C.N_OBJECTS, None]  # [8, n]
    flat = jnp.sum(codes[:, None] * place, axis=0).astype(jnp.int8)
    agent_idx = idx[C.N_OBJECTS]
    init_flat = jnp.where(
        cells == agent_idx, jnp.int8(C.AGENT_INIT_MARK), flat
    )
    agent = jnp.stack(
        [agent_idx // cfg.width, agent_idx % cfg.width]
    ).astype(jnp.int32)
    objects = flat.reshape(cfg.height, cfg.width)
    init_objects = init_flat.reshape(cfg.height, cfg.width)
    return objects, agent, init_objects


def _reset_one(cfg: EnvConfig, key: jax.Array) -> EnvState:
    k_task, k_world, k_goal, k_next = jax.random.split(key, 4)
    desired = sample_desired(cfg, k_task)
    objects, agent, init_objects = sample_world(cfg, k_world)

    agent_idx = agent[0] * cfg.width + agent[1]
    goal_flat, goal_agent_idx = imagine_goal(
        k_goal, objects.reshape(-1), agent_idx, desired
    )
    goal_agent = jnp.stack(
        [goal_agent_idx // cfg.width, goal_agent_idx % cfg.width]
    ).astype(jnp.int32)

    return EnvState(
        objects=objects,
        agent=agent,
        holding=jnp.int32(0),
        desired=desired,
        achieved=jnp.zeros((C.N_TASKS,), jnp.int8),
        init_objects=init_objects,
        init_agent=agent,
        goal_objects=goal_flat.reshape(cfg.height, cfg.width),
        goal_agent=goal_agent,
        step_num=jnp.int32(0),
        rng=jax.random.key_data(k_next),
    )


def _reset_one_from_pool(
    cfg: EnvConfig, key: jax.Array, pool_objects: jax.Array, pool_agent: jax.Array
) -> EnvState:
    """Reset drawing the world uniformly from a pre-generated pool
    (reference ``fixed_init_state`` path, craftingworld_ray.py:116-118,630-644).

    Draw order mirrors the reference: task sampling first, then one randint
    into the pool (instead of the placement shuffle).
    """
    k_task, k_pick, k_goal, k_next = jax.random.split(key, 4)
    desired = sample_desired(cfg, k_task)
    i = jax.random.randint(k_pick, (), 0, pool_objects.shape[0])
    objects = pool_objects[i]
    agent = pool_agent[i]
    # Pool worlds come from sample_world: the agent's cell holds no object.
    at_agent = (
        jnp.arange(cfg.height, dtype=jnp.int32)[:, None] == agent[0]
    ) & (jnp.arange(cfg.width, dtype=jnp.int32)[None, :] == agent[1])
    init_objects = jnp.where(at_agent, jnp.int8(C.AGENT_INIT_MARK), objects)

    agent_idx = agent[0] * cfg.width + agent[1]
    goal_flat, goal_agent_idx = imagine_goal(
        k_goal, objects.reshape(-1), agent_idx, desired
    )
    goal_agent = jnp.stack(
        [goal_agent_idx // cfg.width, goal_agent_idx % cfg.width]
    ).astype(jnp.int32)

    return EnvState(
        objects=objects,
        agent=agent,
        holding=jnp.int32(0),
        desired=desired,
        achieved=jnp.zeros((C.N_TASKS,), jnp.int8),
        init_objects=init_objects,
        init_agent=agent,
        goal_objects=goal_flat.reshape(cfg.height, cfg.width),
        goal_agent=goal_agent,
        step_num=jnp.int32(0),
        rng=jax.random.key_data(k_next),
    )


@partial(jax.jit, static_argnums=0)
def reset_from_pool(
    cfg: EnvConfig, keys: jax.Array, pool_objects: jax.Array, pool_agent: jax.Array
) -> EnvState:
    """Batched fixed-init-state reset: each env draws one pool entry uniformly."""
    if keys.dtype == jnp.uint32:
        keys = jax.vmap(jax.random.wrap_key_data)(keys)
    return jax.vmap(partial(_reset_one_from_pool, cfg), in_axes=(0, None, None))(
        keys, pool_objects, pool_agent
    )


def generate_pool(cfg: EnvConfig, key: jax.Array, num_states: int):
    """Pre-generate ``num_states`` worlds (reference generate_fixed_states)."""
    keys = jax.random.split(key, num_states)
    objects, agent, _ = jax.vmap(partial(sample_world, cfg))(keys)
    return objects, agent


@partial(jax.jit, static_argnums=0)
def reset(cfg: EnvConfig, keys: jax.Array) -> EnvState:
    """Batched reset from per-env keys.

    ``keys`` may be a typed key array of shape [B] or raw uint32 key data
    [B, 2]; returns a batched EnvState.
    """
    if keys.dtype == jnp.uint32:
        keys = jax.vmap(jax.random.wrap_key_data)(keys)
    return jax.vmap(partial(_reset_one, cfg))(keys)


def reset_from_seed(cfg: EnvConfig, seed: int, batch_size: int) -> EnvState:
    """Convenience: derive B per-env keys from one integer seed and reset."""
    keys = jax.random.split(jax.random.PRNGKey(seed), batch_size)
    return reset(cfg, keys)
