"""Gymnasium-style vector environment over the batched device core.

Modern RL stacks consume `gymnasium.vector.VectorEnv`-shaped interfaces; this
adapter exposes the whole device-resident batch through that protocol —
``reset() -> (obs, info)`` and ``step(actions) -> (obs, rewards, terminations,
truncations, infos)`` with per-env autoreset — while everything (stepping,
resets, rendering) stays jitted on device. No per-env Python objects exist.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.api import spaces
from gym_craftingworld_tpu.config import EnvConfig, resolve_selected_tasks
from gym_craftingworld_tpu.core.reset import reset as core_reset
from gym_craftingworld_tpu.core.state import EnvState
from gym_craftingworld_tpu.core.step import step as core_step
from gym_craftingworld_tpu.core.reset import _reset_one
from functools import partial


@partial(jax.jit, static_argnums=0, donate_argnums=1)
def _step_autoreset(cfg: EnvConfig, state: EnvState, actions):
    """One batched step; finished episodes are freshly reset in-place."""
    state, res = core_step(cfg, state, actions)
    keys = jax.vmap(jax.random.wrap_key_data)(state.rng)
    fresh = jax.vmap(partial(_reset_one, cfg))(keys)
    state = jax.tree.map(
        lambda f, s: jnp.where(
            res.done.reshape((-1,) + (1,) * (s.ndim - 1)), f, s
        ),
        fresh,
        state,
    )
    return state, res


class CraftingWorldVectorEnv:
    """num_envs CraftingWorlds stepping in lockstep on device.

    obs_mode: 'onehot' (B, H, W, 12) | 'pixels' (B, 4H, 4W, 3) |
              'features' (B, H*W*12 + 18) — the policy-feature vector.
    """

    def __init__(self, num_envs: int, size=(21, 21), max_steps=300,
                 selected_tasks=None, number_of_tasks=None, stacking=True,
                 reward_style=None, obs_mode="onehot", seed=0):
        sel = (
            resolve_selected_tasks(selected_tasks)
            if selected_tasks is not None
            else tuple(range(C.N_TASKS))
        )
        self.cfg = EnvConfig(
            height=size[0],
            width=size[1],
            max_steps=max_steps,
            stacking=stacking,
            selected_task_indices=sel,
            number_of_tasks=(
                number_of_tasks if number_of_tasks is not None else len(sel)
            ),
            reward_equal=(reward_style is None),
        )
        self.num_envs = int(num_envs)
        self.obs_mode = obs_mode
        self._seed = seed
        self._key = jax.random.PRNGKey(seed)
        self._state: EnvState | None = None

        self.single_action_space = spaces.Discrete(C.N_ACTIONS)
        self.action_space = spaces.Discrete(C.N_ACTIONS)
        H, W = size
        if obs_mode == "onehot":
            self.single_observation_space = spaces.Box(
                0, 1, (H, W, C.N_CHANNELS), dtype=np.uint8
            )
        elif obs_mode == "pixels":
            self.single_observation_space = spaces.Box(
                0, 255, (4 * H, 4 * W, 3), dtype=np.uint8
            )
        elif obs_mode == "features":
            self.single_observation_space = spaces.Box(
                0, 1, (H * W * C.N_CHANNELS + 2 * C.N_TASKS,), dtype=np.float32
            )
        else:
            raise ValueError(f"unknown obs_mode {obs_mode!r}")

    # -- observation builders ---------------------------------------------

    def _obs(self):
        from gym_craftingworld_tpu.render import raster
        from gym_craftingworld_tpu.render.features import obs_features

        st = self._state
        if self.obs_mode == "onehot":
            return raster.render_onehot(st.objects, st.agent, st.holding)
        if self.obs_mode == "pixels":
            return raster.render_ray(st.objects, st.agent, st.holding)
        return obs_features(st)

    # -- vector env protocol ----------------------------------------------

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._seed = seed
            self._key = jax.random.PRNGKey(seed)
        self._key, sub = jax.random.split(self._key)
        keys = jax.random.split(sub, self.num_envs)
        self._state = core_reset(self.cfg, keys)
        return self._obs(), {}

    def step(self, actions):
        actions = jnp.asarray(actions, jnp.int32)
        self._state, res = _step_autoreset(self.cfg, self._state, actions)
        obs = self._obs()
        rewards = res.reward
        # success → terminated; step-cap → truncated (gymnasium semantics)
        terminated = res.reward == self.cfg.max_steps
        truncated = res.done & ~terminated
        infos = {
            "achieved_goal": self._state.achieved,
            "desired_goal": self._state.desired,
        }
        return obs, rewards, terminated, truncated, infos

    @property
    def state(self) -> EnvState:
        return self._state

    def close(self):
        pass
