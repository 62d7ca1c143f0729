"""Compositional plan-vector policy (CPV family).

CraftingWorld was published as the testbed for "Plan Arithmetic:
Compositional Plan Vectors" (NeurIPS 2019 — reference README.md:8), whose
core idea is a task-embedding space where composite tasks are *sums* of their
parts. The reference repo ships the env only; this module provides the
framework-native model family:

  * each of the 9 skills owns a learned embedding row ``E[i]``;
  * the policy is conditioned on the **residual plan vector**
    ``plan = (desired - achieved) @ E`` — what is left to do — so plan
    vectors compose additively *by construction*:
    ``plan({A, B}) = plan({A}) + plan({B})``, and finishing A while pursuing
    {A, B} leaves exactly the vector that conditions the single-task-B policy;
  * the torso is the same bf16 MLP as the flagship actor-critic,
    so the family drops into the BC trainer (train/bc.py) and the PPO
    learner unchanged.

The practical payoff (exercised in tests/test_cpv.py and
examples/compositional_tasks.py): train on *single-task* expert
demonstrations only, then execute *stacked* goal sets zero-shot by walking
the residual plan vector down to zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from flax import linen as nn

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.models.actor_critic import feature_dim


class CPVPolicy(nn.Module):
    """Actor-critic over [grid features, residual plan vector].

    Consumes the same flat ``obs_features`` rows as the flagship model
    (grid one-hot ++ desired ++ achieved) and splits them internally, so it
    is API-compatible with train/bc.py and train/ppo.py.
    """

    height: int
    width: int
    embed_dim: int = 32
    hidden: int = 256
    n_actions: int = C.N_ACTIONS
    with_init: bool = False  # consume obs_features_init rows (grid ++ goal
    # bits ++ init-grid one-hot): the Move*/GoToHouse semantics compare the
    # live grid against the reset grid, so item-origin cells are invisible
    # without the init view (models/actor_critic.obs_features_init)

    def plan_vector(self, desired, achieved):
        """Residual plan embedding: (desired - achieved) @ E."""
        E = self.param(
            "task_embed",
            nn.initializers.normal(stddev=1.0),
            (C.N_TASKS, self.embed_dim),
        )
        return (desired - achieved).astype(jnp.float32) @ E

    @nn.compact
    def __call__(self, obs):
        from gym_craftingworld_tpu.models.actor_critic import feature_dim_init

        grid_dim = self.height * self.width * C.N_CHANNELS
        want = (feature_dim_init(self.height, self.width) if self.with_init
                else feature_dim(self.height, self.width))
        if obs.shape[-1] != want:
            raise ValueError(
                f"obs width {obs.shape[-1]} != {want} for "
                f"CPVPolicy(with_init={self.with_init}, "
                f"{self.height}x{self.width})"
            )
        grid = obs[..., :grid_dim]
        desired = obs[..., grid_dim : grid_dim + C.N_TASKS]
        achieved = obs[..., grid_dim + C.N_TASKS : grid_dim + 2 * C.N_TASKS]
        if self.with_init:
            init = obs[..., grid_dim + 2 * C.N_TASKS :]
            grid = jnp.concatenate([grid, init], axis=-1)
        plan = self.plan_vector(desired, achieved)

        x = nn.Dense(self.hidden, dtype=jnp.bfloat16, name="grid0")(
            grid.astype(jnp.bfloat16)
        )
        x = nn.relu(x)
        x = jnp.concatenate([x, plan.astype(jnp.bfloat16)], axis=-1)
        x = nn.Dense(self.hidden // 2, dtype=jnp.bfloat16, name="torso1")(x)
        x = nn.relu(x)
        logits = nn.Dense(self.n_actions, dtype=jnp.float32, name="policy")(x)
        value = nn.Dense(1, dtype=jnp.float32, name="value")(x)
        return logits, value.squeeze(-1)


def init_cpv(key, height: int, width: int, embed_dim: int = 32,
             hidden: int = 256, with_init: bool = False):
    from gym_craftingworld_tpu.models.actor_critic import feature_dim_init

    model = CPVPolicy(height=height, width=width, embed_dim=embed_dim,
                      hidden=hidden, with_init=with_init)
    dim = (feature_dim_init(height, width) if with_init
           else feature_dim(height, width))
    dummy = jnp.zeros((1, dim), jnp.float32)
    return model, model.init(key, dummy)


class CPVGridPolicy(nn.Module):
    """CPV at canonical scale: conv torso, goal via residual plan vector ONLY.

    Consumes the exact (planes, extras) tensors of models/grid_policy.py so
    the SnapDataset trainer (train/dagger.bc_train_snaps / _bc_epoch) and
    the on-device rollout machinery drop in unchanged — but the goal
    conditioning is protocol-pure CPV:

      * of the 49 feature planes it reads only the first 18 (current objects
        8, agent 1, init objects 8, init-agent mark 1) — the broadcast
        desired/achieved/residual planes are explicitly sliced away;
      * of the 33 extras it reads holding (4) and the agent row/col (2);
        the desired/achieved rows (extras[..., 4:13] / [..., 13:22], see
        grid_policy._scalar_features) enter ONLY as the residual plan
        embedding ``(desired - achieved) @ E`` — so composite plans are sums
        of their parts by construction, the Plan-Arithmetic claim
        (reference README.md:8) this model family exists to test.
    """

    channels: int = 64
    hidden: int = 1024
    embed_dim: int = 32
    n_actions: int = C.N_ACTIONS

    @nn.compact
    def __call__(self, planes, extras):
        x = planes[..., :18].astype(jnp.bfloat16)  # objects+agent+init only
        hold = extras[..., :4].astype(jnp.bfloat16)
        desired = extras[..., 4:13]
        achieved = extras[..., 13:22]
        rc = extras[..., -2:].astype(jnp.bfloat16)
        E = self.param(
            "task_embed",
            nn.initializers.normal(stddev=1.0),
            (C.N_TASKS, self.embed_dim),
        )
        plan = (desired - achieved).astype(jnp.float32) @ E

        for i in range(3):
            x = nn.Conv(self.channels, (3, 3), dtype=jnp.bfloat16,
                        name=f"conv{i}")(x)
            x = nn.relu(x)
        x = nn.Conv(32, (1, 1), dtype=jnp.bfloat16, name="squeeze")(x)
        x = nn.relu(x)
        x = x.reshape(x.shape[0], -1)
        x = jnp.concatenate(
            [x, hold, rc, plan.astype(jnp.bfloat16)], axis=-1
        )
        x = nn.Dense(self.hidden, dtype=jnp.bfloat16, name="dense0")(x)
        x = nn.relu(x)
        x = nn.Dense(self.hidden // 2, dtype=jnp.bfloat16, name="dense1")(x)
        x = nn.relu(x)
        logits = nn.Dense(self.n_actions, dtype=jnp.float32, name="policy")(x)
        value = nn.Dense(1, dtype=jnp.float32, name="value")(x)
        return logits, value.squeeze(-1)


def init_cpv_grid(key, cfg, channels: int = 64, hidden: int = 1024,
                  embed_dim: int = 32):
    from gym_craftingworld_tpu.models.grid_policy import N_EXTRAS, N_PLANES

    model = CPVGridPolicy(channels=channels, hidden=hidden,
                          embed_dim=embed_dim)
    dummy_p = jnp.zeros((1, cfg.height, cfg.width, N_PLANES), jnp.bfloat16)
    dummy_e = jnp.zeros((1, N_EXTRAS), jnp.bfloat16)
    return model, model.init(key, dummy_p, dummy_e)


def plan_of(model: CPVPolicy, params, desired, achieved) -> jax.Array:
    """The residual plan vector for given goal masks (plan arithmetic probe)."""
    E = params["params"]["task_embed"]
    return (jnp.asarray(desired) - jnp.asarray(achieved)).astype(
        jnp.float32
    ) @ E
