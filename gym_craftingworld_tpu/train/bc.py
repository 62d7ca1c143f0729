"""Imitation learning: expert demonstrations → behavioral cloning.

CraftingWorld was built for demonstration-conditioned learning
("Compositional Plan Vectors", NeurIPS 2019 — reference README.md:8), but the
reference repo ships no data-collection or training code. This module closes
that loop framework-natively:

  * :func:`collect_demos` drives the scripted expert (agents/expert.py)
    through seeded episodes of the single-env API shim and records
    (goal-conditioned feature, expert action) pairs;
  * :func:`bc_train` clones the flagship actor-critic policy
    (models/actor_critic.py) from them with a jitted cross-entropy trainer —
    the compute path is the same bf16 MLP the PPO learner uses, so
    a BC-pretrained policy drops straight into train/ppo.py for fine-tuning;
  * :func:`evaluate_bc` rolls the cloned policy greedily and reports success.

Demo collection is host-side by necessity (the expert is a host planner);
training and evaluation forward passes are jitted.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
import optax

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.agents.expert import ExpertPolicy
from gym_craftingworld_tpu.api.gym_env import CraftingWorldEnvRay
from gym_craftingworld_tpu.models.actor_critic import init_params, obs_features


class Demos(NamedTuple):
    """Flat demonstration dataset (episodes concatenated)."""

    features: np.ndarray  # f32[N, D] — obs_features rows
    actions: np.ndarray  # i32[N] — expert action per row
    episode: np.ndarray  # i32[N] — source episode index (for splits)

    @property
    def num_episodes(self) -> int:
        return int(self.episode.max()) + 1 if self.episode.size else 0

    def save(self, path: str) -> None:
        np.savez_compressed(path, features=self.features,
                            actions=self.actions, episode=self.episode)

    @classmethod
    def load(cls, path: str) -> "Demos":
        with np.load(path) as z:
            return cls(z["features"], z["actions"], z["episode"])


def collect_demos(num_episodes: int, seed: int = 0,
                  only_successful: bool = True, random_warmup: int = 0,
                  feature_fn=None, **env_kwargs) -> Demos:
    """Expert demonstrations over ``num_episodes`` seeded resets.

    ``env_kwargs`` pass through to :class:`CraftingWorldEnvRay` (grid size,
    ``selected_tasks``, ``stacking``, ``fixed_init_state`` pool, ...). With
    ``only_successful`` (default) episodes where the expert failed are
    dropped, so the dataset contains only goal-reaching behaviour.

    ``feature_fn`` overrides the per-state feature builder (default
    ``obs_features``; the CPV protocol passes ``obs_features_init``).

    ``random_warmup > 0`` takes 0..N unrecorded random *move* steps before
    handing control to the expert — standard noise injection that widens
    state coverage so a cloned policy recovers from off-demonstration states
    (essential for compositional execution, where task handoffs land the
    agent in positions no single-task demonstration starts from).
    """
    env = CraftingWorldEnvRay(seed=seed, **env_kwargs)
    wrng = np.random.RandomState(seed + 977)
    feats: list[np.ndarray] = []
    acts: list[int] = []
    eps: list[int] = []
    kept = 0
    for _ in range(num_episodes):
        env.reset()
        if random_warmup:
            dead = False
            for _ in range(wrng.randint(0, random_warmup + 1)):
                _, _, done, _ = env.step(int(wrng.randint(4)))
                if done:  # warmup stumbled into the goal; drop the episode
                    dead = True
                    break
            if dead:
                continue
        expert = ExpertPolicy(env)
        ep_f: list[np.ndarray] = []
        ep_a: list[int] = []
        reward = -1
        for _ in range(env.MAX_STEPS):
            a = expert.action()
            if a is None:  # stalled: mirror ExpertPolicy.run_episode
                a = C.ACTION_UP
            ep_f.append(np.asarray((feature_fn or obs_features)(env.state))[0])
            ep_a.append(int(a))
            _, reward, done, _ = env.step(int(a))
            if done:
                break
        if only_successful and reward != env.MAX_STEPS:
            continue
        feats.extend(ep_f)
        acts.extend(ep_a)
        eps.extend([kept] * len(ep_a))
        kept += 1
    if not feats:
        raise ValueError("expert produced no successful demonstrations")
    return Demos(
        np.stack(feats).astype(np.float32),
        np.asarray(acts, np.int32),
        np.asarray(eps, np.int32),
    )


def augment_stacked_goals(demos: Demos, height: int, width: int,
                          first_task: int, second_task: int) -> Demos:
    """Plan-space augmentation for compositional execution (no new rollouts).

    Re-labels the *goal masks* of single-task demonstration rows so the
    cloned policy learns to execute the stacked set {first, second} in order,
    without a single stacked trajectory ever being collected:

      * rows demonstrating ``first_task`` get ``second_task`` added to
        ``desired`` (act on *first* while *second* is still pending);
      * rows demonstrating ``second_task`` get ``first_task`` added to both
        ``desired`` and ``achieved`` (act on *second* once *first* is done).

    Exact for latching tasks (MakeBread/EatBread/BuildHouse/ChopTree/
    ChopRock — craftingworld_ray.py:657-665,686-697), whose achieved bits
    never un-set; for the non-latching Move*/GoToHouse bits the "already
    done" relabel is an approximation. The returned Demos holds only the
    augmented rows — concatenate with the originals for training.
    """
    grid_dim = height * width * C.N_CHANNELS
    des = demos.features[:, grid_dim : grid_dim + C.N_TASKS]
    rows_first = des[:, first_task] == 1
    rows_second = des[:, second_task] == 1
    f1 = demos.features[rows_first].copy()
    f1[:, grid_dim + second_task] = 1
    f2 = demos.features[rows_second].copy()
    f2[:, grid_dim + first_task] = 1
    f2[:, grid_dim + C.N_TASKS + first_task] = 1
    return Demos(
        np.concatenate([f1, f2]),
        np.concatenate([demos.actions[rows_first],
                        demos.actions[rows_second]]),
        np.concatenate([demos.episode[rows_first],
                        demos.episode[rows_second]]),
    )


def concat_demos(*parts: Demos) -> Demos:
    """Concatenate datasets, re-basing episode indices to stay unique."""
    feats, acts, eps = [], [], []
    base = 0
    for d in parts:
        feats.append(d.features)
        acts.append(d.actions)
        eps.append(d.episode + base)
        base += d.num_episodes
    return Demos(np.concatenate(feats), np.concatenate(acts),
                 np.concatenate(eps))


def bc_train(demos: Demos, key, height: int, width: int, hidden: int = 256,
             epochs: int = 30, batch_size: int = 256, lr: float = 1e-3,
             model_and_params=None):
    """Clone the expert: cross-entropy on actions over shuffled minibatches.

    Returns ``(model, params, metrics)`` where metrics carries per-epoch
    ``loss`` and final training ``accuracy``. By default trains the flagship
    ActorCritic; pass ``model_and_params`` (e.g. from models/cpv.init_cpv) to
    clone any family whose ``apply(params, obs) -> (logits, value)``. The
    params are reusable as a PPO init (the value head stays at its random
    init; only the policy head and torso receive BC gradients).
    """
    from gym_craftingworld_tpu.models.actor_critic import feature_dim

    if demos.features.shape[1] != feature_dim(height, width):
        raise ValueError(
            f"demo feature width {demos.features.shape[1]} does not match "
            f"a {height}x{width} grid ({feature_dim(height, width)})"
        )
    key, init_key = jax.random.split(key)
    if model_and_params is None:
        model, params = init_params(init_key, height, width, hidden)
    else:
        model, params = model_and_params

    tx = optax.adam(lr)
    opt_state = tx.init(params)
    feats = jnp.asarray(demos.features)
    actions = jnp.asarray(demos.actions)
    n = feats.shape[0]
    batch_size = min(batch_size, n)

    @jax.jit
    def train_step(params, opt_state, fb, ab):
        def loss_fn(p):
            logits, _ = model.apply(p, fb)
            logp = jax.nn.log_softmax(logits)
            return -jnp.take_along_axis(logp, ab[:, None], axis=1).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    steps = max(1, n // batch_size)
    for epoch in range(epochs):
        key, k = jax.random.split(key)
        perm = jax.random.permutation(k, n)
        ep_loss = 0.0
        for i in range(steps):
            idx = perm[i * batch_size : (i + 1) * batch_size]
            params, opt_state, loss = train_step(
                params, opt_state, feats[idx], actions[idx]
            )
            ep_loss += float(loss)
        losses.append(ep_loss / steps)

    metrics = {
        "loss": losses,
        "accuracy": float(bc_accuracy(model, params, demos)),
    }
    return model, params, metrics


def bc_accuracy(model, params, demos: Demos) -> float:
    """Fraction of dataset rows where argmax policy == expert action."""
    logits, _ = jax.jit(model.apply)(params, jnp.asarray(demos.features))
    return float(
        (jnp.argmax(logits, axis=-1) == jnp.asarray(demos.actions)).mean()
    )


def evaluate_bc(model, params, num_episodes: int, seed: int = 0,
                **env_kwargs) -> dict:
    """Greedy rollouts of the cloned policy; returns success/return stats.

    Uses the same single-env shim configuration demos were collected with, so
    pool-based setups (``fixed_init_state``) evaluate on the demonstrated
    layouts. Forward passes are jitted; the env loop is the interactive shim.
    """
    env = CraftingWorldEnvRay(seed=seed, **env_kwargs)
    apply = jax.jit(lambda p, f: model.apply(p, f)[0])
    successes, steps_used = 0, []
    for _ in range(num_episodes):
        env.reset()
        reward = -1
        for t in range(env.MAX_STEPS):
            a = int(jnp.argmax(apply(params, obs_features(env.state))[0]))
            _, reward, done, _ = env.step(a)
            if done:
                break
        if reward == env.MAX_STEPS:
            successes += 1
            steps_used.append(t + 1)
    return {
        "success_rate": successes / num_episodes,
        "mean_success_steps": float(np.mean(steps_used)) if steps_used else None,
        "episodes": num_episodes,
    }


def evaluate_bc_stacked(model, params, num_episodes: int, seed: int = 0,
                        n_tasks: int = 2, **env_kwargs) -> dict:
    """Greedy rollouts on episodes whose goal stacks exactly ``n_tasks`` bits.

    ``stacking=True`` draws 1..number_of_tasks tasks per reset
    (craftingworld_ray.py:169-176); this keeps resetting until a reset with
    exactly ``n_tasks`` desired bits comes up, then rolls the policy — the
    compositional-execution measurement of examples/compositional_tasks.py.
    """
    env = CraftingWorldEnvRay(seed=seed, stacking=True, **env_kwargs)
    apply = jax.jit(lambda p, f: model.apply(p, f)[0])
    successes, tries, resets = 0, 0, 0
    while tries < num_episodes and resets < 50 * num_episodes:
        env.reset()
        resets += 1
        if int(np.asarray(env.desired_goal_vector).sum()) != n_tasks:
            continue
        tries += 1
        reward = -1
        for _ in range(env.MAX_STEPS):
            a = int(jnp.argmax(apply(params, obs_features(env.state))[0]))
            _, reward, done, _ = env.step(a)
            if done:
                break
        successes += reward == env.MAX_STEPS
    return {"success_rate": successes / max(tries, 1), "episodes": tries}
