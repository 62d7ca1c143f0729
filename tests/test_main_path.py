"""Main-path hygiene: imports without the model libraries and the
compile-cache location."""

import os
import subprocess
import sys

import jax

from gym_craftingworld_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_WITHOUT_FLAX = f"""
import sys
for m in ("flax", "flax.linen", "flax.struct", "orbax", "orbax.checkpoint"):
    sys.modules[m] = None  # any import of them now raises ImportError
sys.path.insert(0, {REPO!r})
import gym_craftingworld_tpu
import gym_craftingworld_tpu.api
import gym_craftingworld_tpu.core
import gym_craftingworld_tpu.ops
import gym_craftingworld_tpu.parallel.sharded_engine
import gym_craftingworld_tpu.render.features
import gym_craftingworld_tpu.train.fast_ppo
import bench
import chip_smoke
from gym_craftingworld_tpu.api import CraftingWorldVectorEnv
obs, _ = CraftingWorldVectorEnv(4, obs_mode="features").reset()
assert obs.shape == (4, 21 * 21 * 12 + 18), obs.shape
print("IMPORTED")
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def test_main_path_imports_without_flax_or_orbax():
    """(h) The package, its main-path modules, bench.py and chip_smoke.py
    import (and the vector env's feature obs runs) with flax and orbax
    blocked."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_WITHOUT_FLAX],
                       capture_output=True, text=True, env=_env(),
                       cwd=REPO, timeout=300)
    assert r.returncode == 0 and "IMPORTED" in r.stdout, r.stderr[-3000:]


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """(i) A set JAX_COMPILATION_CACHE_DIR wins and nothing is configured."""
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compilation_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, tmp_path):
    """(i) Unset, the cache is <checkout>/.jax_cache whatever the cwd."""
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compilation_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
