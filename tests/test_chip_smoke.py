"""chip_smoke.py off the card: it refuses to run without a GPU, and each of
its phases passes on the CPU at small sizes with the rollout kernel in the
Pallas interpreter (the checks the card runs, rehearsed)."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke
from gym_craftingworld_tpu.ops import packed_fused as pf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_chip_smoke_refuses_cpu(args):
    """(j) Without a GPU chip_smoke.py exits non-zero and claims nothing."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py", *args],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


_PHASES = {
    "semantics": lambda dev: chip_smoke.phase1_semantics(dev, B=64, T=40),
    "rollout_fleet": lambda dev: chip_smoke.phase2_rollout_fleet(
        B=200, T=40, scan_steps=16, kernel_steps=16),
    "fast_ppo": lambda dev: chip_smoke.phase3_fast_ppo(dev, B=256, U=2),
    "user_api": lambda dev: chip_smoke.phase4_user_api(dev.platform, n=64),
    "four": lambda dev: chip_smoke.four_cards(B=1024, n_devices=8),
}


@pytest.mark.parametrize("phase", sorted(_PHASES))
def test_phase_passes_on_cpu_at_small_size(phase, monkeypatch):
    """Every phase's checks hold on the CPU (8 virtual devices stand in for
    the cards of ``--four``), with the kernel forced into interpret mode."""
    call = pf._call
    monkeypatch.setattr(
        pf, "_call",
        lambda kernel, n, block, interpret, **kw: call(kernel, n, block, True,
                                                       **kw))
    _PHASES[phase](jax.devices()[0])
