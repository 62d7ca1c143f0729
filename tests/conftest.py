"""Test configuration: force the CPU backend with 8 virtual devices.

Tests pin ``jax_platforms`` to CPU (before any backend is materialised,
also where a sitecustomize set another platform at interpreter start) and
expose 8 virtual host devices, so the multi-device sharding paths compile
and execute without accelerators.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("MPLBACKEND", "Agg")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu():
    assert jax.devices()[0].platform == "cpu"
    assert jax.device_count() == 8


@pytest.fixture
def rng():
    return np.random.RandomState(1234)
