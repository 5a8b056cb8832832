"""Test harness config.

Tests run on the CPU, on a virtual 8-device mesh (deterministic simulation
of the sharded paths), unless ``JAX_PLATFORMS`` names another platform.
Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on the card
they run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist

(``chip_smoke.py`` runs them in its last phase).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {platform}")
