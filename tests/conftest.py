"""Test env setup (SURVEY.md §4.3): the CPU backend with 8 virtual devices,
unless JAX_PLATFORMS names another platform.

Tests that need the GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips them where JAX finds no GPU. On a machine with one:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/gpu
"""

import os
import sys

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(__file__))  # make `sim` importable


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX finds none")


@pytest.fixture(scope="session")
def gpu_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    from kmerax.utils.compile_cache import enable
    enable()
    return dev
