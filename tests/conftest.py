"""Test configuration: run JAX on an 8-device virtual CPU mesh.

Sharding is tested on a virtual 8-device CPU mesh (SURVEY.md §7 step 8),
so the CPU platform is pinned before any test module imports jax.  Tests
that need the card carry the ``gpu`` marker and skip elsewhere through the
``gpu`` fixture; ``pytest -m gpu`` selects only them and leaves JAX on its
default platform, the GPU.
"""
import os

import pytest


def pytest_configure(config):
    if config.option.markexpr.strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, so
    every xdist worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU: run `pytest -m gpu` on the card")
    return jax.devices()[0]
