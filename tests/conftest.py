"""Test configuration: the CPU backend with an 8-device virtual mesh.

Sharding tests run against XLA's host-platform device emulation. To run
the GPU-marked tests on a machine with a card, ask for its platform:
  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
(any JAX_PLATFORMS other than cpu leaves the platform choice to jax).
"""
import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute scale tests (deselect with -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (skips elsewhere; run with JAX_PLATFORMS=cuda)",
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests when the default device is not a GPU —
    decided here, per test, never while modules are imported."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(
            f"needs a GPU (default device is {platform}); run with "
            "JAX_PLATFORMS=cuda python -m pytest -m gpu"
        )

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
SMALLEXAMPLE = FIXTURES / "smallexample"


@pytest.fixture(scope="session")
def fixtures_dir():
    return FIXTURES


@pytest.fixture(scope="session")
def smallexample_dir():
    return SMALLEXAMPLE
