"""Test platform: the CPU with 8 virtual devices, unless a platform is set.

The correctness tests run on the CPU, hermetic, and the 8 virtual devices
exercise the multi-device sharding paths. Tests that need a GPU carry the
`gpu` marker and skip elsewhere; they run on the card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`, which chip_smoke.py
does in its own process (it sets the platform before it gets here).

XLA_FLAGS is read when the CPU backend initializes, which has not happened
yet when this file is imported, so setting it here still works.
"""

import os

import jax
import pytest

if not jax.config.jax_platforms:
    jax.config.update("jax_platforms", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a `gpu`-marked test unless JAX runs on a GPU (decided here, at
    run time, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
