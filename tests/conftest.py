"""Test harness configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu`` unless the caller set
another platform) with 8 virtual devices
(``--xla_force_host_platform_device_count=8``), so multi-device sharding
paths compile and execute without accelerators, and with x64 enabled, so
numerical-parity tests against float64 NumPy/SciPy oracles are meaningful.

Tests marked ``gpu`` need a GPU: the ``_gpu_only`` fixture skips them,
with a reason, when JAX finds none.  On a machine with a GPU run them with
``python -m pytest tests -m gpu``.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a ``gpu``-marked test when JAX has no GPU (decided here, at
    run time, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; JAX found "
                    f"{jax.devices()[0].platform} only")


@pytest.fixture
def rng():
    return np.random.default_rng(20260816)
