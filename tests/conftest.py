"""Test harness configuration.

Tests run on CPU with 8 virtual devices so the multi-card sharding paths are
exercised without a GPU (the reference requires a real GPU for its gtest
suite, ``msb/tests/main.cu:20-34``; here only the ``gpu``-marked tests do).
An explicit ``JAX_PLATFORMS`` (e.g. ``cuda`` on the card) is kept.

Environment must be set before the first ``import jax`` anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# 64-bit key dtypes are accepted at the API boundary (then decomposed to
# uint32 planes internally); tests need x64 to build those inputs.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's backend is a GPU.  Decided
    when the test runs, never at import, so every xdist worker collects
    the same tests."""
    if request.node.get_closest_marker("gpu") is not None and \
            jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs these "
                    "phases on the card)")
