"""Test configuration.

By default tests run on CPU with 8 virtual devices so the multi-device
sharding paths can be exercised without a GPU, and with x64 enabled so
device engines can be compared bit-for-bit with the float64 oracle.
``ALIGNER_TEST_PLATFORM=gpu`` leaves JAX on its default platform for the
``gpu``-marked tests (``python -m pytest tests -m gpu``).  Whether a card
is present is decided by the ``gpu`` fixture, inside each test.
"""

import os

_PLATFORM = os.environ.get("ALIGNER_TEST_PLATFORM", "cpu")

if _PLATFORM == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if _PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# the persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the
# checkout's .jax_cache) is configured when the package is imported
import aligner_tpu.backend  # noqa: E402,F401


@pytest.fixture
def gpu():
    """Skip unless the default JAX device is an NVIDIA GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (ALIGNER_TEST_PLATFORM=gpu)")


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the GPU batch kernel in Pallas interpret mode (CPU tests)."""
    from aligner_tpu.ops import pallas_dp

    monkeypatch.setattr(pallas_dp, "INTERPRET", True)


@pytest.fixture
def rng():
    import numpy as np

    return np.random.default_rng(0)
