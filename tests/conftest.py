"""Test configuration: an 8-device virtual CPU mesh.

The suite runs on the CPU, where all sharding tests use XLA's host-platform
device emulation. These env vars must be set before jax is imported
anywhere. With `NWW_TEST_PLATFORM=gpu` the tests see the real devices
instead; the `gpu`-marked tests (`pytest -m gpu`) run only there.
"""

import os

ON_CARD = os.environ.get("NWW_TEST_PLATFORM") == "gpu"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(10)


@pytest.fixture
def gpu_device():
    """The first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the first device is {dev.platform}")
    return dev
