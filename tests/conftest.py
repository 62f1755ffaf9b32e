"""Test harness config.

Tests run on the CPU backend with 8 virtual devices, so multi-device sharding
logic is exercised without accelerator hardware (the analog of the reference
testing dask paths on the local threaded scheduler, reference
fixtures.py:8-17). Set XHIST_TEST_PLATFORM=gpu to leave JAX on its default
backend, as ``chip_smoke.py`` does for the chip-marked tests.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if os.environ.get("XHIST_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: run `python chip_smoke.py` on the card "
            "(it runs the chip-marked tests)"
        )
    return dev
