"""Test harness: CPU backend with 8 virtual devices, float64 enabled.

Must run before any jax import (hence env vars here, at conftest import
time).  The engine is device-agnostic; tests validate numerics on CPU and
multi-device sharding on the virtual device mesh.  Tests that need a GPU
carry the ``gpu`` marker and take the ``gpu_devices`` fixture, which skips
them unless JAX reports a GPU (e.g. ``JAX_PLATFORMS=cuda pytest -m gpu``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_devices():
    """The GPU devices; skips the test where JAX reports none.  Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX reports "
                    f"{devices[0].platform!r}); the card is checked by "
                    "chip_smoke.py")
    return devices
