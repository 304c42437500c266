"""Test bootstrap: run all tests on a virtual 8-device CPU mesh.

Kernel unit tests run on the CPU backend, so the suite needs no GPU;
sharding tests use --xla_force_host_platform_device_count.  Tests that
need the card carry the ``chip`` marker and decide inside a fixture or
the test body whether a card is present (never at import time: every
xdist worker must collect the same tests).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips on the CPU backend")
