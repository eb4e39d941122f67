"""Test configuration: the CPU with 8 virtual devices unless told otherwise.

With ``JAX_PLATFORMS`` unset the tests run on the CPU, and on the CPU
XLA exposes 8 virtual devices so the sharding tests have a mesh.  Tests
marked ``gpu`` need a card; run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  Whether a card
is present is decided by the ``gpu`` fixture when a test runs, never at
collection, so every worker collects the same tests.
"""

import os

import pytest

_FORCE_CPU = "JAX_PLATFORMS" not in os.environ
if _FORCE_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
if os.environ["JAX_PLATFORMS"] == "cpu":
    # XLA_FLAGS is read at CPU-client init (lazy), so this still applies
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if _FORCE_CPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
    return dev
