"""Test configuration: run on a virtual 8-device CPU mesh with float64.

The standard JAX idiom for testing multi-device sharding without hardware
(SURVEY.md §4).  The platform is set through jax.config (it works even if
jax was imported before this file), and XLA_FLAGS is read at backend init.
Tests marked ``gpu`` run on the card with the platform list given
explicitly: ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU")
    return gpus[0]
