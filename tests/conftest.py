"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device hardware is not available in CI; sharded code paths are
validated on XLA's host platform with 8 virtual devices (the strategy the
survey prescribes in SURVEY.md §4). The platform is forced via jax.config,
which works as long as no backend has been initialized yet. Tests marked
``gpu`` need the card and skip elsewhere (see the ``gpu`` fixture)."""
import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

# Tests never use the persistent compile cache: XLA:CPU serializes AOT
# executables with compile-machine feature flags, and both writing and
# reloading them has crashed jax 0.9.0 here. The environment variable also
# reaches the child processes some tests start.
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax  # noqa: E402

# NBODYHPC_TEST_DEVICE=gpu leaves the platform alone, so that the `gpu`
# tests can run on the card (chip_smoke.py sets it)
if os.environ.get("NBODYHPC_TEST_DEVICE") != "gpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """The GPU for tests marked ``gpu``; skips when JAX has none (decided
    here, at run time, never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (on the card: NBODYHPC_TEST_DEVICE=gpu "
                    "python -m pytest tests/ -m gpu)")
    return jax.devices()[0]
