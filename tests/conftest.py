"""Test harness config.

By default the tests run on an 8-virtual-device CPU platform, so they are
deterministic, parallel-safe and need no accelerator.  With
``MITR_CHIP_TESTS=1`` the platform is left to JAX, which on a machine with a
GPU runs the tests marked ``chip`` on the card (``python chip_smoke.py``
does this as its last phase).  Tests marked ``chip`` skip when the default
backend is not a GPU; the decision is taken in a fixture, at run time.

The persistent compilation cache is off for the tests: XLA:CPU executables
are tied to the host's instruction set, and a populated cache in the
checkout would travel with every copy of the tree.
"""
import os

CHIP_RUN = os.environ.get("MITR_CHIP_TESTS") == "1"

if not CHIP_RUN:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

if not CHIP_RUN:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip ``chip``-marked tests unless JAX's default backend is a GPU."""
    if (request.node.get_closest_marker("chip") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")


# Stability: the full suite compiles many hundreds of distinct XLA:CPU
# programs in one process; with all of them held live the process has been
# seen to segfault near the end of the run.  Dropping the in-memory
# executable caches between test modules bounds that accumulation.
@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
