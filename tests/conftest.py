"""Test harness: an 8-virtual-device CPU JAX, so sharding/pjit paths are
exercised without accelerator hardware (SURVEY.md §4: multi-host behavior
is tested with XLA_FLAGS=--xla_force_host_platform_device_count).

JAX_PLATFORMS decides the backend: the fast tier runs with
JAX_PLATFORMS=cpu; tests marked `gpu` need the card and skip without one
(run them on a GPU machine, in one process:
`python -m pytest -m gpu -n 0 tests/`).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

from scheme_raytrace.utils import smoke  # noqa: E402

# Persistent compilation cache: the tier is dominated by single-threaded
# XLA CPU compiles of large scan graphs; caching them on disk makes
# re-runs compile-free (entries key on the HLO hash, so source changes
# invalidate naturally).  JAX_COMPILATION_CACHE_DIR places it.
smoke.enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--slow", action="store_true", default=False,
        help="also run the slow tier (the multi-minute parity renders); "
             "default `pytest -q` stays the fast tier")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow"):
        return
    skip = pytest.mark.skip(reason="slow tier — run with --slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _device_for_test(request):
    """Tests marked `gpu` skip without a card; every other test runs on
    the 8-device CPU mesh.  Decided here, per test, never at import."""
    dev = jax.devices()[0]
    if request.node.get_closest_marker("gpu") is not None:
        if dev.platform != "gpu":
            pytest.skip(f"needs a GPU (JAX platform is {dev.platform})")
        return
    assert dev.platform == "cpu", (
        f"the fast tier runs on the CPU: set JAX_PLATFORMS=cpu "
        f"(platform is {dev.platform})")
    assert len(jax.devices()) == 8


@pytest.fixture
def key():
    return jax.random.key(0)


def mc_keys(n=4):
    return [jax.random.key(i) for i in range(n)]
