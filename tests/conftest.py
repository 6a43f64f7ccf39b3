"""Test configuration.

On the CPU (``JAX_PLATFORMS=cpu``, the tier-1 run) sharding paths are
validated on a virtual 8-device host-platform mesh (the standard JAX
recipe); the flag must be set before jax initializes, hence the env mutation
at import time. It only shapes the CPU platform, so the same suite runs on
the GPU, where ``python -m pytest tests -m gpu`` runs the card-only tests.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_OBJECTS = os.environ.get("CRENDER_OBJECTS",
                                   "/root/reference/objects")
# committed fallbacks: the repo stands alone when the reference mount is
# absent — tiny meshes are vendored in assets/, bigger reference-only
# meshes (T-Rex, bunny, basketball) skip their tests
VENDORED_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def _asset(name, vendored=True):
    p = os.path.join(REFERENCE_OBJECTS, name)
    if os.path.exists(p):
        return p
    if vendored:
        p = os.path.join(VENDORED_ASSETS, name)
        if os.path.exists(p):
            return p
    pytest.skip(f"{name} unavailable (no reference mount, not vendored)")


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests when JAX's default platform is not a
    GPU (decided here, at run time, never while collecting)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU (compiled Triton kernel); run "
                    "`python -m pytest tests -m gpu` on the card")


@pytest.fixture
def cube_path():
    return _asset("cube.obj")


@pytest.fixture
def cube2_path():
    return _asset("Cube2.obj")


@pytest.fixture
def trex_path():
    return _asset("T-Rex.obj", vendored=False)


@pytest.fixture
def basketball_path():
    return _asset("basketball.obj", vendored=False)


@pytest.fixture
def igor_sphere_path():
    return _asset("igor_sphere.obj")


# ---------------------------------------------------------------------------
# slow-test marking: the multi-view suite dominates the full-suite wall;
# `pytest -m "not slow"` keeps an iteration loop under a minute while CI
# still runs everything.
SLOW_MODULES = {"test_multiview"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-view / large-scene tests (~minutes); "
        "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skipped elsewhere")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__.rsplit(".", 1)[-1] in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
