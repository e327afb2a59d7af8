"""Test configuration: CPU JAX with a virtual 8-device mesh.

Tests run on the CPU (``JAX_PLATFORMS=cpu`` unless the caller set another
platform); sharding tests use ``xla_force_host_platform_device_count`` per
the standard JAX recipe. Tests marked ``gpu`` need an NVIDIA GPU and skip
elsewhere: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs them
on the card. This must run before jax is imported anywhere in the test
process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# Cache even small, quick compiles: the suite compiles many tiny programs.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from raytracingc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

BOX_SCENE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "examples", "box_scene.txt"
)

REFERENCE_DIR = "/root/reference"


@pytest.fixture(scope="session")
def reference_dir() -> str:
    if not os.path.isdir(REFERENCE_DIR):
        pytest.skip("reference sources not mounted")
    return REFERENCE_DIR


@pytest.fixture(scope="session")
def models_dir(reference_dir) -> str:
    return os.path.join(reference_dir, "3Dmodels")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided here, not at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="session")
def box_scene_path() -> str:
    """The in-repo triangles.txt room (10 triangles + the default sphere)."""
    return BOX_SCENE


@pytest.fixture
def rtol():
    return 1e-5


def assert_allclose(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)
