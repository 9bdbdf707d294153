"""Test configuration.

Tests run on a virtual 8-device CPU mesh (the analogue of the reference's
``mpirun -np N`` single-box testing with NUM_MPI_PROCS ≤ 8,
packages/tpetra/core/test/Map/CMakeLists.txt:2-23) and with x64 enabled so
fp64 convergence tolerances (Belos default 1e-8) are meaningful.
"""
import os

# must be set before jax import: the unit tests run on the virtual CPU
# mesh unless the caller names a platform (the GPU-marked tests are run
# on the card with JAX_PLATFORMS=cuda, see README "Testing")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

from trilinos_tpu.utils.compile_cache import enable_compile_cache

jax.config.update("jax_enable_x64", True)
# persistent compile cache: shard_map/while-loop programs dominate suite
# wall time; the cache survives across pytest processes
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    here, at run time, never while a module is imported."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run on the card: JAX_PLATFORMS=cuda "
                    "python -m pytest tests/ -m gpu)")
    return devs[0]


# The XLA:CPU compiler deterministically SEGFAULTS after ~535
# compilations in one process on this box (independent of which test
# lands there and of the persistent cache — measured by bisecting a
# single-process run; every test passes in per-file runs). Bound the
# in-process compiler state by dropping JAX's compiled-program caches
# every N tests; recompiles reload from the persistent cache cheaply.
_TEST_COUNT = [0]
_CLEAR_EVERY = int(os.environ.get("TT_CLEAR_CACHES_EVERY", "150"))


@pytest.fixture(autouse=True)
def _bound_compiler_state():
    yield
    _TEST_COUNT[0] += 1
    if _CLEAR_EVERY and _TEST_COUNT[0] % _CLEAR_EVERY == 0:
        jax.clear_caches()


def pytest_collection_modifyitems(config, items):
    """Auto-mark the heavyweight files so `-m "not slow"` is a quick
    (<2 min) suite; the full suite stays the default."""
    slow_files = {"test_dist.py", "test_baseline_configs.py",
                  "test_dist_precond.py", "test_combine_modes.py"}
    for item in items:
        if item.path.name in slow_files:
            item.add_marker(pytest.mark.slow)
