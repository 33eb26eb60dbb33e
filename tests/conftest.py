"""Test config: run everything on a virtual 8-device CPU mesh.

This is the standard JAX trick for testing distributed code without a
multi-GPU machine (SURVEY.md §4): the sharding/pjit tests see 8
devices, and all numerical tests are deterministic on CPU. XLA_FLAGS
must be set before the first backend initialization; the platform is
pinned through jax.config too (CPU unless JAX_PLATFORMS names another).
Tests marked `chip` need a GPU and skip elsewhere; on a GPU machine run
them with `JAX_PLATFORMS=cuda python -m pytest tests -m chip`.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache: the march loops are compile-heavy on CPU;
# cache across test runs.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_test_cache")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """The suite now compiles 200+ executables in one process; jaxlib's
    CPU compiler has been observed to segfault partway through a full
    one-process run (compile #~150+, backend_compile_and_load — not
    OOM, 120+ GB free). Dropping the in-process executable/tracing
    caches at module boundaries keeps the live-executable count bounded;
    the persistent on-disk cache (JAX_COMPILATION_CACHE_DIR) makes
    re-loads cheap."""
    yield
    jax.clear_caches()
