"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Tests validate numerics in float64 on CPU (the GPU path runs float32; the
SHT/solver code is dtype-polymorphic).  Multi-device sharding tests use the
8 virtual CPU devices as a stand-in for a multi-GPU host.  On-card checks
live in chip_smoke.py (run on the GPU machine), not in this suite.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled-executable caches between test modules.

    The full suite compiles ~700 XLA CPU executables in one process; near
    the end of the run the CPU backend's compiler has been observed to
    segfault inside backend_compile_and_load (reproducible only with the
    nearly-full suite in one process — every subset passes).  Clearing
    the jit caches at module boundaries keeps the live-executable count
    bounded; cross-module cache reuse is rare, so the time cost is small.
    """
    yield
    jax.clear_caches()
