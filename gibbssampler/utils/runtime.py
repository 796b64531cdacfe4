"""Process set-up shared by the entry points (benchmark, smoke test, tools):
where JAX keeps its persistent compilation cache, and the accelerator guard
that keeps a measurement from silently running on the CPU."""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["CHECKOUT_CACHE_DIR", "use_compile_cache", "require_gpu"]

# fixed in-checkout location (listed in .gitignore): JAX keys cache entries
# by program, so a directory that never moves keeps hitting across runs
CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    at import) and nothing is changed; otherwise the cache goes to
    :data:`CHECKOUT_CACHE_DIR`.  Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU (timings and on-card
    checks must fail rather than fall back to the CPU)."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's default backend is {backend!r} "
            f"(devices: {jax.devices()})")
