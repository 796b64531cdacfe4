"""Shared utilities."""

from .pytree import register_arrays_pytree
from .runtime import require_gpu, use_compile_cache

__all__ = ["register_arrays_pytree", "require_gpu", "use_compile_cache"]
