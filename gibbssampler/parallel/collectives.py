"""Device-side cross-chain statistics (jittable, psum-able).

The numpy diagnostics in gibbssampler.diagnostics run offline on pulled
chains; these run *inside* jitted/sharded programs over the chain axis, so a
mesh-sharded run computes pooled statistics with XLA collectives over the
device interconnect instead of shipping chains to the host (the in-band
replacement for the reference's offline SLURM-output pooling,
config.py:161-189)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["pooled_moments", "split_rhat_device", "acceptance_mean"]


def pooled_moments(samples, chain_axis=0, sample_axis=1):
    """(mean, var) pooled over chains and samples; works under jit/shard_map
    (reductions over a sharded chain axis lower to psum)."""
    m = jnp.mean(samples, axis=(chain_axis, sample_axis))
    v = jnp.var(samples, axis=(chain_axis, sample_axis))
    return m, v


def split_rhat_device(samples):
    """Split R-hat per parameter, samples: (nchains, niter, ...); jittable."""
    nchains, niter = samples.shape[:2]
    half = niter // 2
    s = jnp.concatenate([samples[:, :half], samples[:, half: 2 * half]],
                        axis=0)
    nn = s.shape[1]
    w = jnp.mean(jnp.var(s, axis=1, ddof=1), axis=0)
    b = nn * jnp.var(jnp.mean(s, axis=1), axis=0, ddof=1)
    var_plus = (nn - 1.0) / nn * w + b / nn
    return jnp.sqrt(var_plus / jnp.where(w > 0, w, 1.0))


def acceptance_mean(accepts, chain_axis=0):
    """Pooled acceptance over chains (scalar per block under jit)."""
    return jnp.mean(accepts, axis=chain_axis)
