"""Device-mesh sharding for chains and for the SHT's m-axis.

The reference's entire parallelism story is a SLURM array of independent
processes (job-script.sh:6, SURVEY.md 2.5).  The device-mesh equivalents:

- **chain axis** ('chains'): data-parallel independent Gibbs chains — the
  vmapped chain batch is sharded across devices; cross-chain statistics
  (pooled adaptation, R-hat) become single collectives instead of
  offline file pooling (config.py:161-225).
- **m axis** ('m'): harmonic-domain model parallelism inside the SHT — the
  per-m Legendre matmuls are embarrassingly parallel over m, so the operator
  tensors and the ring-Fourier intermediate F[..., r, m] shard over 'm'
  (the spherical analogue of sequence/tensor parallelism for high lmax).

Sharding is expressed GSPMD-style: ``jit`` in/out shardings on the chain
axis plus ``with_sharding_constraint`` annotations on the SHT intermediates;
XLA inserts the all-gathers/all-to-alls (NCCL between GPUs).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "chain_sharding", "shard_sht", "sharded_run"]


def make_mesh(n_chains: int | None = None, n_m: int = 1,
              devices=None) -> Mesh:
    """Build a ('chains', 'm') mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_chains is None:
        n_chains = n // n_m
    assert n_chains * n_m == n, (n_chains, n_m, n)
    return Mesh(devices.reshape(n_chains, n_m), ("chains", "m"))


def chain_sharding(mesh: Mesh, ndim: int, chain_axis: int = 0):
    """NamedSharding placing axis ``chain_axis`` on 'chains', rest replicated."""
    spec = [None] * ndim
    spec[chain_axis] = "chains"
    return NamedSharding(mesh, P(*spec))


def shard_sht(sht, mesh: Mesh):
    """Return a copy of ``sht`` whose ring-Fourier intermediates
    F[..., r, m] carry a GSPMD constraint sharding the m axis over the
    mesh's 'm' axis (zero-padded to a shard multiple when lmax+1 is not
    divisible — 513 in production).  Batch/chain axes propagate from the
    caller's in_shardings; XLA inserts the collectives."""
    import copy

    nm = mesh.shape["m"]

    def constrain(x):
        n = x.shape[-1]
        pad = (-n) % nm
        if pad:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        spec = [None] * x.ndim
        spec[-1] = "m"
        x = jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(*spec)))
        return x[..., :n] if pad else x

    out = copy.copy(sht)
    out._constrain_F = constrain
    return out


def sharded_run(scheme, key, dl_init_tuple, n_iter: int, nchains: int,
                mesh: Mesh):
    """scheme.run with the chain axis sharded over the mesh's 'chains' axis.

    Every per-chain quantity (states, chain histories) is placed
    NamedSharding(mesh, P('chains', ...)); XLA partitions the vmapped step
    and runs chains data-parallel across devices."""
    n_dev = mesh.shape["chains"]
    if nchains % n_dev:
        raise ValueError(f"nchains={nchains} not divisible by chains axis "
                         f"size {n_dev}")
    from ..schemes.gibbs import _init_scheme
    kinit, krun = jax.random.split(key)
    init_keys = jax.random.split(kinit, nchains)
    dl0 = jax.tree.map(jnp.asarray, tuple(dl_init_tuple))
    states = _init_scheme(scheme, init_keys, dl0)
    states = jax.device_put(
        states, jax.tree.map(
            lambda a: chain_sharding(mesh, np.ndim(a)), states))

    from ..schemes.gibbs import _scan_scheme
    keys = jax.random.split(krun, n_iter)
    with mesh:
        states, infos = _scan_scheme(scheme, states, keys, nchains)
    out = {"dl_chains": tuple(
        jnp.moveaxis(infos["dl"][f], 0, 1)
        for f in range(len(scheme.bins_list)))}
    for k, v in infos.items():
        if k == "dl":
            continue
        out[k] = jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), v)
    out["final_state"] = states
    return out
