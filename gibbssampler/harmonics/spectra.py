"""Power-spectrum conventions: D_ell <-> C_ell, variance expansion, binning,
empirical spectra, beams.

JAX replacement for the reference's Cython ``variance_expension`` module
and the spectrum helpers scattered through utils.py / config.py / GibbsSampler.py:

- D_ell <-> C_ell scaling  (reference: GibbsSampler.py:54, utils.py:139-147)
- variance expansion: per-real-coefficient prior variance vector
  (reference: variance_expension.pyx:8-33, utils.py:114-137)
- 3x3 per-ell block variance expansion for joint TT/TE/EE(+BB) sampling
  (reference: variance_expension.pyx:36-61)
- bin fold/unfold (reference: utils.py:150-162)
- alm2cl / almxfl / gauss_beam equivalents (reference uses healpy)

All functions are pure, jittable, and broadcast over leading batch axes.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..utils.precision import PRECISION
from .packing import index_maps

__all__ = [
    "dl_to_cl_factor",
    "dl_to_cl",
    "cl_to_dl",
    "variance_expansion",
    "variance_expansion_matrix",
    "unfold_bins",
    "bin_sum",
    "bin_index",
    "alm2cl",
    "almxfl",
    "gauss_beam",
]


@functools.lru_cache(maxsize=None)
def _dl_to_cl_factor_np(lmax: int) -> np.ndarray:
    """scale[l] with C_l = D_l * scale[l]; scale[0] = scale[1] = 0.

    The monopole and dipole are fixed to zero throughout (reference:
    CenteredGibbs.py:47, NonCenteredGibbs.py:207-210), so the factor carries
    the zeroing.
    """
    ell = np.arange(lmax + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = 2.0 * np.pi / (ell * (ell + 1.0))
    scale[:2] = 0.0
    return scale


def dl_to_cl_factor(lmax: int, dtype=jnp.float32) -> jnp.ndarray:
    return jnp.asarray(_dl_to_cl_factor_np(lmax), dtype=dtype)


def dl_to_cl(dl: jnp.ndarray, lmax: int | None = None) -> jnp.ndarray:
    """D_ell -> C_ell = D_ell * 2 pi / (l (l+1)), with l = 0, 1 zeroed."""
    if lmax is None:
        lmax = dl.shape[-1] - 1
    return dl * dl_to_cl_factor(lmax, dl.dtype)


def cl_to_dl(cl: jnp.ndarray, lmax: int | None = None) -> jnp.ndarray:
    """C_ell -> D_ell = l (l+1) C_ell / (2 pi)."""
    if lmax is None:
        lmax = cl.shape[-1] - 1
    ell = jnp.arange(lmax + 1, dtype=cl.dtype)
    return cl * ell * (ell + 1.0) / (2.0 * jnp.pi)


def variance_expansion(dl: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """Per-real-coefficient prior variance vector from D_ell.

    var[i] = C_{ell(i)} = D_{ell(i)} * 2 pi / (l(l+1)) for every slot of the
    real packing (the sqrt(2) packing makes each real coefficient have
    variance exactly C_ell; reference: variance_expension.pyx:8-33).

    dl: (..., lmax+1) -> (..., (lmax+1)^2)
    """
    cl = dl_to_cl(dl, lmax)
    ell_of = jnp.asarray(index_maps(lmax).ell_of)
    return cl[..., ell_of]


def variance_expansion_matrix(dl_blocks: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """Per-real-coefficient k x k prior covariance blocks from per-ell blocks.

    For joint sampling of k correlated fields (e.g. (T, E) with TE correlation,
    or (T, E, B)).  Input D_ell blocks (..., lmax+1, k, k); output
    (..., (lmax+1)^2, k, k) — the C_ell block replicated over every (l, m)
    slot of the real packing (JAX analogue of the reference's 3x3 Cython
    variance expansion, variance_expension.pyx:36-61).
    """
    scale = dl_to_cl_factor(lmax, dl_blocks.dtype)
    cl_blocks = dl_blocks * scale[..., :, None, None]
    ell_of = jnp.asarray(index_maps(lmax).ell_of)
    return cl_blocks[..., ell_of, :, :]


# ---------------------------------------------------------------------------
# Binning.  ``bins`` is a static numpy int array of ell breakpoints; bin b
# covers [bins[b], bins[b+1]) (reference: utils.py:150-162, config.py:45-46).
# ---------------------------------------------------------------------------

def bin_index(bins: np.ndarray, lmax: int) -> np.ndarray:
    """bin_of[l] for l = 0..lmax; ells outside [bins[0], bins[-1]) map to -1."""
    bins = np.asarray(bins)
    ells = np.arange(lmax + 1)
    idx = np.searchsorted(bins, ells, side="right") - 1
    idx[(ells < bins[0]) | (ells >= bins[-1])] = -1
    return idx.astype(np.int32)


def unfold_bins(binned: jnp.ndarray, bins: np.ndarray, lmax: int) -> jnp.ndarray:
    """(..., nbins) binned D_ell -> (..., lmax+1) per-ell D_ell (np.repeat
    semantics of the reference's unfold_bins; ells outside the binned range,
    e.g. the fixed monopole/dipole, get 0)."""
    idx = bin_index(bins, lmax)
    vals = binned[..., jnp.asarray(np.maximum(idx, 0))]
    return jnp.where(jnp.asarray(idx >= 0), vals, 0.0)


def bin_sum(per_ell: jnp.ndarray, bins: np.ndarray, lmax: int) -> jnp.ndarray:
    """Sum per-ell values within each bin -> (..., nbins); ells outside the
    binned range are dropped."""
    idx = bin_index(bins, lmax)
    nbins = len(bins) - 1
    onehot = jnp.asarray(
        (idx[:, None] == np.arange(nbins)[None, :]).astype(np.float64),
        dtype=per_ell.dtype,
    )
    return jnp.matmul(per_ell, onehot, precision=PRECISION)


# ---------------------------------------------------------------------------
# Empirical spectra and harmonic-space filters
# ---------------------------------------------------------------------------

def alm2cl(flat: jnp.ndarray, lmax: int,
           flat2: jnp.ndarray | None = None) -> jnp.ndarray:
    """Empirical (pseudo-) power spectrum of a real-packed alm vector.

    hat C_l = 1/(2l+1) sum_m |a_lm|^2; with the sqrt(2) real packing this is
    exactly 1/(2l+1) * sum of squares of the real slots of degree l.
    Cross-spectrum when ``flat2`` is given.  Output (..., lmax+1).
    """
    import jax
    ell_of = jnp.asarray(index_maps(lmax).ell_of)
    other = flat if flat2 is None else flat2
    prod = flat * other
    seg = lambda v: jax.ops.segment_sum(v, ell_of, num_segments=lmax + 1)
    for _ in range(prod.ndim - 1):
        seg = jax.vmap(seg)
    sums = seg(prod)
    counts = jnp.asarray(2.0 * np.arange(lmax + 1) + 1.0, dtype=flat.dtype)
    return sums / counts


def almxfl(flat: jnp.ndarray, fl: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """Multiply a real-packed alm by a per-ell filter fl (healpy.almxfl
    equivalent); fl has shape (..., lmax+1)."""
    ell_of = jnp.asarray(index_maps(lmax).ell_of)
    return flat * fl[..., ell_of]


def gauss_beam(fwhm_radians: float, lmax: int, dtype=jnp.float32) -> jnp.ndarray:
    """Gaussian beam window b_l = exp(-l(l+1) sigma^2 / 2),
    sigma = fwhm / sqrt(8 ln 2) (healpy.gauss_beam equivalent;
    reference: GibbsSampler.py:64-74 uses it to build the beam map)."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    sigma = fwhm_radians / np.sqrt(8.0 * np.log(2.0))
    return jnp.asarray(np.exp(-0.5 * ell * (ell + 1.0) * sigma ** 2), dtype=dtype)
