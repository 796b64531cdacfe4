"""Grid-packed alm state layout — the hot-path representation.

The reference packs real alm into a ragged, m-major interleaved vector
(reference: utils.py:49-76); that layout is cache-friendly on CPU but every
conversion to the dense (m, l) grid the SHT needs is a large gather (on
the accelerator this code was first tuned on, those gathers cost more than
the transform's matmuls; not measured on the GPU).  The framework
therefore keeps sampler state in a
*rectangular* "grid-packed" layout whose conversion to the SHT's internal
(part, m, l) grids is a free reshape:

    state : real array (..., nstate),  nstate = 2 (lmax+1)^2
    state.reshape(..., 2, L, L)[p, m, l] =
        p = 0:  a_{l0}            if m = 0
                sqrt(2) Re a_{lm} if m > 0
        p = 1:  0                 if m = 0
                sqrt(2) Im a_{lm} if m > 0
    slots with l < m are 0 (invalid).

The sqrt(2) scaling matches the reference convention: every *valid* slot of a
field with spectrum C_ell has prior variance exactly C_ell, so variance
expansion is a broadcast (not a gather) and all conditional samplers stay
elementwise.  Invalid slots carry variance 0 and are kept at exactly 0 by the
samplers' existing var > 0 masking.

The reference-compatible ragged packing ("flat", harmonics.packing) remains
the interop/boundary format; ``flat_to_state`` / ``state_to_flat`` convert
(gathers — boundary only, never in the hot loop).
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from .packing import index_maps, nflat
from .spectra import dl_to_cl

__all__ = [
    "nstate",
    "state_masks",
    "expand_cl_state",
    "variance_expansion_state",
    "almxfl_state",
    "alm2cl_state",
    "ell_mask_state",
    "flat_to_state",
    "state_to_flat",
]

_SQRT2 = np.sqrt(2.0)
_INV_SQRT2 = 1.0 / np.sqrt(2.0)


def nstate(lmax: int) -> int:
    """Length of the grid-packed state vector: 2 (lmax+1)^2."""
    return 2 * (lmax + 1) ** 2


class _StateMasks:
    """Cached numpy constants for one lmax (float64; cast at use sites)."""

    def __init__(self, lmax: int):
        L = lmax + 1
        m = np.arange(L)[:, None]
        l = np.arange(L)[None, :]
        tri = (l >= m)                                   # (L, L)
        valid_re = tri
        valid_im = tri & (m > 0)
        self.valid = np.stack([valid_re, valid_im]).astype(np.float64)
        # state -> true Re/Im grids (the SHT's internal values)
        sc_re = np.where(m > 0, _INV_SQRT2, 1.0) * valid_re
        sc_im = np.full((L, L), _INV_SQRT2) * valid_im
        self.in_scale = np.stack([sc_re, sc_im])         # (2, L, L)
        # true Re/Im grids -> state (the exact transpose's diagonal)
        self.out_scale = np.stack([
            np.where(m > 0, _SQRT2, 1.0) * valid_re,
            np.full((L, L), _SQRT2) * valid_im,
        ])
        # flat <-> state permutations
        maps = index_maps(lmax)
        n_f = nflat(lmax)
        part = maps.is_imag.astype(np.int64)
        state_of_flat = (part * L * L + maps.m_of.astype(np.int64) * L
                         + maps.ell_of.astype(np.int64))
        self.state_of_flat = state_of_flat.astype(np.int32)   # (nflat,)
        flat_of_state = np.zeros(2 * L * L, dtype=np.int64)
        flat_of_state[state_of_flat] = np.arange(n_f)
        self.flat_of_state = flat_of_state.astype(np.int32)   # (nstate,)
        self.state_valid_flat = self.valid.reshape(-1)        # (nstate,)
        self.lmax = lmax


@functools.lru_cache(maxsize=None)
def state_masks(lmax: int) -> _StateMasks:
    return _StateMasks(lmax)


def expand_cl_state(cl: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """Per-ell values -> per-slot values of the grid-packed state.

    cl: (..., lmax+1) -> (..., nstate); invalid slots get 0.  A broadcast
    multiply — the gather-free replacement of the flat-layout variance
    expansion on the hot path."""
    L = lmax + 1
    sm = state_masks(lmax)
    valid = jnp.asarray(sm.valid, dtype=cl.dtype)          # (2, L, L)
    out = cl[..., None, None, :] * valid
    return out.reshape(cl.shape[:-1] + (2 * L * L,))


def variance_expansion_state(dl: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """Per-slot prior variance from D_ell: var[slot] = C_{l(slot)}
    (the grid-packed analogue of harmonics.spectra.variance_expansion;
    reference kernel: variance_expension.pyx:8-33)."""
    return expand_cl_state(dl_to_cl(dl, lmax), lmax)


def almxfl_state(x: jnp.ndarray, fl: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """Multiply a grid-packed alm state by a per-ell filter (hp.almxfl role).

    fl: (..., lmax+1).  Broadcast multiply over the l axis — no gather."""
    L = lmax + 1
    g = x.reshape(x.shape[:-1] + (2, L, L))
    out = g * fl[..., None, None, :]
    return out.reshape(x.shape)


def alm2cl_state(x: jnp.ndarray, lmax: int,
                 y: jnp.ndarray | None = None) -> jnp.ndarray:
    """Empirical (pseudo-)spectrum of a grid-packed state (hp.alm2cl role).

    hat C_l = 1/(2l+1) sum over the valid slots of degree l of x*y — with the
    sqrt(2) packing this equals 1/(2l+1) sum_m x_lm conj(y_lm) including
    negative m.  Output (..., lmax+1)."""
    L = lmax + 1
    other = x if y is None else y
    prod = (x * other).reshape(x.shape[:-1] + (2, L, L))
    sums = jnp.sum(prod, axis=(-3, -2))
    counts = jnp.asarray(2.0 * np.arange(L) + 1.0, dtype=x.dtype)
    return sums / counts


def ell_mask_state(lmax: int, lmin: int = 2, dtype=np.float64) -> np.ndarray:
    """(nstate,) numpy mask: 1 on valid slots with l >= lmin, else 0."""
    sm = state_masks(lmax)
    L = lmax + 1
    lsel = (np.arange(L) >= lmin).astype(np.float64)
    return (sm.valid * lsel[None, None, :]).reshape(-1).astype(dtype)


def flat_to_state(flat: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """Reference ragged packing -> grid-packed state (boundary gather)."""
    sm = state_masks(lmax)
    src = jnp.asarray(sm.flat_of_state)
    valid = jnp.asarray(sm.state_valid_flat, dtype=flat.dtype)
    return flat[..., src] * valid


def state_to_flat(x: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """Grid-packed state -> reference ragged packing (boundary gather)."""
    sm = state_masks(lmax)
    return x[..., jnp.asarray(sm.state_of_flat)]
