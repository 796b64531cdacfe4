"""Iso-latitude sphere grids for the SHT.

The native grid of the framework is Gauss–Legendre (GL): nrings >= lmax+1
rings at the Legendre nodes with GL quadrature weights and a uniform number
of longitudes per ring.  On this grid, analysis is an *exact* inverse of
synthesis for band-limited fields, and the quadrature-weighted adjoint
relations hold to machine precision — unlike the reference's HEALPix +
`map2alm(iter=3)` approximate pseudo-inverse (reference: utils.py:89-104,
SURVEY.md 2.6.9).  A HEALPix grid (for data/mask parity with the reference)
is provided by gibbssampler.sht.healpix.

A grid is described by per-ring colatitudes theta, per-ring quadrature
weights w (for analysis), a uniform nphi, and per-ring first-pixel
longitude offsets phi0.  Maps are stored as (..., nrings, nphi) arrays;
the solid-angle measure used for quadrature is

    integral f dOmega  ~=  sum_r w_r * (2 pi / nphi) * sum_j f[r, j].
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

__all__ = ["SphereGrid", "gauss_legendre_grid", "subgrid_rows"]


@dataclass(frozen=True)
class SphereGrid:
    """Iso-latitude grid with uniform ring length (HEALPix uses its own class)."""

    name: str
    theta: np.ndarray       # (nrings,) colatitudes
    weights: np.ndarray     # (nrings,) quadrature weights, sum ~= 2
    nphi: int               # pixels per ring
    phi0: np.ndarray        # (nrings,) longitude of pixel j=0 per ring

    @property
    def nrings(self) -> int:
        return self.theta.shape[0]

    @property
    def npix(self) -> int:
        return self.nrings * self.nphi

    @property
    def pixel_area(self) -> np.ndarray:
        """(nrings,) solid angle represented by one pixel of each ring."""
        return self.weights * (2.0 * np.pi / self.nphi)

    def __hash__(self):
        return hash((self.name, self.nrings, self.nphi))

    def __eq__(self, other):
        return (isinstance(other, SphereGrid) and self.name == other.name
                and self.nrings == other.nrings and self.nphi == other.nphi)


def subgrid_rows(grid: SphereGrid, rows) -> SphereGrid:
    """The iso-latitude grid restricted to a static subset of rings.

    Used by the cut-sky complement decomposition (ops.model): a masked
    operator on a quadrature grid equals its exact full-sky diagonal minus a
    correction supported on the masked rings, so transforms restricted to
    those rings replace full-sky transforms in the hot masked paths."""
    import hashlib
    idx = np.asarray(rows)
    if idx.dtype == bool:
        idx = np.where(idx)[0]
    tag = hashlib.sha1(idx.tobytes()).hexdigest()[:10]
    return SphereGrid(
        name=f"{grid.name}_rows{idx.size}_{tag}",
        theta=grid.theta[idx],
        weights=grid.weights[idx],
        nphi=grid.nphi,
        phi0=grid.phi0[idx],
    )


@functools.lru_cache(maxsize=None)
def gauss_legendre_grid(lmax: int, nrings: int | None = None,
                        nphi: int | None = None) -> SphereGrid:
    """Gauss–Legendre grid exact for products of fields band-limited at lmax.

    Defaults: nrings = lmax + 1 (exact for integrands of degree <= 2 lmax + 1),
    nphi = 2 lmax + 2 (even, > 2 lmax, so no Nyquist-bin special case).
    """
    if nrings is None:
        nrings = lmax + 1
    if nphi is None:
        nphi = 2 * lmax + 2
    x, w = np.polynomial.legendre.leggauss(nrings)
    # nodes ascending in x = cos(theta) => theta descending; store north->south
    order = np.argsort(-x)
    theta = np.arccos(x[order])
    return SphereGrid(
        name=f"gl_{lmax}_{nrings}_{nphi}",
        theta=theta,
        weights=w[order],
        nphi=int(nphi),
        phi0=np.zeros(nrings),
    )
