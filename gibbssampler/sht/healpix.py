"""HEALPix-grid spherical harmonic transforms (reference data parity).

The reference stores every map in HEALPix RING ordering (Npix = 12 nside^2)
via healpy (reference: config.py:19-21, main_polarization.py:36).  This
module reimplements the pixelization geometry and an SHT on it from scratch,
with the same structure as the Gauss–Legendre transform
(per-m Legendre matmuls + real cos/sin azimuthal matmuls; no complex dtypes):

- ring geometry (z, ring sizes 4i / 4 nside, first-pixel offsets) from the
  HEALPix definition (Gorski et al. 2005)
- equatorial-belt rings share one *folded* azimuthal DFT matrix: the
  reflection j <-> nb - j halves both table bytes and matmul flops, with the
  per-ring phi0 offsets applied as elementwise rotations of the ring Fourier
  coefficients
- polar-cap rings (ring i has 4i pixels, half-pixel offset) are folded over
  j <-> 4i-1-j (cos even / sin odd about phi = pi, with no self-paired pixel
  thanks to the half-pixel offset) and grouped into a few width classes of
  rings padded to a common half-width (a multiple of 128).  This
  replaces the single (ncap, L, 4(nside-1)) padded matrix pair of the naive
  scheme — at nside=256 the cap tables drop from 2 x 534 MB fp32 to
  2 x 86 MB bf16 while also halving the cap flops.
- mirrored south-cap rings share the north tables by *reordering the ring
  Fourier coefficients* (a cheap transpose on the small F tensor) and
  batching north/south through one einsum — never by reversing the big
  tables (which would materialize a copy per transform).

Two map layouts:

- ``layout="ring"`` (default): maps are flat (..., npix) RING-order vectors,
  bit-compatible with the reference's healpy maps.  One gather (synthesis) /
  one scatter-style gather (adjoint) converts between the internal padded
  section layout and RING order.
- ``layout="padded"``: maps are (..., npadded) vectors in the internal
  section layout; the boundary gathers disappear from the hot path entirely.
  Padding slots are in the exact null space of both A and A^T (the padded
  table columns are zero), so samplers run unchanged as long as the noise
  model carries inv-noise 0 on padding (NoiseModel.white_healpix(sht=...)).
  ``to_ring``/``from_ring`` convert at IO boundaries and ``valid`` marks the
  real pixels.

Analysis on HEALPix is a *scaled adjoint* (pixel area 4 pi / Npix), i.e. the
iter=0 map2alm of healpy — the same approximation the reference's sampler
math assumes (A^T A ~= Npix/4pi I; reference: config.py:72-73).  The adjoint
itself is the exact transpose of synthesis (verified in tests), which is what
the MCMC kernels require.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..harmonics.gridstate import flat_to_state, state_to_flat
from ..utils.precision import PRECISION
from ..utils.pytree import register_arrays_pytree
from .lcore import LegendreCore
from .legendre import legendre_table, spin2_lambda_tables

__all__ = ["HealpixGeometry", "healpix_geometry", "HealpixSHT",
           "make_healpix_sht"]


@dataclass(frozen=True)
class HealpixGeometry:
    nside: int
    theta: np.ndarray      # (nrings,) ring colatitudes, north -> south
    nphi: np.ndarray       # (nrings,) pixels per ring
    phi0: np.ndarray       # (nrings,) first-pixel longitude
    ring_start: np.ndarray  # (nrings,) RING-order offset of each ring

    @property
    def npix(self) -> int:
        return 12 * self.nside * self.nside

    @property
    def nrings(self) -> int:
        return self.theta.shape[0]

    @property
    def pixel_area(self) -> float:
        return 4.0 * np.pi / self.npix

    def __hash__(self):
        return hash(("healpix", self.nside))

    def __eq__(self, other):
        return isinstance(other, HealpixGeometry) and self.nside == other.nside


@functools.lru_cache(maxsize=None)
def healpix_geometry(nside: int) -> HealpixGeometry:
    """RING-scheme ring table for one nside (healpy pix geometry equivalent)."""
    assert nside >= 1
    rings = np.arange(1, 4 * nside)
    z = np.empty(rings.shape)
    nphi = np.empty(rings.shape, dtype=np.int64)
    phi0 = np.empty(rings.shape)
    for idx, i in enumerate(rings):
        if i < nside:                       # north cap
            z[idx] = 1.0 - (i * i) / (3.0 * nside * nside)
            nphi[idx] = 4 * i
            phi0[idx] = np.pi / (4.0 * i)
        elif i <= 3 * nside:                # equatorial belt
            z[idx] = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
            nphi[idx] = 4 * nside
            s = (i - nside + 1) % 2
            phi0[idx] = s * np.pi / (4.0 * nside)
        else:                               # south cap
            i_m = 4 * nside - i
            z[idx] = -(1.0 - (i_m * i_m) / (3.0 * nside * nside))
            nphi[idx] = 4 * i_m
            phi0[idx] = np.pi / (4.0 * i_m)
    ring_start = np.concatenate([[0], np.cumsum(nphi)[:-1]])
    return HealpixGeometry(nside=nside, theta=np.arccos(z), nphi=nphi,
                           phi0=phi0, ring_start=ring_start)


def _cap_classes(ncap: int, lane: int = 128):
    """Group north-cap ring indices idx = 0..ncap-1 (ring i = idx+1, half
    ring width 2i) into contiguous classes padded to a common half-width
    that is a multiple of ``lane`` (capped below at a multiple of 8 for tiny
    grids).  Returns list of (idx_lo, idx_hi, w)."""
    if ncap <= 0:
        return []
    wmax = 2 * ncap
    step = lane if wmax >= lane else max(8, -(-wmax // 8) * 8)
    classes = []
    idx_lo = 0
    w = step
    while idx_lo < ncap:
        # rings with half-width 2(idx+1) <= w  =>  idx <= w/2 - 1
        idx_hi = min(ncap, w // 2)
        classes.append((idx_lo, idx_hi, w))
        idx_lo = idx_hi
        w += step
    return classes


class HealpixSHT(LegendreCore):
    """SHT on the HEALPix grid; same method surface as
    :class:`~gibbssampler.sht.transform.SHT` but maps are flat pixel
    vectors (..., npix) in RING order (``layout="ring"``) or (..., npadded)
    in the internal padded section layout (``layout="padded"``).  The
    Legendre stage (wedge m-blocking + north/south ring-parity split — the
    HEALPix ring layout is equator-symmetric with a self-paired equator
    ring) is shared with the GL transform via sht.lcore."""

    map_ndim = 1   # maps are flat vectors

    def __init__(self, nside: int, lmax: int, dtype=jnp.float32,
                 spin2: bool = False, table_dtype=None, m_block: int = 128,
                 ring_split: bool = False, layout: str = "ring"):
        if layout not in ("ring", "padded"):
            raise ValueError(f"layout must be 'ring' or 'padded', got {layout!r}")
        geo = healpix_geometry(nside)
        self.geo = geo
        self.grid = geo              # SkyModel uses .grid.npix etc.
        self.nside = nside
        self.layout = layout
        self._init_core(lmax, geo.theta, dtype, table_dtype, m_block,
                        ring_split)
        self._constrain_F = None
        L = lmax + 1
        ns = nside

        x = np.cos(geo.theta)
        self.lam0 = self._block_table(legendre_table(lmax, x))
        self.lam_p2 = self.lam_m2 = self.lam_w = self.lam_x = None
        if spin2:
            lp, lm_ = spin2_lambda_tables(lmax, geo.theta)
            self._build_spin2_tables(lp, lm_)

        # ring sections (indices into the nrings axis)
        self.ncap = ns - 1
        self.nbelt = 2 * ns + 1
        self.belt_sl = slice(self.ncap, self.ncap + self.nbelt)

        m = np.arange(L)
        # belt: folded DFT matrix (columns j = 0..nb/2 only; j and nb - j
        # combine as lo = C - S / hi = C + S) + per-ring phi0 rotation
        nb = 4 * ns
        nbh = nb // 2 + 1
        ang = 2.0 * np.pi * np.outer(m, np.arange(nbh)) / nb
        self.nb = nb
        self.nbh = nbh
        self.belt_cos = jnp.asarray(np.cos(ang), dtype=self.table_dtype)
        self.belt_sin = jnp.asarray(np.sin(ang), dtype=self.table_dtype)
        bphi = geo.phi0[self.belt_sl]
        bang = np.outer(bphi, m)
        self.belt_rot_cos = jnp.asarray(np.cos(bang), dtype=self.dtype)
        self.belt_rot_sin = jnp.asarray(np.sin(bang), dtype=self.dtype)

        # caps: width-classed folded tables shared between the north ring i
        # and its southern mirror (ring 4 nside - i).  Ring i half-width is
        # 2i; table columns j >= 2i are zero (padding is in the null space).
        self.cap_classes = tuple(_cap_classes(self.ncap))
        cap_cos, cap_sin = [], []
        for (lo, hi, w) in self.cap_classes:
            nc = hi - lo
            Mc = np.zeros((nc, L, w))
            Ms = np.zeros((nc, L, w))
            for k in range(nc):
                i = lo + k + 1
                h = 2 * i
                phi = (np.pi / (2.0 * i)) * (np.arange(h) + 0.5)
                a = np.outer(m, phi)
                Mc[k, :, :h] = np.cos(a)
                Ms[k, :, :h] = np.sin(a)
            cap_cos.append(jnp.asarray(Mc, dtype=self.table_dtype))
            cap_sin.append(jnp.asarray(Ms, dtype=self.table_dtype))
        self.cap_cos = tuple(cap_cos)
        self.cap_sin = tuple(cap_sin)

        # padded section layout:
        #   [north cap class 0.. | belt | south cap class 0..]
        # south-cap rows are stored in *north index order* (row k of class c
        # is the mirror of north ring lo+k+1); the RING-order gather tables
        # below absorb the reordering.
        cap_widths = [2 * w * (hi - lo) for (lo, hi, w) in self.cap_classes]
        capn_off = np.concatenate([[0], np.cumsum(cap_widths)]).astype(np.int64)
        belt_off = int(capn_off[-1])
        caps_off = belt_off + self.nbelt * nb
        self._belt_off = belt_off
        npadded = caps_off + int(capn_off[-1])
        self._npadded = npadded

        nrings = geo.nrings
        pix_of = np.zeros(geo.npix, dtype=np.int64)      # padded idx per pixel
        src_of = np.full(npadded, 0, dtype=np.int64)
        valid = np.zeros(npadded, dtype=np.float64)
        for c, (lo, hi, w) in enumerate(self.cap_classes):
            for k in range(hi - lo):
                idx = lo + k
                i = idx + 1
                n_r = 4 * i
                base_n = int(capn_off[c]) + k * 2 * w
                base_s = caps_off + int(capn_off[c]) + k * 2 * w
                for base, r in ((base_n, idx), (base_s, nrings - 1 - idx)):
                    start = geo.ring_start[r]
                    # pixel p < 2i at row position p; p >= 2i at 2w - n_r + p
                    p = np.arange(n_r)
                    pos = np.where(p < 2 * i, p, 2 * w - n_r + p)
                    pix_of[start + p] = base + pos
                    src_of[base + pos] = start + p
                    valid[base + pos] = 1.0
        for rb in range(self.nbelt):
            r = self.ncap + rb
            start = geo.ring_start[r]
            base = belt_off + rb * nb
            p = np.arange(nb)
            pix_of[start + p] = base + p
            src_of[base + p] = start + p
            valid[base + p] = 1.0
        self._pix_of = jnp.asarray(pix_of)
        self._src_of = jnp.asarray(src_of)
        self._src_valid = jnp.asarray(valid, dtype=self.dtype)

        # analysis scaling: uniform pixel area (iter=0 map2alm semantics)
        self.pixel_area = geo.pixel_area
        self.nrings = geo.nrings
        self.wq = jnp.full((geo.nrings,), geo.pixel_area, dtype=self.dtype)

    # ---- layout ---------------------------------------------------------

    @property
    def npadded(self) -> int:
        return self._npadded

    @property
    def npix_layout(self) -> int:
        """Length of the map vectors this instance produces/consumes."""
        return self._npadded if self.layout == "padded" else self.geo.npix

    @property
    def valid(self) -> jnp.ndarray:
        """(npadded,) 1.0 on real pixels, 0.0 on padding slots."""
        return self._src_valid

    def to_ring(self, padded: jnp.ndarray) -> jnp.ndarray:
        """Padded section layout (..., npadded) -> RING order (..., npix)."""
        return padded[..., self._pix_of]

    def from_ring(self, maps: jnp.ndarray) -> jnp.ndarray:
        """RING order (..., npix) -> padded layout (zeros on padding)."""
        return maps[..., self._src_of] * self._src_valid

    def _maps_out(self, padded):
        return self.to_ring(padded) if self.layout == "ring" else padded

    def _maps_in(self, maps):
        if self.layout == "ring":
            return self.from_ring(maps.astype(self.dtype))
        return maps.astype(self.dtype)

    # ---- azimuthal primitives (padded section layout) --------------------

    def _belt_rot(self, Xre, Xim, sign):
        c = self.belt_rot_cos
        s = sign * self.belt_rot_sin
        return Xre * c - Xim * s, Xre * s + Xim * c

    def _south_rows(self, X, lo, hi):
        """Ring Fourier rows of the southern mirrors of north-cap indices
        [lo, hi), in north index order (mirror of idx is ring nr-1-idx)."""
        nr = self.nrings
        return X[..., nr - hi: nr - lo, :][..., ::-1, :]

    def _cos_sin_eval(self, Xre, Xim):
        """padded(..., npadded) = Re[sum_m (Xre + i Xim)_rm e^{i m phi_pix}]
        = Xre cos(m phi) - Xim sin(m phi), summed over m.  Xre/Xim are
        (..., nrings, L) ring Fourier coefficient tensors."""
        batch = Xre.shape[:-2]
        td = self.table_dtype
        pet = self.dtype
        outs_n, outs_s = [], []
        for c, (lo, hi, w) in enumerate(self.cap_classes):
            # north rows stacked with reordered south rows: one einsum per
            # class reads each table once for both hemispheres
            Xr = jnp.stack([Xre[..., lo:hi, :],
                            self._south_rows(Xre, lo, hi)], axis=-3)
            Xi = jnp.stack([Xim[..., lo:hi, :],
                            self._south_rows(Xim, lo, hi)], axis=-3)
            C = jnp.einsum("...krm,rmw->...krw", Xr.astype(td),
                           self.cap_cos[c],
                           precision=PRECISION,
                           preferred_element_type=pet).astype(pet)
            S = jnp.einsum("...krm,rmw->...krw", Xi.astype(td),
                           self.cap_sin[c],
                           precision=PRECISION,
                           preferred_element_type=pet).astype(pet)
            # fold: f[j] = C_j - S_j, f[4i-1-j] = C_j + S_j (j < 2i); rows
            # are [lo | reversed(hi)] of width 2w
            row = jnp.concatenate([C - S, (C + S)[..., ::-1]], axis=-1)
            outs_n.append(row[..., 0, :, :].reshape(batch + (-1,)))
            outs_s.append(row[..., 1, :, :].reshape(batch + (-1,)))
        bre = Xre[..., self.belt_sl, :]
        bim = Xim[..., self.belt_sl, :]
        bre, bim = self._belt_rot(bre, bim, +1)
        C = jnp.matmul(bre.astype(td), self.belt_cos,
                       precision=PRECISION,
                       preferred_element_type=pet).astype(pet)
        S = jnp.matmul(bim.astype(td), self.belt_sin,
                       precision=PRECISION,
                       preferred_element_type=pet).astype(pet)
        # f[j] = lo_j (j <= nb/2), f[nb - j] = hi_j (j = 1..nb/2 - 1)
        lo_, hi_ = C - S, C + S
        belt = jnp.concatenate([lo_, hi_[..., 1:-1][..., ::-1]], axis=-1)
        parts = outs_n + [belt.reshape(batch + (-1,))] + outs_s
        return jnp.concatenate(parts, axis=-1)

    def _cos_sin_adj(self, padded):
        """Transpose of _cos_sin_eval: padded (..., npadded) -> (C, S) with
        C_rm = sum_j f cos(m phi_j), S_rm = sum_j f sin(m phi_j)."""
        batch = padded.shape[:-1]
        td = self.table_dtype
        pet = self.dtype
        nb = self.nb
        Cn_parts, Sn_parts, Cs_parts, Ss_parts = [], [], [], []
        for c, (lo, hi, w) in enumerate(self.cap_classes):
            nc = hi - lo
            width = nc * 2 * w
            off_n = self._cap_off(c)
            off_s = self._belt_off + self.nbelt * nb + off_n
            sec = jnp.stack([padded[..., off_n: off_n + width],
                             padded[..., off_s: off_s + width]], axis=-2)
            rows = sec.astype(pet).reshape(batch + (2, nc, 2 * w))
            a = rows[..., :w]
            b = rows[..., w:][..., ::-1]
            u, v = a + b, a - b         # cos-weights u, sin-weights v
            Cc = jnp.einsum("...krw,rmw->...krm", u.astype(td),
                            self.cap_cos[c],
                            precision=PRECISION,
                            preferred_element_type=pet).astype(pet)
            Sc = jnp.einsum("...krw,rmw->...krm", v.astype(td),
                            self.cap_sin[c],
                            precision=PRECISION,
                            preferred_element_type=pet).astype(pet)
            Cn_parts.append(Cc[..., 0, :, :])
            Sn_parts.append(Sc[..., 0, :, :])
            Cs_parts.append(Cc[..., 1, :, :][..., ::-1, :])
            Ss_parts.append(Sc[..., 1, :, :][..., ::-1, :])
        belt = padded[..., self._belt_off: self._belt_off
                      + self.nbelt * nb].reshape(batch + (self.nbelt, nb))
        belt = belt.astype(pet)
        lo_ = belt[..., : self.nbh]
        rev = belt[..., self.nbh - 1:][..., ::-1]
        pad = [(0, 0)] * (belt.ndim - 1) + [(1, 1)]
        hi_ = jnp.pad(rev[..., :-1], pad)
        Cb = jnp.matmul((lo_ + hi_).astype(td), self.belt_cos.T,
                        precision=PRECISION,
                        preferred_element_type=pet).astype(pet)
        Sb = jnp.matmul((lo_ - hi_).astype(td), self.belt_sin.T,
                        precision=PRECISION,
                        preferred_element_type=pet).astype(pet)
        # transpose of the phi0 rotation: the complex pair (C - iS) picks up
        # e^{-i m phi0}, which on the (C, +S) pair is a rotation by +phi0
        Cb, Sb = self._belt_rot(Cb, Sb, +1)
        C = jnp.concatenate(Cn_parts + [Cb] + Cs_parts[::-1], axis=-2)
        S = jnp.concatenate(Sn_parts + [Sb] + Ss_parts[::-1], axis=-2)
        return C, S

    def _cap_off(self, c: int) -> int:
        off = 0
        for cc, (lo, hi, w) in enumerate(self.cap_classes):
            if cc == c:
                return off
            off += (hi - lo) * 2 * w
        return off

    # ---- spin 0 -------------------------------------------------------

    def synthesis_state(self, x):
        F = self._lsynth_stack(self.lam0, self._state_grids(x))
        Fre, Fim = F[..., 0, :, :], F[..., 1, :, :]
        if self._constrain_F is not None:
            Fre, Fim = self._constrain_F(Fre), self._constrain_F(Fim)
        cm = jnp.ones((self.lmax + 1,), self.dtype).at[1:].set(2.0)
        return self._maps_out(self._cos_sin_eval(Fre * cm, Fim * cm))

    def synthesis(self, flat):
        return self.synthesis_state(
            flat_to_state(flat.astype(self.dtype), self.lmax))

    def adjoint_synthesis_state(self, maps):
        C, S = self._cos_sin_adj(self._maps_in(maps))
        # G_m = sum_j f e^{-im phi} = C - iS; real packing absorbs the cm
        # factor exactly as in the GL transform
        a2 = self._ladj_stack(self.lam0, jnp.stack([C, -S], axis=-3))
        return self._grids_to_state(a2)

    def adjoint_synthesis(self, maps):
        return state_to_flat(self.adjoint_synthesis_state(maps), self.lmax)

    def analysis_state(self, maps):
        return self.adjoint_synthesis_state(maps) * self.pixel_area

    def analysis(self, maps):
        """iter=0 map2alm: pixel-area-weighted adjoint (approximate inverse,
        reference semantics: utils.py:89-104 with the Npix/4pi rescale)."""
        return self.adjoint_synthesis(maps) * self.pixel_area

    # ---- spin 2 -------------------------------------------------------

    def _require_spin2(self):
        if self.lam_p2 is None and self.lam_w is None:
            raise ValueError("HealpixSHT built without spin2=True")

    def synthesis_spin2_state(self, e_state, b_state):
        self._require_spin2()
        Fp_re, Fp_im, Fm_re, Fm_im = self._spin2_F(e_state, b_state)
        if self._constrain_F is not None:
            Fp_re, Fp_im = self._constrain_F(Fp_re), self._constrain_F(Fp_im)
            Fm_re, Fm_im = self._constrain_F(Fm_re), self._constrain_F(Fm_im)
        pos = jnp.ones((self.lmax + 1,), self.dtype).at[0].set(0.0)
        Are = Fp_re + Fm_re * pos
        Aim = Fp_im + Fm_im * pos
        Bre = Fp_re - Fm_re * pos
        Bim = Fp_im - Fm_im * pos
        # Q = Re sum (Are + i Aim) e^{im phi}; U = Re sum (Bim - i Bre):
        # stack Q/U into one leading axis so each azimuthal table is read
        # once for both Stokes maps
        Xre = jnp.stack([Are, Bim], axis=-3)
        Xim = jnp.stack([Aim, -Bre], axis=-3)
        out = self._maps_out(self._cos_sin_eval(Xre, Xim))
        return out[..., 0, :], out[..., 1, :]

    def synthesis_spin2(self, e_flat, b_flat):
        return self.synthesis_spin2_state(
            flat_to_state(e_flat.astype(self.dtype), self.lmax),
            flat_to_state(b_flat.astype(self.dtype), self.lmax))

    def adjoint_synthesis_spin2_state(self, q_maps, u_maps):
        self._require_spin2()
        qu = jnp.stack([self._maps_in(q_maps), self._maps_in(u_maps)],
                       axis=-2)
        Cqu, Squ = self._cos_sin_adj(qu)
        Cq, Sq = Cqu[..., 0, :, :], Squ[..., 0, :, :]
        Cu, Su = Cqu[..., 1, :, :], Squ[..., 1, :, :]
        # C+_m = sum (Q + iU) e^{-im phi}: re = Cq + Su, im = Cu - Sq
        # C-_m = sum (Q + iU) e^{+im phi}: re = Cq - Su, im = Cu + Sq
        Cp_re, Cp_im = Cq + Su, Cu - Sq
        Cm_re, Cm_im = Cq - Su, Cu + Sq
        return self._spin2_alm(Cp_re, Cp_im, Cm_re, Cm_im)

    def adjoint_synthesis_spin2(self, q_maps, u_maps):
        e, b = self.adjoint_synthesis_spin2_state(q_maps, u_maps)
        return (state_to_flat(e, self.lmax), state_to_flat(b, self.lmax))

    def analysis_spin2_state(self, q_maps, u_maps):
        e, b = self.adjoint_synthesis_spin2_state(q_maps, u_maps)
        return e * self.pixel_area, b * self.pixel_area

    def analysis_spin2(self, q_maps, u_maps):
        e, b = self.adjoint_synthesis_spin2(q_maps, u_maps)
        return e * self.pixel_area, b * self.pixel_area


register_arrays_pytree(
    HealpixSHT,
    array_fields=("lam0", "lam_p2", "lam_m2", "lam_w", "lam_x", "par_sign",
                  "belt_cos", "belt_sin", "belt_rot_cos", "belt_rot_sin",
                  "cap_cos", "cap_sin", "_pix_of", "_src_of", "_src_valid",
                  "wq", "pack_in", "pack_out"),
    static_fields=("geo", "grid", "nside", "lmax", "dtype", "table_dtype",
                   "m_block", "ring_split", "nrh", "has_mid", "_constrain_F",
                   "ncap", "nbelt", "belt_sl", "cap_classes", "nb", "nbh",
                   "_belt_off", "_npadded", "pixel_area", "nrings", "layout"),
)


def make_healpix_sht(nside: int, lmax: int | None = None,
                     dtype=jnp.float32, spin2: bool = False,
                     table_dtype=None, m_block: int = 128,
                     ring_split: bool = False,
                     layout: str = "ring") -> HealpixSHT:
    """Build a HEALPix SHT; default lmax = 2 nside (the reference's choice,
    config.py:21).  ``layout="padded"`` keeps maps in the internal padded
    section layout (no boundary gathers in the hot path; use
    to_ring/from_ring at IO boundaries)."""
    if lmax is None:
        lmax = 2 * nside
    return HealpixSHT(nside, lmax, dtype=dtype, spin2=spin2,
                      table_dtype=table_dtype, m_block=m_block,
                      ring_split=ring_split, layout=layout)
