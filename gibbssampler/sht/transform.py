"""Spherical-harmonic transforms (spin-0 and spin-2).

The transform is the framework's dominant kernel — the accelerator re-design
of what the reference gets from healpy/libsharp on CPU (hp.alm2map / hp.map2alm /
adjoint synthesis; reference: utils.py:79-111, CenteredGibbs.py:505-513,
ClsSampler.py:100-110).  Structure:

  synthesis  (alm -> map):  per-m Legendre matmul over l  ->  azimuthal stage
  analysis   (map -> alm):  azimuthal stage               ->  weighted Legendre matmul

The azimuthal (longitude) stage has three interchangeable implementations
(which one is fastest on the GPU is not measured yet; "matmul" is the
default):

- ``fft_mode="matmul"``: real cos/sin DFT matmuls over the folded half
  range, entirely real-valued.
- ``fft_mode="fft"``: complex FFTs (rFFTs at spin 0).
- ``fft_mode="ct"``: one Cooley–Tukey split (n = n1*n2) expressed as two
  real matmul stages with a twiddle in between — ~4x fewer azimuthal
  flops than "matmul" at production lmax; falls back to "matmul" when
  nphi has no useful factorization.

Both stages batch over arbitrary leading axes (fields, chains), so vmapping
chains turns everything into large batched matmuls.  On the Gauss–Legendre grid
``analysis`` is the exact inverse of ``synthesis`` and ``adjoint_synthesis``
is the exact transpose (verified to machine precision in tests) — one
consistent A / A^T everywhere, fixing the reference's mixed iter=3/iter=0
adjoint discipline (SURVEY.md 2.6.9).

The hot-path alm format is the grid-packed state (harmonics.gridstate):
``*_state`` methods consume/produce it with a free reshape.  The reference's
ragged real packing (harmonics.packing) is supported through thin interop
wrappers (one boundary gather).  Maps are (..., nrings, nphi) real arrays.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..harmonics.gridstate import flat_to_state, state_to_flat
from ..utils.precision import PRECISION
from ..utils.pytree import register_arrays_pytree
from .grids import SphereGrid, gauss_legendre_grid
from .lcore import LegendreCore
from .legendre import legendre_table, spin2_lambda_tables

__all__ = ["SHT", "make_sht"]


class SHT(LegendreCore):
    """Precomputed transform operators for one (grid, lmax, dtype).

    Holds the Legendre operator tensors and azimuthal DFT matrices on device
    and exposes pure, jittable methods.  Instances are cheap to close over in
    jitted sampler steps.  ``_constrain_F`` is an optional hook (set by
    gibbssampler.parallel.shard_sht) that applies GSPMD sharding
    constraints to the ring-Fourier intermediate.
    """

    map_ndim = 2   # maps are (..., nrings, nphi)

    def __init__(self, grid: SphereGrid, lmax: int, dtype=jnp.float32,
                 spin2: bool = False, fft_mode: str = "matmul",
                 table_dtype=None, m_block: int = 128,
                 ring_split: bool = False, allow_aliasing: bool = False):
        self.grid = grid
        self.allow_aliasing = bool(allow_aliasing)
        # operator tables may be stored lower-precision (bfloat16) with
        # float32 accumulation: halves the table bytes the Legendre stage
        # reads; ~4e-3 relative operator error,
        # statistically irrelevant for MCMC (A/A^T stay exact transposes
        # because both read the same tables).  _init_core also enables the
        # north/south ring-parity split on this (symmetric) grid — see
        # sht.lcore for the wedge/parity table layout.
        self._init_core(lmax, grid.theta, dtype, table_dtype, m_block,
                        ring_split)
        self.fft_mode = fft_mode
        self._constrain_F = None
        L = lmax + 1
        if grid.nphi < 2 * lmax + 2 and not allow_aliasing:
            # synthesis (pointwise evaluation) and its transpose are exact
            # for ANY nphi; only analysis-as-inverse needs nphi > 2 lmax.
            # allow_aliasing=True opts into the synthesis/adjoint-only use
            # (e.g. the cut transform over HEALPix belt rows, nphi = 2 lmax).
            raise ValueError(
                f"grid nphi={grid.nphi} too small for lmax={lmax}; need >= {2*lmax+2}")

        x = np.cos(grid.theta)
        self.lam0 = self._block_table(legendre_table(lmax, x))
        # quadrature weights including the 2 pi / nphi azimuthal factor
        self.wq = jnp.asarray(grid.weights * (2.0 * np.pi / grid.nphi),
                              dtype=self.dtype)
        self.nphi = grid.nphi
        self.nrings = grid.nrings
        # per-ring, per-m phase rotation for the first-pixel offset phi0
        m = np.arange(L)
        ang = np.outer(grid.phi0, m)                 # (nr, L)
        self.has_phase = bool(np.any(grid.phi0 != 0.0))
        self.phase_cos = jnp.asarray(np.cos(ang), dtype=self.dtype)
        self.phase_sin = jnp.asarray(np.sin(ang), dtype=self.dtype)
        # azimuthal DFT matrices, folded over the reflection j <-> nphi - j:
        # only columns j = 0..nphi/2 are stored; f[j] = C[j] - S[j] and
        # f[nphi - j] = C[j] + S[j], halving the azimuthal matmul flops
        nh = grid.nphi // 2 + 1
        ang2 = 2.0 * np.pi * np.outer(m, np.arange(nh)) / grid.nphi
        self.nphi_half = nh
        self.dft_cos = jnp.asarray(np.cos(ang2),
                                   dtype=self.table_dtype)  # (L, nh)
        self.dft_sin = jnp.asarray(np.sin(ang2), dtype=self.table_dtype)
        self._ct = None
        if fft_mode == "ct":
            self._ct = _ct_setup(grid.nphi, L, self.table_dtype)
            if self._ct is None:
                self.fft_mode = "matmul"
        self.lam_p2 = self.lam_m2 = self.lam_w = self.lam_x = None
        if spin2:
            lp, lm_ = spin2_lambda_tables(lmax, grid.theta)
            self._build_spin2_tables(lp, lm_)

    # -- shared azimuthal-stage helpers (all real arithmetic) -------------

    def _rot(self, Fre, Fim, sign=+1):
        """Rotate ring Fourier coefficients by e^{sign * i m phi0_r}."""
        if not self.has_phase:
            return Fre, Fim
        c, s = self.phase_cos, sign * self.phase_sin
        return Fre * c - Fim * s, Fre * s + Fim * c

    def _unfold_half(self, lo, hi):
        """Assemble f over all nphi columns from the half-range results:
        f[j] = lo[j] (j = 0..n/2), f[n - j] = hi[j] (j = 1..n/2 - 1)."""
        return jnp.concatenate([lo, hi[..., 1:-1][..., ::-1]], axis=-1)

    def _fold_half(self, maps):
        """(u, v) with u[j] = f[j] + f[n-j], v[j] = f[j] - f[n-j]
        (j = 0 and n/2 self-paired) — the transpose of _unfold_half."""
        lo = maps[..., : self.nphi_half]
        rev = maps[..., self.nphi_half - 1:][..., ::-1]
        pad = [(0, 0)] * (maps.ndim - 1) + [(1, 1)]
        hi = jnp.pad(rev[..., :-1], pad)
        return lo + hi, lo - hi

    def _ring_ifft_real(self, Fre, Fim):
        """f[.., r, j] = sum_m (2 - delta_m0) (Fre cos(m phi_j) - Fim sin).

        Fre/Fim: (..., nr, L).  Real-matmul or rFFT depending on fft_mode."""
        Fre, Fim = self._rot(Fre, Fim, +1)
        if self.fft_mode == "fft":
            F = Fre + 1j * Fim
            pad = self.nphi // 2 + 1 - (self.lmax + 1)
            F = jnp.pad(F, [(0, 0)] * (F.ndim - 1) + [(0, pad)])
            return jnp.fft.irfft(F, n=self.nphi, axis=-1) * self.nphi
        cm = jnp.ones((self.lmax + 1,), self.dtype).at[1:].set(2.0)
        fre = (Fre * cm).astype(self.table_dtype)
        fim = (Fim * cm).astype(self.table_dtype)
        if self.fft_mode == "ct":
            return _ct_halfspec_to_real(self._ct, fre, fim, self.dtype)
        C = jnp.matmul(fre, self.dft_cos,
                       precision=PRECISION,
                       preferred_element_type=self.dtype).astype(self.dtype)
        S = jnp.matmul(fim, self.dft_sin,
                       precision=PRECISION,
                       preferred_element_type=self.dtype).astype(self.dtype)
        return self._unfold_half(C - S, C + S)

    def _ring_fft_real(self, maps):
        """G_m = sum_j f e^{-i m phi_j}; returns (Gre, Gim), (..., nr, L)."""
        maps = maps.astype(self.dtype)
        if self.fft_mode == "fft":
            G = jnp.fft.rfft(maps, axis=-1)[..., : self.lmax + 1]
            Gre, Gim = G.real, G.imag
        elif self.fft_mode == "ct":
            C, S = _ct_real_to_halfspec(self._ct, maps.astype(self.table_dtype),
                                        self.dtype)
            Gre, Gim = C, -S
        else:
            u, v = self._fold_half(maps)
            Gre = jnp.matmul(u.astype(self.table_dtype), self.dft_cos.T,
                             precision=PRECISION,
                             preferred_element_type=self.dtype).astype(self.dtype)
            Gim = -jnp.matmul(v.astype(self.table_dtype), self.dft_sin.T,
                              precision=PRECISION,
                              preferred_element_type=self.dtype).astype(self.dtype)
        return self._rot(Gre, Gim, -1)

    # -- spin 0 ------------------------------------------------------------

    def _legendre_synth_state(self, x, lam):
        """state -> (Fre, Fim) ring Fourier coefficients (..., nr, L)."""
        F = self._lsynth_stack(lam, self._state_grids(x))
        Fre, Fim = F[..., 0, :, :], F[..., 1, :, :]
        if self._constrain_F is not None:
            Fre, Fim = self._constrain_F(Fre), self._constrain_F(Fim)
        return Fre, Fim

    def synthesis_state(self, x: jnp.ndarray) -> jnp.ndarray:
        """A: grid-packed alm state (..., nstate) -> map (..., nr, nphi)."""
        Fre, Fim = self._legendre_synth_state(x, self.lam0)
        return self._ring_ifft_real(Fre, Fim)

    def synthesis_from_grids(self, g0: jnp.ndarray) -> jnp.ndarray:
        """Spin-0 synthesis from a PREBUILT ``_state_grids`` array (shared
        grid prep across a cut/sparse transform pair)."""
        F = self._lsynth_stack(self.lam0, g0)
        Fre, Fim = F[..., 0, :, :], F[..., 1, :, :]
        if self._constrain_F is not None:
            Fre, Fim = self._constrain_F(Fre), self._constrain_F(Fim)
        return self._ring_ifft_real(Fre, Fim)

    def _spin0_agrids(self, maps: jnp.ndarray) -> jnp.ndarray:
        """Spin-0 adjoint up to the alm grids (..., 2, L, L) — summable
        across transforms before one shared ``_grids_to_state``."""
        Gre, Gim = self._ring_fft_real(maps)
        if self._constrain_F is not None:
            Gre, Gim = self._constrain_F(Gre), self._constrain_F(Gim)
        return self._ladj_stack(self.lam0, jnp.stack([Gre, Gim], axis=-3))

    def _spin2_ring_coefs(self, q_maps, u_maps):
        """(Q, U) maps -> unweighted (Cp_re, Cp_im, Cm_re, Cm_im) ring
        coefficients C+_m = sum_j (Q + iU) e^{-im phi_j},
        C-_m = sum_j (Q + iU) e^{+im phi_j} (the azimuthal stage of
        adjoint_synthesis_spin2_state; feeds ``_spin2_agrids`` for
        grid-level summing)."""
        pet = self.dtype
        td = self.table_dtype
        q = q_maps.astype(pet)
        u = u_maps.astype(pet)
        if self.fft_mode == "fft":
            Y = jnp.fft.fft(q + 1j * u, axis=-1)
            Cp = Y[..., : self.lmax + 1]
            Cm = Y[..., (-np.arange(self.lmax + 1)) % self.nphi]
            Cp_re, Cp_im = Cp.real.astype(pet), Cp.imag.astype(pet)
            Cm_re, Cm_im = Cm.real.astype(pet), Cm.imag.astype(pet)
        else:
            Cp_re, Cp_im, Cm_re, Cm_im = self._spin2_halfspec(q, u)
        Cp_re, Cp_im = self._rot(Cp_re, Cp_im, -1)
        Cm_re, Cm_im = self._rot(Cm_re, Cm_im, +1)
        if self._constrain_F is not None:
            Cp_re, Cp_im = self._constrain_F(Cp_re), self._constrain_F(Cp_im)
            Cm_re, Cm_im = self._constrain_F(Cm_re), self._constrain_F(Cm_im)
        return Cp_re, Cp_im, Cm_re, Cm_im

    def _spin2_halfspec(self, q, u):
        """Real-arithmetic C+/C- of :meth:`_spin2_ring_coefs` (matmul or
        ct azimuthal stage), before the ring phase rotation."""
        pet = self.dtype
        td = self.table_dtype
        if self.fft_mode == "ct":
            qc, qs = _ct_real_to_halfspec(self._ct, q.astype(td), pet)
            uc, us = _ct_real_to_halfspec(self._ct, u.astype(td), pet)
        else:
            qu_, qv_ = self._fold_half(q)
            uu_, uv_ = self._fold_half(u)
            qc = jnp.matmul(qu_.astype(td), self.dft_cos.T,
                            precision=PRECISION,
                            preferred_element_type=pet).astype(pet)
            qs = jnp.matmul(qv_.astype(td), self.dft_sin.T,
                            precision=PRECISION,
                            preferred_element_type=pet).astype(pet)
            uc = jnp.matmul(uu_.astype(td), self.dft_cos.T,
                            precision=PRECISION,
                            preferred_element_type=pet).astype(pet)
            us = jnp.matmul(uv_.astype(td), self.dft_sin.T,
                            precision=PRECISION,
                            preferred_element_type=pet).astype(pet)
        return qc + us, uc - qs, qc - us, uc + qs

    def synthesis(self, flat: jnp.ndarray) -> jnp.ndarray:
        """A on the reference ragged packing (interop wrapper; the hot path
        is ``synthesis_state``)."""
        return self.synthesis_state(
            flat_to_state(flat.astype(self.dtype), self.lmax))

    def _analysis_core_state(self, maps, ring_w):
        """map -> grid-packed alm state with per-ring weights ring_w."""
        Gre, Gim = self._ring_fft_real(maps)
        Gre = Gre * ring_w[:, None]
        Gim = Gim * ring_w[:, None]
        if self._constrain_F is not None:
            Gre, Gim = self._constrain_F(Gre), self._constrain_F(Gim)
        a2 = self._ladj_stack(self.lam0, jnp.stack([Gre, Gim], axis=-3))
        return self._grids_to_state(a2)

    def analysis_state(self, maps: jnp.ndarray) -> jnp.ndarray:
        """Exact inverse of synthesis_state on a quadrature grid."""
        if self.allow_aliasing:
            raise ValueError("analysis is not an inverse on an aliased "
                             "(nphi <= 2 lmax) grid; only synthesis and "
                             "adjoint_synthesis are exact here")
        return self._analysis_core_state(maps, self.wq)

    def adjoint_synthesis_state(self, maps: jnp.ndarray) -> jnp.ndarray:
        """A^T: exact transpose of ``synthesis_state`` w.r.t. the plain
        pixel and state dot products."""
        return self._analysis_core_state(maps, jnp.ones_like(self.wq))

    def analysis(self, maps: jnp.ndarray) -> jnp.ndarray:
        """Exact inverse of synthesis on a quadrature grid (hp.map2alm role)."""
        return state_to_flat(self.analysis_state(maps), self.lmax)

    def adjoint_synthesis(self, maps: jnp.ndarray) -> jnp.ndarray:
        """A^T: exact transpose of ``synthesis`` w.r.t. the plain (unweighted)
        pixel dot product and the real-packed alm dot product (the role of
        the reference's map2alm * Npix/(4 pi), reference: utils.py:79-111,
        but exact by construction)."""
        return state_to_flat(self.adjoint_synthesis_state(maps), self.lmax)

    # -- spin 2 ------------------------------------------------------------

    def _require_spin2(self):
        if self.lam_p2 is None and self.lam_w is None:
            raise ValueError("SHT built without spin2=True")

    def synthesis_spin2_state(self, e_state: jnp.ndarray,
                              b_state: jnp.ndarray):
        """(E, B) grid-packed alm states -> (Q, U) maps.

        Convention: Q + iU = sum_lm a+_{lm} 2Y_lm with a+ = -(E + iB),
        a- = -(E - iB) (IAU/healpy CMB convention), negative m handled through
        the reality relations — all arithmetic stays real."""
        self._require_spin2()
        Fp_re, Fp_im, Fm_re, Fm_im = self._spin2_F(e_state, b_state)
        if self._constrain_F is not None:
            Fp_re, Fp_im = self._constrain_F(Fp_re), self._constrain_F(Fp_im)
            Fm_re, Fm_im = self._constrain_F(Fm_re), self._constrain_F(Fm_im)
        return self._spin2_maps_from_F(Fp_re, Fp_im, Fm_re, Fm_im)

    def _spin2_maps_from_F(self, Fp_re, Fp_im, Fm_re, Fm_im):
        """(F+, F-) ring Fourier coefficients (..., nr, L) -> (Q, U) maps."""
        Fp_re, Fp_im = self._rot(Fp_re, Fp_im, +1)
        Fm_re, Fm_im = self._rot(Fm_re, Fm_im, +1)
        # P(phi) = sum_{m>=0} F+ e^{im phi} + sum_{m>0} conj(F-) e^{-im phi}
        # Q = Re P, U = Im P
        if self.fft_mode == "fft":
            L = self.lmax + 1
            Fp = Fp_re + 1j * Fp_im
            Fmc = Fm_re - 1j * Fm_im
            gap = jnp.zeros(Fp.shape[:-1] + (self.nphi - 2 * L + 1,),
                            Fp.dtype)
            spec = jnp.concatenate([Fp, gap, Fmc[..., 1:][..., ::-1]],
                                   axis=-1)
            P = jnp.fft.ifft(spec, axis=-1) * self.nphi
            return P.real.astype(self.dtype), P.imag.astype(self.dtype)
        # the m > 0 negative-frequency terms add/subtract:
        pos = jnp.ones((self.lmax + 1,), self.dtype).at[0].set(0.0)
        td = self.table_dtype
        Are = (Fp_re + Fm_re * pos).astype(td)
        Aim = (Fp_im + Fm_im * pos).astype(td)
        Bre = (Fp_re - Fm_re * pos).astype(td)
        Bim = (Fp_im - Fm_im * pos).astype(td)
        pet = self.dtype
        if self.fft_mode == "ct":
            # Q = Re sum (Are + i Aim) w^mj ; U = Re sum (Bim - i Bre) w^mj
            q = _ct_halfspec_to_real(self._ct, Are, Aim, pet)
            u = _ct_halfspec_to_real(self._ct, Bim, -Bre, pet)
            return q, u
        qc = jnp.matmul(Are, self.dft_cos, precision=PRECISION,
                        preferred_element_type=pet).astype(pet)
        qs = jnp.matmul(Aim, self.dft_sin, precision=PRECISION,
                        preferred_element_type=pet).astype(pet)
        us = jnp.matmul(Bre, self.dft_sin, precision=PRECISION,
                        preferred_element_type=pet).astype(pet)
        uc = jnp.matmul(Bim, self.dft_cos, precision=PRECISION,
                        preferred_element_type=pet).astype(pet)
        q = self._unfold_half(qc - qs, qc + qs)
        u = self._unfold_half(uc + us, uc - us)
        return q, u

    # -- ring half-spectrum (m-domain) representation -----------------------
    #
    # Every ring of an iso-latitude grid holds nphi equispaced pixels, so a
    # synthesized map restricted to one ring is a finite cos/sin series in
    # the ring angle theta_j = 2 pi j / nphi:
    #     f[j] = sum_m  C_m cos(m theta_j) + S_m sin(m theta_j)
    # (phi0 offsets are absorbed into (C, S) by the ring phase rotation).
    # With mmax <= nphi/2 the pixel dot product of two such series is exact
    # in the coefficients (discrete Parseval):
    #     sum_j f g = pw_cos . (C C') + pw_sin . (S S')
    # which lets the blocked-MH fast path (samplers.nc_cls_sample_cut) do
    # ALL its per-bin likelihood algebra in the m domain — no per-bin
    # azimuthal iFFTs and no per-bin pixel maps.

    def ring_dot_weights(self):
        """(pw_cos, pw_sin) Parseval weights of the ring pixel dot product
        in the cos/sin half-spectrum basis; exact for mmax <= nphi/2
        (m = 0 and the Nyquist column 2 m = nphi carry pw_cos = nphi,
        pw_sin = 0)."""
        n = self.nphi
        L = self.lmax + 1
        if n < 2 * self.lmax:
            raise ValueError(
                f"ring-domain dot products need nphi >= 2 lmax "
                f"(nphi={n}, lmax={self.lmax}): cross-mode aliasing")
        pwc = np.full(L, n / 2.0)
        pws = np.full(L, n / 2.0)
        pwc[0], pws[0] = float(n), 0.0
        if 2 * self.lmax == n:
            pwc[self.lmax], pws[self.lmax] = float(n), 0.0
        return (jnp.asarray(pwc, self.dtype), jnp.asarray(pws, self.dtype))

    def ring_cs_of_maps(self, maps: jnp.ndarray):
        """(..., nr, nphi) pixel maps -> (Rc, Rs) raw ring sums
        Rc_m = sum_j f cos(m theta_j), Rs_m = sum_j f sin(m theta_j),
        so that sum_j f a = sum_m (Cc Rc + Cs Rs) for any half-spectrum
        series a with coefficients (Cc, Cs)."""
        u, v = self._fold_half(maps.astype(self.dtype))
        td = self.table_dtype
        Rc = jnp.matmul(u.astype(td), self.dft_cos.T,
                        precision=PRECISION,
                        preferred_element_type=self.dtype).astype(self.dtype)
        Rs = jnp.matmul(v.astype(td), self.dft_sin.T,
                        precision=PRECISION,
                        preferred_element_type=self.dtype).astype(self.dtype)
        return Rc, Rs

    def lsel_table(self, lam, j_idx):
        """Gather the wedge m-block table stack into one dense
        (L, J, nr) array over the static selected ells ``j_idx`` (zero
        where m > ell).  Feeds the table-domain blocked-MH reductions."""
        j_idx = np.asarray(j_idx)
        outs = []
        for (m0, m1), blk in zip(self._msplit(), lam):
            jrel = j_idx - m0
            valid = jrel >= 0
            lamj = jnp.take(blk, jnp.asarray(np.where(valid, jrel, 0)),
                            axis=1)                      # (mb, J, nr)
            if not valid.all():
                lamj = lamj * jnp.asarray(
                    valid.astype(np.float64), lamj.dtype)[None, :, None]
            outs.append(lamj)
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)

    def ring_cs_lsel_spin0(self, x: jnp.ndarray, j_idx, seg):
        """Per-bin ell-selected spin-0 synthesis in the ring half-spectrum
        basis: -> (Cc, Cs) each (..., nb, nr, L) with
        map_b[j] = sum_m Cc cos(m theta_j) + Cs sin(m theta_j)."""
        return self.ring_cs_lsel_spin0_grids(self._state_grids(x), j_idx,
                                             seg)

    def ring_cs_lsel_spin0_grids(self, g0, j_idx, seg):
        """Spin-0 variant taking a PREBUILT ``_state_grids`` array — callers
        that sweep many ell-chunks of one state hoist the (..., 2, L, L)
        grid expansion out of the chunk loop (it costs ~state-sized memory
        traffic per build; the chunk gathers are near-free)."""
        F = self._lsel_F(self.lam0, g0, j_idx, seg)
        Fre, Fim = F[..., 0, :, :], F[..., 1, :, :]
        if self._constrain_F is not None:
            Fre, Fim = self._constrain_F(Fre), self._constrain_F(Fim)
        Fre, Fim = self._rot(Fre, Fim, +1)
        cm = jnp.ones((self.lmax + 1,), self.dtype).at[1:].set(2.0)
        return cm * Fre, -(cm * Fim)

    def lsel_grid_spin2_single(self, state: jnp.ndarray, which: str):
        """Prebuild the ap/am grid of a SINGLE-field spin-2 input (the
        other field zero) for :meth:`ring_cs_lsel_spin2_grids`.

        For E-only input (B = 0): ap = am = -(g_re, g_im) = -g, so one grid
        serves both tables with sign (-1, -1).  For B-only (E = 0):
        ap = (g_im, -g_re) and am = -ap: the swapped grid with signs
        (+1, -1).  Returns (grid, sign_p, sign_m)."""
        self._require_spin2()
        g = self._state_grids(state)
        if which == "e":
            return g, -1.0, -1.0
        if which != "b":
            raise ValueError(which)
        gsw = jnp.stack([g[..., 1, :, :], -g[..., 0, :, :]], axis=-3)
        return gsw, 1.0, -1.0

    def ring_cs_lsel_spin2_grids(self, g, sign_p, sign_m, j_idx, seg):
        """Per-bin ell-selected spin-2 synthesis from a prebuilt
        single-field grid (:meth:`lsel_grid_spin2_single`):
        -> ((Qc, Qs), (Uc, Us)), each (..., nb, nr, L)."""
        if self.lam_p2 is None:
            raise NotImplementedError(
                "ell-selected spin-2 synthesis requires ring_split=False")
        Fp = self._lsel_F(self.lam_p2, g, j_idx, seg)
        Fm = self._lsel_F(self.lam_m2, g, j_idx, seg)
        pos = jnp.ones((self.lmax + 1,), self.dtype).at[0].set(0.0)
        pos_p = sign_m * pos
        Are = sign_p * Fp[..., 0, :, :] + Fm[..., 0, :, :] * pos_p
        Aim = sign_p * Fp[..., 1, :, :] + Fm[..., 1, :, :] * pos_p
        Bre = sign_p * Fp[..., 0, :, :] - Fm[..., 0, :, :] * pos_p
        Bim = sign_p * Fp[..., 1, :, :] - Fm[..., 1, :, :] * pos_p
        if self._constrain_F is not None:
            Are, Aim = self._constrain_F(Are), self._constrain_F(Aim)
            Bre, Bim = self._constrain_F(Bre), self._constrain_F(Bim)
        Are, Aim = self._rot(Are, Aim, +1)
        Bre, Bim = self._rot(Bre, Bim, +1)
        # Q[j] = sum Are cos - Aim sin ; U[j] = sum Bim cos + Bre sin
        # (matches _spin2_maps_from_F's qc/qs/uc/us assembly exactly)
        return (Are, -Aim), (Bim, Bre)

    def ring_cs_lsel_spin2(self, e_state: jnp.ndarray, b_state: jnp.ndarray,
                           j_idx, seg):
        """Per-bin ell-selected spin-2 synthesis in the ring half-spectrum
        basis: -> ((Qc, Qs), (Uc, Us)), each (..., nb, nr, L).  General
        two-field entry point; the blocked-MH fast path uses the
        single-field ``_grids`` variant with hoisted grids."""
        self._require_spin2()
        if self.lam_p2 is None:
            raise NotImplementedError(
                "ell-selected spin-2 synthesis requires ring_split=False")
        eg = self._state_grids(e_state)
        bg = self._state_grids(b_state)
        ere, eim = eg[..., 0, :, :], eg[..., 1, :, :]
        bre, bim = bg[..., 0, :, :], bg[..., 1, :, :]
        ap = jnp.stack([-(ere - bim), -(eim + bre)], axis=-3)
        am = jnp.stack([-(ere + bim), -(eim - bre)], axis=-3)
        Fp = self._lsel_F(self.lam_p2, ap, j_idx, seg)
        Fm = self._lsel_F(self.lam_m2, am, j_idx, seg)
        pos = jnp.ones((self.lmax + 1,), self.dtype).at[0].set(0.0)
        Are = Fp[..., 0, :, :] + Fm[..., 0, :, :] * pos
        Aim = Fp[..., 1, :, :] + Fm[..., 1, :, :] * pos
        Bre = Fp[..., 0, :, :] - Fm[..., 0, :, :] * pos
        Bim = Fp[..., 1, :, :] - Fm[..., 1, :, :] * pos
        if self._constrain_F is not None:
            Are, Aim = self._constrain_F(Are), self._constrain_F(Aim)
            Bre, Bim = self._constrain_F(Bre), self._constrain_F(Bim)
        Are, Aim = self._rot(Are, Aim, +1)
        Bre, Bim = self._rot(Bre, Bim, +1)
        # Q[j] = sum Are cos - Aim sin ; U[j] = sum Bim cos + Bre sin
        # (matches _spin2_maps_from_F's qc/qs/uc/us assembly exactly)
        return (Are, -Aim), (Bim, Bre)

    # -- ell-selected (binned) synthesis: the rank-one MH fast path ---------

    def synthesis_state_lsel(self, x: jnp.ndarray, sel) -> jnp.ndarray:
        """A applied to each ell-subset of x: sel (nb, L) 0/1 selectors ->
        (..., nb, nr, nphi) maps, all subsets through one batched Legendre
        einsum (lcore._lsynth_stack_binned)."""
        sel = jnp.asarray(sel, self.dtype)
        F = self._lsynth_stack_binned(self.lam0, self._state_grids(x), sel)
        return self._ring_ifft_real(F[..., 0, :, :], F[..., 1, :, :])

    def synthesis_spin2_state_lsel(self, e_state, b_state, sel):
        """Spin-2 synthesis of each ell-subset of (E, B): (..., nb, nr, nphi)
        Q and U maps (rank-one MH fast path; requires ring_split=False)."""
        self._require_spin2()
        if self.lam_p2 is None:
            raise NotImplementedError(
                "binned spin-2 synthesis requires ring_split=False tables")
        sel = jnp.asarray(sel, self.dtype)
        eg = self._state_grids(e_state)
        bg = self._state_grids(b_state)
        ere, eim = eg[..., 0, :, :], eg[..., 1, :, :]
        bre, bim = bg[..., 0, :, :], bg[..., 1, :, :]
        ap = jnp.stack([-(ere - bim), -(eim + bre)], axis=-3)
        am = jnp.stack([-(ere + bim), -(eim - bre)], axis=-3)
        Fp = self._lsynth_stack_binned(self.lam_p2, ap, sel)
        Fm = self._lsynth_stack_binned(self.lam_m2, am, sel)
        return self._spin2_maps_from_F(
            Fp[..., 0, :, :], Fp[..., 1, :, :],
            Fm[..., 0, :, :], Fm[..., 1, :, :])

    def synthesis_spin2(self, e_flat: jnp.ndarray, b_flat: jnp.ndarray):
        """(E, B) real-packed alm -> (Q, U) maps (interop wrapper; the hot
        path is ``synthesis_spin2_state``)."""
        return self.synthesis_spin2_state(
            flat_to_state(e_flat.astype(self.dtype), self.lmax),
            flat_to_state(b_flat.astype(self.dtype), self.lmax))

    def _analysis_spin2_core(self, q_maps, u_maps, ring_w):
        self._require_spin2()
        w = ring_w[:, None]
        # a+_{lm} = sum_r w 2lam_lm C+ ; a-_{lm} = sum_r w -2lam_lm conj(C-)
        return self._spin2_alm(*(c * w for c in
                                 self._spin2_ring_coefs(q_maps, u_maps)))

    def analysis_spin2_state(self, q_maps, u_maps):
        """Exact inverse: (Q, U) maps -> (E, B) grid-packed alm states."""
        if self.allow_aliasing:
            raise ValueError("analysis is not an inverse on an aliased "
                             "(nphi <= 2 lmax) grid; only synthesis and "
                             "adjoint_synthesis are exact here")
        return self._analysis_spin2_core(q_maps, u_maps, self.wq)

    def adjoint_synthesis_spin2_state(self, q_maps, u_maps):
        """Exact transpose of synthesis_spin2_state w.r.t. plain dots."""
        return self._analysis_spin2_core(q_maps, u_maps,
                                         jnp.ones_like(self.wq))

    def analysis_spin2(self, q_maps, u_maps):
        """Exact inverse: (Q, U) maps -> (E, B) real-packed alm."""
        e, b = self.analysis_spin2_state(q_maps, u_maps)
        return (state_to_flat(e, self.lmax), state_to_flat(b, self.lmax))

    def adjoint_synthesis_spin2(self, q_maps, u_maps):
        """Exact transpose of synthesis_spin2 w.r.t. plain dot products."""
        e, b = self.adjoint_synthesis_spin2_state(q_maps, u_maps)
        return (state_to_flat(e, self.lmax), state_to_flat(b, self.lmax))


class _CT:
    """Mixed-radix azimuthal operator: DFT_n factored as two matmul stages
    with a twiddle in between (n = n1 n2; m = n1 a + b; j = j2 + n2 j1).
    For n ~ 2 lmax this cuts the azimuthal flops ~4x vs the direct
    (folded) DFT matmul — the FFT idea expressed as real matmuls."""

    def __init__(self, n, n1, n2, A, L, td):
        self.n, self.n1, self.n2, self.A, self.L = n, n1, n2, A, L
        a = np.arange(A)[:, None] * np.arange(n2)[None, :]
        w2 = 2.0 * np.pi * a / n2
        self.W2c = jnp.asarray(np.cos(w2), dtype=td)     # (A, n2)
        self.W2s = jnp.asarray(np.sin(w2), dtype=td)
        tw = 2.0 * np.pi * (np.arange(n1)[:, None]
                            * np.arange(n2)[None, :]) / n
        self.TWc = jnp.asarray(np.cos(tw), dtype=td)     # (n1, n2)
        self.TWs = jnp.asarray(np.sin(tw), dtype=td)
        w1 = 2.0 * np.pi * (np.arange(n1)[:, None]
                            * np.arange(n1)[None, :]) / n1
        self.W1c = jnp.asarray(np.cos(w1), dtype=td)     # (n1, n1)
        self.W1s = jnp.asarray(np.sin(w1), dtype=td)


def _ct_setup(n, L, td):
    """Pick n = n1 n2 minimizing 4 ceil(L/n1) + 2 n1; None if no useful
    factorization exists."""
    best = None
    for n1 in range(2, n):
        if n % n1:
            continue
        A = -(-L // n1)
        cost = 4 * A + 2 * n1
        if best is None or cost < best[0]:
            best = (cost, n1)
    if best is None or best[0] >= 2 * (n // 2 + 1) * L // n:
        return None
    n1 = best[1]
    return _CT(n, n1, n // n1, -(-L // n1), L, td)


def _ct_halfspec_to_real(ct, Gre, Gim, out_dtype):
    """f[..., j] = Re sum_{m<L} (Gre + i Gim)[m] e^{2 pi i m j / n}."""
    pad = ct.A * ct.n1 - ct.L
    if pad:
        padspec = [(0, 0)] * (Gre.ndim - 1) + [(0, pad)]
        Gre = jnp.pad(Gre, padspec)
        Gim = jnp.pad(Gim, padspec)
    Xre = Gre.reshape(Gre.shape[:-1] + (ct.A, ct.n1))
    Xim = Gim.reshape(Xre.shape)
    pet = out_dtype
    e = lambda x, w: jnp.einsum("...ab,aj->...bj", x, w,
                                precision=PRECISION,
                                preferred_element_type=pet).astype(pet)
    T1re = e(Xre, ct.W2c) - e(Xim, ct.W2s)
    T1im = e(Xre, ct.W2s) + e(Xim, ct.W2c)
    T2re = T1re * ct.TWc - T1im * ct.TWs
    T2im = T1re * ct.TWs + T1im * ct.TWc
    f = lambda x, w: jnp.einsum("...bj,bk->...jk", x.astype(Gre.dtype), w,
                                precision=PRECISION,
                                preferred_element_type=pet).astype(pet)
    out = f(T2re, ct.W1c) - f(T2im, ct.W1s)      # (..., n2, n1)
    # j = j2 + n2 j1  ->  flatten with j1 major
    out = jnp.swapaxes(out, -1, -2)              # (..., n1, n2)
    return out.reshape(out.shape[:-2] + (ct.n,))


def _ct_real_to_halfspec(ct, maps, out_dtype):
    """(C, S)[..., m] = (sum_j f cos(2 pi m j/n), sum_j f sin(...)), m < L —
    the exact transpose of _ct_halfspec_to_real."""
    pet = out_dtype
    x = maps.reshape(maps.shape[:-1] + (ct.n1, ct.n2))   # (..., j1, j2)
    e2 = lambda v, w: jnp.einsum("...kj,bk->...bj", v, w,
                                 precision=PRECISION,
                                 preferred_element_type=pet).astype(pet)
    Ure = e2(x, ct.W1c)
    Uim = -e2(x, ct.W1s)
    Vre = Ure * ct.TWc + Uim * ct.TWs
    Vim = Uim * ct.TWc - Ure * ct.TWs
    g = lambda v, w: jnp.einsum("...bj,aj->...ab", v.astype(maps.dtype), w,
                                precision=PRECISION,
                                preferred_element_type=pet).astype(pet)
    Cre = g(Vre, ct.W2c) + g(Vim, ct.W2s)
    Cim = g(Vim, ct.W2c) - g(Vre, ct.W2s)
    Cre = Cre.reshape(Cre.shape[:-2] + (ct.A * ct.n1,))[..., : ct.L]
    Cim = Cim.reshape(Cim.shape[:-2] + (ct.A * ct.n1,))[..., : ct.L]
    return Cre, -Cim


register_arrays_pytree(
    _CT,
    array_fields=("W2c", "W2s", "TWc", "TWs", "W1c", "W1s"),
    static_fields=("n", "n1", "n2", "A", "L"),
)

register_arrays_pytree(
    SHT,
    array_fields=("lam0", "wq", "phase_cos", "phase_sin", "dft_cos",
                  "dft_sin", "lam_p2", "lam_m2", "lam_w", "lam_x",
                  "par_sign", "_ct", "pack_in", "pack_out"),
    static_fields=("grid", "lmax", "dtype", "table_dtype", "fft_mode",
                   "has_phase", "nphi", "nphi_half", "nrings", "m_block",
                   "ring_split", "nrh", "has_mid", "_constrain_F",
                   "allow_aliasing"),
)


def make_sht(lmax: int, grid: SphereGrid | None = None, dtype=jnp.float32,
             spin2: bool = False, fft_mode: str = "matmul",
             table_dtype=None, m_block: int = 128,
             ring_split: bool = False) -> SHT:
    """Build an SHT for ``lmax`` (Gauss–Legendre grid by default).

    table_dtype=jnp.bfloat16 halves the bytes of the operator tables
    (tests validate fp32/fp64).  ``m_block`` controls the wedge-aware
    m-block split of the Legendre contractions (0 disables).
    ``ring_split`` enables the north/south parity split on
    equator-symmetric grids (half table memory; half Legendre flops at
    spin 0) — off by default: the blocked-MH fast paths need the dense
    layout, and the split's end-to-end effect on the GPU is not measured."""
    if grid is None:
        grid = gauss_legendre_grid(lmax)
    return SHT(grid, lmax, dtype=dtype, spin2=spin2, fft_mode=fft_mode,
               table_dtype=table_dtype, m_block=m_block,
               ring_split=ring_split)
