"""Point-set spherical-harmonic evaluation — the sparse-hole operator.

Evaluates ``A s`` (and its exact transpose) at an arbitrary list of sky
positions grouped by iso-latitude ring: each "row" is one colatitude with
its own arbitrary azimuth list (padded to a common width ``p``; padded
slots are annihilated by the validity mask on both sides, so synthesis and
adjoint stay exact transposes of each other).

Why it exists: the reference's production mask is an apodized galactic
mask PLUS point-source holes at all latitudes (reference: config.py:22-28,
Planck HFI GalPlane-apo0 + point sources), and healpy always transforms
the full sphere (reference: NonCenteredGibbs.py:333-355).  Under the
cut-sky complement decomposition (ops.model.with_cut_decomposition) the
azimuthally-uniform "floor" of such a mask runs through the uniform-grid
cut-ring SHT (m/table-domain fast paths eligible) while the sparse hole
pixels — a few thousand points instead of half the sphere — run through
this operator: a per-m Legendre stage shared with the grid transforms
(sht.lcore) followed by a thin per-row trig matmul at the exact azimuths
(a type-2 nonuniform DFT expressed as matmuls).

Conventions match :class:`~gibbssampler.sht.transform.SHT` exactly
(same Legendre tables, same spin-2 F+/F- assembly); azimuths are stored
ABSOLUTE, so no per-ring phase rotation is needed.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils.precision import PRECISION
from ..utils.pytree import register_arrays_pytree
from .lcore import LegendreCore
from .legendre import legendre_table, spin2_lambda_tables

__all__ = ["PointSHT", "group_points_by_ring"]


def group_points_by_ring(ring_idx, theta, phi, flat_idx, max_width=None):
    """Group a flat point list by ring and pad to a rectangle.

    ring_idx, theta, phi, flat_idx: (npts,) per-point arrays (ring label,
    colatitude, absolute azimuth, index into the caller's flat pixel
    layout).  Returns (theta_rows (nrows,), phi_pad (nrows, p),
    valid (nrows, p), gather_idx (nrows, p) int64 — flat_idx per slot with
    0 on padding; mask with ``valid`` after gathering).

    ``max_width`` (env GS_SPARSE_PMAX, default 64) caps the padded width:
    a ring holding more points is split into several virtual rows sharing
    its colatitude.  Without the cap a single dense ring (a hole crossing
    a polar ring covers ~1/sin(theta) pixels — measured p = 667 at
    lmax = 512 with 0.35 deg holes) would pad EVERY row's trig tables and
    azimuthal matmuls to its width (~90x waste); with it the padded slot
    count stays within a few x of the true point count while the Legendre
    stage grows only by the handful of duplicated rows."""
    import os as _os
    if max_width is None:
        max_width = int(_os.environ.get("GS_SPARSE_PMAX", "64"))
    ring_idx = np.asarray(ring_idx)
    order = np.argsort(ring_idx, kind="stable")
    ring_idx = ring_idx[order]
    theta = np.asarray(theta, np.float64)[order]
    phi = np.asarray(phi, np.float64)[order]
    flat_idx = np.asarray(flat_idx, np.int64)[order]
    rows, starts, counts = np.unique(ring_idx, return_index=True,
                                     return_counts=True)
    segs = []                      # (theta, start, count) virtual rows
    for k in range(rows.size):
        s, c = int(starts[k]), int(counts[k])
        for s0 in range(s, s + c, max_width):
            segs.append((theta[s], s0, min(max_width, s + c - s0)))
    nrows = len(segs)
    p = max(c for (_t, _s, c) in segs)
    phi_pad = np.zeros((nrows, p))
    valid = np.zeros((nrows, p))
    gidx = np.zeros((nrows, p), dtype=np.int64)
    theta_rows = np.empty(nrows)
    for k, (th, s, c) in enumerate(segs):
        theta_rows[k] = th
        phi_pad[k, :c] = phi[s: s + c]
        valid[k, :c] = 1.0
        gidx[k, :c] = flat_idx[s: s + c]
    return theta_rows, phi_pad, valid, gidx


class PointSHT(LegendreCore):
    """Precomputed point-evaluation operators for one (point set, lmax).

    Same pure-method surface as the grid transforms where it matters to
    :class:`~gibbssampler.ops.model.SkyModel`: ``synthesis_state`` /
    ``adjoint_synthesis_state`` (spin 0), ``synthesis_spin2_state`` /
    ``adjoint_synthesis_spin2_state``, plus the ell-selected per-bin
    variants the blocked-MH fast path uses.  "Maps" are (..., nrows, p)
    value arrays.
    """

    map_ndim = 2   # values are (..., nrows, p)

    def __init__(self, theta, phi, valid, lmax: int, dtype=jnp.float32,
                 spin0: bool = True, spin2: bool = False, table_dtype=None,
                 m_block: int = 128):
        theta = np.asarray(theta, np.float64)        # (nrows,)
        phi = np.asarray(phi, np.float64)            # (nrows, p)
        valid_np = np.asarray(valid, np.float64)
        if phi.ndim != 2 or phi.shape[0] != theta.shape[0]:
            raise ValueError("phi must be (nrows, p) matching theta")
        self._init_core(lmax, theta, dtype, table_dtype, m_block,
                        ring_split=False)
        self.nrows, self.p = int(phi.shape[0]), int(phi.shape[1])
        L = lmax + 1
        ang = phi[:, None, :] * np.arange(L)[None, :, None]   # (nr, L, p)
        self.cosT = jnp.asarray(np.cos(ang), dtype=self.table_dtype)
        self.sinT = jnp.asarray(np.sin(ang), dtype=self.table_dtype)
        self.valid = jnp.asarray(valid_np, dtype=self.dtype)
        self.lam0 = (self._block_table(legendre_table(lmax, np.cos(theta)))
                     if spin0 else None)
        self.lam_p2 = self.lam_m2 = self.lam_w = self.lam_x = None
        if spin2:
            lp, lm_ = spin2_lambda_tables(lmax, theta)
            self._build_spin2_tables(lp, lm_)
        # flat-slot view: the REAL points as one unpadded axis.  The
        # blocked-MH per-bin corrections use it — their per-chunk tensors
        # then scale with the true point count instead of nrows x p, and
        # no (row, L) ring-Fourier planes are ever materialized per chain.
        vr, vc = np.nonzero(valid_np)
        self.nslots = int(vr.size)
        self.slot_row = jnp.asarray(vr, dtype=jnp.int32)
        self.slot_col = jnp.asarray(vc, dtype=jnp.int32)
        phi_flat = phi[vr, vc]
        angF = np.outer(np.arange(L), phi_flat)            # (L, S)
        self.cosF = jnp.asarray(np.cos(angF), dtype=self.table_dtype)
        self.sinF = jnp.asarray(np.sin(angF), dtype=self.table_dtype)

    # -- azimuthal point stage (exact-transpose pair) ----------------------

    def _to_points(self, Cc, Cs):
        """Half-spectrum coefficients (..., nr, L) -> values (..., nr, p):
        v[r, k] = sum_m Cc cos(m phi_rk) + Cs sin(m phi_rk)."""
        td = self.table_dtype
        v = (jnp.einsum("...rm,rmp->...rp", Cc.astype(td), self.cosT,
                        precision=PRECISION,
                        preferred_element_type=self.dtype)
             + jnp.einsum("...rm,rmp->...rp", Cs.astype(td), self.sinT,
                          precision=PRECISION,
                          preferred_element_type=self.dtype))
        return v.astype(self.dtype) * self.valid

    def _from_points(self, f):
        """Exact transpose of _to_points: values -> (Sc, Ss) trig sums."""
        ft = (f * self.valid).astype(self.table_dtype)
        Sc = jnp.einsum("...rp,rmp->...rm", ft, self.cosT,
                        precision=PRECISION,
                        preferred_element_type=self.dtype).astype(self.dtype)
        Ss = jnp.einsum("...rp,rmp->...rm", ft, self.sinT,
                        precision=PRECISION,
                        preferred_element_type=self.dtype).astype(self.dtype)
        return Sc, Ss

    def _cm(self):
        return jnp.ones((self.lmax + 1,), self.dtype).at[1:].set(2.0)

    def _pos(self):
        return jnp.ones((self.lmax + 1,), self.dtype).at[0].set(0.0)

    # -- spin 0 ------------------------------------------------------------

    def synthesis_state(self, x: jnp.ndarray) -> jnp.ndarray:
        """A: grid-packed alm state (..., nstate) -> values (..., nr, p)."""
        F = self._lsynth_stack(self.lam0, self._state_grids(x))
        cm = self._cm()
        return self._to_points(cm * F[..., 0, :, :], -(cm * F[..., 1, :, :]))

    def adjoint_synthesis_state(self, f: jnp.ndarray) -> jnp.ndarray:
        """A^T: exact transpose of ``synthesis_state`` (no cm factor here:
        the grid-packing output scale absorbs it, exactly as in
        SHT._analysis_core_state)."""
        return self._grids_to_state(self._spin0_agrids(f))

    def synthesis_from_grids(self, g0: jnp.ndarray) -> jnp.ndarray:
        """Spin-0 point synthesis from a prebuilt ``_state_grids`` array."""
        F = self._lsynth_stack(self.lam0, g0)
        cm = self._cm()
        return self._to_points(cm * F[..., 0, :, :], -(cm * F[..., 1, :, :]))

    def _spin0_agrids(self, f: jnp.ndarray) -> jnp.ndarray:
        """Spin-0 adjoint up to the alm grids (summable across
        transforms)."""
        Sc, Ss = self._from_points(f)
        return self._ladj_stack(self.lam0, jnp.stack([Sc, -Ss], axis=-3))

    def _spin2_ring_coefs(self, q, u):
        """(Q, U) point values -> (Cp_re, Cp_im, Cm_re, Cm_im) trig-sum
        coefficients (absolute frame; feeds ``_spin2_agrids``)."""
        qc, qs = self._from_points(q)
        uc, us = self._from_points(u)
        return qc + us, uc - qs, qc - us, uc + qs

    # -- spin 2 ------------------------------------------------------------

    def _require_spin2(self):
        if self.lam_p2 is None:
            raise ValueError("PointSHT built without spin2=True")

    def _spin2_points_from_F(self, Fp_re, Fp_im, Fm_re, Fm_im):
        """(F+, F-) ring Fourier coefficients -> (Q, U) point values (the
        azimuthal assembly of SHT._spin2_maps_from_F at exact azimuths)."""
        pos = self._pos()
        Are = Fp_re + Fm_re * pos
        Aim = Fp_im + Fm_im * pos
        Bre = Fp_re - Fm_re * pos
        Bim = Fp_im - Fm_im * pos
        # Q = sum Are cos - Aim sin ; U = sum Bim cos + Bre sin
        return self._to_points(Are, -Aim), self._to_points(Bim, Bre)

    def synthesis_spin2_state(self, e_state: jnp.ndarray,
                              b_state: jnp.ndarray):
        """(E, B) grid-packed states -> (Q, U) point values."""
        self._require_spin2()
        return self._spin2_points_from_F(*self._spin2_F(e_state, b_state))

    def adjoint_synthesis_spin2_state(self, q: jnp.ndarray, u: jnp.ndarray):
        """Exact transpose of ``synthesis_spin2_state``."""
        self._require_spin2()
        qc, qs = self._from_points(q)
        uc, us = self._from_points(u)
        # C+ = sum (Q+iU) e^{-im phi}, C- = sum (Q+iU) e^{+im phi}
        # (the absolute-frame trig sums of SHT._analysis_spin2_core)
        return self._spin2_alm(qc + us, uc - qs, qc - us, uc + qs)

    # -- ell-selected per-bin values (blocked-MH fast-path hooks) -----------

    def values_lsel_spin0_grids(self, g0, j_idx, seg):
        """Per-bin ell-selected spin-0 values from a prebuilt
        ``_state_grids`` array: (..., nb, nr, p)."""
        F = self._lsel_F(self.lam0, g0, j_idx, seg)
        cm = self._cm()
        return self._to_points(cm * F[..., 0, :, :], -(cm * F[..., 1, :, :]))

    def values_lsel_spin2_grids(self, g, sign_p, sign_m, j_idx, seg):
        """Per-bin ell-selected spin-2 values from a prebuilt single-field
        grid (SHT.lsel_grid_spin2_single): -> (Q, U) each (..., nb, nr, p)."""
        self._require_spin2()
        Fp = self._lsel_F(self.lam_p2, g, j_idx, seg)
        Fm = self._lsel_F(self.lam_m2, g, j_idx, seg)
        pos_p = sign_m * self._pos()
        Are = sign_p * Fp[..., 0, :, :] + Fm[..., 0, :, :] * pos_p
        Aim = sign_p * Fp[..., 1, :, :] + Fm[..., 1, :, :] * pos_p
        Bre = sign_p * Fp[..., 0, :, :] - Fm[..., 0, :, :] * pos_p
        Bim = sign_p * Fp[..., 1, :, :] - Fm[..., 1, :, :] * pos_p
        return self._to_points(Are, -Aim), self._to_points(Bim, Bre)

    # -- flat-slot per-bin values (no padding; chain-independent tables) ----

    def flat_of(self, padded: jnp.ndarray) -> jnp.ndarray:
        """(..., nrows, p) padded point values -> (..., nslots) flat."""
        return padded[..., self.slot_row, self.slot_col]

    def _lsel_lam(self, lam, j_idx):
        """Gather the wedge m-block table stack into one dense (L, J, nr)
        array over the static selected ells (zero where m > ell)."""
        j_idx = np.asarray(j_idx)
        outs = []
        for (m0, m1), blk in zip(self._msplit(), lam):
            jrel = j_idx - m0
            ok = jrel >= 0
            lamj = jnp.take(blk, jnp.asarray(np.where(ok, jrel, 0)), axis=1)
            if not ok.all():
                lamj = lamj * jnp.asarray(ok.astype(np.float64),
                                          lamj.dtype)[None, :, None]
            outs.append(lamj)
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)

    def _flat_fold(self, v, seg):
        if seg is None:
            return v
        return jnp.einsum("...js,jb->...bs", v,
                          jnp.asarray(seg, v.dtype),
                          precision=PRECISION,
                          preferred_element_type=self.dtype).astype(v.dtype)

    def values_flat_spin0_gsel(self, gsel, j_idx, seg):
        """Per-bin ell-selected spin-0 values on the FLAT slot axis from a
        pre-gathered grid selection gsel (..., 2, L, J): (..., nb, S).

        The route never builds per-chain (row, L) planes: the thin
        ell-gathered lambda table is expanded to slots (chain-independent,
        ~J x S floats) and contracted against the selected grid columns."""
        lamj = self._lsel_lam(self.lam0, j_idx)            # (L, J, r)
        lam_s = jnp.take(lamj, self.slot_row, axis=2)      # (L, J, S)
        Ec = lam_s * self.cosF[:, None, :]
        Es = lam_s * self.sinF[:, None, :]
        cm = self._cm().astype(gsel.dtype)
        g_re = (gsel[..., 0, :, :] * cm[:, None]).astype(self.table_dtype)
        g_im = (gsel[..., 1, :, :] * cm[:, None]).astype(self.table_dtype)
        v = (jnp.einsum("...mj,mjs->...js", g_re, Ec,
                        precision=PRECISION,
                        preferred_element_type=self.dtype)
             - jnp.einsum("...mj,mjs->...js", g_im, Es,
                          precision=PRECISION,
                          preferred_element_type=self.dtype))
        return self._flat_fold(v.astype(self.dtype), seg)

    def values_flat_spin2_gsel(self, gsel, sign_p, sign_m, j_idx, seg):
        """Per-bin ell-selected spin-2 values on the flat slot axis from a
        pre-gathered single-field grid selection (..., 2, L, J) with its
        (sign_p, sign_m) from SHT.lsel_grid_spin2_single:
        -> (Q, U) each (..., nb, S)."""
        self._require_spin2()
        lamp = self._lsel_lam(self.lam_p2, j_idx)          # (L, J, r)
        lamm = self._lsel_lam(self.lam_m2, j_idx)
        pos = self._pos().astype(lamp.dtype)[:, None, None]
        La = sign_p * lamp + sign_m * pos * lamm
        Lb = sign_p * lamp - sign_m * pos * lamm
        La_s = jnp.take(La, self.slot_row, axis=2)         # (L, J, S)
        Lb_s = jnp.take(Lb, self.slot_row, axis=2)
        Eac = La_s * self.cosF[:, None, :]
        Eas = La_s * self.sinF[:, None, :]
        Ebc = Lb_s * self.cosF[:, None, :]
        Ebs = Lb_s * self.sinF[:, None, :]
        g_re = gsel[..., 0, :, :].astype(self.table_dtype)
        g_im = gsel[..., 1, :, :].astype(self.table_dtype)
        e = lambda g, E: jnp.einsum("...mj,mjs->...js", g, E,
                                    precision=PRECISION,
                                    preferred_element_type=self.dtype
                                    ).astype(self.dtype)
        q = e(g_re, Eac) - e(g_im, Eas)
        u = e(g_im, Ebc) + e(g_re, Ebs)
        return self._flat_fold(q, seg), self._flat_fold(u, seg)

    def synthesis_state_lsel(self, x: jnp.ndarray, sel) -> jnp.ndarray:
        """A applied to each ell-subset of x (sel (nb, L) 0/1 selectors)
        -> (..., nb, nr, p) values (mirror of SHT.synthesis_state_lsel)."""
        sel = jnp.asarray(sel, self.dtype)
        F = self._lsynth_stack_binned(self.lam0, self._state_grids(x), sel)
        cm = self._cm()
        return self._to_points(cm * F[..., 0, :, :], -(cm * F[..., 1, :, :]))

    def synthesis_spin2_state_lsel(self, e_state, b_state, sel):
        """Spin-2 values of each ell-subset of (E, B): (..., nb, nr, p)
        Q and U (mirror of SHT.synthesis_spin2_state_lsel)."""
        self._require_spin2()
        sel = jnp.asarray(sel, self.dtype)
        eg = self._state_grids(e_state)
        bg = self._state_grids(b_state)
        ere, eim = eg[..., 0, :, :], eg[..., 1, :, :]
        bre, bim = bg[..., 0, :, :], bg[..., 1, :, :]
        ap = jnp.stack([-(ere - bim), -(eim + bre)], axis=-3)
        am = jnp.stack([-(ere + bim), -(eim - bre)], axis=-3)
        Fp = self._lsynth_stack_binned(self.lam_p2, ap, sel)
        Fm = self._lsynth_stack_binned(self.lam_m2, am, sel)
        return self._spin2_points_from_F(
            Fp[..., 0, :, :], Fp[..., 1, :, :],
            Fm[..., 0, :, :], Fm[..., 1, :, :])


register_arrays_pytree(
    PointSHT,
    array_fields=("lam0", "lam_p2", "lam_m2", "lam_w", "lam_x", "cosT",
                  "sinT", "valid", "cosF", "sinF", "slot_row", "slot_col",
                  "par_sign", "pack_in", "pack_out"),
    static_fields=("lmax", "dtype", "table_dtype", "m_block", "ring_split",
                   "nrows", "p", "nslots", "nrh", "has_mid"),
)
