"""The forward model d = A B s + n as a bundle of jittable operators.

``SkyModel`` unifies temperature (spin-0, one field) and polarization
(spin-2, E/B fields) behind one interface so every sampler is written once:

- state ``s``    : (..., nfields, nstate) grid-packed alm
  (harmonics.gridstate; the gather-free layout)
- pixel data ``d``: (..., nfields, nrings, nphi) maps  (T, or Q/U)

The reference implements the same operators per case through healpy + qcinv
(A: hp.alm2map; A^T: map2alm * Npix/4pi, reference: utils.py:79-111; the
qcinv opfilt_tt/opfilt_pp forward ops, reference: ConstrainedRealization.py:40,
CenteredGibbs.py:281).  Here A/A^T are the exact-transpose SHT pair and
everything else is elementwise, so Q applies fuse into two SHTs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..harmonics.gridstate import (almxfl_state, ell_mask_state,
                                   expand_cl_state, nstate)
from ..sht.transform import SHT
from ..utils.pytree import register_arrays_pytree
from .noise import NoiseModel

__all__ = ["SkyModel", "with_cut_decomposition", "healpix_belt_rows"]


@dataclass(frozen=True)
class SkyModel:
    """Operators for one observed dataset (beam, noise, mask, SHT).

    spin = 0: nfields = 1 (T).  spin = 2: nfields = 2 (E, B alm; Q, U maps).
    spin = 3: joint TQU — nfields = 3, fields (T, E, B) <-> maps (T, Q, U),
    T through the spin-0 transform and (E, B) through spin-2 (the joint
    correlated-field mode the reference scaffolded; SURVEY.md 2.6.8).
    """

    sht: SHT
    noise: NoiseModel
    bl: jnp.ndarray            # (lmax+1,) beam window
    spin: int
    d: Optional[jnp.ndarray] = None   # observed maps (nfields, nr, nphi)

    # --- optional cut-sky complement decomposition (with_cut_decomposition):
    # on a quadrature grid with uniform unmasked noise, A^T diag(tau_bar q) A
    # = (tau_bar/omega) I exactly, so every masked pixel-diagonal operator is
    # an exact harmonic diagonal minus a correction supported on the masked
    # ("cut") rings only.  cut_sht transforms over just those rings.
    cut_sht: Optional[SHT] = None
    d_cut: Optional[jnp.ndarray] = None   # d on cut rows (nfields, ncut, nphi)
    w_cut: Optional[jnp.ndarray] = None   # q (tau_bar - tau) on cut rows >= 0
    cut_c0: Optional[jnp.ndarray] = None  # scalar: d^T N0^-1 d
    cut_c1: Optional[jnp.ndarray] = None  # (nfields, nstate): A^T N0^-1 d
    # static: w_cut is constant along phi on every cut ring (true for the
    # analytic galactic band cuts; enables the m-domain blocked-MH fast
    # path, samplers.nc_cls_sample_cut)
    cut_w_uniform: bool = False
    # static: w_cut identical across the map components (T/Q/U share one
    # mask — the production case); enables the table-domain reductions
    cut_w_equal_fields: bool = False
    # --- optional sparse-hole extension of the cut (floor + sparse split):
    # azimuthally non-uniform masks (apodized band + point-source holes,
    # the reference's actual production mask, config.py:22-28) split into
    # an azimuthally-uniform per-ring FLOOR (held in cut_sht/w_cut above,
    # so the m/table-domain fast paths stay eligible) plus a SPARSE
    # correction supported only on the hole pixels, applied through a
    # point-set transform (sht.points.PointSHT).
    sp_sht: Optional[object] = None       # PointSHT over the hole pixels
    d_sp: Optional[jnp.ndarray] = None    # d at holes (nfields, nr_sp, p)
    w_sp: Optional[jnp.ndarray] = None    # sparse weights >= 0 (0 on padding)

    @property
    def lmax(self) -> int:
        return self.sht.lmax

    @property
    def nfields(self) -> int:
        return {0: 1, 2: 2, 3: 3}[self.spin]

    @property
    def nstate(self) -> int:
        """State-vector length per field (grid packing, 2 (lmax+1)^2)."""
        return nstate(self.lmax)

    @property
    def map_ndim(self) -> int:
        """Pixel-array rank: 2 for (nrings, nphi) grids, 1 for HEALPix."""
        return getattr(self.sht, "map_ndim", 2)

    def _field(self, f: jnp.ndarray, i: int) -> jnp.ndarray:
        """Select field i from (..., nfields, *pix)."""
        return jnp.take(f, i, axis=f.ndim - self.map_ndim - 1)

    def _stack_fields(self, fields) -> jnp.ndarray:
        return jnp.stack(fields, axis=-(self.map_ndim + 1))

    def ell_mask(self, dtype=None) -> jnp.ndarray:
        """(nstate,) 1 on valid slots with l >= 2 (the monopole/dipole and
        the layout's invalid slots are projected out everywhere)."""
        dtype = dtype or self.sht.dtype
        return jnp.asarray(ell_mask_state(self.lmax, lmin=2), dtype=dtype)

    # ---- primitive operators -------------------------------------------

    def beam(self, s: jnp.ndarray) -> jnp.ndarray:
        """B s (diagonal per-ell, identical for every field)."""
        return almxfl_state(s, self.bl.astype(s.dtype), self.lmax)

    def synthesis(self, s: jnp.ndarray) -> jnp.ndarray:
        """A s: (..., nfields, nstate) -> (..., nfields, *pix)."""
        if self.spin == 0:
            return self._stack_fields([self.sht.synthesis_state(s[..., 0, :])])
        if self.spin == 3:
            t = self.sht.synthesis_state(s[..., 0, :])
            q, u = self.sht.synthesis_spin2_state(s[..., 1, :], s[..., 2, :])
            return self._stack_fields([t, q, u])
        q, u = self.sht.synthesis_spin2_state(s[..., 0, :], s[..., 1, :])
        return self._stack_fields([q, u])

    def adjoint_synthesis(self, f: jnp.ndarray) -> jnp.ndarray:
        """A^T f: (..., nfields, *pix) -> (..., nfields, nstate)."""
        if self.spin == 0:
            return self.sht.adjoint_synthesis_state(
                self._field(f, 0))[..., None, :]
        if self.spin == 3:
            t = self.sht.adjoint_synthesis_state(self._field(f, 0))
            e, b = self.sht.adjoint_synthesis_spin2_state(self._field(f, 1),
                                                          self._field(f, 2))
            return jnp.stack([t, e, b], axis=-2)
        e, b = self.sht.adjoint_synthesis_spin2_state(self._field(f, 0),
                                                      self._field(f, 1))
        return jnp.stack([e, b], axis=-2)

    def forward(self, s: jnp.ndarray) -> jnp.ndarray:
        """A B s — the noiseless sky seen by the instrument."""
        return self.synthesis(self.beam(s))

    def project_data(self, f: jnp.ndarray) -> jnp.ndarray:
        """B^T A^T f = B A^T f (B diagonal)."""
        return self.beam(self.adjoint_synthesis(f))

    # ---- composite operators -------------------------------------------

    def bt_ninv_d(self, d: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        """B A^T N^-1 d — the data-dependent term of the CR mean, precomputed
        once per dataset (reference precomputes it at init,
        CenteredGibbs.py:296-314)."""
        d = self.d if d is None else d
        return self.project_data(self.noise.inv_noise * d)

    def q_apply(self, s: jnp.ndarray, inv_cvar: jnp.ndarray) -> jnp.ndarray:
        """Q s = C^-1 s + B A^T N^-1 A B s.

        inv_cvar: (..., nfields, nstate) inverse prior variance per slot
        (zeros on l < 2 slots; those components are projected out)."""
        mask = self.ell_mask(s.dtype)
        s = s * mask
        out = inv_cvar * s + self.project_data(
            self.noise.inv_noise * self.forward(s))
        return out * mask

    # ---- cut-sky complement operators ------------------------------------

    @property
    def has_cut(self) -> bool:
        return self.cut_sht is not None

    def _synthesis_with(self, sht, s: jnp.ndarray) -> jnp.ndarray:
        """A s through an arbitrary transform (the full grid's or the cut
        subgrid's)."""
        if self.spin == 0:
            return sht.synthesis_state(s[..., 0, :])[..., None, :, :]
        if self.spin == 3:
            t = sht.synthesis_state(s[..., 0, :])
            q, u = sht.synthesis_spin2_state(s[..., 1, :], s[..., 2, :])
            return jnp.stack([t, q, u], axis=-3)
        q, u = sht.synthesis_spin2_state(s[..., 0, :], s[..., 1, :])
        return jnp.stack([q, u], axis=-3)

    def _adjoint_with(self, sht, f: jnp.ndarray) -> jnp.ndarray:
        if self.spin == 0:
            return sht.adjoint_synthesis_state(f[..., 0, :, :])[..., None, :]
        if self.spin == 3:
            t = sht.adjoint_synthesis_state(f[..., 0, :, :])
            e, b = sht.adjoint_synthesis_spin2_state(f[..., 1, :, :],
                                                     f[..., 2, :, :])
            return jnp.stack([t, e, b], axis=-2)
        e, b = sht.adjoint_synthesis_spin2_state(f[..., 0, :, :],
                                                 f[..., 1, :, :])
        return jnp.stack([e, b], axis=-2)

    @property
    def has_sparse(self) -> bool:
        return self.sp_sht is not None

    def synthesis_cut(self, s: jnp.ndarray) -> jnp.ndarray:
        """A s restricted to the cut rings (..., nfields, ncut, nphi)."""
        return self._synthesis_with(self.cut_sht, s)

    def adjoint_synthesis_cut(self, f_cut: jnp.ndarray) -> jnp.ndarray:
        """A_cut^T f (exact transpose of synthesis_cut)."""
        return self._adjoint_with(self.cut_sht, f_cut)

    def synthesis_sp(self, s: jnp.ndarray) -> jnp.ndarray:
        """A s evaluated at the sparse hole points
        (..., nfields, nr_sp, p)."""
        return self._synthesis_with(self.sp_sht, s)

    def adjoint_synthesis_sp(self, f_sp: jnp.ndarray) -> jnp.ndarray:
        """A_sp^T f (exact transpose of synthesis_sp)."""
        return self._adjoint_with(self.sp_sht, f_sp)

    def synthesis_cut_sp(self, s: jnp.ndarray):
        """(A_cut s, A_sp s) as ONE fused pair sharing the Legendre-stage
        grid prep.  Each SHT instance carries its own pack arrays as
        distinct runtime parameters, so XLA cannot CSE the ~GB grid
        expansions across the cut and point transforms by itself — this
        builds them once and feeds both Legendre stages.  Returns
        (cut_maps, point_values); point_values is None without the
        sparse split."""
        if not self.has_sparse:
            return self.synthesis_cut(s), None
        cut, sp = self.cut_sht, self.sp_sht
        if self.spin == 0:
            g0 = cut._state_grids(s[..., 0, :])
            return (cut.synthesis_from_grids(g0)[..., None, :, :],
                    sp.synthesis_from_grids(g0)[..., None, :, :])
        if self.spin == 2:
            ap, am = cut._spin2_stacks(s[..., 0, :], s[..., 1, :])
            qc, uc = cut._spin2_maps_from_F(*cut._spin2_F_stacks(ap, am))
            qs, us = sp._spin2_points_from_F(*sp._spin2_F_stacks(ap, am))
            return (jnp.stack([qc, uc], axis=-3),
                    jnp.stack([qs, us], axis=-3))
        g0 = cut._state_grids(s[..., 0, :])
        t_c = cut.synthesis_from_grids(g0)
        t_s = sp.synthesis_from_grids(g0)
        ap, am = cut._spin2_stacks(s[..., 1, :], s[..., 2, :])
        qc, uc = cut._spin2_maps_from_F(*cut._spin2_F_stacks(ap, am))
        qs, us = sp._spin2_points_from_F(*sp._spin2_F_stacks(ap, am))
        return (jnp.stack([t_c, qc, uc], axis=-3),
                jnp.stack([t_s, qs, us], axis=-3))

    def adjoint_cut_sp(self, f_cut: jnp.ndarray,
                       f_sp: Optional[jnp.ndarray]) -> jnp.ndarray:
        """A_cut^T f_cut + A_sp^T f_sp with the two contributions summed at
        alm-grid level and recombined/packed once (the fused-pair adjoint;
        exact transpose of :meth:`synthesis_cut_sp`)."""
        if f_sp is None or not self.has_sparse:
            return self.adjoint_synthesis_cut(f_cut)
        cut, sp = self.cut_sht, self.sp_sht
        if self.spin == 0:
            a2 = (cut._spin0_agrids(f_cut[..., 0, :, :])
                  + sp._spin0_agrids(f_sp[..., 0, :, :]))
            return cut._grids_to_state(a2)[..., None, :]

        def _eb(qc_, uc_, qs_, us_):
            g1 = cut._spin2_agrids(*cut._spin2_ring_coefs(qc_, uc_))
            g2 = sp._spin2_agrids(*sp._spin2_ring_coefs(qs_, us_))
            return cut._spin2_recombine(*[a + b for a, b in zip(g1, g2)])
        if self.spin == 2:
            e, b = _eb(f_cut[..., 0, :, :], f_cut[..., 1, :, :],
                       f_sp[..., 0, :, :], f_sp[..., 1, :, :])
            return jnp.stack([e, b], axis=-2)
        a2 = (cut._spin0_agrids(f_cut[..., 0, :, :])
              + sp._spin0_agrids(f_sp[..., 0, :, :]))
        t = cut._grids_to_state(a2)
        e, b = _eb(f_cut[..., 1, :, :], f_cut[..., 2, :, :],
                   f_sp[..., 1, :, :], f_sp[..., 2, :, :])
        return jnp.stack([t, e, b], axis=-2)

    def _w_corr(self, sb: jnp.ndarray) -> jnp.ndarray:
        """A_cut^T (w_cut A_cut u) [+ A_sp^T (w_sp A_sp u)] — the masked
        correction operator of the complement decomposition, floor rows
        plus (when present) the sparse hole points, as fused pairs."""
        if not self.has_sparse:
            return self.adjoint_synthesis_cut(
                self.w_cut * self.synthesis_cut(sb))
        au_cut, au_sp = self.synthesis_cut_sp(sb)
        return self.adjoint_cut_sp(self.w_cut * au_cut, self.w_sp * au_sp)

    def q_apply_cut(self, s: jnp.ndarray, inv_cvar: jnp.ndarray):
        """Exact masked Q apply via the complement decomposition:
        Q s = (C^-1 + tau_bar/omega b_l^2) s
              - B [A_cut^T (w_cut A_cut B s) + A_sp^T (w_sp A_sp B s)]
        — identical to q_apply on a quadrature grid, but the transforms run
        over the masked floor rings and hole points only, not the full
        sphere."""
        mask = self.ell_mask(s.dtype)
        s = s * mask
        sb = self.beam(s)
        corr = self.beam(self._w_corr(sb))
        diag = inv_cvar + self.harmonic_noise_diag().astype(s.dtype)
        return (diag * s - corr) * mask

    def _op_valid_mask(self, dtype) -> jnp.ndarray:
        """(nfields, nstate) mask of the slots the synthesis operator acts
        on: valid layout slots with l >= 0 for spin-0 fields and l >= 2 for
        spin-2 fields (spin-2 harmonics start at l = 2)."""
        lmins = {0: [0], 2: [2, 2], 3: [0, 2, 2]}[self.spin]
        return jnp.stack([
            jnp.asarray(ell_mask_state(self.lmax, lmin=lm), dtype=dtype)
            for lm in lmins])

    def qn_apply(self, s: jnp.ndarray) -> jnp.ndarray:
        """B A^T N^-1 A B s (the noise term of Q); cut-ring transforms when
        the complement decomposition is attached, full transforms otherwise."""
        if self.has_cut:
            # project onto the operator's valid subspace first: the
            # transforms annihilate the complement, so the diagonal term
            # must too (the quadrature identity holds on that subspace)
            s = s * self._op_valid_mask(s.dtype)
            sb = self.beam(s)
            corr = self.beam(self._w_corr(sb))
            return self.harmonic_noise_diag().astype(s.dtype) * s - corr
        return self.project_data(self.noise.inv_noise * self.forward(s))

    def cut_data_terms(self):
        """(c0, c1) of the complement likelihood identity
        -1/2 (d - A u)^T N0^-1 (d - A u) = -c0/2 + <c1, u> - tau_bar/(2 om)
        ||u||^2 with N0^-1 = tau_bar q (u = B-applied alm).  One full adjoint;
        precompute once per dataset."""
        tb = self.noise.field_bcast(self.noise.tau_max)
        n0 = tb * self.noise.q_map
        c0 = jnp.sum(n0 * self.d * self.d)
        c1 = self.adjoint_synthesis(n0 * self.d)
        return c0, c1

    def data_loglike_cut(self, u: jnp.ndarray,
                         au_cut: Optional[jnp.ndarray] = None,
                         au_sp: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        """-1/2 (d - A u)^T N^-1 (d - A u) via the complement identity;
        ``u`` is the beam-applied alm state; pass ``au_cut =
        synthesis_cut(u)`` (and ``au_sp = synthesis_sp(u)`` for sparse-split
        models) when already computed (shared with the gradient's
        correction term)."""
        u = u * self._op_valid_mask(u.dtype)
        if au_cut is None:
            au_cut = self.synthesis_cut(u)
        g = (self.noise.tau_max / self.noise.omega).astype(u.dtype)
        quad = jnp.sum(g[:, None] * u * u)
        cross = jnp.sum(self.cut_c1 * u)
        r_cut = self.d_cut - au_cut
        cut = jnp.sum(self.w_cut * r_cut * r_cut)
        out = -0.5 * self.cut_c0 + cross - 0.5 * quad + 0.5 * cut
        if self.has_sparse:
            if au_sp is None:
                au_sp = self.synthesis_sp(u)
            r_sp = self.d_sp - au_sp
            out = out + 0.5 * jnp.sum(self.w_sp * r_sp * r_sp)
        return out

    def harmonic_noise_diag(self) -> jnp.ndarray:
        """(nfields, nstate) exact diagonal of B A^T N^-1 A B when the mask
        is trivial (full sky): g_f * b_l^2 with g_f = tau_f / omega.  Used by
        the exact full-sky solves (reference: CenteredGibbs.py:108-132) and
        as the CG preconditioner / Langevin preconditioner on masked skies
        (with an f_sky correction).  Invalid layout slots carry 0."""
        bl2 = expand_cl_state(self.bl.astype(self.sht.dtype) ** 2, self.lmax)
        g = self.noise.tau_max / self.noise.omega
        return g[:, None] * bl2[None, :]


_CUT_TERMS_JIT = None


def _cut_terms_cached(model: SkyModel):
    """model.cut_data_terms() as ONE compiled unit (it contains a full
    adjoint synthesis; eager op-by-op dispatch of that is slow)."""
    global _CUT_TERMS_JIT
    import jax
    if _CUT_TERMS_JIT is None:
        _CUT_TERMS_JIT = jax.jit(lambda m: m.cut_data_terms())
    return _CUT_TERMS_JIT(model)


def with_cut_decomposition(model: SkyModel,
                           sparse_split: Optional[bool] = None) -> SkyModel:
    """Attach the cut-sky complement decomposition to a masked model.

    Requires per-field noise that is *uniform on unmasked pixels*
    (tau = tau_max wherever the mask is 1) — the reference's model exactly
    (N = sigma^2 I times a mask, ClsSampler.py:28-33).  The masked rings
    ("cut" rows: any pixel with tau < tau_max) get their own SHT; masked
    operators then cost one transform over ~(1 - f_sky) of the rings instead
    of the full sphere.

    ``sparse_split`` — the azimuthal-floor + sparse-hole split for masks
    that are NOT azimuthally uniform (apodized band + point-source holes,
    the reference's actual production mask, config.py:22-28):
    w = w_floor(theta) + w_sparse(theta, phi) with w_floor the per-ring
    azimuthal minimum.  The floor rides the uniform cut-ring SHT (so the
    m/table-domain blocked-MH engines stay eligible and the "cut" rows
    shrink back to the band) and the sparse remainder — supported only on
    the hole pixels — goes through a point-set transform (sht.PointSHT).
    None (default) = automatic: split when sparse pixels exist and cover
    at most GS_SPARSE_MAX_FRAC (default 0.15) of the sky.  True/False
    force it on/off.

    - On an iso-latitude quadrature grid (GL) the decomposition is EXACT:
      A^T diag(tau_bar q) A = (tau_bar/omega) I to machine precision.
    - On a HEALPix grid (the reference's production grid) the same identity
      holds only at the level the reference itself assumes everywhere
      (A^T A ~= Npix/(4 pi) I, the iter=0 map2alm algebra of its full-sky
      solves, aux conditionals and all_sph likelihoods; reference:
      config.py:72-73, CenteredGibbs.py:108-132,:676-729,
      NonCenteredGibbs.py:357-377).  The pieces supported on the masked
      pixels (the aux-field conditionals' gap operator, the cut residual
      terms, the rank-one MH correction's cut part) are exact on any grid;
      only the smooth full-sphere quadratic terms carry the HEALPix
      quadrature error (measured at the 1e-3..1e-2 relative level near
      lmax = 2 nside; tests/test_cut.py pins it).  With the sparse split,
      cap-ring holes are supported too (they join the point set); without
      it, masks must live on equatorial-belt rings (_healpix_cut)."""
    from ..sht.healpix import HealpixSHT

    if isinstance(model.sht, HealpixSHT):
        return _healpix_cut(model, sparse_split)
    return _quadrature_cut(model, sparse_split)


def _sparse_auto(n_sp: int, npix: int, sparse_split) -> bool:
    if sparse_split is not None:
        return bool(sparse_split) and n_sp > 0
    import os as _os
    frac = float(_os.environ.get("GS_SPARSE_MAX_FRAC", "0.15"))
    return 0 < n_sp <= frac * npix


def _attach_sparse(model, out, w_sp_flat, d_flat, ring_idx, theta, phi,
                   flat_idx, dt):
    """Build the PointSHT over the sparse pixels and gather w_sp / d_sp.
    w_sp_flat, d_flat: (nfields, npix_flat) host arrays."""
    import dataclasses as _dc
    from ..sht.points import PointSHT, group_points_by_ring

    theta_rows, phi_pad, valid, gidx = group_points_by_ring(
        ring_idx, theta, phi, flat_idx)
    sht = model.sht
    sp_sht = PointSHT(theta_rows, phi_pad, valid, sht.lmax, dtype=sht.dtype,
                      spin0=(model.spin != 2), spin2=(model.spin >= 2),
                      table_dtype=sht.table_dtype, m_block=sht.m_block)
    w_sp = w_sp_flat[:, gidx] * valid[None]
    d_sp = None if d_flat is None else \
        jnp.asarray(d_flat[:, gidx] * valid[None], dtype=dt)
    return _dc.replace(out, sp_sht=sp_sht,
                       w_sp=jnp.asarray(w_sp, dtype=dt), d_sp=d_sp)


def _quadrature_cut(model: SkyModel, sparse_split=None) -> SkyModel:
    import dataclasses as _dc
    from ..sht.grids import SphereGrid, subgrid_rows

    if model.map_ndim != 2 or not isinstance(model.sht.grid, SphereGrid):
        raise ValueError("cut decomposition needs an iso-latitude "
                         "quadrature grid (GL) or a HEALPix grid")
    noise = model.noise
    tau = np.asarray(noise.tau)                      # (nf, nr, nphi)
    q = np.asarray(noise.q_map)
    tau_bar = tau.reshape(tau.shape[0], -1).max(axis=1)
    w = q * (tau_bar[:, None, None] - tau)
    tol = 1e-12 * tau_bar.max()
    any_rows = np.where(np.any(w > tol, axis=(0, 2)))[0]
    if any_rows.size == 0:
        raise ValueError("model has no masked pixels; cut decomposition "
                         "is pointless on the full sky")
    sht = model.sht
    grid = sht.grid
    dt = sht.dtype

    # azimuthal floor + sparse remainder
    w_floor = w.min(axis=2)                          # (nf, nr)
    w_sp_full = np.maximum(w - w_floor[:, :, None], 0.0)
    w_sp_full[w_sp_full <= tol] = 0.0
    sp_pix = np.any(w_sp_full > 0.0, axis=0)         # (nr, nphi)
    n_sp = int(sp_pix.sum())
    split = _sparse_auto(n_sp, sp_pix.size, sparse_split)

    if split:
        rows = np.where(np.any(w_floor > tol, axis=0))[0]
        if rows.size == 0:
            # holes-only mask: keep ONE zero-weight floor row so the cut
            # transform (and every consumer of it) stays non-degenerate;
            # w_cut = 0 there makes it a mathematical no-op
            rows = any_rows[:1]
            w_floor = np.zeros_like(w_floor)
        w_cut_np = np.broadcast_to(w_floor[:, rows, None],
                                   (w.shape[0], rows.size, w.shape[2]))
    else:
        rows = any_rows
        w_cut_np = w[:, rows, :]

    cut_sht = SHT(subgrid_rows(sht.grid, rows), sht.lmax, dtype=sht.dtype,
                  spin2=(model.spin >= 2), fft_mode=sht.fft_mode,
                  table_dtype=sht.table_dtype, m_block=sht.m_block,
                  ring_split=False)
    out = _dc.replace(
        model,
        cut_sht=cut_sht,
        d_cut=(None if model.d is None
               # numpy slice on the host: no eager device gather to compile
               else jnp.asarray(np.asarray(model.d)[..., rows, :],
                                dtype=dt)),
        w_cut=jnp.asarray(w_cut_np, dtype=dt),
        cut_w_uniform=bool(np.allclose(w_cut_np, w_cut_np[:, :, :1],
                                       rtol=0, atol=0)),
        cut_w_equal_fields=bool(np.allclose(w_cut_np, w_cut_np[:1],
                                            rtol=0, atol=0)),
    )
    if split:
        rr, cc = np.nonzero(sp_pix)
        phi = grid.phi0[rr] + 2.0 * np.pi * cc / grid.nphi
        flat_idx = rr * grid.nphi + cc
        nf = w.shape[0]
        d_flat = (None if model.d is None
                  else np.asarray(model.d).reshape(model.nfields, -1))
        out = _attach_sparse(model, out, w_sp_full.reshape(nf, -1), d_flat,
                             rr, grid.theta[rr], phi, flat_idx, dt)
    if model.d is not None:
        c0, c1 = _cut_terms_cached(out)
        out = _dc.replace(out, cut_c0=c0, cut_c1=c1)
    return out


def healpix_belt_rows(sht, cols):
    """Map a set of flat pixel positions (in the sht's map layout) to the
    equatorial-belt rings containing them.  Returns (rows, idx): global ring
    indices and an (nrows, 4 nside) matrix of each ring's pixel positions in
    the layout.  Raises if any position lies on a cap ring (caps have
    varying ring lengths, so they cannot share the uniform-nphi cut
    transform)."""
    cols = np.asarray(cols)
    nb = 4 * sht.nside
    if getattr(sht, "layout", "ring") == "padded":
        belt_lo = sht._belt_off
        belt_hi = sht._belt_off + sht.nbelt * nb
        if (cols < belt_lo).any() or (cols >= belt_hi).any():
            raise ValueError("HEALPix cut decomposition supports masks on "
                             "equatorial-belt rings only (cap rings have "
                             "varying ring lengths); use the full-transform "
                             "paths for this mask")
        rows = np.unique((cols - belt_lo) // nb) + sht.ncap   # global rings
        idx = (belt_lo + (rows[:, None] - sht.ncap) * nb
               + np.arange(nb)[None, :])
    else:
        start = np.asarray(sht.geo.ring_start)
        ring_of = np.searchsorted(start, cols, side="right") - 1
        if (ring_of < sht.ncap).any() or \
                (ring_of >= sht.ncap + sht.nbelt).any():
            raise ValueError("HEALPix cut decomposition supports masks on "
                             "equatorial-belt rings only (cap rings have "
                             "varying ring lengths); use the full-transform "
                             "paths for this mask")
        rows = np.unique(ring_of)
        idx = start[rows][:, None] + np.arange(nb)[None, :]
    return rows, idx


def _healpix_cut(model: SkyModel, sparse_split=None) -> SkyModel:
    """HEALPix cut decomposition.  The azimuthally-uniform FLOOR of the
    mask must lie on equatorial-belt rings (the production galactic cut
    does; reference mask: config.py:22-28): belt rings share one uniform
    nphi = 4 nside and are iso-latitude, so the floor's cut transform is a
    plain :class:`~.transform.SHT` over those rings built with
    ``allow_aliasing=True`` (synthesis and its transpose are exact
    pointwise on any nphi; nphi = 2 lmax < 2 lmax + 2 here).

    With the sparse split, everything the floor does not cover — point
    -source holes at ANY latitude including cap rings, apodization
    azimuthal structure — goes to the point-set transform, closing the
    cap-ring gap of earlier rounds.  Without it (sparse_split=False or the
    sparse set too large), masked pixels off the belt rings are rejected —
    fall back to the full-transform paths for those masks."""
    import dataclasses as _dc
    from ..sht.grids import SphereGrid
    from ..sht.transform import SHT

    sht = model.sht
    geo = sht.geo
    noise = model.noise
    tau = np.asarray(noise.tau)                       # (nf, npix_layout)
    q = np.asarray(noise.q_map)
    tau_bar = tau.max(axis=1)
    w = q * (tau_bar[:, None] - tau)
    w = np.maximum(w, 0.0)
    tol = 1e-12 * tau_bar.max()
    cols = np.where(np.any(w > tol, axis=0))[0]
    if cols.size == 0:
        raise ValueError("model has no masked pixels; cut decomposition "
                         "is pointless on the full sky")
    nb = 4 * sht.nside
    nf = w.shape[0]
    ring_start = np.asarray(geo.ring_start)
    nphi_r = np.asarray(geo.nphi)

    # ring-order view of the weights (pix_of: RING pixel -> layout index)
    if getattr(sht, "layout", "ring") == "padded":
        pix_of = np.asarray(sht._pix_of)
    else:
        pix_of = np.arange(geo.npix)
    w_ring = w[:, pix_of]                              # (nf, npix) ring order
    ring_of = np.searchsorted(ring_start, np.arange(geo.npix),
                              side="right") - 1
    # per-ring azimuthal floor over BELT rings only (cap rings have varying
    # nphi and cannot join the uniform cut transform; their weight goes
    # entirely to the sparse set)
    belt_lo, belt_hi = sht.ncap, sht.ncap + sht.nbelt
    w_floor = np.zeros((nf, geo.nrings))
    for r in range(belt_lo, belt_hi):
        s = ring_start[r]
        w_floor[:, r] = w_ring[:, s: s + nb].min(axis=1)
    w_sp_ring = np.maximum(w_ring - w_floor[:, ring_of], 0.0)
    w_sp_ring[w_sp_ring <= tol] = 0.0
    sp_pix = np.any(w_sp_ring > 0.0, axis=0)
    n_sp = int(sp_pix.sum())
    split = _sparse_auto(n_sp, geo.npix, sparse_split)

    if split:
        rows = np.where(np.any(w_floor > tol, axis=0))[0]
        if rows.size == 0:
            rows = np.array([belt_lo + sht.nbelt // 2])
            w_floor = np.zeros_like(w_floor)
        idx = pix_of[ring_start[rows][:, None] + np.arange(nb)[None, :]]
        w_cut_np = np.broadcast_to(w_floor[:, rows, None],
                                   (nf, rows.size, nb))
    else:
        rows, idx = healpix_belt_rows(sht, cols)
        w_cut_np = w[:, idx]

    import hashlib
    tag = hashlib.sha1(rows.tobytes()).hexdigest()[:10]
    cut_grid = SphereGrid(
        name=f"hpbelt{sht.nside}_rows{rows.size}_{tag}",
        theta=np.asarray(geo.theta)[rows],
        # weights chosen so pixel_area = the uniform HEALPix pixel area
        # (only analysis would use them, and analysis is disabled under
        # allow_aliasing)
        weights=np.full(rows.size, geo.pixel_area * nb / (2.0 * np.pi)),
        nphi=nb,
        phi0=np.asarray(geo.phi0)[rows],
    )
    cut_sht = SHT(cut_grid, sht.lmax, dtype=sht.dtype,
                  spin2=(model.spin >= 2), fft_mode="matmul",
                  table_dtype=sht.table_dtype, m_block=sht.m_block,
                  ring_split=False, allow_aliasing=True)
    dt = sht.dtype
    out = _dc.replace(
        model,
        cut_sht=cut_sht,
        d_cut=(None if model.d is None
               else jnp.asarray(np.asarray(model.d)[..., idx], dtype=dt)),
        w_cut=jnp.asarray(w_cut_np, dtype=dt),
        cut_w_uniform=bool(np.allclose(w_cut_np, w_cut_np[:, :, :1],
                                       rtol=0, atol=0)),
        cut_w_equal_fields=bool(np.allclose(w_cut_np, w_cut_np[:1],
                                            rtol=0, atol=0)),
    )
    if split:
        rp = np.where(sp_pix)[0]                       # ring-order pixels
        r_of = ring_of[rp]
        j = rp - ring_start[r_of]
        phi = np.asarray(geo.phi0)[r_of] + 2.0 * np.pi * j / nphi_r[r_of]
        flat_idx = pix_of[rp]                          # layout indices
        # sparse weights in LAYOUT order for the gather
        w_sp_layout = np.zeros_like(w)
        w_sp_layout[:, pix_of] = w_sp_ring
        d_flat = None if model.d is None else np.asarray(model.d)
        out = _attach_sparse(model, out, w_sp_layout, d_flat,
                             r_of, np.asarray(geo.theta)[r_of], phi,
                             flat_idx, dt)
    if model.d is not None:
        c0, c1 = _cut_terms_cached(out)
        out = _dc.replace(out, cut_c0=c0, cut_c1=c1)
    return out


register_arrays_pytree(SkyModel,
                       array_fields=("sht", "noise", "bl", "d", "cut_sht",
                                     "d_cut", "w_cut", "cut_c0", "cut_c1",
                                     "sp_sht", "d_sp", "w_sp"),
                       static_fields=("spin", "cut_w_uniform",
                                      "cut_w_equal_fields"))
