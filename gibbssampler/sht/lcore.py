"""Shared Legendre-stage core for the GL and HEALPix transforms.

Both grids run the same latitude contraction — per-m associated-Legendre
matmuls between (m, l, ring) operator slabs and (…, m, l) alm grids — and
differ only in the azimuthal stage.  This core implements that contraction
once, with the two structural optimizations that set the stage's memory
traffic and flops (this is the framework's dominant kernel; reference
equivalent: healpy/libsharp's on-the-fly Legendre recurrences,
utils.py:89-104):

- **wedge m-blocking**: the tables are triangular (lambda_lm = 0 for
  l < m); splitting the m axis into blocks and contracting only l >= m0
  per block removes the zero quadrants with static slices (~37% fewer
  flops at m_block=128, lmax=512).
- **north/south ring-parity split**: lambda_lm(pi - theta) =
  (-1)^{l+m} lambda_lm(theta), so on an equator-symmetric grid each
  contraction runs over the north-half rings with the l axis split by
  parity — half the table bytes streamed and half the spin-0 flops.
  Spin-2 uses the half-sum / half-difference tables W = (lam+2 + lam-2)/2 and X = (lam+2 - lam-2)/2, which have
  *definite* reflection parity (lam+2 and lam-2 swap under reflection).

Subclasses must set: lmax, dtype, table_dtype, m_block, ring_split, nrh,
has_mid, par_sign, pack_in, pack_out.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils.precision import PRECISION

__all__ = ["LegendreCore", "grid_symmetric"]


def grid_symmetric(theta) -> bool:
    """True when ring r mirrors ring nrings-1-r about the equator; only
    theta symmetry matters — weights and phi0 enter per-ring stages that
    commute with the split."""
    th = np.asarray(theta)
    if th.shape[0] < 2:
        return False
    return bool(np.allclose(th + th[::-1], np.pi, rtol=0, atol=1e-12))


def _interleave_l(aE, aO, oe, n):
    """Merge even-l (offset ``oe``) and odd-l slabs back into a length-``n``
    l axis via pad + stack + reshape (no scatter)."""
    first, second = (aE, aO) if oe == 0 else (aO, aE)
    nf = first.shape[-1]
    if second.shape[-1] < nf:
        second = jnp.pad(
            second, [(0, 0)] * (second.ndim - 1) + [(0, nf - second.shape[-1])])
    out = jnp.stack([first, second], axis=-1)
    return out.reshape(out.shape[:-2] + (2 * nf,))[..., :n]


class LegendreCore:
    """Mixin holding the Legendre contraction and its table layout."""

    def _init_core(self, lmax, theta, dtype, table_dtype, m_block,
                   ring_split):
        from ..harmonics.gridstate import state_masks
        self.lmax = lmax
        self.dtype = jnp.dtype(dtype)
        self.table_dtype = (jnp.dtype(table_dtype) if table_dtype
                            else self.dtype)
        self.m_block = int(m_block)
        nr = np.asarray(theta).shape[0]
        self.ring_split = bool(ring_split) and grid_symmetric(theta)
        self.nrh = nr // 2
        self.has_mid = bool(nr % 2)
        self.par_sign = jnp.asarray((-1.0) ** np.arange(lmax + 1),
                                    dtype=self.dtype)
        sm = state_masks(lmax)
        self.pack_in = jnp.asarray(sm.in_scale, dtype=self.dtype)
        self.pack_out = jnp.asarray(sm.out_scale, dtype=self.dtype)

    # -- table layout -------------------------------------------------------

    def _msplit(self):
        """m-block ranges for the wedge-aware Legendre contraction."""
        L = self.lmax + 1
        blk = self.m_block
        if not blk or blk >= L:
            return [(0, L)]
        edges = list(range(0, L, blk)) + [L]
        return list(zip(edges[:-1], edges[1:]))

    def _block_table(self, tab):
        """Slice an (L, L, nr) fp64 table into per-m-block wedge slabs (on
        device, table dtype); a 1-tuple holding the dense table if m_block=0.

        With ring_split, each slab is stored as a (lamE, lamO, lamM) triple:
        even-l and odd-l wedge slabs over the *north-half* rings, plus the
        self-paired equator ring row when nrings is odd."""
        if not self.ring_split:
            return tuple(
                jnp.asarray(tab[m0:m1, m0:], dtype=self.table_dtype)
                for m0, m1 in self._msplit())
        nrh = self.nrh
        out = []
        for m0, m1 in self._msplit():
            slab = tab[m0:m1, m0:, :]
            oe = m0 % 2          # rel. l-index offset of even global l
            lamE = jnp.asarray(slab[:, oe::2, :nrh], dtype=self.table_dtype)
            lamO = jnp.asarray(slab[:, 1 - oe::2, :nrh],
                               dtype=self.table_dtype)
            lamM = (jnp.asarray(slab[:, :, nrh], dtype=self.dtype)
                    if self.has_mid else None)
            out.append((lamE, lamO, lamM))
        return tuple(out)

    def _build_spin2_tables(self, lp, lm_):
        """Store (lam_p2, lam_m2) dense or (lam_w, lam_x) parity-split."""
        self.lam_p2 = self.lam_m2 = self.lam_w = self.lam_x = None
        if self.ring_split:
            self.lam_w = self._block_table((lp + lm_) * 0.5)
            self.lam_x = self._block_table((lp - lm_) * 0.5)
        else:
            self.lam_p2 = self._block_table(lp)
            self.lam_m2 = self._block_table(lm_)

    # -- state <-> grid packing (free reshape + fused diagonal scale) --------

    def _state_grids(self, x):
        """Grid-packed state (..., nstate) -> scaled (..., 2, L, L) grids."""
        L = self.lmax + 1
        g = x.reshape(x.shape[:-1] + (2, L, L)).astype(self.dtype)
        return g * self.pack_in

    def _grids_to_state(self, g2):
        """Stacked (..., 2, L, L) true Re/Im grids -> grid-packed state."""
        L = self.lmax + 1
        out = g2 * self.pack_out
        return out.reshape(g2.shape[:-3] + (2 * L * L,))

    # -- contraction cores (re/im stacked so each table is read once) --------

    def _lsynth_stack(self, lam, g2, flip=False):
        """(..., c, L, L) grids -> F (..., c, nr, L), one table read.

        ``flip`` selects the opposite reflection parity (the spin-2 X
        table); only meaningful with ring_split."""
        if self.ring_split:
            return self._lsynth_stack_sym(lam, g2, flip)
        gt = g2.astype(self.table_dtype)
        outs = [
            jnp.einsum("mlr,...cml->...crm", blk, gt[..., m0:m1, m0:],
                       precision=PRECISION,
                       preferred_element_type=self.dtype)
            for (m0, m1), blk in zip(self._msplit(), lam)]
        F = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)
        return F.astype(self.dtype)

    def _lsynth_stack_sym(self, lam, g2, flip=False):
        """Ring-parity synthesis: per block, contract even-l and odd-l wedge
        slabs over north rings only; F_north = E + O and the mirrored
        F_south = +/-(-1)^m (E - O) by the reflection parity of the table."""
        gt = g2.astype(self.table_dtype)
        sgn = -self.par_sign if flip else self.par_sign
        Fn_parts, Fs_parts, mid_parts = [], [], []
        for (m0, m1), (lamE, lamO, lamM) in zip(self._msplit(), lam):
            gb = gt[..., m0:m1, m0:]
            oe = m0 % 2
            E = jnp.einsum("mlr,...cml->...crm", lamE, gb[..., oe::2],
                           precision=PRECISION,
                           preferred_element_type=self.dtype)
            O = jnp.einsum("mlr,...cml->...crm", lamO, gb[..., 1 - oe::2],
                           precision=PRECISION,
                           preferred_element_type=self.dtype)
            Fn_parts.append((E + O).astype(self.dtype))
            Fs_parts.append(((E - O) * sgn[m0:m1]).astype(self.dtype))
            if self.has_mid:
                mid_parts.append(
                    jnp.einsum("ml,...cml->...cm", lamM,
                               gb.astype(self.dtype),
                               precision=PRECISION,
                               preferred_element_type=self.dtype))
        cat = lambda ps, ax: ps[0] if len(ps) == 1 else jnp.concatenate(ps, ax)
        rows = [cat(Fn_parts, -1)]
        if self.has_mid:
            rows.append(cat(mid_parts, -1)[..., None, :])
        rows.append(cat(Fs_parts, -1)[..., ::-1, :])
        return jnp.concatenate(rows, axis=-2)

    def _lsynth_stack_binned(self, lam, g2, sel):
        """Segmented Legendre synthesis: (..., c, L, L) grids and a static
        (nb, L) 0/1 ell-selector -> (..., nb, c, nr, L) ring-Fourier
        coefficients of each selected ell-subset.  One 3-operand einsum per
        m-block (the l contraction picks up the selector), so all nb subsets
        are produced in one batched matmul instead of nb separate syntheses.
        Used by the rank-one blocked-MH fast path (cls_samplers).  Requires
        the dense (non-ring-split) table layout."""
        if self.ring_split:
            raise NotImplementedError(
                "binned synthesis requires ring_split=False tables")
        gt = g2.astype(self.table_dtype)
        selt = sel.astype(self.table_dtype)
        outs = [
            jnp.einsum("mlr,bl,...cml->...bcrm", blk, selt[:, m0:],
                       gt[..., m0:m1, m0:],
                       precision=PRECISION,
                       preferred_element_type=self.dtype)
            for (m0, m1), blk in zip(self._msplit(), lam)]
        F = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)
        return F.astype(self.dtype)

    def _lsel_F(self, lam, g2, j_idx, seg):
        """Per-bin Legendre synthesis without the dense one-hot ell
        contraction: j_idx (J,) static selected ells (disjoint bins), seg
        (J, nb) static 0/1 segment matrix (None when every bin is a single
        ell, i.e. j IS the bin axis).  Returns (..., nb, c, nr, L) ring
        Fourier coefficients.  Each selected ell costs one table *gather*
        plus an elementwise product — O(J/L) of the dense
        ``_lsynth_stack_binned`` einsum's flops."""
        if self.ring_split:
            raise NotImplementedError(
                "ell-selected synthesis requires ring_split=False tables")
        gt = g2.astype(self.table_dtype)
        j_idx = np.asarray(j_idx)
        outs = []
        for (m0, m1), blk in zip(self._msplit(), lam):
            jrel = j_idx - m0
            valid = jrel >= 0
            lamj = jnp.take(blk, jnp.asarray(np.where(valid, jrel, 0)),
                            axis=1)                      # (mb, J, r)
            if not valid.all():
                lamj = lamj * jnp.asarray(
                    valid.astype(np.float64), lamj.dtype)[None, :, None]
            gj = jnp.take(gt[..., m0:m1, :], jnp.asarray(j_idx),
                          axis=-1)                       # (..., c, mb, J)
            prod = gj[..., None] * lamj                  # (..., c, mb, J, r)
            if seg is None:
                # j == bin: (..., c, m, j, r) -> (..., j, c, r, m)
                Fb = jnp.moveaxis(jnp.moveaxis(prod, -2, -4), -1, -2)
                Fb = Fb.astype(self.dtype)
            else:
                Fb = jnp.einsum("...cmjr,jb->...bcrm", prod,
                                jnp.asarray(seg, self.table_dtype),
                                precision=PRECISION,
                                preferred_element_type=self.dtype
                                ).astype(self.dtype)
            outs.append(Fb)
        F = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)
        return F

    def _lsynth2(self, lam, re, im):
        """[re, im] (..., L, L) -> (Fre, Fim) (..., nr, L), one table read."""
        F = self._lsynth_stack(lam, jnp.stack([re, im], axis=-3))
        return F[..., 0, :, :], F[..., 1, :, :]

    def _ladj_stack(self, lam, g, flip=False):
        """(..., c, nr, L) ring grids -> (..., c, L, L) alm grids."""
        if self.ring_split:
            return self._ladj_stack_sym(lam, g, flip)
        gt = g.astype(self.table_dtype)
        outs = []
        for (m0, m1), blk in zip(self._msplit(), lam):
            a = jnp.einsum("mlr,...crm->...cml", blk, gt[..., m0:m1],
                           precision=PRECISION,
                           preferred_element_type=self.dtype)
            if m0:
                a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(m0, 0)])
            outs.append(a)
        a = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-2)
        return a.astype(self.dtype)

    def _ladj_stack_sym(self, lam, g, flip=False):
        """Transpose of _lsynth_stack_sym: fold the signed south-half rows
        into the north half, then contract the parity wedge slabs."""
        nrh = self.nrh
        sgn = -self.par_sign if flip else self.par_sign
        Gn = g[..., :nrh, :]
        Gs = g[..., g.shape[-2] - nrh:, :][..., ::-1, :] * sgn
        U = (Gn + Gs).astype(self.table_dtype)
        V = (Gn - Gs).astype(self.table_dtype)
        Gmid = g[..., nrh, :].astype(self.dtype) if self.has_mid else None
        outs = []
        for (m0, m1), (lamE, lamO, lamM) in zip(self._msplit(), lam):
            aE = jnp.einsum("mlr,...crm->...cml", lamE, U[..., m0:m1],
                            precision=PRECISION,
                            preferred_element_type=self.dtype)
            aO = jnp.einsum("mlr,...crm->...cml", lamO, V[..., m0:m1],
                            precision=PRECISION,
                            preferred_element_type=self.dtype)
            a = _interleave_l(aE.astype(self.dtype), aO.astype(self.dtype),
                              m0 % 2, self.lmax + 1 - m0)
            if self.has_mid:
                a = a + lamM * Gmid[..., m0:m1, None]
            if m0:
                a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(m0, 0)])
            outs.append(a)
        a = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-2)
        return a.astype(self.dtype)

    def _ladj2(self, lam, Gre, Gim):
        """(Gre, Gim) (..., nr, L) -> (are, aim) (..., L, L) grids."""
        a = self._ladj_stack(lam, jnp.stack([Gre, Gim], axis=-3))
        return a[..., 0, :, :], a[..., 1, :, :]

    # -- spin-2 Legendre stages (shared between grids) ------------------------

    def _spin2_stacks(self, e_state, b_state):
        """(ap, am) Legendre-stage input stacks of a+ = -(E + iB),
        a- = -(E - iB) — the (dense-table) grid prep of :meth:`_spin2_F`,
        exposed so a cut transform and a sparse point transform over the
        SAME state can share it (each SHT instance carries its own pack
        arrays as distinct runtime parameters, so XLA cannot CSE the
        ~GB-scale grid expansions across instances by itself)."""
        if self.ring_split:
            raise NotImplementedError("stack sharing needs dense tables")
        eg = self._state_grids(e_state)
        bg = self._state_grids(b_state)
        ere, eim = eg[..., 0, :, :], eg[..., 1, :, :]
        bre, bim = bg[..., 0, :, :], bg[..., 1, :, :]
        ap = jnp.stack([-(ere - bim), -(eim + bre)], axis=-3)
        am = jnp.stack([-(ere + bim), -(eim - bre)], axis=-3)
        return ap, am

    def _spin2_F_stacks(self, ap, am):
        """(ap, am) stacks -> (Fp_re, Fp_im, Fm_re, Fm_im) through this
        instance's dense spin-2 tables."""
        Fp = self._lsynth_stack(self.lam_p2, ap)
        Fm = self._lsynth_stack(self.lam_m2, am)
        return (Fp[..., 0, :, :], Fp[..., 1, :, :],
                Fm[..., 0, :, :], Fm[..., 1, :, :])

    def _spin2_agrids(self, Cp_re, Cp_im, Cm_re, Cm_im):
        """Ring coefficients -> (ap_re, ap_im, am_re, am_im) alm grids
        (the dense-path Legendre adjoint of :meth:`_spin2_alm`, before the
        E/B recombination — exposed so two transforms' contributions can
        be SUMMED at grid level and recombined once)."""
        ap_re, ap_im = self._ladj2(self.lam_p2, Cp_re, Cp_im)
        am_re, am_im = self._ladj2(self.lam_m2, Cm_re, -Cm_im)
        return ap_re, ap_im, am_re, am_im

    def _spin2_recombine(self, ap_re, ap_im, am_re, am_im):
        """(a+, a-) grids -> (E, B) grid-packed states."""
        e_re, e_im = -0.5 * (ap_re + am_re), -0.5 * (ap_im + am_im)
        b_re, b_im = -0.5 * (ap_im - am_im), 0.5 * (ap_re - am_re)
        return (self._grids_to_state(jnp.stack([e_re, e_im], axis=-3)),
                self._grids_to_state(jnp.stack([b_re, b_im], axis=-3)))

    def _spin2_F(self, e_state, b_state):
        """(E, B) grid-packed states -> (Fp_re, Fp_im, Fm_re, Fm_im) ring
        Fourier coefficients of a+ = -(E + iB) through lam+2 and
        a- = -(E - iB) through lam-2."""
        eg = self._state_grids(e_state)
        bg = self._state_grids(b_state)
        ere, eim = eg[..., 0, :, :], eg[..., 1, :, :]
        bre, bim = bg[..., 0, :, :], bg[..., 1, :, :]
        if self.ring_split:
            # lam_p2 = W + X, lam_m2 = W - X: two definite-parity half-ring
            # contractions over the [Ere, Eim, Bre, Bim] stack, then cheap
            # elementwise recombination into F+/F-
            stack = jnp.stack([ere, eim, bre, bim], axis=-3)
            FW = self._lsynth_stack(self.lam_w, stack)
            FX = self._lsynth_stack(self.lam_x, stack, flip=True)
            we, wei, wbr, wbi = (FW[..., i, :, :] for i in range(4))
            xe, xei, xbr, xbi = (FX[..., i, :, :] for i in range(4))
            Fp_re = -(we + xe) + (wbi + xbi)
            Fp_im = -(wei + xei) - (wbr + xbr)
            Fm_re = -(we - xe) - (wbi - xbi)
            Fm_im = -(wei - xei) + (wbr - xbr)
        else:
            ap_re, ap_im = -(ere - bim), -(eim + bre)
            am_re, am_im = -(ere + bim), -(eim - bre)
            Fp_re, Fp_im = self._lsynth2(self.lam_p2, ap_re, ap_im)
            Fm_re, Fm_im = self._lsynth2(self.lam_m2, am_re, am_im)
        return Fp_re, Fp_im, Fm_re, Fm_im

    def _spin2_alm(self, Cp_re, Cp_im, Cm_re, Cm_im):
        """Ring Fourier coefficients C+ = sum (Q+iU) e^{-im phi},
        C- = sum (Q+iU) e^{+im phi} -> (E, B) grid-packed states
        (the transpose of _spin2_F composed with the E/B recombination)."""
        if self.ring_split:
            U1 = Cp_re + Cm_re
            D1 = Cp_re - Cm_re
            U2 = Cp_im - Cm_im
            D2 = Cp_im + Cm_im
            stack = jnp.stack([U1, U2, D1, D2], axis=-3)
            AW = self._ladj_stack(self.lam_w, stack)
            AX = self._ladj_stack(self.lam_x, stack, flip=True)
            e_re = -0.5 * (AW[..., 0, :, :] + AX[..., 2, :, :])
            e_im = -0.5 * (AW[..., 1, :, :] + AX[..., 3, :, :])
            b_re = -0.5 * (AW[..., 3, :, :] + AX[..., 1, :, :])
            b_im = 0.5 * (AW[..., 2, :, :] + AX[..., 0, :, :])
        else:
            ap_re, ap_im = self._ladj2(self.lam_p2, Cp_re, Cp_im)
            am_re, am_im = self._ladj2(self.lam_m2, Cm_re, -Cm_im)
            # E = -(a+ + a-)/2,  B = i (a+ - a-)/2
            e_re, e_im = -0.5 * (ap_re + am_re), -0.5 * (ap_im + am_im)
            b_re, b_im = -0.5 * (ap_im - am_im), 0.5 * (ap_re - am_re)
        return (self._grids_to_state(jnp.stack([e_re, e_im], axis=-3)),
                self._grids_to_state(jnp.stack([b_re, b_im], axis=-3)))
