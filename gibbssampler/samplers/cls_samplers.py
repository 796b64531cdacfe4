"""Power-spectrum (C_ell / D_ell) conditional samplers.

The reference's portfolio (SURVEY.md 2.4), pure and jittable:

- binned conjugate inverse-gamma draw (centered parametrization;
  reference: CenteredGibbs.py:24-48 TT, :54-93 EE/BB)
- blocked Metropolis-within-Gibbs with truncated-normal proposals on the
  non-centered (whitened) parametrization (reference: ClsSampler.py:45-125,
  NonCenteredGibbs.py:205-248 TT, :252-445 pol), with both the pixel-space
  and the harmonic-only ("all_sph") likelihood paths
  (reference: NonCenteredGibbs.py:333-377)
- per-ell k x k inverse-Wishart draw for joint correlated fields
  (TT/TE/EE...; the reference only ever scaffolded this — invwishart import
  CenteredGibbs.py:7 and the 3x3 Cython kernel variance_expension.pyx:36-61)

All spectra are sampled as binned D_ell (conversion GibbsSampler.py:54;
binning utils.py:150-162); whiten/recenter transforms for ASIS included
(reference: ASIS.py:109-120).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..harmonics.gridstate import (alm2cl_state, almxfl_state,
                                   expand_cl_state,
                                   variance_expansion_state)
from ..harmonics.spectra import bin_sum, unfold_bins
from ..ops.model import SkyModel
from ..utils.precision import PRECISION

__all__ = [
    "invgamma_dl", "centered_cls_sample",
    "propose_truncnorm", "truncnorm_logratio", "nc_cls_sample",
    "invwishart_cls_sample",
    "whiten", "recenter",
]


# ---------------------------------------------------------------------------
# Centered conjugate inverse-gamma step
# ---------------------------------------------------------------------------

def invgamma_dl(key, s_flat: jnp.ndarray, bins: np.ndarray, lmax: int):
    """Binned conjugate draw for one field.

    beta_bin = sum_l (2l+1) l(l+1) hat-C_l / (4 pi),
    alpha_bin = sum_l (2l+1)/2 - 1,  D_bin = beta_bin / Gamma(alpha_bin)
    (reference: CenteredGibbs.py:24-48; alpha of a degenerate first bin is
    clamped to 1 as in the reference's alpha_bin0 := 1)."""
    dt = s_flat.dtype
    cl_hat = alm2cl_state(s_flat, lmax)
    ell = jnp.arange(lmax + 1, dtype=dt)
    beta_l = (2.0 * ell + 1.0) * ell * (ell + 1.0) * cl_hat / (4.0 * jnp.pi)
    beta = bin_sum(beta_l, bins, lmax)
    counts = bin_sum(2.0 * ell + 1.0, bins, lmax)
    alpha = counts / 2.0 - 1.0
    alpha = jnp.where(alpha <= 0, 1.0, alpha)
    g = jax.random.gamma(key, alpha.astype(dt))
    return beta / g


def centered_cls_sample(key, s: jnp.ndarray, bins_list: Sequence[np.ndarray],
                        lmax: int):
    """Independent binned inverse-gamma draws per field (EE then BB in the
    reference, CenteredGibbs.py:81-93).  s: (nfields, nflat).
    Returns tuple of per-field (nbins_f,) binned D_ell."""
    keys = jax.random.split(key, len(bins_list))
    return tuple(
        invgamma_dl(k, s[f], bins, lmax)
        for f, (k, bins) in enumerate(zip(keys, bins_list))
    )


# ---------------------------------------------------------------------------
# Non-centered blocked Metropolis-within-Gibbs
# ---------------------------------------------------------------------------

def propose_truncnorm(key, x, sigma):
    """x' ~ N(x, sigma^2) truncated to [0, inf) (reference:
    ClsSampler.py:79-92)."""
    lower = -x / sigma
    z = jax.random.truncated_normal(key, lower, jnp.full_like(lower, jnp.inf),
                                    dtype=x.dtype)
    return x + sigma * z


def truncnorm_logratio(x_old, x_new, sigma):
    """log q(old | new) - log q(new | old) for the truncated-normal kernel:
    only the truncation normalizers survive (reference computes both
    truncnorm logpdfs, ClsSampler.py:112-125)."""
    return (jax.scipy.special.log_ndtr(x_old / sigma)
            - jax.scipy.special.log_ndtr(x_new / sigma))


def _dl_tuple_to_var(dl_tuple, bins_list, lmax, nstate_, dtype):
    """Per-field binned D_ell -> (nfields, nstate) prior variance —
    a broadcast over the grid-packed layout, no gather."""
    vars_ = [
        variance_expansion_state(unfold_bins(dl.astype(dtype), bins, lmax),
                                 lmax)
        for dl, bins in zip(dl_tuple, bins_list)
    ]
    return jnp.stack(vars_, axis=0)


def make_nc_log_likelihood(model: SkyModel, bins_list, all_sph: bool,
                           d_alm: jnp.ndarray | None = None):
    """Returns log L(dl_tuple; s_nc) for the non-centered parametrization.

    pixel path  : -1/2 sum_pix N^-1 (d - A B C^{1/2} s_nc)^2  — one synthesis
                  per evaluation (reference: NonCenteredGibbs.py:333-355)
    complement  : the same masked likelihood through the cut-sky identity
                  (exact on a quadrature grid; SkyModel.data_loglike_cut) —
                  transforms run over the masked rings only.  Selected
                  automatically when the model carries the cut decomposition.
    all_sph path: the same likelihood evaluated fully in harmonic space,
                  valid on the full sky where the analysis-basis noise is
                  white: -g/2 sum (d_alm - b_l C^{1/2} s_nc)^2
                  (reference: NonCenteredGibbs.py:357-377)
    """
    lmax = model.lmax

    if all_sph:
        if d_alm is None:
            raise ValueError("all_sph likelihood needs precomputed d_alm")
        g = model.noise.harmonic_white_level()  # (nfields,)

        def log_like(dl_tuple, s_nc):
            var = _dl_tuple_to_var(dl_tuple, bins_list, lmax, model.nstate,
                                   s_nc.dtype)
            s = jnp.sqrt(var) * s_nc
            resid = d_alm - model.beam(s)
            return -0.5 * jnp.sum(g[:, None] * resid * resid)
    elif model.has_cut:

        def log_like(dl_tuple, s_nc):
            var = _dl_tuple_to_var(dl_tuple, bins_list, lmax, model.nstate,
                                   s_nc.dtype)
            u = model.beam(jnp.sqrt(var) * s_nc)
            return model.data_loglike_cut(u)
    else:

        def log_like(dl_tuple, s_nc):
            var = _dl_tuple_to_var(dl_tuple, bins_list, lmax, model.nstate,
                                   s_nc.dtype)
            s = jnp.sqrt(var) * s_nc
            resid = model.d - model.forward(s)
            return -0.5 * jnp.sum(model.noise.inv_noise * resid * resid)

    return log_like


class NCClsInfo(NamedTuple):
    accept: tuple      # per-field (nblocks_f,) acceptance indicator means
    log_like: jnp.ndarray


def nc_cls_sample(key, dl_tuple, s_nc, log_like_fn, bins_list, blocks_list,
                  prop_sigma_list, n_iter: int = 1):
    """Blocked MH sweep(s) over binned D_ell given the whitened map s_nc.

    blocks_list[f] : list of (start, stop) bin-index ranges for field f
                     (static; the reference's ell-blocks, config.py:51-55)
    prop_sigma_list[f] : (nbins_f,) proposal std devs
    n_iter : MH sweeps per call (reference n_iter_metropolis)

    Per sweep: propose every bin once (truncated normal), then accept/reject
    block-by-block, field-by-field, each decision using one likelihood
    evaluation (reference: NonCenteredGibbs.py:401-445).

    Compiled as a ``lax.scan`` over a static (nblocks, nbins_total) one-hot
    block table (sweeps are a second scan level), so compile size is one
    block body regardless of n_iter x nblocks — the reference's production
    configuration has tens of blocks and many sweeps (config.py:51-55,65-68)
    and an unrolled trace would not fit a remote-compile budget."""
    nfields = len(dl_tuple)
    dt = dl_tuple[0].dtype
    sizes = [int(d.shape[-1]) for d in dl_tuple]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    ntot = int(offs[-1])
    rows = []
    for f, blocks in enumerate(blocks_list):
        for (lo, hi) in blocks:
            r = np.zeros(ntot)
            r[offs[f] + lo: offs[f] + hi] = 1.0
            rows.append(r)
    bmask = jnp.asarray(np.stack(rows), dtype=dt)      # (nblocks, ntot)
    nblocks = bmask.shape[0]
    sigma = jnp.concatenate([jnp.broadcast_to(jnp.asarray(p, dt), (n,))
                             for p, n in zip(prop_sigma_list, sizes)])

    def split_fields(dvec):
        return tuple(dvec[..., offs[f]: offs[f + 1]] for f in range(nfields))

    dl0 = jnp.concatenate([d.astype(dt) for d in dl_tuple], axis=-1)
    ll0 = log_like_fn(dl_tuple, s_nc)

    def sweep(carry, k):
        dl, ll = carry
        kp, ka = jax.random.split(k)
        # propose every bin once from the sweep-start value; each bin belongs
        # to exactly one block, so the per-block proposal correction depends
        # only on the sweep-start dl (bins of block b are untouched until
        # block b's own accept decision)
        props = propose_truncnorm(kp, dl, sigma)
        lr_vec = truncnorm_logratio(dl, props, sigma)
        akeys = jax.random.split(ka, nblocks)

        def block_step(c, xs):
            dl_c, ll_c = c
            mask_b, kb = xs
            cand = jnp.where(mask_b > 0, props, dl_c)
            ll_cand = log_like_fn(split_fields(cand), s_nc)
            qcorr = jnp.sum(mask_b * lr_vec)
            acc = (jnp.log(jax.random.uniform(kb, dtype=dt))
                   < ll_cand - ll_c + qcorr)
            dl_c = jnp.where(acc, cand, dl_c)
            ll_c = jnp.where(acc, ll_cand, ll_c)
            return (dl_c, ll_c), acc.astype(dt)

        (dl, ll), accs = jax.lax.scan(block_step, (dl, ll), (bmask, akeys))
        return (dl, ll), accs

    (dlf, ll), accs = jax.lax.scan(sweep, (dl0, ll0),
                                   jax.random.split(key, n_iter))
    acc_mean = jnp.mean(accs, axis=0)                  # (nblocks,)
    out_acc, i0 = [], 0
    for f, blocks in enumerate(blocks_list):
        out_acc.append(acc_mean[i0: i0 + len(blocks)])
        i0 += len(blocks)
    return split_fields(dlf), NCClsInfo(accept=tuple(out_acc), log_like=ll)


def _per_ell(y, lmax):
    """(..., nstate) -> (..., L) sums over the (part, m) axes."""
    L = lmax + 1
    return y.reshape(y.shape[:-1] + (2, L, L)).sum(axis=(-3, -2))


def _mdomain_eligible(model) -> bool:
    """Static eligibility of the m-domain singles sweep: azimuthally
    uniform cut weights (cut_w_uniform), dense (non-ring-split) cut tables,
    and a cut-ring nphi >= 2 lmax so the ring Parseval identity is exact
    (GL: nphi = 2 lmax + 2; HEALPix belt rows: nphi = 4 nside = 2 lmax,
    exact through the Nyquist-column weights)."""
    cut = model.cut_sht
    return (getattr(model, "cut_w_uniform", False)
            and cut is not None
            and not getattr(cut, "ring_split", False)
            and getattr(cut, "nphi", 0) >= 2 * model.lmax)


import os as _os

# chunk_size bounds the live coefficient memory: each chunk keeps
# ~4 * chunk * ncut * (lmax+1) floats per chain alive (XLA overlaps
# neighboring chunks' lifetimes, so large chunks run out of memory at high
# chain counts).  16 was sized for a 16 GB device; the best chunk on the
# GPU's 80 GB is not measured.
_MDOMAIN_CHUNK = int(_os.environ.get("GS_MDOMAIN_CHUNK", "16"))
# unroll factor of the scalar singles scan (tuning knob; >1 trades compile
# time/register pressure for fewer sequential kernel launches)
_MDOMAIN_UNROLL = int(_os.environ.get("GS_MDOMAIN_UNROLL", "1"))
# phi-domain singles chunk: bounds the live per-bin map-stack memory of the
# general-mask (azimuthally non-uniform w) fallback engine — the full
# (nsingles, nmaps, ncut, nphi) stack OOMs 128 chains at production scale;
# chunks of ~16 bins keep peak memory O(chunk * ncut * nphi) per chain.
# The bound nchains * chunk * nmaps * ncut * nphi * 4 B <~ 2 GB per buffer
# is a limit of the device this was first tuned on; whether the GPU needs
# any such per-buffer bound is not measured.
_PHI_CHUNK = int(_os.environ.get("GS_PHI_CHUNK", "16"))


def _prepare_mchunks(singles, single_rows, bins_list,
                     chunk_size: int | None = None):
    """Static chunking of the single-bin blocks for the m-domain sweep:
    field-pure chunks of at most chunk_size bins AND at most chunk_size
    selected ells (wide bins count by their ell width, so the live-memory
    bound GS_MDOMAIN_CHUNK documents really holds), each described by
    (field, j_idx, seg, gbins, rows) with j_idx the chunk's selected ells,
    seg the (J, nb) segment matrix (None when all bins are single ells)."""
    if chunk_size is None:
        chunk_size = _MDOMAIN_CHUNK
    groups = []
    cur = None
    for (f, lo, gi), row in zip(singles, single_rows):
        bins_f = np.asarray(bins_list[f])
        js = list(range(int(bins_f[lo]), int(bins_f[lo + 1])))
        if cur is None or cur["f"] != f or len(cur["gbins"]) >= chunk_size \
                or len(cur["j"]) >= chunk_size:
            cur = {"f": f, "j": [], "wid": [], "gbins": [], "rows": []}
            groups.append(cur)
        cur["j"].extend(js)
        cur["wid"].append(len(js))
        cur["gbins"].append(gi)
        cur["rows"].append(row)
    out = []
    for c in groups:
        j_idx = np.asarray(c["j"], dtype=np.int64)
        nb = len(c["gbins"])
        if all(w == 1 for w in c["wid"]):
            seg = None
        else:
            seg = np.zeros((len(j_idx), nb))
            k = 0
            for b, w in enumerate(c["wid"]):
                seg[k: k + w, b] = 1.0
                k += w
        out.append((c["f"], j_idx, seg,
                    np.asarray(c["gbins"]), np.asarray(c["rows"])))
    return out


def _prepare_mgrids(model, t, mchunks):
    """Hoist the per-field ``_state_grids`` expansions out of the chunk
    loop: each field's grid costs ~state-sized memory traffic to build, and
    the chunks only gather thin ell slices from it.  Returns
    {field: ("s0"|"s2", grid, sign_p, sign_m)}."""
    cut = model.cut_sht
    grids = {}
    for f in sorted({f for (f, *_r) in mchunks}):
        if model.spin == 0 or (model.spin == 3 and f == 0):
            grids[f] = ("s0", cut._state_grids(t[0]), 1.0, 1.0)
        else:
            which = "e" if (f == 0 if model.spin == 2 else f == 1) else "b"
            fi = f
            g, sp, sm = cut.lsel_grid_spin2_single(t[fi], which)
            grids[f] = ("s2", g, sp, sm)
    return grids


def _chunk_comps(model, f):
    """Static map-component indices a field occupies in the map axis."""
    if model.spin == 0 or (model.spin == 3 and f == 0):
        return (0,)
    return (0, 1) if model.spin == 2 else (1, 2)


def _prepare_tchunks(model, cut, mchunks, w1, dt, nyq: bool = False):
    """Per-chunk ell-pair weight tables of the TABLE-DOMAIN reductions
    (the fastest blocked-MH singles engine; requires one shared mask
    across map components and azimuthally uniform cut weights).

    The w-weighted dot product of two per-bin components factorizes
    through the ring Parseval identity into ell-pair tables contracted
    against per-(m, ell) state products: every Fp x Fm cross term cancels
    in Q.Q' + U.U' structurally (A = Fp + Fm, B = Fp - Fm combinations),
    leaving

        <a_i, a_j>_w = nphi sum_m C_ij(m) [Wpp + pos_m Wmm](m, li, lj)
        W__(m, l, l') = sum_r w_r lam_(m,l,r) lam_(m,l',r)

    with C_ij(m) = sum_c g[c,m,li] g[c,m,lj] — so no per-bin (ring, m)
    planes are ever materialized (the coefficient-domain engine's cost).
    Ring phases rotate the (re, im) coefficient pairs jointly and the
    like-component pairing is rotation-invariant, so the tables hold on
    PHASED grids too (HEALPix belt rows); only the raw-ring-sum pairings
    (rho, residual updates, handled in the sweep) need rotation factors.

    ``nyq``: the grid sits exactly at nphi = 2 lmax, where the m = lmax
    column carries (pw_cos, pw_sin) = (nphi, 0) and the uniform-weight
    pairing above is wrong.  The column is ZEROED out of the tables here
    and its exact contribution is added by a dedicated per-chunk path in
    the sweep; each tuple then carries the raw Nyquist lambda column(s)."""
    n = float(cut.nphi)
    L = model.lmax + 1
    pos = np.ones(L)
    pos[0] = 0.0
    out = []
    for (f, j_idx, seg, gbins, rows) in mchunks:
        if model.spin == 0 or (model.spin == 3 and f == 0):
            lam0_j = cut.lsel_table(cut.lam0, j_idx)      # (L, J, r)
            lnyq = None
            if nyq:
                lnyq = lam0_j[L - 1]                       # (J, r)
                lam0_j = lam0_j.at[L - 1].set(0.0)
            lw = lam0_j * w1.astype(lam0_j.dtype)
            W00 = jnp.einsum("mjr,mkr->mjk", lw, lam0_j,
                             precision=PRECISION,
                             preferred_element_type=dt).astype(dt)
            omega = np.full((2, L), 2.0 * n)
            omega[0, 0] = n
            omega[1, 0] = 0.0
            out.append(("s0", lam0_j, None, W00, jnp.asarray(omega, dt),
                        lnyq))
        else:
            lamp_j = cut.lsel_table(cut.lam_p2, j_idx)
            lamm_j = cut.lsel_table(cut.lam_m2, j_idx)
            lnyq = None
            if nyq:
                lnyq = (lamp_j[L - 1], lamm_j[L - 1])
                lamp_j = lamp_j.at[L - 1].set(0.0)
                lamm_j = lamm_j.at[L - 1].set(0.0)
            lpw = lamp_j * w1.astype(lamp_j.dtype)
            lmw = lamm_j * w1.astype(lamm_j.dtype)
            Wpp = jnp.einsum("mjr,mkr->mjk", lpw, lamp_j,
                             precision=PRECISION,
                             preferred_element_type=dt).astype(dt)
            Wmm = jnp.einsum("mjr,mkr->mjk", lmw, lamm_j,
                             precision=PRECISION,
                             preferred_element_type=dt).astype(dt)
            Wsum = n * (Wpp + jnp.asarray(pos, dt)[:, None, None] * Wmm)
            out.append(("s2", lamp_j, lamm_j, Wsum, None, lnyq))
    return out


def _chunk_ring_coefs(model, mgrids, f, j_idx, seg):
    """Ring half-spectrum coefficients of the chunk's per-bin components
    A t_i on the cut rings: (Cc, Cs) each (..., nb, ncomp, nr, L) plus the
    static map-component indices they occupy in the model's map axis.
    Consumes the hoisted per-field grids from :func:`_prepare_mgrids`."""
    cut = model.cut_sht
    kind, g, sp, sm = mgrids[f]
    if kind == "s0":
        Cc, Cs = cut.ring_cs_lsel_spin0_grids(g, j_idx, seg)
        return Cc[..., None, :, :], Cs[..., None, :, :], (0,)
    (qc, qs), (uc, us) = cut.ring_cs_lsel_spin2_grids(g, sp, sm, j_idx, seg)
    comps = (0, 1) if model.spin == 2 else (1, 2)
    return (jnp.stack([qc, uc], axis=-3),
            jnp.stack([qs, us], axis=-3), comps)


def nc_cls_sample_cut(key, dl_tuple, s_nc, model, bins_list, blocks_list,
                      prop_sigma_list, n_iter: int = 1, mdomain="auto",
                      l_cut_identity: int | None = None):
    """Rank-one fast path of :func:`nc_cls_sample` for cut-decomposition
    models — same Markov kernel, same random stream, scalar-cost blocks.

    The whitened likelihood is quadratic in u(dl) = B sqrt(var(dl)) s_nc and
    u is *linear in the per-bin sqrt(D_i)* with mutually orthogonal per-bin
    components t_i (disjoint ell supports):

        u = sum_i sqrt(D_i) t_i,   t_i = B sqrt(2 pi / l(l+1)) s_nc|_{bin i}

    so a single-bin block's candidate changes u by gamma t_i
    (gamma = sqrt(D') - sqrt(D)) and, through the complement identity
    (SkyModel.data_loglike_cut), its log-likelihood change is

        dll = gamma (alpha_i - sqrt(D_i) beta_i - <w r, A t_i>)
              + gamma^2 (q_i - beta_i) / 2

    with alpha_i = <c1, t_i>, beta_i = g ||t_i||^2, q_i = ||sqrt(w) A t_i||^2
    precomputed once per call (A t_i for every single bin comes from ONE
    batched ell-selected cut synthesis, sht.synthesis_*_lsel) and the cut
    residual r maintained incrementally.  Multi-bin ("big") blocks are
    evaluated directly (one cut synthesis each).  The reference's production
    blocking — EE one block, BB big block + ~133 per-bin blocks
    (config.py:44-55) — thus costs 2 cut syntheses + scalars per sweep
    instead of ~136 full likelihood evaluations.

    Sparse-split models (floor + holes, ops.model.with_cut_decomposition):
    every per-bin scalar gains a hole-point correction through the point
    transform (q_i += ||sqrt(w_sp) A_sp t_i||^2, Gram and rho likewise) and
    the sparse residual values are carried alongside the floor residual —
    so the reference's ACTUAL mask shape (apodized band + point sources at
    all latitudes, config.py:22-28) runs the fast engines instead of the
    near-full-sphere chunked fallback.

    ``l_cut_identity`` (PNCP, SURVEY.md 2.4): slots with l < l_cut use the
    IDENTITY re-centering (u = B s_nc there, independent of D_ell) instead
    of sqrt(C_l); the low-ell part enters as a fixed u_base with support
    disjoint from every (high-ell) block, so the per-bin rank-one algebra
    is unchanged."""
    if not model.has_cut:
        raise ValueError("nc_cls_sample_cut needs a cut-decomposition model")
    from ..harmonics.spectra import dl_to_cl_factor
    lmax = model.lmax
    L = lmax + 1
    dt = dl_tuple[0].dtype
    nfields = len(dl_tuple)
    sizes = [int(d.shape[-1]) for d in dl_tuple]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    ntot = int(offs[-1])
    rows = []
    for f, blocks in enumerate(blocks_list):
        for (lo, hi) in blocks:
            r = np.zeros(ntot)
            r[offs[f] + lo: offs[f] + hi] = 1.0
            rows.append(r)
    bmask = jnp.asarray(np.stack(rows), dtype=dt)
    nblocks = bmask.shape[0]
    sigma = jnp.concatenate([jnp.broadcast_to(jnp.asarray(p, dt), (n,))
                             for p, n in zip(prop_sigma_list, sizes)])

    # ---- static per-call precomputation --------------------------------
    fac = dl_to_cl_factor(lmax, dt)                       # 2pi/(l(l+1))
    tfl = model.bl.astype(dt) * jnp.sqrt(fac)
    t = almxfl_state(s_nc.astype(dt), tfl, lmax)          # (nf, nstate)
    g = (model.noise.tau_max / model.noise.omega).astype(dt)   # (nf,)
    # per-bin harmonic scalars (bin masks are pure ell selections)
    alpha = jnp.concatenate([
        bin_sum(_per_ell(model.cut_c1[f].astype(dt) * t[f], lmax),
                np.asarray(bins_list[f]), lmax)
        for f in range(nfields)])
    beta = jnp.concatenate([
        g[f] * bin_sum(_per_ell(t[f] * t[f], lmax),
                       np.asarray(bins_list[f]), lmax)
        for f in range(nfields)])

    # single-bin blocks (in sweep order) and their global bin indices
    order = []          # (kind, field, block_row, data) in block order
    singles = []        # global bin index per single block, in order
    brow = 0
    for f, blocks in enumerate(blocks_list):
        for (lo, hi) in blocks:
            if hi - lo == 1:
                order.append(("single", f, brow, offs[f] + lo))
                singles.append((f, lo, offs[f] + lo))
            else:
                order.append(("big", f, brow, None))
            brow += 1

    single_rows = [row for (kind, _, row, _) in order if kind == "single"]

    # the fast path processes the big blocks at their positions and then the
    # singles as one scan: require the blocks_list order to already be
    # [bigs..., singles...] (the reference's production layout) so the
    # Markov-kernel composition order matches nc_cls_sample exactly
    kinds = [k for (k, *_rest) in order]
    if "single" in kinds and "big" in kinds[kinds.index("single"):]:
        raise ValueError("nc_cls_sample_cut requires all multi-bin blocks "
                         "to precede the single-bin blocks; use "
                         "nc_cls_sample for this blocking")

    # m-domain sweep eligibility (the production fast-fast path): all
    # per-bin likelihood algebra in the ring half-spectrum basis
    use_m = (mdomain is not False) and bool(singles) \
        and _mdomain_eligible(model)
    has_sp = getattr(model, "has_sparse", False)
    if has_sp and use_m:
        # sparse hole corrections are implemented for the table-domain
        # engine and the phi-domain fallback; the coefficient m-domain
        # engine is not extended — fall back to phi when it would be picked
        use_m = (mdomain != "m"
                 and getattr(model, "cut_w_equal_fields", False)
                 and getattr(model.cut_sht, "nphi", 0) >= 2 * model.lmax)
    spt = model.sp_sht if has_sp else None
    w_sp = model.w_sp.astype(dt) if has_sp else None

    cut = model.cut_sht
    zeros = jnp.zeros_like(t[0])
    w_cut = model.w_cut.astype(dt)
    phi_chunks = None
    if singles and not use_m:
        # phi-domain fallback (general, non-uniform w): process the singles
        # in static chunks, each chunk's per-bin maps A t_i built by one
        # ell-selected cut synthesis INSIDE the sweep — peak memory is
        # O(chunk * nmaps * ncut * nphi) per chain instead of the full
        # (nsingles, ...) stack (which OOMs 128 chains at production scale)
        phi_chunks = _prepare_mchunks(singles, single_rows, bins_list,
                                      chunk_size=_PHI_CHUNK)

    def _chunk_maps(tr, f, j_idx, seg, t_in):
        """(nb, nfmaps, *pix) per-bin component maps/values A t_i of one
        field-pure chunk through transform ``tr`` (the cut-ring SHT or the
        sparse point transform — both expose synthesis_*_state_lsel),
        zero-filled on the map components the field does not occupy
        (matches the full-stack layout the residual carries).  ``t_in`` is
        the (possibly barrier-sequenced) per-bin component state."""
        nbc = len(j_idx) if seg is None else seg.shape[1]
        sel = np.zeros((nbc, L))
        if seg is None:
            sel[np.arange(nbc), np.asarray(j_idx)] = 1.0
        else:
            for jj, l in enumerate(np.asarray(j_idx)):
                sel[int(np.argmax(seg[jj])), l] = 1.0
        sel = jnp.asarray(sel, dt)
        z_in = jnp.zeros_like(t_in[0])
        if model.spin == 0:
            return tr.synthesis_state_lsel(t_in[0], sel)[..., None, :, :]
        if model.spin == 2:
            if f == 0:
                q, u_ = tr.synthesis_spin2_state_lsel(t_in[0], z_in, sel)
            else:
                q, u_ = tr.synthesis_spin2_state_lsel(z_in, t_in[1], sel)
            return jnp.stack([q, u_], axis=-3)
        # spin 3: (T, E, B) <-> (T, Q, U)
        if f == 0:
            tm = tr.synthesis_state_lsel(t_in[0], sel)
            z = jnp.zeros_like(tm)
            return jnp.stack([tm, z, z], axis=-3)
        e_in = t_in[1] if f == 1 else z_in
        b_in = t_in[2] if f == 2 else z_in
        q, u_ = tr.synthesis_spin2_state_lsel(e_in, b_in, sel)
        return jnp.stack([jnp.zeros_like(q), q, u_], axis=-3)

    if l_cut_identity is not None:
        # PNCP: l < l_cut slots are identity-recentered — a FIXED base
        # component u_base = B s_nc there; blocks must only touch bins at
        # l >= l_cut (PNCPGibbs guarantees this), so u stays linear in the
        # per-bin sqrt(D_i) with components disjoint from the base.
        # l_cut_identity may be PER FIELD (int or sequence): the signal/
        # noise crossover is field-dependent (EE is signal-dominated to
        # far higher ell than BB — measured per-bin ESS, PERF.md).
        lcs = (list(l_cut_identity)
               if isinstance(l_cut_identity, (tuple, list))
               else [l_cut_identity] * nfields)
        lowm = jnp.stack([expand_cl_state(jnp.asarray(
            (np.arange(lmax + 1) < lc).astype(np.float64), dt), lmax)
            for lc in lcs])                               # (nf, nstate)
        him = 1.0 - lowm
        u_base = almxfl_state(s_nc.astype(dt) * lowm, model.bl.astype(dt),
                              lmax)
    else:
        him, u_base = None, None

    def u_of(dlcat):
        parts = [jnp.sqrt(expand_cl_state(
            unfold_bins(dlcat[offs[f]: offs[f + 1]],
                        np.asarray(bins_list[f]), lmax), lmax)) * t[f]
            for f in range(nfields)]
        u = jnp.stack(parts, axis=0)
        if u_base is not None:
            u = u_base + him * u
        return u

    dl0 = jnp.concatenate([d.astype(dt) for d in dl_tuple], axis=-1)
    u0 = u_of(dl0)
    au0, au_sp0 = model.synthesis_cut_sp(u0)
    resid0 = model.d_cut.astype(dt) - au0
    rp0 = (model.d_sp.astype(dt) - au_sp0) if has_sp else None
    ll0 = model.data_loglike_cut(u0, au0, au_sp0)

    if use_m:
        mchunks = _prepare_mchunks(singles, single_rows, bins_list)
        mgrids = _prepare_mgrids(model, t, mchunks)
        if has_sp:
            w_sp_flat = spt.flat_of(w_sp)        # (nmaps, nslots)
        pwc, pws = cut.ring_dot_weights()
        w_ring = w_cut[..., 0]                      # (nfmaps, ncut) uniform
        # table-domain engine: needs one shared mask across map
        # components (cut_w_equal_fields).  Ring phases are handled by
        # rotation factors on the raw-ring-sum pairings, and the Nyquist
        # nphi = 2 lmax column (HEALPix belt rows) by a dedicated exact
        # per-chunk path (_prepare_tchunks nyq=True).  "m" pins the
        # coefficient engine.
        use_t = (mdomain != "m"
                 and getattr(model, "cut_w_equal_fields", False)
                 and getattr(cut, "nphi", 0) >= 2 * model.lmax)
        if use_t:
            w1 = w_ring[0]
            pos_t = jnp.ones((L,), dt).at[0].set(0.0)
            nyq_t = getattr(cut, "nphi", 0) == 2 * model.lmax
            if getattr(cut, "has_phase", False):
                ph_c = cut.phase_cos.astype(dt)        # (ncut, L)
                ph_s = cut.phase_sin.astype(dt)
            else:
                ph_c = ph_s = None
            nphi_f = jnp.asarray(float(cut.nphi), dt)
            tpre = _prepare_tchunks(model, cut, mchunks, w1, dt, nyq=nyq_t)
    else:
        use_t = False

    def _bigs(dlcat, ll, resid_like, props, lr_vec, akeys, accs, to_resid):
        """Process the multi-bin blocks in sweep order.  ``resid_like`` is
        whatever residual representation the singles phase uses (phi maps
        or ring half-spectrum, plus sparse point values when present);
        ``to_resid(r_cut, r_sp)`` maps fresh residuals into that
        representation (r_sp is None for non-sparse models)."""
        for (kind, f, row, gi) in order:
            if kind != "big":
                continue
            mb = bmask[row]
            cand = jnp.where(mb > 0, props, dlcat)
            u_c = u_of(cand)
            au_c, au_sp_c = model.synthesis_cut_sp(u_c)
            ll_c = model.data_loglike_cut(u_c, au_c, au_sp_c)
            qcorr = jnp.sum(mb * lr_vec)
            acc = (jnp.log(jax.random.uniform(akeys[row], dtype=dt))
                   < ll_c - ll + qcorr)
            dlcat = jnp.where(acc, cand, dlcat)
            ll = jnp.where(acc, ll_c, ll)
            fresh = to_resid(
                model.d_cut.astype(dt) - au_c,
                None if au_sp_c is None
                else model.d_sp.astype(dt) - au_sp_c)
            resid_like = jax.tree.map(
                lambda new, old: jnp.where(acc, new, old),
                fresh, resid_like)
            accs = accs.at[row].set(acc.astype(dt))
        return dlcat, ll, resid_like, accs

    def sweep_phi(carry, k):
        """phi-domain sweep: per-bin pixel maps a_i carried through the
        singles scan (general w; the original rank-one fast path), one
        memory-bounded chunk at a time.  Sparse-split models additionally
        carry the hole-point residual rp and add the point corrections to
        q_i / cwr."""
        if has_sp:
            dlcat, ll, resid, rp = carry
        else:
            dlcat, ll, resid = carry
            rp = None
        kp, ka = jax.random.split(k)
        props = propose_truncnorm(kp, dlcat, sigma)
        lr_vec = truncnorm_logratio(dlcat, props, sigma)
        akeys = jax.random.split(ka, nblocks)
        accs = jnp.zeros((nblocks,), dt)
        if has_sp:
            dlcat, ll, (resid, rp), accs = _bigs(
                dlcat, ll, (resid, rp), props, lr_vec, akeys, accs,
                lambda r, rsp: (r, rsp))
        else:
            dlcat, ll, resid, accs = _bigs(dlcat, ll, resid, props, lr_vec,
                                           akeys, accs, lambda r, rsp: r)

        t_seq = t
        for ci, (f, j_idx, seg, gbins, rows) in enumerate(phi_chunks or ()):
            if ci > 0:
                # sequence the chunks: without this barrier XLA hoists
                # every chunk's (nb, nmaps, ncut, nphi) map stack ahead of
                # the scans and keeps them ALL live (measured 45 GB at 128
                # chains on a 271-ring planckish mask); tying the chunk's
                # synthesis input to the previous chunk's carry bounds
                # liveness at ~one chunk
                if has_sp:
                    dlcat, ll, resid, rp, t_seq = \
                        jax.lax.optimization_barrier(
                            (dlcat, ll, resid, rp, t_seq))
                else:
                    dlcat, ll, resid, t_seq = jax.lax.optimization_barrier(
                        (dlcat, ll, resid, t_seq))
            a_c = _chunk_maps(cut, f, j_idx, seg, t_seq)
            q_c = jnp.sum(w_cut * a_c * a_c, axis=(-3, -2, -1))
            gb = jnp.asarray(gbins)
            if has_sp:
                asp_c = _chunk_maps(spt, f, j_idx, seg, t_seq)
                q_c = q_c + jnp.sum(w_sp * asp_c * asp_c, axis=(-3, -2, -1))
            else:
                asp_c = jnp.zeros(q_c.shape + (0, 0, 0), dt)
            xs = (gb, a_c, asp_c, q_c, alpha[gb], beta[gb],
                  akeys[jnp.asarray(rows)])

            def one(carry, x):
                dlcat, ll, resid, rp_c = carry
                gi, a_i, asp_i, q_i, al_i, be_i, ak = x
                D = dlcat[gi]
                P = props[gi]
                gamma = jnp.sqrt(P) - jnp.sqrt(D)
                cwr = jnp.sum(w_cut * resid * a_i)
                if has_sp:
                    cwr = cwr + jnp.sum(w_sp * rp_c * asp_i)
                dll = (gamma * (al_i - jnp.sqrt(D) * be_i - cwr)
                       + 0.5 * gamma * gamma * (q_i - be_i))
                acc = (jnp.log(jax.random.uniform(ak, dtype=dt))
                       < dll + lr_vec[gi])
                gam_eff = jnp.where(acc, gamma, 0.0)
                dlcat = dlcat.at[gi].set(jnp.where(acc, P, D))
                resid = resid - gam_eff * a_i
                if has_sp:
                    rp_c = rp_c - gam_eff * asp_i
                ll = ll + jnp.where(acc, dll, 0.0)
                return (dlcat, ll, resid, rp_c), acc.astype(dt)

            rp_in = rp if has_sp else jnp.zeros((), dt)
            (dlcat, ll, resid, rp_in), acc_s = jax.lax.scan(
                one, (dlcat, ll, resid, rp_in), xs)
            if has_sp:
                rp = rp_in
            accs = accs.at[jnp.asarray(rows)].set(acc_s)

        if has_sp:
            return (dlcat, ll, resid, rp), accs
        return (dlcat, ll, resid), accs

    def sweep_m(carry, k):
        """m-domain sweep: the singles' likelihood algebra runs entirely in
        the ring half-spectrum basis.  Per chunk of single-bin blocks the
        per-bin components A t_i are built by ell-gathered table products
        (no dense one-hot contraction, ~L/J fewer flops than the lsel
        einsum), reduced once to scalars — q_i = <a_i, a_i>_w, the in-chunk
        Gram G_ij = <a_i, a_j>_w and rho_i = <r, a_i>_w — and the sweep
        itself is a scalar scan: cwr_i = rho_i - sum_{j<i} gamma_j G_ij.
        No per-bin pixel maps are materialized or carried, so memory stays
        O(chunk) and the azimuthal iFFT disappears."""
        if has_sp:
            dlcat, ll, Rc, Rs, Rp = carry
        else:
            dlcat, ll, Rc, Rs = carry
            Rp = None
        kp, ka = jax.random.split(k)
        props = propose_truncnorm(kp, dlcat, sigma)
        lr_vec = truncnorm_logratio(dlcat, props, sigma)
        akeys = jax.random.split(ka, nblocks)
        accs = jnp.zeros((nblocks,), dt)
        if has_sp:
            # Rp is carried FLAT (nmaps, nslots) in this sweep
            dlcat, ll, ((Rc, Rs), Rp), accs = _bigs(
                dlcat, ll, ((Rc, Rs), Rp), props, lr_vec, akeys, accs,
                lambda r, rsp: (cut.ring_cs_of_maps(r), spt.flat_of(rsp)))
        else:
            dlcat, ll, (Rc, Rs), accs = _bigs(
                dlcat, ll, (Rc, Rs), props, lr_vec, akeys, accs,
                lambda r, rsp: cut.ring_cs_of_maps(r))
        # pre-draw every single's accept uniform in ONE batched op
        # (bit-identical to per-step draws from the same keys); the scalar
        # scan then runs arithmetic only
        log_u_all = jnp.log(jax.vmap(
            lambda kk: jax.random.uniform(kk, dtype=dt))(akeys))

        for ci, (f, j_idx, seg, gbins, rows) in enumerate(mchunks):
            comps = _chunk_comps(model, f)
            c0, c1 = comps[0], comps[-1] + 1
            kind_f, g_f, sp_f, sm_f = mgrids[f]
            if ci > 0 and (not use_t or has_sp):
                # sequence the chunks (see sweep_phi): the coefficient
                # engine's per-chunk (nb, ncomp, ncut, L) ring-coefficient
                # planes otherwise ALL get hoisted live by XLA (measured
                # 26 GB at 128 chains on the HEALPix 153-row belt); the
                # table engine's per-chunk tensors are small and stay
                # unsequenced for scheduling freedom — except with sparse
                # holes, whose per-chunk (nb, ncomp, r_sp, p) value stacks
                # need the same liveness bound
                if has_sp:
                    dlcat, ll, Rc, Rs, Rp, g_f = \
                        jax.lax.optimization_barrier(
                            (dlcat, ll, Rc, Rs, Rp, g_f))
                else:
                    dlcat, ll, Rc, Rs, g_f = jax.lax.optimization_barrier(
                        (dlcat, ll, Rc, Rs, g_f))
            mg_seq = dict(mgrids)
            mg_seq[f] = (kind_f, g_f, sp_f, sm_f)
            if use_t:
                # --- table-domain reductions (_prepare_tchunks): no
                # per-bin (ring, m) planes; q/G/rho from ell-pair weight
                # tables and thin gathered state slices.  Ring phases:
                # the raw ring sums (Rc, Rs) rotate into the unrotated-F
                # pairing basis; the Nyquist column (lnyq) contributes
                # through its own exact r-resolved path. -------------------
                kind, lamA, lamB, W, omega, lnyq = tpre[ci]
                _kg, gmat, sp, sm = mg_seq[f]
                gsel = jnp.take(gmat, jnp.asarray(j_idx), axis=-1)
                segj = None if seg is None else jnp.asarray(seg, dt)
                if lnyq is not None:
                    g_nre = gsel[..., 0, L - 1, :]       # (..., J)
                    g_nim = gsel[..., 1, L - 1, :]
                    if ph_c is not None:
                        pcn, psn = ph_c[:, L - 1], ph_s[:, L - 1]   # (r,)
                if kind == "s0":
                    gw = gsel * omega[:, :, None]
                    CM = jnp.einsum("...cml,...cmk->...mlk", gw, gsel,
                                    precision=PRECISION,
                                    preferred_element_type=dt)
                    Gl = jnp.einsum("...mlk,mlk->...lk", CM, W,
                                    precision=PRECISION,
                                    preferred_element_type=dt)
                    cmv = jnp.ones((L,), dt).at[1:].set(2.0)
                    RcF = Rc[..., c0, :, :]
                    RsF = Rs[..., c0, :, :]
                    if ph_c is not None:
                        Rct = ph_c * RcF - ph_s * RsF
                        Rst = ph_s * RcF + ph_c * RsF
                    else:
                        Rct, Rst = RcF, RsF
                    WRc = Rct * w1[:, None]
                    WRs = Rst * w1[:, None]
                    U0re = jnp.einsum("mjr,...rm->...mj", lamA, WRc,
                                      precision=PRECISION,
                                      preferred_element_type=dt)
                    U0im = -jnp.einsum("mjr,...rm->...mj", lamA, WRs,
                                       precision=PRECISION,
                                       preferred_element_type=dt)
                    rho_l = (jnp.einsum("...mj,...mj,m->...j",
                                        gsel[..., 0, :, :], U0re, cmv,
                                        precision=PRECISION,
                                        preferred_element_type=dt)
                             + jnp.einsum("...mj,...mj,m->...j",
                                          gsel[..., 1, :, :], U0im, cmv,
                                          precision=PRECISION,
                                          preferred_element_type=dt))
                    if lnyq is not None:
                        # exact Nyquist-column (m = lmax) contribution:
                        # local cos coefficient Cc = 2 (Fre c - Fim s),
                        # pairing weight pw_cos = nphi, sin column zero
                        Fre_n = g_nre[..., None] * lnyq          # (..., J, r)
                        Fim_n = g_nim[..., None] * lnyq
                        if ph_c is not None:
                            Ccn = 2.0 * (Fre_n * pcn - Fim_n * psn)
                        else:
                            Ccn = 2.0 * Fre_n
                        Gl = Gl + nphi_f * jnp.einsum(
                            "...jr,r,...kr->...jk", Ccn, w1, Ccn,
                            precision=PRECISION,
                            preferred_element_type=dt)
                        rho_l = rho_l + jnp.einsum(
                            "...jr,...r->...j", Ccn,
                            w1 * RcF[..., :, L - 1],
                            precision=PRECISION,
                            preferred_element_type=dt)
                else:
                    CM = jnp.einsum("...cml,...cmk->...mlk", gsel, gsel,
                                    precision=PRECISION,
                                    preferred_element_type=dt)
                    Gl = jnp.einsum("...mlk,mlk->...lk", CM, W,
                                    precision=PRECISION,
                                    preferred_element_type=dt)
                    cq, cu = comps
                    wb = w1[:, None]
                    RcQ_, RsQ_ = Rc[..., cq, :, :], Rs[..., cq, :, :]
                    RcU_, RsU_ = Rc[..., cu, :, :], Rs[..., cu, :, :]
                    if ph_c is not None:
                        RcQ = ph_c * RcQ_ - ph_s * RsQ_
                        RsQ = ph_s * RcQ_ + ph_c * RsQ_
                        RcU = ph_c * RcU_ - ph_s * RsU_
                        RsU = ph_s * RcU_ + ph_c * RsU_
                    else:
                        RcQ, RsQ, RcU, RsU = RcQ_, RsQ_, RcU_, RsU_
                    if lnyq is not None:
                        # Nyquist column: build the chunk's local Q/U cos
                        # coefficients at m = lmax (pos_lmax = 1)
                        lpn, lmn = lnyq
                        Fpre_n = g_nre[..., None] * lpn
                        Fpim_n = g_nim[..., None] * lpn
                        Fmre_n = g_nre[..., None] * lmn
                        Fmim_n = g_nim[..., None] * lmn
                        Are_n = sp * Fpre_n + sm * Fmre_n
                        Aim_n = sp * Fpim_n + sm * Fmim_n
                        Bre_n = sp * Fpre_n - sm * Fmre_n
                        Bim_n = sp * Fpim_n - sm * Fmim_n
                        if ph_c is not None:
                            Qcn = Are_n * pcn - Aim_n * psn
                            Ucn = Bre_n * psn + Bim_n * pcn
                        else:
                            Qcn, Ucn = Are_n, Bim_n
                        Gl = Gl + nphi_f * (
                            jnp.einsum("...jr,r,...kr->...jk", Qcn, w1,
                                       Qcn, precision=PRECISION,
                                       preferred_element_type=dt)
                            + jnp.einsum("...jr,r,...kr->...jk", Ucn, w1,
                                         Ucn, precision=PRECISION,
                                         preferred_element_type=dt))
                    Spre = wb * (RcQ + RsU)
                    Spim = wb * (RcU - RsQ)
                    Smre = wb * (RcQ - RsU)
                    Smim = -wb * (RsQ + RcU)
                    Upre = jnp.einsum("mjr,...rm->...mj", lamA, Spre,
                                      precision=PRECISION,
                                      preferred_element_type=dt)
                    Upim = jnp.einsum("mjr,...rm->...mj", lamA, Spim,
                                      precision=PRECISION,
                                      preferred_element_type=dt)
                    Umre = jnp.einsum("mjr,...rm->...mj", lamB, Smre,
                                      precision=PRECISION,
                                      preferred_element_type=dt)
                    Umim = jnp.einsum("mjr,...rm->...mj", lamB, Smim,
                                      precision=PRECISION,
                                      preferred_element_type=dt)
                    posj = pos_t[:, None]
                    Xre = sp * Upre + sm * posj * Umre
                    Xim = sp * Upim + sm * posj * Umim
                    rho_l = (jnp.einsum("...mj,...mj->...j",
                                        gsel[..., 0, :, :], Xre,
                                        precision=PRECISION,
                                        preferred_element_type=dt)
                             + jnp.einsum("...mj,...mj->...j",
                                          gsel[..., 1, :, :], Xim,
                                          precision=PRECISION,
                                          preferred_element_type=dt))
                    if lnyq is not None:
                        rho_l = rho_l + (
                            jnp.einsum("...jr,...r->...j", Qcn,
                                       w1 * RcQ_[..., :, L - 1],
                                       precision=PRECISION,
                                       preferred_element_type=dt)
                            + jnp.einsum("...jr,...r->...j", Ucn,
                                         w1 * RcU_[..., :, L - 1],
                                         precision=PRECISION,
                                         preferred_element_type=dt))
                if segj is None:
                    G, rho = Gl, rho_l
                else:
                    G = jnp.einsum("lb,...lk,kc->...bc", segj, Gl, segj,
                                   precision=PRECISION,
                                   preferred_element_type=dt)
                    rho = jnp.einsum("...l,lb->...b", rho_l, segj,
                                     precision=PRECISION,
                                     preferred_element_type=dt)
                if has_sp:
                    # sparse-hole corrections on the FLAT slot axis: the
                    # per-bin hole values come from chain-independent
                    # slot-expanded lambda tables contracted against the
                    # already-gathered grid columns — no per-chain
                    # (row, L) planes and no padding waste
                    if kind == "s0":
                        a_sp = spt.values_flat_spin0_gsel(
                            gsel, j_idx, seg)[..., None, :]
                    else:
                        qsp, usp = spt.values_flat_spin2_gsel(
                            gsel, sp, sm, j_idx, seg)
                        a_sp = jnp.stack([qsp, usp], axis=-2)
                    wspf = w_sp_flat[c0:c1]
                    G = G + jnp.einsum("...ics,cs,...jcs->...ij",
                                       a_sp, wspf, a_sp,
                                       precision=PRECISION,
                                       preferred_element_type=dt)
                    rho = rho + jnp.einsum("...ics,...cs->...i", a_sp,
                                           wspf * Rp[..., c0:c1, :],
                                           precision=PRECISION,
                                           preferred_element_type=dt)
                q_c = jnp.diagonal(G, axis1=-2, axis2=-1)
            else:
                Cc, Cs, comps = _chunk_ring_coefs(model, mg_seq, f, j_idx,
                                                  seg)
                wf = w_ring[c0:c1]                   # (ncomp, ncut)
                # ONE weighted copy per coefficient array: scale by
                # sqrt(w_r pw_m) so <a_i, a_j>_w is a plain einsum of the
                # scaled coefficients with themselves; rho and the residual
                # update reuse the same arrays with the small (Rc, Rs) side
                # carrying the compensating sqrt factors.  Rings with
                # w_r = 0 contribute to nothing downstream (every use of
                # the carried residual spectrum is w-weighted), so the
                # where-guards are exact.  Keeps live coefficient memory at
                # 2 arrays per chunk (the chunk-48 version's ~8 copies
                # OOM'd 128 chains).
                sc_c = jnp.sqrt(wf[:, :, None] * pwc)
                sc_s = jnp.sqrt(wf[:, :, None] * pws)
                Cc = Cc * sc_c
                Cs = Cs * sc_s
                G = (jnp.einsum("...icrm,...jcrm->...ij", Cc, Cc,
                                precision=PRECISION,
                                preferred_element_type=dt)
                     + jnp.einsum("...icrm,...jcrm->...ij", Cs, Cs,
                                  precision=PRECISION,
                                  preferred_element_type=dt))
                q_c = jnp.diagonal(G, axis1=-2, axis2=-1)
                # rho_i = <r, a_i>_w = sum (Cc sc_c) (Rc sqrt(w/pw)) + ...
                rc_t = Rc[..., c0:c1, :, :] * jnp.where(
                    pwc > 0, sc_c / jnp.where(pwc > 0, pwc, 1.0), 0.0)
                rs_t = Rs[..., c0:c1, :, :] * jnp.where(
                    pws > 0, sc_s / jnp.where(pws > 0, pws, 1.0), 0.0)
                rho = (jnp.einsum("...icrm,...crm->...i", Cc, rc_t,
                                  precision=PRECISION,
                                  preferred_element_type=dt)
                       + jnp.einsum("...icrm,...crm->...i", Cs, rs_t,
                                    precision=PRECISION,
                                    preferred_element_type=dt))
            gb = jnp.asarray(gbins)
            xs = (jnp.arange(len(gbins)), gb, q_c, alpha[gb], beta[gb],
                  G, rho, log_u_all[jnp.asarray(rows)],
                  props[gb], lr_vec[gb])

            def one(carry, x):
                dlcat, ll, gacc = carry
                kpos, gi, q_i, al_i, be_i, Grow, rho_i, lu, P, lr = x
                D = dlcat[gi]
                gamma = jnp.sqrt(P) - jnp.sqrt(D)
                cwr = rho_i - jnp.dot(gacc, Grow, precision=PRECISION)
                dll = (gamma * (al_i - jnp.sqrt(D) * be_i - cwr)
                       + 0.5 * gamma * gamma * (q_i - be_i))
                acc = lu < dll + lr
                gam_eff = jnp.where(acc, gamma, 0.0)
                dlcat = dlcat.at[gi].set(jnp.where(acc, P, D))
                gacc = gacc.at[kpos].set(gam_eff)
                ll = ll + jnp.where(acc, dll, 0.0)
                return (dlcat, ll, gacc), acc.astype(dt)

            gacc0 = jnp.zeros((len(gbins),), dt)
            (dlcat, ll, gacc), acc_s = jax.lax.scan(
                one, (dlcat, ll, gacc0), xs, unroll=_MDOMAIN_UNROLL)
            accs = accs.at[jnp.asarray(rows)].set(acc_s)
            # fold the accepted moves into the residual spectrum:
            # r <- r - sum_i gamma_i a_i
            if use_t:
                gl = gacc if segj is None else jnp.einsum(
                    "lb,...b->...l", segj, gacc, precision=PRECISION)
                gg = gsel * gl[..., None, None, :]
                if kind == "s0":
                    Fc = jnp.einsum("mjr,...cmj->...crm", lamA, gg,
                                    precision=PRECISION,
                                    preferred_element_type=dt)
                    Fre_u, Fim_u = Fc[..., 0, :, :], Fc[..., 1, :, :]
                    if ph_c is not None:
                        Fre_u, Fim_u = (Fre_u * ph_c - Fim_u * ph_s,
                                        Fre_u * ph_s + Fim_u * ph_c)
                    Rc = Rc.at[..., c0, :, :].add(-(pwc * cmv) * Fre_u)
                    Rs = Rs.at[..., c0, :, :].add((pws * cmv) * Fim_u)
                    if lnyq is not None:
                        Fn = jnp.einsum("...j,...jr->...r", gl, Ccn,
                                        precision=PRECISION,
                                        preferred_element_type=dt)
                        Rc = Rc.at[..., c0, :, L - 1].add(-nphi_f * Fn)
                else:
                    Fp = jnp.einsum("mjr,...cmj->...crm", lamA, gg,
                                    precision=PRECISION,
                                    preferred_element_type=dt) * sp
                    Fm = jnp.einsum("mjr,...cmj->...crm", lamB, gg,
                                    precision=PRECISION,
                                    preferred_element_type=dt) * sm
                    Are = Fp[..., 0, :, :] + pos_t * Fm[..., 0, :, :]
                    Aim = Fp[..., 1, :, :] + pos_t * Fm[..., 1, :, :]
                    Bre = Fp[..., 0, :, :] - pos_t * Fm[..., 0, :, :]
                    Bim = Fp[..., 1, :, :] - pos_t * Fm[..., 1, :, :]
                    if ph_c is not None:
                        Are, Aim = (Are * ph_c - Aim * ph_s,
                                    Are * ph_s + Aim * ph_c)
                        Bre, Bim = (Bre * ph_c - Bim * ph_s,
                                    Bre * ph_s + Bim * ph_c)
                    # (Qc, Qs, Uc, Us) = (Are, -Aim, Bim, Bre)
                    Rc = Rc.at[..., cq, :, :].add(-pwc * Are)
                    Rs = Rs.at[..., cq, :, :].add(pws * Aim)
                    Rc = Rc.at[..., cu, :, :].add(-pwc * Bim)
                    Rs = Rs.at[..., cu, :, :].add(-pws * Bre)
                    if lnyq is not None:
                        FnQ = jnp.einsum("...j,...jr->...r", gl, Qcn,
                                         precision=PRECISION,
                                         preferred_element_type=dt)
                        FnU = jnp.einsum("...j,...jr->...r", gl, Ucn,
                                         precision=PRECISION,
                                         preferred_element_type=dt)
                        Rc = Rc.at[..., cq, :, L - 1].add(-nphi_f * FnQ)
                        Rc = Rc.at[..., cu, :, L - 1].add(-nphi_f * FnU)
                if has_sp:
                    # hole-point residual: rp <- rp - sum_i gamma_i a_sp_i
                    Rp = Rp.at[..., c0:c1, :].add(
                        -jnp.einsum("...i,...ics->...cs", gacc, a_sp,
                                    precision=PRECISION,
                                    preferred_element_type=dt))
            else:
                # Rc(a) = pwc Cc_raw = sqrt(pwc/w) (Cc sc_c-scaled); w = 0
                # rings never feed any downstream w-weighted product, so
                # zeroing them is exact
                dRc = jnp.einsum("...i,...icrm->...crm", gacc, Cc,
                                 precision=PRECISION,
                                 preferred_element_type=dt) \
                    * jnp.where(sc_c > 0,
                                pwc / jnp.where(sc_c > 0, sc_c, 1.0), 0.0)
                dRs = jnp.einsum("...i,...icrm->...crm", gacc, Cs,
                                 precision=PRECISION,
                                 preferred_element_type=dt) \
                    * jnp.where(sc_s > 0,
                                pws / jnp.where(sc_s > 0, sc_s, 1.0), 0.0)
                Rc = Rc.at[..., c0:c1, :, :].add(-dRc)
                Rs = Rs.at[..., c0:c1, :, :].add(-dRs)

        if has_sp:
            return (dlcat, ll, Rc, Rs, Rp), accs
        return (dlcat, ll, Rc, Rs), accs

    if use_m:
        Rc0, Rs0 = cut.ring_cs_of_maps(resid0)
        carry0 = ((dl0, ll0, Rc0, Rs0, spt.flat_of(rp0)) if has_sp
                  else (dl0, ll0, Rc0, Rs0))
        carry, accs = jax.lax.scan(
            sweep_m, carry0, jax.random.split(key, n_iter))
    else:
        carry0 = ((dl0, ll0, resid0, rp0) if has_sp
                  else (dl0, ll0, resid0))
        carry, accs = jax.lax.scan(
            sweep_phi, carry0, jax.random.split(key, n_iter))
    dlcat, ll = carry[0], carry[1]
    acc_mean = jnp.mean(accs, axis=0)
    out_acc, i0 = [], 0
    for f, blocks in enumerate(blocks_list):
        out_acc.append(acc_mean[i0: i0 + len(blocks)])
        i0 += len(blocks)
    dl_out = tuple(dlcat[offs[f]: offs[f + 1]] for f in range(nfields))
    return dl_out, NCClsInfo(accept=tuple(out_acc), log_like=ll)


# ---------------------------------------------------------------------------
# Joint k x k inverse-Wishart step (TT/TE/EE... extension)
# ---------------------------------------------------------------------------

def invwishart_cls_sample(key, s: jnp.ndarray, lmax: int, lmin: int = 2):
    """Per-ell joint draw C_ell ~ InvWishart(nu = 2l+1, Psi = S_ell) where
    S_ell = sum_m a_lm a_lm^T is the k x k scatter of the fields.

    Sampled via the Bartlett decomposition, vmapped over ell.  Returns
    (lmax+1, k, k) C_ell blocks (zero below lmin).  This is the joint
    correlated-field generalization the reference prepared but never wired
    (invwishart import CenteredGibbs.py:7, 3x3 kernel
    variance_expension.pyx:36-61)."""
    k = s.shape[0]
    dt = s.dtype
    L = lmax + 1
    # S[l, i, j] = sum over valid slots of degree l of s_i s_j; in the
    # grid-packed layout that is one einsum over the (part, m) axes
    g = s.reshape(k, 2, L, L)
    S = jnp.einsum("ipml,jpml->lij", g, g, precision=PRECISION)
    nu = 2.0 * jnp.arange(lmax + 1, dtype=dt) + 1.0

    kchi, knorm = jax.random.split(key)
    # Bartlett: W ~ Wishart(nu, I): L lower-tri, diag sqrt(chi2_{nu-i}),
    # off-diag N(0,1); then Wishart(nu, Psi^-1) sample = (A L)(A L)^T with
    # A A^T = Psi^-1; the InvWishart draw is its inverse.
    i_idx = jnp.arange(k, dtype=dt)
    df = jnp.maximum(nu[:, None] - i_idx[None, :], 1e-3)  # (L, k)
    chi2 = 2.0 * jax.random.gamma(kchi, df / 2.0).astype(dt)
    normals = jax.random.normal(knorm, (lmax + 1, k, k), dtype=dt)
    tril = jnp.tril(normals, k=-1)
    Lmat = tril + jax.vmap(jnp.diag)(jnp.sqrt(chi2))
    # Bartlett: W = A (L L^T) A^T ~ Wishart(nu, A A^T) for any A with
    # A A^T = Psi^-1 = S^-1; take A = cS^-T (cS = chol(S), lower), so
    # C = W^-1 = A^-T (L L^T)^-1 A^-1 = cS (L L^T)^-1 cS^T.
    eye = jnp.eye(k, dtype=dt)
    # relative diagonal jitter: at high SNR the fields' scatter can be
    # correlation-degenerate (|r| -> 1) and an absolute epsilon is dwarfed
    # by scatter scales ~1e3 muK^2 — chol's trailing pivot then goes
    # negative by roundoff and the draw NaNs; 1e-9 relative per diagonal
    # protects the pivot far below MC noise (plus 1e-30 for the all-zero
    # sub-lmin rows)
    diagS = jnp.diagonal(S, axis1=-2, axis2=-1)
    Sreg = S + jax.vmap(jnp.diag)(1e-9 * diagS + 1e-30)
    cS = jnp.linalg.cholesky(Sreg)
    LLT = jnp.matmul(Lmat, jnp.swapaxes(Lmat, -1, -2), precision=PRECISION)
    inv_LLT = jnp.linalg.inv(LLT + 1e-30 * eye)
    C = jnp.matmul(jnp.matmul(cS, inv_LLT, precision=PRECISION),
                   jnp.swapaxes(cS, -1, -2), precision=PRECISION)
    lmask = jnp.arange(lmax + 1) >= lmin
    # where (not multiply): sub-lmin rows can contain inf from degenerate
    # scatters, and 0 * inf = nan
    return jnp.where(lmask[:, None, None], C, 0.0)


# ---------------------------------------------------------------------------
# ASIS whiten / recenter transforms (reference: ASIS.py:109-120, 185-203)
# ---------------------------------------------------------------------------

def whiten(s, dl_tuple, bins_list, lmax):
    """s_nc = C^-1/2 s (slots with C = 0 stay 0)."""
    var = _dl_tuple_to_var(dl_tuple, bins_list, lmax, s.shape[-1], s.dtype)
    inv_sqrt = jnp.where(var > 0, 1.0 / jnp.sqrt(jnp.where(var > 0, var, 1.0)),
                         0.0)
    return s * inv_sqrt


def recenter(s_nc, dl_tuple, bins_list, lmax):
    """s = C^{1/2} s_nc."""
    var = _dl_tuple_to_var(dl_tuple, bins_list, lmax, s_nc.shape[-1],
                           s_nc.dtype)
    return jnp.sqrt(var) * s_nc
