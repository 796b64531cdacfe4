"""Azimuthal-floor + sparse-hole mask decomposition.

The reference's production mask is an apodized galactic mask PLUS point-
source holes at all latitudes (reference: config.py:22-28); round-4
measured such masks 25x slower than the band-mask headline because the
holes disqualified the uniform-ring fast engines.  The split
w = w_floor(theta) + w_sparse(theta, phi) restores them: the floor rides
the cut-ring SHT, the holes ride the point transform (sht.points).  These
tests pin (a) the point transform against the grid transform, (b) the
split operators against the full-sphere ones, and (c) the blocked-MH fast
engines on split models against the direct likelihood path bit-near.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import variance_expansion_state
from gibbssampler.harmonics.gridstate import expand_cl_state
from gibbssampler.harmonics.spectra import unfold_bins
from gibbssampler.inference import example_dl, simulate_dataset
from gibbssampler.ops import with_cut_decomposition
from gibbssampler.samplers import (aux_gibbs_cr, overrelax_cr, mala_cr,
                                       exact_cr, cg_cr,
                                       make_nc_log_likelihood)
from gibbssampler.samplers.cls_samplers import (nc_cls_sample,
                                                    nc_cls_sample_cut)
from gibbssampler.sht import (PointSHT, gauss_legendre_grid, make_sht)

LMAX = 16


def holey_mask(grid, seed=3, nholes=6, band=0.25, apo=0.15):
    """Apodized band + square holes at random positions (the planckish
    shape at toy scale)."""
    lat = np.abs(np.pi / 2 - grid.theta)
    x = np.clip((lat - band) / apo, 0.0, 1.0)
    keep = 0.5 - 0.5 * np.cos(np.pi * x)
    mask = np.broadcast_to(keep[:, None],
                           (grid.nrings, grid.nphi)).copy()
    rng = np.random.default_rng(seed)
    for _ in range(nholes):
        r = rng.integers(0, grid.nrings)
        c = rng.integers(0, grid.nphi)
        mask[max(0, r - 1): r + 2, max(0, c - 1): c + 2] = 0.0
    return mask


def make_holey(spin=2, sigma2=0.5, seed=0, sparse_split=True):
    grid = gauss_legendre_grid(LMAX)
    mask = holey_mask(grid)
    fields = (example_dl(LMAX, amp=10.0)[None] if spin == 0 else
              np.stack([example_dl(LMAX, "ee", amp=10.0),
                        example_dl(LMAX, "bb", amp=10.0)]))
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), LMAX, spin=spin,
                                dl_fields=fields, noise_sigma2=sigma2,
                                fwhm_radians=0.05, mask=mask,
                                dtype=jnp.float64)
    return model, with_cut_decomposition(model,
                                         sparse_split=sparse_split), fields


def var_of(model, fields):
    return jnp.stack([variance_expansion_state(jnp.asarray(f), LMAX)
                      for f in fields])


# ---------------------------------------------------------------------------
# PointSHT against the grid transform
# ---------------------------------------------------------------------------

def test_point_sht_matches_grid():
    grid = gauss_legendre_grid(LMAX)
    sht = make_sht(LMAX, dtype=jnp.float64, spin2=True)
    phi = (2 * np.pi * np.arange(grid.nphi) / grid.nphi)[None, :].repeat(
        grid.nrings, 0)
    pt = PointSHT(grid.theta, phi, np.ones_like(phi), LMAX,
                  dtype=jnp.float64, spin2=True)
    x = jax.random.normal(jax.random.PRNGKey(0), (model_nstate(),))
    np.testing.assert_allclose(np.asarray(pt.synthesis_state(x)),
                               np.asarray(sht.synthesis_state(x)),
                               atol=1e-12)
    f = jax.random.normal(jax.random.PRNGKey(1), (grid.nrings, grid.nphi))
    np.testing.assert_allclose(np.asarray(pt.adjoint_synthesis_state(f)),
                               np.asarray(sht.adjoint_synthesis_state(f)),
                               atol=1e-11)
    e = jax.random.normal(jax.random.PRNGKey(2), (model_nstate(),))
    b = jax.random.normal(jax.random.PRNGKey(3), (model_nstate(),))
    q1, u1 = sht.synthesis_spin2_state(e, b)
    q2, u2 = pt.synthesis_spin2_state(e, b)
    np.testing.assert_allclose(np.asarray(q2), np.asarray(q1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u1), atol=1e-12)
    e1, b1 = sht.adjoint_synthesis_spin2_state(q1, u1)
    e2, b2 = pt.adjoint_synthesis_spin2_state(q1, u1)
    np.testing.assert_allclose(np.asarray(e2), np.asarray(e1), atol=1e-11)
    np.testing.assert_allclose(np.asarray(b2), np.asarray(b1), atol=1e-11)


def model_nstate():
    from gibbssampler.harmonics import nstate
    return nstate(LMAX)


def test_point_sht_padded_subset_transpose():
    """Random padded point subset: synthesis equals the gathered grid
    synthesis and <A x, f> = <x, A^T f> exactly (validity mask on both
    sides)."""
    grid = gauss_legendre_grid(LMAX)
    sht = make_sht(LMAX, dtype=jnp.float64, spin2=True)
    rng = np.random.default_rng(7)
    rows = np.sort(rng.choice(grid.nrings, 5, replace=False))
    pmax = 6
    phis, vals, cols = [], [], []
    for r in rows:
        k = int(rng.integers(1, pmax + 1))
        cs = rng.choice(grid.nphi, k, replace=False)
        phis.append(np.pad(2 * np.pi * cs / grid.nphi, (0, pmax - k)))
        vals.append(np.pad(np.ones(k), (0, pmax - k)))
        cols.append(np.pad(cs, (0, pmax - k)))
    pt = PointSHT(grid.theta[rows], np.stack(phis), np.stack(vals), LMAX,
                  dtype=jnp.float64, spin2=True)
    e = jax.random.normal(jax.random.PRNGKey(2), (model_nstate(),))
    b = jax.random.normal(jax.random.PRNGKey(3), (model_nstate(),))
    qg, ug = sht.synthesis_spin2_state(e, b)
    qp, up = pt.synthesis_spin2_state(e, b)
    for i, r in enumerate(rows):
        for k in range(pmax):
            if vals[i][k] > 0:
                assert abs(float(qp[i, k]) - float(qg[r, cols[i][k]])) < 1e-12
                assert abs(float(up[i, k]) - float(ug[r, cols[i][k]])) < 1e-12
    gq = jax.random.normal(jax.random.PRNGKey(9), qp.shape)
    gu = jax.random.normal(jax.random.PRNGKey(10), qp.shape)
    ea, ba = pt.adjoint_synthesis_spin2_state(gq, gu)
    lhs = float(jnp.sum(qp * gq) + jnp.sum(up * gu))
    rhs = float(jnp.sum(e * ea) + jnp.sum(b * ba))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


# ---------------------------------------------------------------------------
# Split operators against the full-sphere ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spin", [0, 2])
def test_sparse_split_operators_exact(spin):
    model, mc, fields = make_holey(spin=spin)
    assert mc.has_sparse and mc.cut_w_uniform and mc.cut_w_equal_fields
    # the floor cut is smaller than the plain all-masked-rows cut
    _, mc_plain, _ = make_holey(spin=spin, sparse_split=False)
    assert mc.cut_sht.grid.nrings < mc_plain.cut_sht.grid.nrings
    var = var_of(model, fields)
    inv = jnp.where(var > 0, 1.0 / jnp.where(var > 0, var, 1.0), 0.0)
    s = jax.random.normal(jax.random.PRNGKey(1),
                          (model.nfields, model.nstate))
    q1 = model.q_apply(s, inv)
    q2 = mc.q_apply_cut(s, inv)
    np.testing.assert_allclose(np.asarray(q2), np.asarray(q1),
                               atol=1e-12 * float(jnp.max(jnp.abs(q1))))
    n1 = model.qn_apply(s)
    n2 = mc.qn_apply(s)
    np.testing.assert_allclose(np.asarray(n2), np.asarray(n1),
                               atol=1e-12 * float(jnp.max(jnp.abs(n1))))
    x = s * model.ell_mask()
    resid = model.d - model.forward(x)
    ll_pix = -0.5 * float(jnp.sum(model.noise.inv_noise * resid * resid))
    ll_cut = float(mc.data_loglike_cut(mc.beam(x)))
    assert abs(ll_cut - ll_pix) < 1e-9 * max(1.0, abs(ll_pix))


def test_sparse_mala_matches_full_path():
    model, mc, fields = make_holey(spin=2, sigma2=2.0)
    var = var_of(model, fields)
    bt = model.bt_ninv_d()
    s0 = exact_cr(jax.random.PRNGKey(4), model, var, bt)[0]
    for k in range(3):
        key = jax.random.PRNGKey(40 + k)
        s1, i1 = mala_cr(key, model, var, bt, s0, tau=0.02)
        s2, i2 = mala_cr(key, mc, var, bt, s0, tau=0.02)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1),
                                   atol=1e-9, rtol=1e-7)
        assert float(i1.accept) == float(i2.accept)


def test_sparse_aux_gibbs_preserves_posterior():
    """The split auxiliary sweep (independent floor + hole aux blocks)
    keeps the masked CR conditional stationary."""
    model, mc, fields = make_holey(spin=0, sigma2=2.0)
    var = var_of(model, fields)
    bt = model.bt_ninv_d()
    nch = 600
    keys = jax.random.split(jax.random.PRNGKey(6), nch)
    ref = jax.vmap(lambda k: cg_cr(k, model, var, bt, tol=1e-10)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(7), nch)
    moved = jax.vmap(lambda k, s: aux_gibbs_cr(k, mc, var, bt, s,
                                               n_gibbs=3)[0])(keys2, ref)
    m_ref, m_new = jnp.mean(ref, 0), jnp.mean(moved, 0)
    v_ref = jnp.var(ref, 0)
    scale = float(jnp.max(jnp.sqrt(v_ref)))
    np.testing.assert_allclose(np.asarray(m_new[0, 2:40]),
                               np.asarray(m_ref[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))
    np.testing.assert_allclose(np.asarray(jnp.var(moved, 0)[0, 2:40]),
                               np.asarray(v_ref[0, 2:40]), rtol=0.5)


def test_sparse_overrelax_preserves_posterior():
    model, mc, fields = make_holey(spin=0, sigma2=1.0)
    var = var_of(model, fields)
    bt = model.bt_ninv_d()
    nch = 600
    keys = jax.random.split(jax.random.PRNGKey(8), nch)
    ref = jax.vmap(lambda k: cg_cr(k, model, var, bt, tol=1e-10)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(9), nch)
    moved = jax.vmap(lambda k, s: overrelax_cr(k, mc, var, bt,
                                               s)[0])(keys2, ref)
    m_ref, m_new = jnp.mean(ref, 0), jnp.mean(moved, 0)
    scale = float(jnp.max(jnp.sqrt(jnp.var(ref, 0))))
    np.testing.assert_allclose(np.asarray(m_new[0, 2:40]),
                               np.asarray(m_ref[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))


# ---------------------------------------------------------------------------
# Blocked-MH fast engines on split models
# ---------------------------------------------------------------------------

def _mh_setup(mc, model, fields):
    bins = [np.arange(2, LMAX + 2)] * 2
    nb = LMAX - 1
    blocks = [[(0, nb)],
              [(0, nb - 6)] + [(i, i + 1) for i in range(nb - 6, nb)]]
    sig = [np.full(nb, 2.0), np.full(nb, 2.0)]
    dl0 = tuple(jnp.asarray(np.maximum(f[2:], 1e-3)) for f in fields)
    s_nc = jax.random.normal(jax.random.PRNGKey(3),
                             (model.nfields, model.nstate)) \
        * model.ell_mask()
    return bins, blocks, sig, dl0, s_nc


@pytest.mark.parametrize("engine", ["auto", False])
def test_sparse_engines_match_direct(engine):
    """Both the table-domain and the phi-domain sparse engines consume the
    identical random stream and compute identical accept decisions, so
    whole MH chains match the direct likelihood path bit-near."""
    model, mc, fields = make_holey(spin=2)
    bins, blocks, sig, dl0, s_nc = _mh_setup(mc, model, fields)
    ll_fn = make_nc_log_likelihood(mc, bins, all_sph=False)
    key = jax.random.PRNGKey(7)
    dl_d, info_d = nc_cls_sample(key, dl0, s_nc, ll_fn, bins, blocks, sig,
                                 n_iter=3)
    dl_f, info_f = nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks, sig,
                                     n_iter=3, mdomain=engine)
    for a, b in zip(dl_f, dl_d):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-12)
    for a, b in zip(info_f.accept, info_d.accept):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pncp_lcut_fast_path_matches_direct():
    """l_cut_identity (PNCP): the fast path with identity re-centering
    below l_cut reproduces the direct partially-non-centered likelihood
    path bit-near."""
    model, mc, fields = make_holey(spin=2)
    bins, _, sig, dl0, s_nc = _mh_setup(mc, model, fields)
    nb = LMAX - 1
    l_cut = 10
    cb = l_cut - 2
    blocks_p = [[(cb, nb)],
                [(cb, nb - 4)] + [(i, i + 1) for i in range(nb - 4, nb)]]

    def vh(dl_tuple):
        vars_ = jnp.stack([
            variance_expansion_state(unfold_bins(d, np.asarray(b), LMAX),
                                     LMAX)
            for d, b in zip(dl_tuple, bins)])
        low = expand_cl_state(
            (jnp.arange(LMAX + 1) < l_cut).astype(jnp.float64), LMAX) > 0
        return jnp.where(low[None, :], 1.0, vars_)

    def pncp_like(dl_tuple, s_):
        return mc.data_loglike_cut(mc.beam(jnp.sqrt(vh(tuple(dl_tuple)))
                                           * s_))

    key = jax.random.PRNGKey(7)
    dl_d, info_d = nc_cls_sample(key, dl0, s_nc, pncp_like, bins, blocks_p,
                                 sig, n_iter=3)
    dl_f, info_f = nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks_p,
                                     sig, n_iter=3, l_cut_identity=l_cut)
    for a, b in zip(dl_f, dl_d):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-12)
    for a, b in zip(info_f.accept, info_d.accept):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pncp_per_field_lcut_fast_path_matches_direct():
    """Per-field l_cut (field 0 fully centered — no MH blocks — field 1
    split): the fast path's per-field identity re-centering reproduces
    the direct likelihood path bit-near.  This is the production PNCP
    configuration (EE signal-dominated everywhere, BB split; measured
    per-bin ESS, PERF.md §6)."""
    model, mc, fields = make_holey(spin=2)
    bins, _, sig, dl0, s_nc = _mh_setup(mc, model, fields)
    nb = LMAX - 1
    lcs = (LMAX + 1, 10)                 # field 0 fully centered
    cb1 = lcs[1] - 2
    blocks_p = [[],
                [(cb1, nb - 4)] + [(i, i + 1) for i in range(nb - 4, nb)]]

    def vh(dl_tuple):
        vars_ = jnp.stack([
            variance_expansion_state(unfold_bins(d, np.asarray(b), LMAX),
                                     LMAX)
            for d, b in zip(dl_tuple, bins)])
        low = jnp.stack([
            expand_cl_state(
                (jnp.arange(LMAX + 1) < lc).astype(jnp.float64), LMAX) > 0
            for lc in lcs])
        return jnp.where(low, 1.0, vars_)

    def pncp_like(dl_tuple, s_):
        return mc.data_loglike_cut(mc.beam(jnp.sqrt(vh(tuple(dl_tuple)))
                                           * s_))

    key = jax.random.PRNGKey(9)
    dl_d, info_d = nc_cls_sample(key, dl0, s_nc, pncp_like, bins, blocks_p,
                                 sig, n_iter=3)
    dl_f, info_f = nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks_p,
                                     sig, n_iter=3, l_cut_identity=lcs)
    for a, b in zip(dl_f, dl_d):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-12)
    for a, b in zip(info_f.accept, info_d.accept):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pncp_scheme_fast_path_runs():
    """PNCPGibbs picks the cut fast path on a sparse model and produces
    finite chains with mixing in both segments."""
    from gibbssampler.schemes import PNCPGibbs
    model, mc, fields = make_holey(spin=2, sigma2=1e-2)
    bins = np.arange(2, LMAX + 2)
    nb = len(bins) - 1
    l_cut = 10
    cb = l_cut - 2
    blocks = [[(cb, nb)],
              [(cb, nb - 3)] + [(i, i + 1) for i in range(nb - 3, nb)]]
    sig = [np.maximum(np.abs(f[2:]), 1e-4) * 0.3 for f in fields]
    dl0 = tuple(np.maximum(f[2:], 1e-5) for f in fields)
    sch = PNCPGibbs(mc, [bins] * 2, blocks, sig, l_cut=l_cut,
                    cr_method="aux_mala")
    assert sch._use_cut_mh
    out = sch.run(jax.random.PRNGKey(12), dl0, n_iter=40, nchains=3)
    for f in range(2):
        c = np.asarray(out["dl_chains"][f])
        assert np.isfinite(c).all()
        assert c[:, -1, :cb].std() > 0 and c[:, -1, cb:].std() > 0


# ---------------------------------------------------------------------------
# HEALPix: cap-ring holes through the sparse set
# ---------------------------------------------------------------------------

def make_holey_healpix(seed=0, sigma2=0.5, layout="padded"):
    from gibbssampler.sht.healpix import make_healpix_sht
    from gibbssampler.sht.healpix_pix import galactic_band_mask
    nside = 8
    lmax = 2 * nside
    sht = make_healpix_sht(nside, lmax, dtype=jnp.float64, spin2=True,
                           layout=layout)
    mask = galactic_band_mask(nside, 20.0)
    # holes on cap rings (first ring has 4 pixels) AND in the belt
    mask[0:4] = 0.0                      # entire first cap ring
    mask[200:203] = 0.0                  # belt pixels
    mask[-3:] = 0.0                      # south cap pixels
    fields = np.stack([example_dl(lmax, "ee", amp=10.0),
                       example_dl(lmax, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), lmax, spin=2,
                                dl_fields=fields, noise_sigma2=sigma2,
                                fwhm_radians=0.1, mask=mask,
                                dtype=jnp.float64, sht=sht)
    return model, fields, lmax


@pytest.mark.parametrize("layout", ["ring", "padded"])
def test_healpix_cap_holes_sparse(layout):
    """Masks with cap-ring holes decompose (no belt-only rejection) and
    the split likelihood matches the direct pixel likelihood at the same
    omega-approximation level as the belt-only cut (tests/test_cut.py
    healpix tolerance)."""
    model, fields, lmax = make_holey_healpix(layout=layout)
    mc = with_cut_decomposition(model, sparse_split=True)
    assert mc.has_sparse
    x = jax.random.normal(jax.random.PRNGKey(2),
                          (model.nfields, model.nstate)) * model.ell_mask()
    resid = model.d - model.forward(x)
    ll_pix = -0.5 * float(jnp.sum(model.noise.inv_noise * resid * resid))
    ll_cut = float(mc.data_loglike_cut(mc.beam(x)))
    # the difference is the full-sphere omega quadrature error, identical
    # in kind to the belt-only decomposition's (test_cut.py pins ~1e-2)
    assert abs(ll_cut - ll_pix) < 3e-2 * max(1.0, abs(ll_pix))


def test_healpix_cap_holes_engines_match_direct():
    """On the same sparse HEALPix model the fast engines and the direct
    complement-likelihood path are the SAME math -> bit-near chains."""
    model, fields, lmax = make_holey_healpix(layout="padded")
    mc = with_cut_decomposition(model, sparse_split=True)
    bins = [np.arange(2, lmax + 2)] * 2
    nb = lmax - 1
    blocks = [[(0, nb)],
              [(0, nb - 5)] + [(i, i + 1) for i in range(nb - 5, nb)]]
    sig = [np.full(nb, 2.0), np.full(nb, 2.0)]
    dl0 = tuple(jnp.asarray(np.maximum(f[2:], 1e-3)) for f in fields)
    s_nc = jax.random.normal(jax.random.PRNGKey(3),
                             (model.nfields, model.nstate)) \
        * model.ell_mask()
    ll_fn = make_nc_log_likelihood(mc, bins, all_sph=False)
    key = jax.random.PRNGKey(7)
    dl_d, info_d = nc_cls_sample(key, dl0, s_nc, ll_fn, bins, blocks, sig,
                                 n_iter=3)
    for engine in ("auto", False):
        dl_f, info_f = nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                         sig, n_iter=3, mdomain=engine)
        for a, b in zip(dl_f, dl_d):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-9, atol=1e-12)
        for a, b in zip(info_f.accept, info_d.accept):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
