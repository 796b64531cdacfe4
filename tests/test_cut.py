"""Cut-sky complement decomposition: exactness of the masked operators
through cut-ring transforms (ops.model.with_cut_decomposition) and
invariance of the samplers that use them.

On the GL quadrature grid A^T diag(tau_bar q) A = (tau_bar/omega) I exactly,
so every masked pixel-diagonal operator equals its full-sky harmonic
diagonal minus a correction supported on the masked rings — the framework's
main algorithmic speedup over the reference's full-sphere qcinv transforms
(reference: CenteredGibbs.py:448-491, NonCenteredGibbs.py:333-355)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import variance_expansion_state, nstate
from gibbssampler.inference import example_dl, simulate_dataset
from gibbssampler.ops import with_cut_decomposition
from gibbssampler.samplers import (aux_gibbs_cr, overrelax_cr, mala_cr,
                                       cg_cr, exact_cr)

LMAX = 10


def make_masked(spin=0, sigma2=1.0, band=0.3, seed=0, fwhm=0.05):
    from gibbssampler.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    keep = (lat > band).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    fields = (example_dl(LMAX, amp=10.0)[None] if spin == 0 else
              np.stack([example_dl(LMAX, "ee", amp=10.0),
                        example_dl(LMAX, "bb", amp=10.0)]))
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), LMAX, spin=spin,
                                dl_fields=fields, noise_sigma2=sigma2,
                                fwhm_radians=fwhm, mask=mask,
                                dtype=jnp.float64)
    return model, with_cut_decomposition(model), fields


def var_of(model, fields):
    return jnp.stack([variance_expansion_state(jnp.asarray(f), LMAX)
                      for f in fields])


@pytest.mark.parametrize("spin", [0, 2])
def test_q_apply_cut_exact(spin):
    model, mc, fields = make_masked(spin=spin)
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


@pytest.mark.parametrize("spin", [0, 2])
def test_data_loglike_cut_exact(spin):
    model, mc, fields = make_masked(spin=spin, sigma2=0.5)
    x = jax.random.normal(jax.random.PRNGKey(2),
                          (model.nfields, model.nstate)) * model.ell_mask()
    resid = model.d - model.forward(x)
    ll_pix = -0.5 * float(jnp.sum(model.noise.inv_noise * resid * resid))
    ll_cut = float(mc.data_loglike_cut(mc.beam(x)))
    assert abs(ll_cut - ll_pix) < 1e-9 * max(1.0, abs(ll_pix))


def test_nc_likelihood_complement_exact():
    from gibbssampler.samplers import make_nc_log_likelihood
    model, mc, fields = make_masked(spin=2, sigma2=0.5)
    bins = [np.arange(2, LMAX + 2)] * 2
    ll_pix = make_nc_log_likelihood(model, bins, all_sph=False)
    ll_cut = make_nc_log_likelihood(mc, bins, all_sph=False)
    s_nc = jax.random.normal(jax.random.PRNGKey(3), (2, model.nstate))
    dl = tuple(jnp.asarray(np.maximum(f[2:], 1e-5)) for f in fields)
    a = float(ll_pix(dl, s_nc))
    b = float(ll_cut(dl, s_nc))
    assert abs(a - b) < 1e-9 * max(1.0, abs(a)), (a, b)


def test_mala_cut_matches_full_path():
    """Same key -> same MALA draw: the cut path computes identical gradient
    and log-target values, so the whole step reproduces bit-near."""
    model, mc, fields = make_masked(spin=0, sigma2=2.0)
    var = var_of(model, fields)
    bt = model.bt_ninv_d()
    s0 = exact_cr(jax.random.PRNGKey(4), model, var, bt)[0]
    for k in range(5):
        key = jax.random.PRNGKey(40 + k)
        s1, i1 = mala_cr(key, model, var, bt, s0, tau=0.02)
        s2, i2 = mala_cr(key, mc, var, bt, s0, tau=0.02)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1),
                                   atol=1e-9, rtol=1e-7)
        assert float(i1.accept) == float(i2.accept)


def test_cg_cut_matches_full_path():
    model, mc, fields = make_masked(spin=2, sigma2=1.0)
    var = var_of(model, fields)
    bt = model.bt_ninv_d()
    key = jax.random.PRNGKey(5)
    s1, _ = cg_cr(key, model, var, bt, tol=1e-11, maxiter=1500)
    s2, _ = cg_cr(key, mc, var, bt, tol=1e-11, maxiter=1500)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), atol=1e-7,
                               rtol=1e-6)


def test_aux_gibbs_cut_preserves_posterior():
    """The cut-ring aux sweep (mu exactly max N^-1, v on the cut rows only)
    keeps the masked CR conditional stationary."""
    model, mc, fields = make_masked(spin=0, sigma2=2.0)
    var = var_of(model, fields)
    bt = model.bt_ninv_d()
    nch = 600
    keys = jax.random.split(jax.random.PRNGKey(6), nch)
    ref = jax.vmap(lambda k: cg_cr(k, model, var, bt, tol=1e-10)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(7), nch)
    moved = jax.vmap(lambda k, s: aux_gibbs_cr(k, mc, var, bt, s,
                                               n_gibbs=3)[0])(keys2, ref)
    m_ref, m_new = jnp.mean(ref, 0), jnp.mean(moved, 0)
    v_ref, v_new = jnp.var(ref, 0), jnp.var(moved, 0)
    scale = float(jnp.max(jnp.sqrt(v_ref)))
    np.testing.assert_allclose(np.asarray(m_new[0, 2:40]),
                               np.asarray(m_ref[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))
    np.testing.assert_allclose(np.asarray(v_new[0, 2:40]),
                               np.asarray(v_ref[0, 2:40]), rtol=0.5)


def test_overrelax_cut_preserves_posterior():
    model, mc, fields = make_masked(spin=0, sigma2=1.0)
    var = var_of(model, fields)
    bt = model.bt_ninv_d()
    nch = 600
    keys = jax.random.split(jax.random.PRNGKey(8), nch)
    ref = jax.vmap(lambda k: cg_cr(k, model, var, bt, tol=1e-10)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(9), nch)
    moved = jax.vmap(lambda k, s: overrelax_cr(k, mc, var, bt,
                                               s)[0])(keys2, ref)
    m_ref, m_new = jnp.mean(ref, 0), jnp.mean(moved, 0)
    v_ref = jnp.var(ref, 0)
    scale = float(jnp.max(jnp.sqrt(v_ref)))
    np.testing.assert_allclose(np.asarray(m_new[0, 2:40]),
                               np.asarray(m_ref[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))


def test_asis_scheme_on_cut_model():
    """Full ASIS scheme with the cut model: runs, finite, and the
    (high-SNR) EE posterior matches the plain-model run.  The cut and plain
    runs consume different random streams (v lives on the cut rows vs the
    full grid), so only distribution-level agreement is expected; the
    exact-equality guarantees are pinned by the operator/likelihood tests
    above."""
    from gibbssampler.schemes import ASISGibbs
    model, mc, fields = make_masked(spin=2, sigma2=1e-3)   # signal-dominated
    bins = np.arange(2, LMAX + 2)
    nb = len(bins) - 1
    blocks = [(0, nb // 2), (nb // 2, nb)]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.3 for f in fields]
    dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)
    kw = dict(n_iter_mh=1, cr_method="overrelax")
    out_a = ASISGibbs(model, [bins] * 2, [blocks] * 2, sig, **kw).run(
        jax.random.PRNGKey(10), dl0, n_iter=400, nchains=4)
    out_b = ASISGibbs(mc, [bins] * 2, [blocks] * 2, sig, **kw).run(
        jax.random.PRNGKey(11), dl0, n_iter=400, nchains=4)
    for f in range(2):
        assert np.isfinite(np.asarray(out_b["dl_chains"][f])).all()
    from gibbssampler.diagnostics import summarize_chains
    a = np.asarray(out_a["dl_chains"][0])[:, 150:]   # EE, signal-dominated
    b = np.asarray(out_b["dl_chains"][0])[:, 150:]
    sa, sb = summarize_chains(a), summarize_chains(b)
    ma, mb = a.mean(axis=(0, 1)), b.mean(axis=(0, 1))
    sd = a.std(axis=(0, 1))
    se = sd * np.sqrt(1.0 / np.maximum(sa["ess"], 4)
                      + 1.0 / np.maximum(sb["ess"], 4))
    bad = np.abs(mb - ma) > 6 * se
    assert not bad.any(), (np.where(bad)[0], mb[bad], ma[bad], se[bad])


def test_nc_cls_sample_cut_matches_reference_path():
    """The rank-one fast path consumes the identical random stream and
    computes identical accept ratios, so whole MH chains must match the
    direct nc_cls_sample (complement likelihood) bit-near."""
    from gibbssampler.samplers import make_nc_log_likelihood
    from gibbssampler.samplers.cls_samplers import (nc_cls_sample,
                                                        nc_cls_sample_cut)
    model, mc, fields = make_masked(spin=2, sigma2=0.5)
    bins = [np.arange(2, LMAX + 2)] * 2
    nb = LMAX - 1
    # reference-shaped blocking satisfying the fast path's bigs-then-singles
    # global order: EE one big block, BB all per-bin blocks
    blocks = [[(0, nb)], [(i, i + 1) for i in range(nb)]]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.5 for f in fields]
    dl0 = tuple(jnp.asarray(np.maximum(f[2:], 1e-6)) for f in fields)
    s_nc = jax.random.normal(jax.random.PRNGKey(30), (2, model.nstate))
    ll_fn = make_nc_log_likelihood(mc, bins, all_sph=False)
    for k in range(3):
        key = jax.random.PRNGKey(100 + k)
        dl_a, info_a = nc_cls_sample(key, dl0, s_nc, ll_fn, bins, blocks,
                                     sig, n_iter=3)
        dl_b, info_b = nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                         sig, n_iter=3)
        for f in range(2):
            np.testing.assert_allclose(np.asarray(dl_b[f]),
                                       np.asarray(dl_a[f]),
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(info_b.accept[f]),
                                       np.asarray(info_a.accept[f]),
                                       atol=1e-12)


def test_joint_cg_on_cut_model():
    """Joint TQU CG with the cut model reproduces the plain-model draw
    (qn_apply complement is exact) under a ring mask, same key."""
    from gibbssampler.samplers import cg_joint_cr, synfast_joint
    from gibbssampler.ops import NoiseModel, SkyModel
    from gibbssampler.sht import make_sht

    lmax = LMAX
    sht = make_sht(lmax, dtype=jnp.float64, spin2=True)
    ell = np.arange(lmax + 1, dtype=np.float64)
    C = np.zeros((lmax + 1, 3, 3))
    C[:, 0, 0] = 10.0 / (1 + ell) ** 1.5
    C[:, 1, 1] = 0.5 / (1 + ell) ** 1.5
    C[:, 2, 2] = 0.05 / (1 + ell) ** 1.5
    C[:, 0, 1] = C[:, 1, 0] = 0.5 * np.sqrt(C[:, 0, 0] * C[:, 1, 1])
    C[:2] = 0.0
    s_true = synfast_joint(jax.random.PRNGKey(20), C, lmax, dtype=jnp.float64)
    lat = np.abs(np.pi / 2 - sht.grid.theta)
    keep = (lat > 0.3).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (sht.grid.nrings, sht.grid.nphi))
    noise = NoiseModel.white(0.5, sht.grid, nfields=3, mask=mask,
                             dtype=jnp.float64)
    model = SkyModel(sht=sht, noise=noise, bl=jnp.ones(lmax + 1), spin=3,
                     d=None)
    sky = model.synthesis(s_true)
    inv = noise.inv_noise
    std = jnp.where(inv > 0, 1.0 / jnp.sqrt(jnp.where(inv > 0, inv, 1.0)),
                    0.0)
    d = sky + std * jax.random.normal(jax.random.PRNGKey(21), sky.shape,
                                      dtype=jnp.float64)
    model = SkyModel(sht=sht, noise=noise, bl=model.bl, spin=3, d=d)
    mc = with_cut_decomposition(model)
    bt = model.bt_ninv_d()
    key = jax.random.PRNGKey(22)
    s1, _ = cg_joint_cr(key, model, jnp.asarray(C), bt, tol=1e-11,
                        maxiter=1500)
    s2, _ = cg_joint_cr(key, mc, jnp.asarray(C), bt, tol=1e-11, maxiter=1500)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), atol=1e-7,
                               rtol=1e-6)


def test_phi_engine_holey_mask_matches_direct(monkeypatch):
    """Realistic-mask fallback: a mask with apodized band + point-source
    holes (azimuthally NON-uniform w, so the m-domain engines are
    ineligible) goes through the memory-bounded chunked phi-domain engine,
    which must equal the direct nc_cls_sample path bit-near over whole
    chains (fp64).  GS_PHI_CHUNK is forced tiny so several chunks and the
    cross-chunk residual handoff are exercised."""
    from gibbssampler.samplers import cls_samplers as cs
    from gibbssampler.schemes import ASISGibbs
    from gibbssampler.sht import gauss_legendre_grid

    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    # apodized band: smooth ramp over ~0.15 rad instead of a hard edge
    keep = np.clip((lat - 0.25) / 0.15, 0.0, 1.0)
    mask = np.broadcast_to(keep[:, None],
                           (grid.nrings, grid.nphi)).copy()
    # point-source holes off the band, at several latitudes/longitudes
    rng = np.random.default_rng(7)
    for _ in range(6):
        r = rng.integers(0, grid.nrings)
        p = rng.integers(0, grid.nphi)
        mask[r, p: p + 2] = 0.0
    fields = np.stack([example_dl(LMAX, "ee", amp=10.0),
                       example_dl(LMAX, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(4), LMAX, spin=2,
                                dl_fields=fields, noise_sigma2=0.5,
                                fwhm_radians=0.05, mask=mask,
                                dtype=jnp.float64)
    # pin the NON-split decomposition: this test exercises the chunked
    # phi-domain fallback on a genuinely azimuthally non-uniform w_cut
    # (the sparse-split path, which round 5 made the default for such
    # masks, is covered by tests/test_sparse.py)
    mc = with_cut_decomposition(model, sparse_split=False)
    assert not mc.cut_w_uniform
    assert not cs._mdomain_eligible(mc)
    monkeypatch.setattr(cs, "_PHI_CHUNK", 3)
    bins = np.arange(2, LMAX + 2)
    nb = len(bins) - 1
    blocks_ee = [(0, nb)]
    blocks_bb = [(0, nb // 2)] + [(i, i + 1) for i in range(nb // 2, nb)]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.5 for f in fields]
    dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)
    kw = dict(n_iter_mh=2, cr_method="overrelax")
    fast = ASISGibbs(mc, [bins] * 2, [blocks_ee, blocks_bb], sig, **kw)
    assert fast._use_cut_mh
    direct = ASISGibbs(mc, [bins] * 2, [blocks_ee, blocks_bb], sig,
                       mh_fast="off", **kw)
    out_f = fast.run(jax.random.PRNGKey(51), dl0, n_iter=25, nchains=2)
    out_d = direct.run(jax.random.PRNGKey(51), dl0, n_iter=25, nchains=2)
    for f in range(2):
        np.testing.assert_allclose(np.asarray(out_f["dl_chains"][f]),
                                   np.asarray(out_d["dl_chains"][f]),
                                   rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(np.asarray(out_f["mh_accept"][f]),
                                   np.asarray(out_d["mh_accept"][f]),
                                   atol=1e-12)
    # kernel-level (eager, jit-cache-proof): chunk 3 == chunk 1000 bit-near
    dl0j = tuple(jnp.asarray(d) for d in dl0)
    s_nc = jax.random.normal(jax.random.PRNGKey(33), (2, model.nstate))
    key = jax.random.PRNGKey(61)
    dl_a, _ = cs.nc_cls_sample_cut(key, dl0j, s_nc, mc, [bins] * 2,
                                   [blocks_ee, blocks_bb], sig, n_iter=2,
                                   mdomain=False)
    monkeypatch.setattr(cs, "_PHI_CHUNK", 1000)
    dl_b, _ = cs.nc_cls_sample_cut(key, dl0j, s_nc, mc, [bins] * 2,
                                   [blocks_ee, blocks_bb], sig, n_iter=2,
                                   mdomain=False)
    for f in range(2):
        np.testing.assert_allclose(np.asarray(dl_a[f]), np.asarray(dl_b[f]),
                                   rtol=1e-9, atol=1e-12)


def test_asis_fast_path_matches_direct_scheme():
    """Full ASIS chains with the rank-one MH fast path equal the direct
    nc_cls_sample path bit-near (same model, same keys) — the scheme-level
    guarantee on top of the kernel-level test above."""
    from gibbssampler.schemes import ASISGibbs
    _, mc, fields = make_masked(spin=2, sigma2=0.5)
    bins = np.arange(2, LMAX + 2)
    nb = len(bins) - 1
    blocks_ee = [(0, nb)]
    blocks_bb = [(0, nb // 2)] + [(i, i + 1) for i in range(nb // 2, nb)]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.5 for f in fields]
    dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)
    kw = dict(n_iter_mh=2, cr_method="overrelax")
    fast = ASISGibbs(mc, [bins] * 2, [blocks_ee, blocks_bb], sig, **kw)
    assert fast._use_cut_mh
    # mh_fast is pytree aux data, so the override survives jit round-trips
    direct = ASISGibbs(mc, [bins] * 2, [blocks_ee, blocks_bb], sig,
                       mh_fast="off", **kw)
    assert not direct._use_cut_mh
    out_f = fast.run(jax.random.PRNGKey(50), dl0, n_iter=30, nchains=2)
    out_d = direct.run(jax.random.PRNGKey(50), dl0, n_iter=30, nchains=2)
    for f in range(2):
        np.testing.assert_allclose(np.asarray(out_f["dl_chains"][f]),
                                   np.asarray(out_d["dl_chains"][f]),
                                   rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(np.asarray(out_f["mh_accept"][f]),
                                   np.asarray(out_d["mh_accept"][f]),
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# HEALPix cut decomposition (the reference's production grid)
#
# Exact pieces (machine precision on any grid): the belt-row cut transform
# and its adjoint, hence everything supported on the masked pixels.  The
# smooth full-sphere terms use A^T A ~= I/omega — the iter=0 quadrature
# algebra the reference itself assumes in its full-sky solves and aux
# conditionals (config.py:72-73, CenteredGibbs.py:108-132, :676-729).
# These tests pin both the exact pieces and the measured size of the
# omega-level error.
# ---------------------------------------------------------------------------


def make_masked_healpix(spin=2, sigma2=0.5, band_deg=20.0, seed=0,
                        fwhm=0.05, nside=8, layout="padded"):
    from gibbssampler.sht.healpix import make_healpix_sht
    from gibbssampler.sht.healpix_pix import galactic_band_mask
    lmax = 2 * nside
    sht = make_healpix_sht(nside, lmax, dtype=jnp.float64,
                           spin2=(spin >= 2), layout=layout)
    mask = galactic_band_mask(nside, band_deg)
    fields = (example_dl(lmax, amp=10.0)[None] if spin == 0 else
              np.stack([example_dl(lmax, "ee", amp=10.0),
                        example_dl(lmax, "bb", amp=10.0)]))
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), lmax, spin=spin,
                                dl_fields=fields, noise_sigma2=sigma2,
                                fwhm_radians=fwhm, mask=mask,
                                dtype=jnp.float64, sht=sht)
    return model, with_cut_decomposition(model), fields


def _healpix_cut_idx(model):
    from gibbssampler.ops.model import healpix_belt_rows
    tau = np.asarray(model.noise.tau)
    q = np.asarray(model.noise.q_map)
    tb = tau.max(axis=1)
    w = np.maximum(q * (tb[:, None] - tau), 0.0)
    cols = np.where((w > 1e-12 * tb.max()).any(0))[0]
    return healpix_belt_rows(model.sht, cols)


@pytest.mark.parametrize("spin,layout",
                         [(0, "padded"), (2, "padded"), (2, "ring")])
def test_healpix_cut_transform_exact(spin, layout):
    """The belt-row cut transform evaluates the same pointwise sums as the
    full HEALPix synthesis on those pixels, and its adjoint is the exact
    transpose — machine precision, no quadrature involved."""
    model, mc, fields = make_masked_healpix(spin=spin, layout=layout)
    s = jax.random.normal(jax.random.PRNGKey(1),
                          (model.nfields, model.nstate)) * model.ell_mask()
    full = np.asarray(model.synthesis(s))
    cut = np.asarray(mc.synthesis_cut(s))
    rows, idx = _healpix_cut_idx(model)
    np.testing.assert_allclose(cut, full[:, idx],
                               atol=1e-13 * np.abs(full).max())
    f = jnp.asarray(np.random.default_rng(2).normal(size=cut.shape))
    lhs = float(jnp.sum(jnp.asarray(cut) * f))
    rhs = float(jnp.sum(s * mc.adjoint_synthesis_cut(f)))
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


def test_healpix_cut_omega_error_measured():
    """Quantifies the omega-level approximation of the smooth full-sphere
    terms on HEALPix: the noise-term operator and log-likelihood differences
    agree with the exact pixel computation to ~1e-2 at lmax = 2 nside (the
    hardest band limit); exactness on this grid is only available through
    the full-transform (non-cut) paths."""
    model, mc, fields = make_masked_healpix(spin=2)
    s = jax.random.normal(jax.random.PRNGKey(1),
                          (2, model.nstate)) * model.ell_mask()
    s2 = jax.random.normal(jax.random.PRNGKey(3),
                           (2, model.nstate)) * model.ell_mask()
    n1 = np.asarray(model.qn_apply(s))
    n2 = np.asarray(mc.qn_apply(s))
    rel_op = np.abs(n2 - n1).max() / np.abs(n1).max()
    assert rel_op < 0.05, rel_op

    def llpix(x):
        r = model.d - model.forward(x)
        return float(-0.5 * jnp.sum(model.noise.inv_noise * r * r))

    dpix = llpix(s) - llpix(s2)
    dcut = float(mc.data_loglike_cut(mc.beam(s))
                 - mc.data_loglike_cut(mc.beam(s2)))
    assert abs(dcut - dpix) < 0.05 * abs(dpix), (dcut, dpix)


def test_healpix_aux_cut_matches_noncut_kernel():
    """The cut aux sweep and the full-transform aux sweep implement the
    SAME (reference-grade) kernel on HEALPix — the gap operator is exactly
    supported on the masked pixels and sigma uses the same omega diagonal in
    both — so their outputs agree in distribution.  Moments over many keys
    from a common start must match to MC tolerance."""
    model, mc, fields = make_masked_healpix(spin=0, sigma2=2.0)
    var = var_of_lmax(model, fields, model.lmax)
    bt = model.bt_ninv_d()
    s0 = exact_cr(jax.random.PRNGKey(4), model, var, bt)[0]
    nch = 400
    keys = jax.random.split(jax.random.PRNGKey(5), nch)
    a = jax.vmap(lambda k: aux_gibbs_cr(k, model, var, bt, s0,
                                        n_gibbs=2)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(6), nch)
    b = jax.vmap(lambda k: aux_gibbs_cr(k, mc, var, bt, s0,
                                        n_gibbs=2)[0])(keys2)
    ma, mb = jnp.mean(a, 0), jnp.mean(b, 0)
    va, vb = jnp.var(a, 0), jnp.var(b, 0)
    scale = float(jnp.max(jnp.sqrt(va)))
    np.testing.assert_allclose(np.asarray(mb[0, 2:40]),
                               np.asarray(ma[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))
    sl = np.asarray(va[0, 2:40]) > 1e-12 * float(jnp.max(va))
    np.testing.assert_allclose(np.asarray(vb[0, 2:40])[sl],
                               np.asarray(va[0, 2:40])[sl], rtol=0.5)


def test_healpix_asis_fast_path_matches_direct():
    """On the HEALPix cut model the rank-one blocked-MH fast path is exact
    algebra on the same cut likelihood, so fast and direct chains match
    bit-near (the omega approximation is in the likelihood itself, not in
    the fast path)."""
    from gibbssampler.schemes import ASISGibbs
    _, mc, fields = make_masked_healpix(spin=2, sigma2=0.5)
    lmax = mc.lmax
    bins = np.arange(2, lmax + 2)
    nb = len(bins) - 1
    blocks_ee = [(0, nb)]
    blocks_bb = [(0, nb // 2)] + [(i, i + 1) for i in range(nb // 2, nb)]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.5 for f in fields]
    dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)
    kw = dict(n_iter_mh=2, cr_method="overrelax")
    fast = ASISGibbs(mc, [bins] * 2, [blocks_ee, blocks_bb], sig, **kw)
    assert fast._use_cut_mh
    direct = ASISGibbs(mc, [bins] * 2, [blocks_ee, blocks_bb], sig,
                       mh_fast="off", **kw)
    out_f = fast.run(jax.random.PRNGKey(50), dl0, n_iter=25, nchains=2)
    out_d = direct.run(jax.random.PRNGKey(50), dl0, n_iter=25, nchains=2)
    for f in range(2):
        np.testing.assert_allclose(np.asarray(out_f["dl_chains"][f]),
                                   np.asarray(out_d["dl_chains"][f]),
                                   rtol=1e-7, atol=1e-10)


def test_healpix_asis_cut_posterior_matches_exact():
    """Chain-level bound on the omega bias: flagship-style ASIS on the
    HEALPix cut model vs the exact-pixel (non-cut) model — signal-dominated
    EE posteriors agree within Monte-Carlo tolerance."""
    from gibbssampler.schemes import ASISGibbs
    model, mc, fields = make_masked_healpix(spin=2, sigma2=1e-3)
    lmax = mc.lmax
    bins = np.arange(2, lmax + 2)
    nb = len(bins) - 1
    blocks = [(0, nb // 2), (nb // 2, nb)]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.3 for f in fields]
    dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)
    kw = dict(n_iter_mh=1, cr_method="overrelax")
    out_a = ASISGibbs(model, [bins] * 2, [blocks] * 2, sig, **kw).run(
        jax.random.PRNGKey(10), dl0, n_iter=400, nchains=4)
    out_b = ASISGibbs(mc, [bins] * 2, [blocks] * 2, sig, **kw).run(
        jax.random.PRNGKey(11), dl0, n_iter=400, nchains=4)
    from gibbssampler.diagnostics import summarize_chains
    a = np.asarray(out_a["dl_chains"][0])[:, 150:]
    b = np.asarray(out_b["dl_chains"][0])[:, 150:]
    sa, sb = summarize_chains(a), summarize_chains(b)
    ma, mb = a.mean(axis=(0, 1)), b.mean(axis=(0, 1))
    sd = a.std(axis=(0, 1))
    se = sd * np.sqrt(1.0 / np.maximum(sa["ess"], 4)
                      + 1.0 / np.maximum(sb["ess"], 4))
    bad = np.abs(mb - ma) > 6 * se
    assert not bad.any(), (np.where(bad)[0], mb[bad], ma[bad], se[bad])


def var_of_lmax(model, fields, lmax):
    return jnp.stack([variance_expansion_state(jnp.asarray(f), lmax)
                      for f in fields])


def test_cut_exact_with_apodized_mask():
    """The complement identity holds for any tau <= tau_bar, including
    apodized (fractional) masks — exactness does not require a binary cut."""
    from gibbssampler.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    x = np.clip((lat - 0.25) / 0.25, 0.0, 1.0)
    apo = 0.5 * (1.0 - np.cos(np.pi * x))            # smooth ring profile
    mask = np.broadcast_to(apo[:, None], (grid.nrings, grid.nphi))
    fields = np.stack([example_dl(LMAX, "ee", amp=10.0),
                       example_dl(LMAX, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(3), LMAX, spin=2,
                                dl_fields=fields, noise_sigma2=0.5,
                                mask=mask, dtype=jnp.float64)
    mc = with_cut_decomposition(model)
    var = var_of(model, fields)
    inv = jnp.where(var > 0, 1.0 / jnp.where(var > 0, var, 1.0), 0.0)
    s = jax.random.normal(jax.random.PRNGKey(4), (2, model.nstate))
    np.testing.assert_allclose(
        np.asarray(mc.q_apply_cut(s, inv)), np.asarray(model.q_apply(s, inv)),
        atol=1e-11 * float(jnp.max(jnp.abs(model.q_apply(s, inv)))))
    x2 = s * model.ell_mask()
    resid = model.d - model.forward(x2)
    ll_pix = -0.5 * float(jnp.sum(model.noise.inv_noise * resid * resid))
    ll_cut = float(mc.data_loglike_cut(mc.beam(x2)))
    assert abs(ll_cut - ll_pix) < 1e-9 * max(1.0, abs(ll_pix))


# ---------------------------------------------------------------------------
# m-domain blocked-MH fast path (ring half-spectrum sweep)
# ---------------------------------------------------------------------------

def test_ring_halfspec_identities():
    """ring_cs_lsel_spin2 / ring_cs_of_maps / ring_dot_weights reproduce the
    per-bin pixel maps and their w-weighted dot products exactly (the
    algebra behind nc_cls_sample_cut's m-domain sweep)."""
    model, mc, fields = make_masked(spin=2, sigma2=0.5)
    cut = mc.cut_sht
    rng = np.random.default_rng(0)
    e = jnp.asarray(rng.standard_normal(model.nstate))
    b = jnp.asarray(rng.standard_normal(model.nstate))
    ellbins = [(2, 3), (3, 4), (5, 9), (9, 10)]     # unit + wide mix
    j_idx = np.concatenate([np.arange(lo, hi) for lo, hi in ellbins])
    seg = np.zeros((len(j_idx), len(ellbins)))
    k = 0
    for i, (lo, hi) in enumerate(ellbins):
        seg[k: k + hi - lo, i] = 1.0
        k += hi - lo
    sel = np.zeros((len(ellbins), LMAX + 1))
    for i, (lo, hi) in enumerate(ellbins):
        sel[i, lo:hi] = 1.0
    q_ref, u_ref = cut.synthesis_spin2_state_lsel(e, b, jnp.asarray(sel))
    (Qc, Qs), (Uc, Us) = cut.ring_cs_lsel_spin2(e, b, j_idx, seg)
    nphi = cut.nphi
    th = 2 * np.pi * np.arange(nphi) / nphi
    cosm = np.cos(np.outer(np.arange(LMAX + 1), th))
    sinm = np.sin(np.outer(np.arange(LMAX + 1), th))
    q_m = (np.einsum("brm,mj->brj", np.asarray(Qc), cosm)
           + np.einsum("brm,mj->brj", np.asarray(Qs), sinm))
    u_m = (np.einsum("brm,mj->brj", np.asarray(Uc), cosm)
           + np.einsum("brm,mj->brj", np.asarray(Us), sinm))
    scale = np.abs(np.asarray(q_ref)).max()
    np.testing.assert_allclose(q_m, np.asarray(q_ref), atol=1e-12 * scale)
    np.testing.assert_allclose(u_m, np.asarray(u_ref), atol=1e-12 * scale)
    # w-weighted dot products: Parseval vs pixel domain
    pwc, pws = cut.ring_dot_weights()
    w_ring = np.asarray(mc.w_cut)[0, :, 0]
    q_i_m = (np.einsum("r,brm,m->b", w_ring, np.asarray(Qc) ** 2,
                       np.asarray(pwc))
             + np.einsum("r,brm,m->b", w_ring, np.asarray(Qs) ** 2,
                         np.asarray(pws)))
    q_i_p = np.einsum("r,brj->b", w_ring, np.asarray(q_ref) ** 2)
    np.testing.assert_allclose(q_i_m, q_i_p, rtol=1e-11)
    r = rng.standard_normal(np.asarray(q_ref).shape[1:])
    Rc, Rs = cut.ring_cs_of_maps(jnp.asarray(r))
    rho_m = (np.einsum("brm,rm->b", np.asarray(Qc), np.asarray(Rc))
             + np.einsum("brm,rm->b", np.asarray(Qs), np.asarray(Rs)))
    rho_p = np.einsum("rj,brj->b", r, np.asarray(q_ref))
    np.testing.assert_allclose(rho_m, rho_p, rtol=1e-10)


def test_ring_dot_weights_nyquist():
    """At nphi = 2 lmax (the HEALPix belt case) the Nyquist column m = lmax
    carries pw_cos = nphi, pw_sin = 0, keeping the Parseval dot product
    exact."""
    from gibbssampler.sht.grids import SphereGrid
    from gibbssampler.sht.transform import SHT
    lmax = 8
    nphi = 2 * lmax
    theta = np.array([1.2, 1.5, 1.9])
    g = SphereGrid(name="nyq", theta=theta, weights=np.ones(3), nphi=nphi,
                   phi0=np.array([0.0, 0.1, 0.0]))
    sht = SHT(g, lmax, dtype=jnp.float64, spin2=True, allow_aliasing=True)
    rng = np.random.default_rng(1)
    from gibbssampler.harmonics import nstate as _nstate
    e = jnp.asarray(rng.standard_normal(_nstate(lmax)))
    b = jnp.asarray(rng.standard_normal(_nstate(lmax)))
    j_idx = np.arange(2, lmax + 1)
    (Qc, Qs), (Uc, Us) = sht.ring_cs_lsel_spin2(e, b, j_idx, None)
    sel = np.zeros((len(j_idx), lmax + 1))
    for i, l in enumerate(j_idx):
        sel[i, l] = 1.0
    q_ref, u_ref = sht.synthesis_spin2_state_lsel(e, b, jnp.asarray(sel))
    pwc, pws = sht.ring_dot_weights()
    assert float(pwc[lmax]) == nphi and float(pws[lmax]) == 0.0
    dot_m = (np.einsum("brm,crm,m->bc", np.asarray(Qc), np.asarray(Qc),
                       np.asarray(pwc))
             + np.einsum("brm,crm,m->bc", np.asarray(Qs), np.asarray(Qs),
                         np.asarray(pws)))
    dot_p = np.einsum("brj,crj->bc", np.asarray(q_ref), np.asarray(q_ref))
    np.testing.assert_allclose(dot_m, dot_p, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("spin", [2, 3])
def test_mdomain_sweep_matches_phi_sweep(spin):
    """nc_cls_sample_cut's m-domain sweep consumes the identical random
    stream and computes the same accept ratios as the phi-domain rank-one
    path, so whole chains must match bit-near (fp64)."""
    from gibbssampler.samplers import cls_samplers as cs
    from gibbssampler.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    mask = np.broadcast_to((lat > 0.3)[:, None],
                           (grid.nrings, grid.nphi)).astype(np.float64)
    if spin == 2:
        fields = np.stack([example_dl(LMAX, "ee", amp=10.0),
                           example_dl(LMAX, "bb", amp=10.0)])
    else:
        fields = np.stack([example_dl(LMAX, "tt", amp=10.0),
                           example_dl(LMAX, "ee", amp=10.0),
                           example_dl(LMAX, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(3), LMAX, spin=spin,
                                dl_fields=fields, noise_sigma2=0.5,
                                mask=mask, dtype=jnp.float64)
    mc = with_cut_decomposition(model)
    assert cs._mdomain_eligible(mc)
    nf = mc.nfields
    bins = [np.arange(2, LMAX + 2)] * nf
    nb = LMAX - 1
    # bigs then singles (incl. a wide single-bin... per-bin singles across
    # ALL fields so the T-field spin-0 path is exercised at spin 3)
    blocks = [[(0, nb // 2)] + [(i, i + 1) for i in range(nb // 2, nb)]
              for _ in range(nf)]
    # global order must be bigs-then-singles: make the first fields all-big
    blocks = ([[(0, nb)] for _ in range(nf - 1)]
              + [[(0, nb // 2)] + [(i, i + 1) for i in range(nb // 2, nb)]])
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.5 for f in fields]
    dl0 = tuple(jnp.asarray(np.maximum(f[2:], 1e-6)) for f in fields)
    s_nc = jax.random.normal(jax.random.PRNGKey(30), (nf, model.nstate))
    for k in range(2):
        key = jax.random.PRNGKey(50 + k)
        dl_a, info_a = cs.nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                            sig, n_iter=3, mdomain=False)
        dl_b, info_b = cs.nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                            sig, n_iter=3, mdomain=True)
        for f in range(nf):
            np.testing.assert_allclose(np.asarray(dl_b[f]),
                                       np.asarray(dl_a[f]),
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(info_b.accept[f]),
                                       np.asarray(info_a.accept[f]),
                                       atol=1e-12)


@pytest.mark.parametrize("spin", [0, 2])
def test_mdomain_sweep_matches_phi_sweep_healpix(spin):
    """ALL m-domain singles engines on a PHASED NYQUIST grid: HEALPix belt
    rows carry per-ring phi0 offsets (has_phase=True) and sit exactly at
    nphi = 2 lmax, so both the coefficient engine's rotated (Cc, Cs)
    handling and the table engine's rotation + Nyquist-column path must
    reproduce the phi-domain rank-one path bit-near over whole chains
    (fp64) — the production HEALPix paths these engines exist for."""
    from gibbssampler.samplers import cls_samplers as cs
    model, mc, fields = make_masked_healpix(spin=spin, sigma2=0.5)
    lmax = model.lmax
    assert cs._mdomain_eligible(mc)
    assert getattr(mc.cut_sht, "has_phase", False)
    assert mc.cut_sht.nphi == 2 * lmax          # Nyquist grid
    assert mc.cut_w_equal_fields                # table engine eligible
    nf = mc.nfields
    bins = [np.arange(2, lmax + 2)] * nf
    nb = lmax - 1
    blocks = ([[(0, nb)] for _ in range(nf - 1)]
              + [[(0, nb // 2)] + [(i, i + 1) for i in range(nb // 2, nb)]])
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.5 for f in fields]
    dl0 = tuple(jnp.asarray(np.maximum(f[2:], 1e-6)) for f in fields)
    s_nc = jax.random.normal(jax.random.PRNGKey(32), (nf, model.nstate))
    key = jax.random.PRNGKey(60)
    dl_a, info_a = cs.nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                        sig, n_iter=3, mdomain=False)
    # mdomain=True -> table engine (phase + Nyquist paths);
    # mdomain="m"  -> coefficient engine (rotated half-spectra)
    for md in (True, "m"):
        dl_b, info_b = cs.nc_cls_sample_cut(key, dl0, s_nc, mc, bins,
                                            blocks, sig, n_iter=3,
                                            mdomain=md)
        for f in range(nf):
            np.testing.assert_allclose(np.asarray(dl_b[f]),
                                       np.asarray(dl_a[f]),
                                       rtol=1e-9, atol=1e-12, err_msg=f"{md}")
            np.testing.assert_allclose(np.asarray(info_b.accept[f]),
                                       np.asarray(info_a.accept[f]),
                                       atol=1e-12, err_msg=f"{md}")


def test_mdomain_singles_spanning_fields_spin3():
    """Singles spanning two fields (T and B) exercise the field-pure
    chunking and the cross-field residual handoff through (Rc, Rs)."""
    from gibbssampler.samplers import cls_samplers as cs
    from gibbssampler.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    mask = np.broadcast_to((lat > 0.3)[:, None],
                           (grid.nrings, grid.nphi)).astype(np.float64)
    fields = np.stack([example_dl(LMAX, "tt", amp=10.0),
                       example_dl(LMAX, "ee", amp=10.0),
                       example_dl(LMAX, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(5), LMAX, spin=3,
                                dl_fields=fields, noise_sigma2=0.5,
                                mask=mask, dtype=jnp.float64)
    mc = with_cut_decomposition(model)
    nb = LMAX - 1
    bins = [np.arange(2, LMAX + 2)] * 3
    # no bigs at all: every block is a single, spanning all three fields
    blocks = [[(i, i + 1) for i in range(nb)] for _ in range(3)]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.5 for f in fields]
    dl0 = tuple(jnp.asarray(np.maximum(f[2:], 1e-6)) for f in fields)
    s_nc = jax.random.normal(jax.random.PRNGKey(31), (3, model.nstate))
    key = jax.random.PRNGKey(77)
    dl_a, info_a = cs.nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                        sig, n_iter=3, mdomain=False)
    dl_b, info_b = cs.nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                        sig, n_iter=3, mdomain=True)
    for f in range(3):
        np.testing.assert_allclose(np.asarray(dl_b[f]), np.asarray(dl_a[f]),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(info_b.accept[f]),
                                   np.asarray(info_a.accept[f]), atol=1e-12)


def test_tdomain_engine_matches_coefficient_engine():
    """The table-domain singles engine (ell-pair weight tables, no per-bin
    (ring, m) planes) computes the same chains as the coefficient m-domain
    engine pinned with mdomain="m"."""
    from gibbssampler.samplers import cls_samplers as cs
    model, mc, fields = make_masked(spin=2, sigma2=0.5)
    assert mc.cut_w_uniform and mc.cut_w_equal_fields
    assert not mc.cut_sht.has_phase
    nb = LMAX - 1
    bins = [np.arange(2, LMAX + 2)] * 2
    blocks = [[(0, nb)],
              [(0, nb // 2)] + [(i, i + 1) for i in range(nb // 2, nb)]]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.5 for f in fields]
    dl0 = tuple(jnp.asarray(np.maximum(f[2:], 1e-6)) for f in fields)
    s_nc = jax.random.normal(jax.random.PRNGKey(40), (2, model.nstate))
    key = jax.random.PRNGKey(41)
    dl_m, info_m = cs.nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                        sig, n_iter=3, mdomain="m")
    dl_t, info_t = cs.nc_cls_sample_cut(key, dl0, s_nc, mc, bins, blocks,
                                        sig, n_iter=3, mdomain="auto")
    for f in range(2):
        np.testing.assert_allclose(np.asarray(dl_t[f]), np.asarray(dl_m[f]),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(info_t.accept[f]),
                                   np.asarray(info_m.accept[f]), atol=1e-12)
