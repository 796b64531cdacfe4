"""HEALPix-grid SHT correctness (reference data-format parity,
SURVEY.md 2.2 item 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import nflat, flat_to_healpy, index_maps
from gibbssampler.sht.healpix import healpix_geometry, make_healpix_sht

NSIDE = 8
LMAX = 2 * NSIDE


@pytest.fixture(scope="module")
def hsht():
    return make_healpix_sht(NSIDE, LMAX, dtype=jnp.float64, spin2=True)


def test_geometry_invariants():
    geo = healpix_geometry(NSIDE)
    assert geo.npix == 12 * NSIDE ** 2
    assert geo.nrings == 4 * NSIDE - 1
    assert int(geo.nphi.sum()) == geo.npix
    # ring sizes: caps 4i, belt 4 nside, symmetric
    assert geo.nphi[0] == 4 and geo.nphi[-1] == 4
    assert (geo.nphi[NSIDE - 1: 3 * NSIDE] == 4 * NSIDE).all()
    np.testing.assert_allclose(geo.theta, np.pi - geo.theta[::-1], atol=1e-14)
    # z values in (-1, 1), strictly decreasing theta increasing
    assert (np.diff(geo.theta) > 0).all()


def pixel_angles(geo):
    """(theta, phi) of every pixel in RING order."""
    th, ph = [], []
    for r in range(geo.nrings):
        n = geo.nphi[r]
        th.append(np.full(n, geo.theta[r]))
        ph.append(geo.phi0[r] + 2.0 * np.pi * np.arange(n) / n)
    return np.concatenate(th), np.concatenate(ph)


def test_synthesis_matches_direct_sum(hsht):
    """Brute-force sum over sph_harm_y at a set of pixels — exactness of the
    synthesis operator (including cap phase offsets)."""
    from scipy.special import sph_harm_y
    rng = np.random.default_rng(0)
    flat = jnp.asarray(rng.normal(size=nflat(LMAX)))
    m = np.asarray(hsht.synthesis(flat))
    alm = np.asarray(flat_to_healpy(flat, LMAX))
    geo = hsht.geo
    th, ph = pixel_angles(geo)
    # sample pixels across caps and belt
    for p in [0, 3, 17, geo.npix // 2, geo.npix - 5, geo.npix - 1]:
        tot = 0.0
        for l in range(LMAX + 1):
            for mm in range(l + 1):
                idx = mm * (2 * LMAX + 1 - mm) // 2 + l
                y = sph_harm_y(l, mm, th[p], ph[p])
                c = alm[idx] * y
                tot += c.real if mm == 0 else 2 * c.real
        assert abs(m[p] - tot) < 1e-10, (p, m[p], tot)


def test_adjointness_spin0(hsht):
    kx, ky = jax.random.split(jax.random.PRNGKey(1))
    x = jax.random.normal(kx, (nflat(LMAX),))
    y = jax.random.normal(ky, (hsht.geo.npix,))
    lhs = float(jnp.vdot(hsht.synthesis(x), y))
    rhs = float(jnp.vdot(x, hsht.adjoint_synthesis(y)))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_adjointness_spin2(hsht):
    key = jax.random.PRNGKey(2)
    ke, kb, kq, ku = jax.random.split(key, 4)
    mask = jnp.asarray(index_maps(LMAX).ell_of >= 2)
    e = jax.random.normal(ke, (nflat(LMAX),)) * mask
    b = jax.random.normal(kb, (nflat(LMAX),)) * mask
    q = jax.random.normal(kq, (hsht.geo.npix,))
    u = jax.random.normal(ku, (hsht.geo.npix,))
    qs, us = hsht.synthesis_spin2(e, b)
    lhs = float(jnp.vdot(qs, q) + jnp.vdot(us, u))
    ea, ba = hsht.adjoint_synthesis_spin2(q, u)
    rhs = float(jnp.vdot(e, ea) + jnp.vdot(b, ba))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_analysis_approximate_roundtrip(hsht):
    """iter=0 analysis is an approximate inverse on HEALPix (the reference's
    assumption A^T A ~= Npix/4pi I); error at the few-percent level for a
    band-limited field at lmax = 2 nside."""
    key = jax.random.PRNGKey(3)
    # smooth field: power only at l <= nside
    flat = jax.random.normal(key, (nflat(LMAX),))
    ell_of = jnp.asarray(index_maps(LMAX).ell_of)
    flat = jnp.where(ell_of <= NSIDE, flat, 0.0)
    m = hsht.synthesis(flat)
    back = hsht.analysis(m)
    err = float(jnp.linalg.norm(back - flat) / jnp.linalg.norm(flat))
    assert err < 0.05, err


def test_spin2_pure_e_analytic(hsht):
    e = jnp.zeros(nflat(LMAX)).at[2].set(1.0)
    b = jnp.zeros(nflat(LMAX))
    q, u = hsht.synthesis_spin2(e, b)
    geo = hsht.geo
    th, ph = pixel_angles(geo)
    expect_q = -np.sqrt(15.0 / (32.0 * np.pi)) * np.sin(th) ** 2
    np.testing.assert_allclose(np.asarray(q), expect_q, atol=1e-12)
    np.testing.assert_allclose(np.asarray(u), 0.0, atol=1e-12)


def test_batched(hsht):
    key = jax.random.PRNGKey(4)
    flat = jax.random.normal(key, (3, nflat(LMAX)))
    m = jax.jit(hsht.synthesis)(flat)
    assert m.shape == (3, hsht.geo.npix)
    single = hsht.synthesis(flat[1])
    np.testing.assert_allclose(np.asarray(m[1]), np.asarray(single),
                               atol=1e-12)


def test_gibbs_on_healpix_grid():
    """End-to-end: centered Gibbs runs on the HEALPix grid through the same
    SkyModel/scheme machinery (reference parity configuration: uniform
    pixels, q = 1, CG constrained realization)."""
    from gibbssampler.inference import example_dl
    from gibbssampler.ops import NoiseModel, SkyModel
    from gibbssampler.schemes import CenteredGibbs
    from gibbssampler.harmonics import variance_expansion_state, nstate

    sht = make_healpix_sht(NSIDE, LMAX, dtype=jnp.float64, spin2=False)
    dl = example_dl(LMAX, amp=10.0)
    var = variance_expansion_state(jnp.asarray(dl), LMAX)
    key = jax.random.PRNGKey(5)
    s_true = jnp.sqrt(var) * jax.random.normal(key, (nstate(LMAX),))
    sky = sht.synthesis_state(s_true)[None]      # (1, npix)
    sigma2 = 1.0
    noise = NoiseModel.white_healpix(sigma2, sht.geo, nfields=1,
                                     dtype=jnp.float64)
    d = sky + np.sqrt(sigma2) * jax.random.normal(
        jax.random.PRNGKey(6), sky.shape)
    model = SkyModel(sht=sht, noise=noise, bl=jnp.ones(LMAX + 1),
                     spin=0, d=d)
    bins = np.arange(2, LMAX + 2)
    scheme = CenteredGibbs(model, [bins], cr_method="cg",
                           cr_options={"cg_tol": 1e-8, "cg_maxiter": 300})
    out = scheme.run(jax.random.PRNGKey(7), (dl[2:],), n_iter=50, nchains=2)
    chain = np.asarray(out["dl_chains"][0])
    assert np.isfinite(chain).all() and (chain > 0).all()


def test_healpix_aux_gibbs_runs():
    """Aux-variable CR on HEALPix (q = 1): one sweep keeps shapes/finiteness."""
    from gibbssampler.inference import example_dl
    from gibbssampler.ops import NoiseModel, SkyModel
    from gibbssampler.samplers import aux_gibbs_cr
    from gibbssampler.harmonics import variance_expansion_state, nstate

    sht = make_healpix_sht(NSIDE, LMAX, dtype=jnp.float64, spin2=False)
    dl = example_dl(LMAX, amp=10.0)
    var = variance_expansion_state(jnp.asarray(dl), LMAX)[None]
    noise = NoiseModel.white_healpix(1.0, sht.geo, nfields=1,
                                     dtype=jnp.float64)
    d = jax.random.normal(jax.random.PRNGKey(8), (1, sht.geo.npix))
    model = SkyModel(sht=sht, noise=noise, bl=jnp.ones(LMAX + 1),
                     spin=0, d=d)
    bt = model.bt_ninv_d()
    s0 = jnp.zeros((1, nstate(LMAX)))
    s1, info = aux_gibbs_cr(jax.random.PRNGKey(9), model, var, bt, s0,
                            n_gibbs=2)
    assert np.isfinite(np.asarray(s1)).all()


def test_ang2pix_pix2ang_roundtrip():
    """ang2pix(center of p) == p for every pixel — pins the RING formulas."""
    from gibbssampler.sht.healpix_pix import ang2pix_ring, pix2ang_ring
    for nside in (1, 2, 4, 8, 16):
        npix = 12 * nside * nside
        th, ph = pix2ang_ring(nside, np.arange(npix))
        back = ang2pix_ring(nside, th, ph)
        assert (back == np.arange(npix)).all(), nside


def test_ud_grade_mask():
    from gibbssampler.sht.healpix_pix import ud_grade, galactic_band_mask
    m = galactic_band_mask(16, 15.0)
    f = float(m.mean())
    assert 0.6 < f < 0.85      # ~f_sky of a 15-deg cut
    down = ud_grade(m, 8)
    assert down.shape == (768,)
    assert abs(down.mean() - f) < 0.02
    up = ud_grade(down, 16)
    assert up.shape == (3072,)
    # degrading the upgrade recovers the coarse map exactly
    np.testing.assert_allclose(ud_grade(up, 8), down, atol=1e-12)
    # apodized mask stays within [0, 1]
    ma = galactic_band_mask(16, 10.0, apodize_deg=5.0)
    assert (ma >= 0).all() and (ma <= 1).all()
    assert ((ma > 0) & (ma < 1)).any()


@pytest.fixture(scope="module")
def hsht_pad():
    return make_healpix_sht(NSIDE, LMAX, dtype=jnp.float64, spin2=True,
                            layout="padded")


def test_padded_layout_matches_ring(hsht, hsht_pad):
    """Padded-layout synthesis is the ring-layout synthesis up to the
    to_ring gather; from_ring inverts to_ring on real pixels."""
    key = jax.random.PRNGKey(11)
    flat = jax.random.normal(key, (nflat(LMAX),))
    m_ring = hsht.synthesis(flat)
    m_pad = hsht_pad.synthesis(flat)
    assert m_pad.shape == (hsht_pad.npadded,)
    np.testing.assert_allclose(np.asarray(hsht_pad.to_ring(m_pad)),
                               np.asarray(m_ring), atol=1e-12)
    np.testing.assert_allclose(np.asarray(hsht_pad.from_ring(m_ring)),
                               np.asarray(m_pad), atol=1e-12)
    # synthesis output is exactly zero on padding slots (null space)
    pad_slots = np.asarray(hsht_pad.valid) == 0.0
    assert np.all(np.asarray(m_pad)[pad_slots] == 0.0)


def test_padded_adjoint_matches_and_ignores_padding(hsht, hsht_pad):
    key = jax.random.PRNGKey(12)
    y = jax.random.normal(key, (hsht.geo.npix,))
    a_ring = hsht.adjoint_synthesis(y)
    y_pad = hsht_pad.from_ring(y)
    a_pad = hsht_pad.adjoint_synthesis(y_pad)
    np.testing.assert_allclose(np.asarray(a_pad), np.asarray(a_ring),
                               atol=1e-12)
    # garbage on padding slots must not change the adjoint (null space)
    trash = jax.random.normal(jax.random.PRNGKey(13),
                              y_pad.shape) * (1.0 - hsht_pad.valid)
    a_trash = hsht_pad.adjoint_synthesis(y_pad + 100.0 * trash)
    np.testing.assert_allclose(np.asarray(a_trash), np.asarray(a_ring),
                               atol=1e-9)


def test_padded_adjointness_spin2(hsht_pad):
    key = jax.random.PRNGKey(14)
    ke, kb, kq, ku = jax.random.split(key, 4)
    mask = jnp.asarray(index_maps(LMAX).ell_of >= 2)
    e = jax.random.normal(ke, (nflat(LMAX),)) * mask
    b = jax.random.normal(kb, (nflat(LMAX),)) * mask
    npad = hsht_pad.npadded
    q = jax.random.normal(kq, (npad,)) * hsht_pad.valid
    u = jax.random.normal(ku, (npad,)) * hsht_pad.valid
    qs, us = hsht_pad.synthesis_spin2(e, b)
    lhs = float(jnp.vdot(qs, q) + jnp.vdot(us, u))
    ea, ba = hsht_pad.adjoint_synthesis_spin2(q, u)
    rhs = float(jnp.vdot(e, ea) + jnp.vdot(b, ba))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))
