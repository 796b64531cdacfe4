"""SHT correctness gates (SURVEY.md 7.1 item 2): round-trip, adjointness,
orthonormality, analytic harmonics, Parseval, batching."""

import numpy as np
from math import comb, factorial
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import nflat, alm2cl, flat_to_healpy
from gibbssampler.sht import make_sht, gauss_legendre_grid
from gibbssampler.sht.legendre import (
    legendre_table, wigner_d_table, spin2_lambda_tables,
)

LMAX = 16


@pytest.fixture(scope="module")
def sht():
    return make_sht(LMAX, dtype=jnp.float64, spin2=True)


def goldberg_sYlm_lat(s, l, m, theta):
    """Latitude part of sY_lm (phi factor removed), Goldberg et al. 1967."""
    th = np.asarray(theta, float)
    pref = (-1.0) ** m * np.sqrt(
        (2 * l + 1) / (4 * np.pi)
        * factorial(l + m) * factorial(l - m)
        / (factorial(l + s) * factorial(l - s)))
    sh, ch = np.sin(th / 2), np.cos(th / 2)
    tot = np.zeros_like(th)
    for r in range(0, l - s + 1):
        if 0 <= r + s - m <= l + s:
            k = 2 * r + s - m
            tot += (comb(l - s, r) * comb(l + s, r + s - m)
                    * (-1.0) ** (l - r - s) * ch ** k * sh ** (2 * l - k))
    return pref * tot


def test_legendre_vs_scipy():
    from scipy.special import sph_harm_y
    theta = np.linspace(0.1, 3.0, 9)
    lam = legendre_table(12, np.cos(theta))
    for l in range(13):
        for m in range(l + 1):
            ref = sph_harm_y(l, m, theta, 0.0).real
            np.testing.assert_allclose(lam[m, l], ref, atol=1e-13, rtol=1e-11)


def test_spin2_lambda_vs_goldberg():
    theta = np.linspace(0.2, 2.9, 8)
    lam_p2, lam_m2 = spin2_lambda_tables(8, theta)
    for l in (2, 3, 5, 8):
        for m in range(0, l + 1):
            np.testing.assert_allclose(
                lam_p2[m, l], goldberg_sYlm_lat(2, l, m, theta),
                atol=1e-12, err_msg=f"+2 l={l} m={m}")
            np.testing.assert_allclose(
                lam_m2[m, l], goldberg_sYlm_lat(-2, l, m, theta),
                atol=1e-12, err_msg=f"-2 l={l} m={m}")


def test_wigner_orthogonality():
    """GL quadrature of d^l_{m,s} d^l'_{m,s} must give 2/(2l+1) delta_ll'."""
    lmax = 12
    grid = gauss_legendre_grid(lmax)
    d = wigner_d_table(lmax, 2, grid.theta)
    for m in (0, 1, 3):
        for l in range(max(m, 2), lmax + 1):
            for lp in range(max(m, 2), lmax + 1):
                val = np.sum(grid.weights * d[m, l] * d[m, lp])
                expect = 2.0 / (2 * l + 1) if l == lp else 0.0
                assert abs(val - expect) < 1e-12, (m, l, lp)


def test_roundtrip_spin0(sht):
    key = jax.random.PRNGKey(0)
    flat = jax.random.normal(key, (nflat(LMAX),))
    m = sht.synthesis(flat)
    assert m.shape == (sht.nrings, sht.nphi)
    back = sht.analysis(m)
    np.testing.assert_allclose(np.asarray(back), np.asarray(flat), atol=1e-11)


def test_roundtrip_spin2(sht):
    key = jax.random.PRNGKey(1)
    e, b = jax.random.normal(key, (2, nflat(LMAX)))
    # monopole/dipole of spin-2 fields do not exist; zero l<2 slots
    from gibbssampler.harmonics import index_maps
    mask = jnp.asarray(index_maps(LMAX).ell_of >= 2)
    e, b = e * mask, b * mask
    q, u = sht.synthesis_spin2(e, b)
    e2, b2 = sht.analysis_spin2(q, u)
    np.testing.assert_allclose(np.asarray(e2), np.asarray(e), atol=1e-11)
    np.testing.assert_allclose(np.asarray(b2), np.asarray(b), atol=1e-11)


def test_adjointness_spin0(sht):
    """<A x, y>_pix = <x, A^T y>_alm to machine precision."""
    kx, ky = jax.random.split(jax.random.PRNGKey(2))
    x = jax.random.normal(kx, (nflat(LMAX),))
    y = jax.random.normal(ky, (sht.nrings, sht.nphi))
    lhs = float(jnp.vdot(sht.synthesis(x), y))
    rhs = float(jnp.vdot(x, sht.adjoint_synthesis(y)))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_adjointness_spin2(sht):
    key = jax.random.PRNGKey(3)
    ke, kb, kq, ku = jax.random.split(key, 4)
    from gibbssampler.harmonics import index_maps
    mask = jnp.asarray(index_maps(LMAX).ell_of >= 2)
    e = jax.random.normal(ke, (nflat(LMAX),)) * mask
    b = jax.random.normal(kb, (nflat(LMAX),)) * mask
    q = jax.random.normal(kq, (sht.nrings, sht.nphi))
    u = jax.random.normal(ku, (sht.nrings, sht.nphi))
    qs, us = sht.synthesis_spin2(e, b)
    lhs = float(jnp.vdot(qs, q) + jnp.vdot(us, u))
    ea, ba = sht.adjoint_synthesis_spin2(q, u)
    rhs = float(jnp.vdot(e, ea) + jnp.vdot(b, ba))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_synthesis_matches_direct_sum(sht):
    """Pointwise check against a brute-force sum over sph_harm_y."""
    from scipy.special import sph_harm_y
    rng = np.random.default_rng(4)
    flat = jnp.asarray(rng.normal(size=nflat(LMAX)))
    m = np.asarray(sht.synthesis(flat))
    alm = np.asarray(flat_to_healpy(flat, LMAX))
    grid = sht.grid
    # evaluate at 3 sample pixels
    for (r, j) in [(0, 0), (LMAX // 2, 5), (LMAX, 11)]:
        th, ph = grid.theta[r], grid.phi0[r] + 2 * np.pi * j / grid.nphi
        tot = 0.0
        for l in range(LMAX + 1):
            for mm in range(l + 1):
                idx = mm * (2 * LMAX + 1 - mm) // 2 + l
                y = sph_harm_y(l, mm, th, ph)
                contrib = alm[idx] * y
                tot += contrib.real if mm == 0 else 2 * contrib.real
        assert abs(m[r, j] - tot) < 1e-10, (r, j, m[r, j], tot)


def test_parseval(sht):
    """integral |f|^2 dOmega = sum_l (2l+1) C_l (orthonormality end-to-end)."""
    key = jax.random.PRNGKey(5)
    flat = jax.random.normal(key, (nflat(LMAX),))
    f = sht.synthesis(flat)
    quad = float(jnp.sum(f ** 2 * sht.wq[:, None]))
    cl = np.asarray(alm2cl(flat, LMAX))
    expect = float(np.sum((2 * np.arange(LMAX + 1) + 1) * cl))
    assert abs(quad - expect) < 1e-10 * expect


def test_batched_and_jit(sht):
    key = jax.random.PRNGKey(6)
    flat = jax.random.normal(key, (3, 2, nflat(LMAX)))
    maps = jax.jit(sht.synthesis)(flat)
    assert maps.shape == (3, 2, sht.nrings, sht.nphi)
    back = jax.jit(sht.analysis)(maps)
    np.testing.assert_allclose(np.asarray(back), np.asarray(flat), atol=1e-11)


def test_spin2_pure_e_analytic(sht):
    """A pure E_20 = 1 field must give Q + iU = -(1) * 2Y_20 * sqrt(... )
    via the packing: flat slot (l=2, m=0) set to 1 => E_20 = 1."""
    e = jnp.zeros(nflat(LMAX)).at[2].set(1.0)
    b = jnp.zeros(nflat(LMAX))
    q, u = sht.synthesis_spin2(e, b)
    th = sht.grid.theta
    expect_q = -np.sqrt(15.0 / (32.0 * np.pi)) * np.sin(th) ** 2
    np.testing.assert_allclose(np.asarray(q[:, 0]), expect_q, atol=1e-12)
    np.testing.assert_allclose(np.asarray(u), 0.0, atol=1e-12)


@pytest.mark.parametrize("mode", ["ct", "fft"])
def test_ct_mode_matches_matmul(mode):
    """The mixed-radix ('ct') and complex-FFT ('fft') azimuthal paths must
    agree with the direct DFT matmuls on every public transform
    (synthesis/analysis, spin 0 and 2)."""
    from gibbssampler.sht.transform import SHT

    lmax = 64  # GL nphi=130=13*10 admits a useful factorization
    g = gauss_legendre_grid(lmax)
    s0 = SHT(g, lmax, spin2=True, fft_mode="matmul", dtype=jnp.float64)
    s1 = SHT(g, lmax, spin2=True, fft_mode=mode, dtype=jnp.float64)
    assert s1.fft_mode == mode
    assert (s1._ct is not None) == (mode == "ct")
    rng = np.random.default_rng(0)
    alm = jnp.asarray(rng.standard_normal((nflat(lmax),)))
    m0, m1 = s0.synthesis(alm), s1.synthesis(alm)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m0),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s1.analysis(m0)),
                               np.asarray(s0.analysis(m0)),
                               rtol=1e-10, atol=1e-10)
    e = jnp.asarray(rng.standard_normal((nflat(lmax),)))
    b = jnp.asarray(rng.standard_normal((nflat(lmax),)))
    q0, u0 = s0.synthesis_spin2(e, b)
    q1, u1 = s1.synthesis_spin2(e, b)
    np.testing.assert_allclose(np.asarray(q1), np.asarray(q0),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u0),
                               rtol=1e-10, atol=1e-10)
    for x0, x1 in zip(s0.analysis_spin2(q0, u0), s1.analysis_spin2(q0, u0)):
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x0),
                                   rtol=1e-10, atol=1e-10)


def test_ct_mode_fallback_small():
    """No profitable factorization at tiny lmax -> silently fall back."""
    from gibbssampler.sht.transform import SHT

    g = gauss_legendre_grid(8)
    s = SHT(g, 8, fft_mode="ct")
    assert s.fft_mode == "matmul"


def test_ring_split_matches_dense():
    """North/south ring-parity split (the half-table fast path, default on
    symmetric grids) must agree with the dense contraction on every public
    transform, for both even and odd ring counts (odd = self-paired
    equator ring)."""
    from gibbssampler.sht.transform import SHT

    rng = np.random.default_rng(3)
    for lmax, nrings in [(16, None), (16, 18), (33, None)]:
        g = gauss_legendre_grid(lmax, nrings=nrings)
        s0 = SHT(g, lmax, spin2=True, dtype=jnp.float64, ring_split=False)
        s1 = SHT(g, lmax, spin2=True, dtype=jnp.float64, ring_split=True)
        assert s1.ring_split
        alm = jnp.asarray(rng.standard_normal((nflat(lmax),)))
        m0, m1 = s0.synthesis(alm), s1.synthesis(alm)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m0),
                                   rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(np.asarray(s1.adjoint_synthesis(m0)),
                                   np.asarray(s0.adjoint_synthesis(m0)),
                                   rtol=1e-11, atol=1e-11)
        e = jnp.asarray(rng.standard_normal((nflat(lmax),)))
        b = jnp.asarray(rng.standard_normal((nflat(lmax),)))
        q0, u0 = s0.synthesis_spin2(e, b)
        q1, u1 = s1.synthesis_spin2(e, b)
        np.testing.assert_allclose(np.asarray(q1), np.asarray(q0),
                                   rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u0),
                                   rtol=1e-11, atol=1e-11)
        for x0, x1 in zip(s0.adjoint_synthesis_spin2(q0, u0),
                          s1.adjoint_synthesis_spin2(q0, u0)):
            np.testing.assert_allclose(np.asarray(x1), np.asarray(x0),
                                       rtol=1e-11, atol=1e-11)
