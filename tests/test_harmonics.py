"""Unit tests for the packing / spectra conventions (reference parity:
utils.py:49-76, variance_expension.pyx, utils.py:150-162)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import (
    index_maps, nflat, nhealpy,
    flat_to_grid, grid_to_flat, flat_to_healpy, healpy_to_flat,
    dl_to_cl, cl_to_dl, variance_expansion, variance_expansion_matrix,
    unfold_bins, bin_sum, alm2cl, almxfl, gauss_beam,
)

LMAX = 9


def random_flat(key, lmax=LMAX, batch=()):
    return jax.random.normal(key, batch + (nflat(lmax),))


def test_packing_layout():
    maps = index_maps(LMAX)
    # first lmax+1 slots are m=0, l ascending, real
    assert (maps.m_of[: LMAX + 1] == 0).all()
    assert (maps.ell_of[: LMAX + 1] == np.arange(LMAX + 1)).all()
    assert not maps.is_imag[: LMAX + 1].any()
    # m=1 block starts right after, interleaved
    pos = LMAX + 1
    assert maps.m_of[pos] == 1 and maps.ell_of[pos] == 1
    assert not maps.is_imag[pos] and maps.is_imag[pos + 1]
    # total slot count
    assert len(maps.ell_of) == nflat(LMAX)
    # every l >= m
    assert (maps.ell_of >= maps.m_of).all()


def test_flat_grid_roundtrip():
    key = jax.random.PRNGKey(0)
    flat = random_flat(key, batch=(3,))
    re, im = flat_to_grid(flat, LMAX)
    back = grid_to_flat(re, im, LMAX)
    np.testing.assert_allclose(np.asarray(back), np.asarray(flat), atol=1e-12)


def test_flat_healpy_roundtrip():
    key = jax.random.PRNGKey(1)
    flat = random_flat(key)
    alm = flat_to_healpy(flat, LMAX)
    assert alm.shape == (nhealpy(LMAX),)
    back = healpy_to_flat(alm, LMAX)
    np.testing.assert_allclose(np.asarray(back), np.asarray(flat), atol=1e-12)


def test_healpy_index_formula():
    maps = index_maps(LMAX)
    for i in [0, 5, LMAX + 1, nflat(LMAX) - 1]:
        m, l = int(maps.m_of[i]), int(maps.ell_of[i])
        assert maps.hp_of_flat[i] == m * (2 * LMAX + 1 - m) // 2 + l


def test_sqrt2_scaling():
    """A flat vector of iid N(0, C_l) slots must give complex alm with
    |a_lm|^2 = C_l in expectation: check the deterministic scaling factor."""
    flat = jnp.zeros(nflat(LMAX))
    maps = index_maps(LMAX)
    # set the (l=2, m=1) re slot to sqrt(2)
    i = np.where((maps.ell_of == 2) & (maps.m_of == 1) & ~maps.is_imag)[0][0]
    flat = flat.at[i].set(np.sqrt(2.0))
    re, im = flat_to_grid(flat, LMAX)
    assert np.isclose(float(re[1, 2]), 1.0)  # grid stores Re a_lm itself


def test_dl_cl_roundtrip():
    dl = jnp.asarray(np.random.default_rng(0).uniform(0.5, 2.0, LMAX + 1))
    cl = dl_to_cl(dl)
    # l=0,1 zeroed
    assert float(cl[0]) == 0.0 and float(cl[1]) == 0.0
    dl_back = cl_to_dl(cl)
    np.testing.assert_allclose(np.asarray(dl_back[2:]), np.asarray(dl[2:]),
                               rtol=1e-12)


def test_variance_expansion_matches_formula():
    rng = np.random.default_rng(1)
    dl = jnp.asarray(rng.uniform(0.5, 2.0, LMAX + 1))
    var = np.asarray(variance_expansion(dl, LMAX))
    maps = index_maps(LMAX)
    for i in range(nflat(LMAX)):
        l = int(maps.ell_of[i])
        expected = 0.0 if l < 2 else float(dl[l]) * 2 * np.pi / (l * (l + 1))
        assert np.isclose(var[i], expected), (i, l)


def test_variance_expansion_matrix():
    rng = np.random.default_rng(2)
    blocks = jnp.asarray(rng.uniform(0.5, 2.0, (LMAX + 1, 3, 3)))
    out = np.asarray(variance_expansion_matrix(blocks, LMAX))
    assert out.shape == (nflat(LMAX), 3, 3)
    maps = index_maps(LMAX)
    i = np.where((maps.ell_of == 4) & (maps.m_of == 3) & maps.is_imag)[0][0]
    np.testing.assert_allclose(
        out[i], np.asarray(blocks[4]) * 2 * np.pi / (4 * 5), rtol=1e-12)


def test_bins_fold_unfold():
    bins = np.array([2, 4, 7, LMAX + 1])
    binned = jnp.asarray([10.0, 20.0, 30.0])
    per_ell = np.asarray(unfold_bins(binned, bins, LMAX))
    assert per_ell.shape == (LMAX + 1,)
    # np.repeat semantics within [bins[b], bins[b+1])
    assert (per_ell[2:4] == 10.0).all()
    assert (per_ell[4:7] == 20.0).all()
    assert (per_ell[7:] == 30.0).all()
    sums = np.asarray(bin_sum(jnp.arange(LMAX + 1.0), bins, LMAX))
    assert np.isclose(sums[0], 2 + 3)
    assert np.isclose(sums[1], 4 + 5 + 6)
    assert np.isclose(sums[2], 7 + 8 + 9)


def test_alm2cl_parseval():
    """alm2cl must equal 1/(2l+1) sum_m |a_lm|^2 computed from the complex alm."""
    key = jax.random.PRNGKey(3)
    flat = random_flat(key)
    cl = np.asarray(alm2cl(flat, LMAX))
    alm = np.asarray(flat_to_healpy(flat, LMAX))
    maps = index_maps(LMAX)
    for l in range(LMAX + 1):
        tot = 0.0
        for m in range(l + 1):
            idx = m * (2 * LMAX + 1 - m) // 2 + l
            w = 1.0 if m == 0 else 2.0
            tot += w * abs(alm[idx]) ** 2
        assert np.isclose(cl[l], tot / (2 * l + 1)), l


def test_almxfl():
    key = jax.random.PRNGKey(4)
    flat = random_flat(key)
    fl = jnp.asarray(np.random.default_rng(5).uniform(0.5, 2.0, LMAX + 1))
    out = almxfl(flat, fl, LMAX)
    cl_in = np.asarray(alm2cl(flat, LMAX))
    cl_out = np.asarray(alm2cl(out, LMAX))
    np.testing.assert_allclose(cl_out, cl_in * np.asarray(fl) ** 2, rtol=1e-10)


def test_gauss_beam():
    bl = np.asarray(gauss_beam(np.radians(0.5), 64, dtype=jnp.float64))
    assert bl[0] == 1.0
    sigma = np.radians(0.5) / np.sqrt(8 * np.log(2))
    assert np.isclose(bl[30], np.exp(-0.5 * 30 * 31 * sigma ** 2))
    assert (np.diff(bl) < 0).all()
