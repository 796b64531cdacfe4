"""Grid-packed state layout: equivalence with the reference flat packing.

The grid-packed layout (harmonics.gridstate) is the hot-path format;
these tests pin its exact correspondence to the reference-compatible ragged
packing and the adjoint discipline of the state-native SHT methods.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gibbssampler.harmonics import (
    nflat, nstate, flat_to_state, state_to_flat,
    variance_expansion, variance_expansion_state,
    almxfl, almxfl_state, alm2cl, alm2cl_state, ell_mask_state,
    expand_cl_state, index_maps,
)
from gibbssampler.sht import make_sht

LMAX = 24


def _flat(key, batch=()):
    return jax.random.normal(key, batch + (nflat(LMAX),))


def test_flat_state_roundtrip():
    x = _flat(jax.random.PRNGKey(0), (3,))
    st = flat_to_state(x, LMAX)
    assert st.shape == (3, nstate(LMAX))
    back = state_to_flat(st, LMAX)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_state_invalid_slots_zero():
    x = _flat(jax.random.PRNGKey(1))
    g = np.asarray(flat_to_state(x, LMAX)).reshape(2, LMAX + 1, LMAX + 1)
    m = np.arange(LMAX + 1)[:, None]
    l = np.arange(LMAX + 1)[None, :]
    assert np.all(g[:, l < m] == 0.0)
    assert np.all(g[1, 0, :] == 0.0)          # m = 0 has no imaginary part


def test_variance_expansion_state_matches_flat():
    dl = jnp.asarray(np.random.default_rng(0).uniform(0.5, 2.0, LMAX + 1))
    vf = np.asarray(variance_expansion(dl, LMAX))
    vs = np.asarray(variance_expansion_state(dl, LMAX))
    np.testing.assert_allclose(np.asarray(state_to_flat(jnp.asarray(vs), LMAX)),
                               vf, rtol=0, atol=0)
    # invalid slots carry zero variance
    valid = ell_mask_state(LMAX, lmin=0)
    assert np.all(vs[valid == 0] == 0.0)


def test_almxfl_alm2cl_state_match_flat():
    x = _flat(jax.random.PRNGKey(2), (2,))
    st = flat_to_state(x, LMAX)
    fl = jnp.asarray(np.random.default_rng(1).uniform(0.5, 2.0, LMAX + 1))
    np.testing.assert_allclose(
        np.asarray(state_to_flat(almxfl_state(st, fl, LMAX), LMAX)),
        np.asarray(almxfl(x, fl, LMAX)), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(alm2cl_state(st, LMAX)),
                               np.asarray(alm2cl(x, LMAX)), rtol=1e-12)
    y = _flat(jax.random.PRNGKey(3), (2,))
    np.testing.assert_allclose(
        np.asarray(alm2cl_state(st, LMAX, flat_to_state(y, LMAX))),
        np.asarray(alm2cl(x, LMAX, y)), rtol=1e-12)


def test_sht_state_methods_match_flat():
    sht = make_sht(LMAX, dtype=jnp.float64, spin2=True)
    e = _flat(jax.random.PRNGKey(4))
    b = _flat(jax.random.PRNGKey(5))
    es, bs = flat_to_state(e, LMAX), flat_to_state(b, LMAX)

    np.testing.assert_array_equal(np.asarray(sht.synthesis(e)),
                                  np.asarray(sht.synthesis_state(es)))
    q, u = sht.synthesis_spin2(e, b)
    q2, u2 = sht.synthesis_spin2_state(es, bs)
    np.testing.assert_array_equal(np.asarray(q), np.asarray(q2))
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))

    np.testing.assert_array_equal(
        np.asarray(sht.analysis(q)),
        np.asarray(state_to_flat(sht.analysis_state(q), LMAX)))


def test_state_adjointness():
    """<A x, f>_pix == <x, A^T f>_state for the state-native pair."""
    sht = make_sht(LMAX, dtype=jnp.float64, spin2=True)
    key = jax.random.PRNGKey(6)
    kx, kf, ke, kb, kq, ku = jax.random.split(key, 6)
    valid = jnp.asarray(ell_mask_state(LMAX, lmin=0))
    x = jax.random.normal(kx, (nstate(LMAX),)) * valid
    f = jax.random.normal(kf, (sht.nrings, sht.nphi))
    lhs = jnp.sum(sht.synthesis_state(x) * f)
    rhs = jnp.sum(x * sht.adjoint_synthesis_state(f))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)

    e = jax.random.normal(ke, (nstate(LMAX),)) * valid
    b = jax.random.normal(kb, (nstate(LMAX),)) * valid
    q = jax.random.normal(kq, (sht.nrings, sht.nphi))
    u = jax.random.normal(ku, (sht.nrings, sht.nphi))
    qs, us = sht.synthesis_spin2_state(e, b)
    ea, ba = sht.adjoint_synthesis_spin2_state(q, u)
    lhs = jnp.sum(qs * q) + jnp.sum(us * u)
    rhs = jnp.sum(e * ea) + jnp.sum(b * ba)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_expand_cl_state_is_broadcast_of_ell():
    cl = jnp.asarray(np.arange(LMAX + 1, dtype=np.float64) + 1.0)
    out = np.asarray(expand_cl_state(cl, LMAX)).reshape(2, LMAX + 1, LMAX + 1)
    maps = index_maps(LMAX)
    # spot check: valid slot (m, l) carries cl[l]
    for m, l in [(0, 0), (0, 5), (3, 7), (LMAX, LMAX)]:
        assert out[0, m, l] == l + 1.0
    assert out[1, 0, 4] == 0.0      # invalid imag m=0
    assert out[0, 5, 3] == 0.0      # invalid l < m
