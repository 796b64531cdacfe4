"""Scheme-level statistical validation: chain posteriors vs the analytic
full-sky marginal, and cross-scheme agreement (the reference eyeballed these
as histogram overlays, .ipynb_checkpoints/main-checkpoint.py:256-282;
here they are asserted with Monte-Carlo tolerances)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import alm2cl, dl_to_cl_factor
from gibbssampler.inference import example_dl, simulate_dataset
from gibbssampler.schemes import (
    CenteredGibbs, NonCenteredGibbs, ASISGibbs, PNCPGibbs,
)

LMAX = 12
SIGMA2 = 0.05   # low noise -> likelihood-dominated, tight posterior


@pytest.fixture(scope="module")
def dataset():
    dl = example_dl(LMAX, amp=10.0)
    model, truth = simulate_dataset(
        jax.random.PRNGKey(42), LMAX, spin=0, dl_fields=dl[None],
        noise_sigma2=SIGMA2, fwhm_radians=0.0, dtype=jnp.float64)
    return model, dl


@pytest.fixture(scope="module")
def dataset_noisy():
    """SNR ~ 1 dataset: the non-centered/interweaved samplers mix well here
    (at very high SNR the non-centered chain is the slow one — the
    motivation for ASIS)."""
    dl = example_dl(LMAX, amp=10.0)
    model, truth = simulate_dataset(
        jax.random.PRNGKey(43), LMAX, spin=0, dl_fields=dl[None],
        noise_sigma2=50.0, fwhm_radians=0.0, dtype=jnp.float64)
    return model, dl


def analytic_posterior_mean(model):
    """Closed-form posterior mean of D_l | d on the full sky with flat prior
    on D (the implied prior of the conjugate inverse-gamma step):
    v = b_l^2 C + n_h follows an inverse-gamma truncated to v >= n_h, so
    E[C] = (E[v | v >= n_h] - n_h) / b_l^2, with
    E[v 1{v>n}] = beta/(alpha-1) * SF_{InvGamma(alpha-1, beta)}(n)."""
    from scipy.stats import invgamma
    lmax = model.lmax
    d_alm = model.sht.analysis(model.d[0])
    shat = np.asarray(alm2cl(d_alm, lmax))
    noise_h = 1.0 / float(model.noise.harmonic_white_level()[0])
    fac = np.asarray(dl_to_cl_factor(lmax, jnp.float64))
    bl2 = np.asarray(model.bl) ** 2
    means = np.zeros(lmax + 1)
    for l in range(2, lmax + 1):
        alpha = (2 * l + 1) / 2.0 - 1.0
        beta = (2 * l + 1) * shat[l] / 2.0
        z = invgamma.sf(noise_h, alpha, scale=beta)
        ev_trunc = (beta / (alpha - 1.0)
                    * invgamma.sf(noise_h, alpha - 1.0, scale=beta)) / z
        means[l] = (ev_trunc - noise_h) / bl2[l] / fac[l]
    return means


def chain_mean_and_se(chain, burn=0.25):
    """chain: (nchains, niter, nbins) -> (mean, standard error) per bin,
    SE from between-chain spread."""
    n = chain.shape[1]
    c = chain[:, int(burn * n):, :]
    per_chain = c.mean(axis=1)
    mean = per_chain.mean(axis=0)
    se = per_chain.std(axis=0, ddof=1) / np.sqrt(chain.shape[0])
    return mean, se


def test_centered_matches_analytic_posterior(dataset):
    model, dl = dataset
    bins = np.arange(2, LMAX + 2)
    scheme = CenteredGibbs(model, [bins], cr_method="exact")
    out = scheme.run(jax.random.PRNGKey(0), (dl[2:],), n_iter=2000, nchains=8)
    chain = np.asarray(out["dl_chains"][0])
    mean, se = chain_mean_and_se(chain)
    target = analytic_posterior_mean(model)[2:]
    # 5 sigma MC tolerance + 1% systematic slack
    tol = 5 * se + 0.01 * target
    assert np.all(np.abs(mean - target) < tol), (
        (mean - target) / np.maximum(se, 1e-12))


def _nc_setup(model):
    bins = np.arange(2, LMAX + 2)
    nbins = len(bins) - 1
    blocks = [(i, min(i + 2, nbins)) for i in range(0, nbins, 2)]
    # the non-centered conditional is noise-limited: Fisher width
    # sigma_D ~ 2 D sqrt(n_h / C) / sqrt(2l+1)
    d_alm = model.sht.analysis_state(model.d[0])
    from gibbssampler.harmonics import alm2cl_state
    shat = np.asarray(alm2cl_state(d_alm, LMAX))
    noise_h = 1.0 / float(model.noise.harmonic_white_level()[0])
    fac = np.asarray(dl_to_cl_factor(LMAX, jnp.float64))
    ell = np.arange(2, LMAX + 1)
    cl_hat = np.maximum(shat[2:] - noise_h, 0.3 * shat[2:])
    sig = (2.0 * (cl_hat / fac[2:])
           * np.sqrt(noise_h / cl_hat) / np.sqrt(2 * ell + 1.0)) * 1.2
    return bins, blocks, sig, d_alm


def test_noncentered_allsph_matches_centered(dataset_noisy):
    model, dl = dataset_noisy
    bins, blocks, sig, d_alm = _nc_setup(model)
    cen = CenteredGibbs(model, [bins], cr_method="exact")
    out_c = cen.run(jax.random.PRNGKey(1), (dl[2:],), n_iter=1500, nchains=8)
    nc = NonCenteredGibbs(model, [bins], [blocks], [sig], n_iter_mh=2,
                          all_sph=True, d_alm=d_alm)
    out_n = nc.run(jax.random.PRNGKey(2), (dl[2:],), n_iter=3000, nchains=8)
    acc = np.asarray(out_n["mh_accept"][0]).mean()
    assert 0.05 < acc < 0.95, f"NC acceptance degenerate: {acc}"
    m_c, se_c = chain_mean_and_se(np.asarray(out_c["dl_chains"][0]))
    m_n, se_n = chain_mean_and_se(np.asarray(out_n["dl_chains"][0]))
    tol = 6 * np.sqrt(se_c ** 2 + se_n ** 2) + 0.02 * m_c
    assert np.all(np.abs(m_c - m_n) < tol), (m_c - m_n) / tol


def test_asis_matches_centered(dataset_noisy):
    model, dl = dataset_noisy
    bins, blocks, sig, d_alm = _nc_setup(model)
    cen = CenteredGibbs(model, [bins], cr_method="exact")
    out_c = cen.run(jax.random.PRNGKey(3), (dl[2:],), n_iter=1500, nchains=8)
    asis = ASISGibbs(model, [bins], [blocks], [sig], n_iter_mh=1,
                     all_sph=True, d_alm=d_alm)
    out_a = asis.run(jax.random.PRNGKey(4), (dl[2:],), n_iter=1500, nchains=8)
    m_c, se_c = chain_mean_and_se(np.asarray(out_c["dl_chains"][0]))
    m_a, se_a = chain_mean_and_se(np.asarray(out_a["dl_chains"][0]))
    tol = 6 * np.sqrt(se_c ** 2 + se_a ** 2) + 0.02 * m_c
    assert np.all(np.abs(m_c - m_a) < tol), (m_c - m_a) / tol


def test_pncp_matches_centered(dataset_noisy):
    model, dl = dataset_noisy
    bins, blocks, sig, d_alm = _nc_setup(model)
    l_cut = 7
    cen = CenteredGibbs(model, [bins], cr_method="exact")
    out_c = cen.run(jax.random.PRNGKey(5), (dl[2:],), n_iter=1500, nchains=8)
    # blocks aligned with the cut (cut bin index = l_cut - 2 = 5)
    nbins = len(bins) - 1
    cut_bin = l_cut - 2
    blocks = [(0, cut_bin), (cut_bin, nbins)]
    pncp = PNCPGibbs(model, [bins], [blocks], [sig], l_cut=l_cut,
                     n_iter_mh=2)
    out_p = pncp.run(jax.random.PRNGKey(6), (dl[2:],), n_iter=1500, nchains=8)
    m_c, se_c = chain_mean_and_se(np.asarray(out_c["dl_chains"][0]))
    m_p, se_p = chain_mean_and_se(np.asarray(out_p["dl_chains"][0]))
    tol = 6 * np.sqrt(se_c ** 2 + se_p ** 2) + 0.03 * m_c
    assert np.all(np.abs(m_p - m_c) < tol), (m_p - m_c) / tol


def test_pncp_rejects_bad_lcut(dataset):
    model, dl = dataset
    bins = np.arange(2, LMAX + 2)
    with pytest.raises(ValueError):
        PNCPGibbs(model, [bins], [[(0, 3)]], [np.ones(len(bins) - 1)],
                  l_cut=LMAX + 5)


def test_polarization_centered_recovers_spectra():
    """EE/BB centered Gibbs on a full-sky polarized dataset: posterior means
    track the analytic per-field marginal (the live reference experiment is
    EE/BB only, main_polarization.py:67-68)."""
    dl_ee = example_dl(LMAX, "ee", amp=10.0)
    dl_bb = example_dl(LMAX, "bb", amp=10.0)
    model, truth = simulate_dataset(
        jax.random.PRNGKey(7), LMAX, spin=2,
        dl_fields=np.stack([dl_ee, dl_bb]), noise_sigma2=1e-4,
        dtype=jnp.float64)
    bins = np.arange(2, LMAX + 2)
    scheme = CenteredGibbs(model, [bins, bins], cr_method="exact")
    out = scheme.run(jax.random.PRNGKey(8), (dl_ee[2:], dl_bb[2:]),
                     n_iter=2000, nchains=8)
    # analytic marginal per field
    from scipy.stats import invgamma
    e_alm, b_alm = model.sht.analysis_spin2(model.d[0], model.d[1])
    for f, d_alm in enumerate([e_alm, b_alm]):
        shat = np.asarray(alm2cl(d_alm, LMAX))
        noise_h = float(1.0 / model.noise.harmonic_white_level()[f])
        fac = np.asarray(dl_to_cl_factor(LMAX, jnp.float64))
        target = np.zeros(LMAX - 1)
        for i, l in enumerate(range(2, LMAX + 1)):
            alpha = (2 * l + 1) / 2.0 - 1.0
            beta = (2 * l + 1) * shat[l] / 2.0
            z = invgamma.sf(noise_h, alpha, scale=beta)
            ev = (beta / (alpha - 1.0)
                  * invgamma.sf(noise_h, alpha - 1.0, scale=beta)) / z
            target[i] = (ev - noise_h) / fac[l]
        chain = np.asarray(out["dl_chains"][f])
        mean, se = chain_mean_and_se(chain)
        tol = 6 * se + 0.02 * np.abs(target)
        assert np.all(np.abs(mean - target) < tol), (f, (mean - target) / tol)
