"""Joint correlated-field (TT/TE/EE/BB) sampling tests (the 3x3 component
the reference scaffolded, SURVEY.md 2.6.8)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import alm2cl_state, ell_mask_state, state_masks
from gibbssampler.ops import NoiseModel, SkyModel
from gibbssampler.samplers import (
    exact_joint_cr, synfast_joint, invwishart_cls_sample,
)
from gibbssampler.schemes import JointCenteredGibbs
from gibbssampler.sht import make_sht

LMAX = 10
K = 3


def theory_blocks(lmax, r_te=0.6):
    """SPD C_ell blocks with TE correlation r_te."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    tt = 10.0 / (1.0 + ell) ** 1.5
    ee = 0.5 / (1.0 + ell) ** 1.5
    bb = 0.05 / (1.0 + ell) ** 1.5
    te = r_te * np.sqrt(tt * ee)
    C = np.zeros((lmax + 1, K, K))
    C[:, 0, 0], C[:, 1, 1], C[:, 2, 2] = tt, ee, bb
    C[:, 0, 1] = C[:, 1, 0] = te
    C[:2] = 0.0
    return C


def make_joint_model(noise_sigma2=1e-3, seed=0):
    sht = make_sht(LMAX, dtype=jnp.float64, spin2=True)
    C = theory_blocks(LMAX)
    s_true = synfast_joint(jax.random.PRNGKey(seed), C, LMAX,
                           dtype=jnp.float64)
    noise = NoiseModel.white(noise_sigma2, sht.grid, nfields=K,
                             dtype=jnp.float64)
    model = SkyModel(sht=sht, noise=noise, bl=jnp.ones(LMAX + 1),
                     spin=3, d=None)
    sky = model.synthesis(s_true)
    inv = noise.inv_noise
    std = jnp.where(inv > 0, 1.0 / jnp.sqrt(inv), 0.0)
    d = sky + std * jax.random.normal(jax.random.PRNGKey(seed + 1), sky.shape,
                                      dtype=jnp.float64)
    model = SkyModel(sht=sht, noise=noise, bl=model.bl, spin=3, d=d)
    return model, C, s_true


def test_synfast_joint_covariance():
    """Empirical per-ell blocks of many sims match the theory blocks."""
    C = theory_blocks(LMAX)
    keys = jax.random.split(jax.random.PRNGKey(2), 600)
    draws = jax.vmap(lambda k: synfast_joint(k, C, LMAX,
                                             dtype=jnp.float64))(keys)
    # cross spectra via alm2cl on the stacked fields
    tt = np.asarray(jax.vmap(lambda s: alm2cl_state(s[0], LMAX))(draws)).mean(0)
    te = np.asarray(jax.vmap(lambda s: alm2cl_state(s[0], LMAX,
                                              s[1]))(draws)).mean(0)
    np.testing.assert_allclose(tt[2:], C[2:, 0, 0], rtol=0.15)
    np.testing.assert_allclose(te[2:], C[2:, 0, 1], rtol=0.25)


def test_exact_joint_cr_moments():
    """Joint CR draws match the analytic per-slot posterior moments."""
    model, C, _ = make_joint_model(noise_sigma2=0.5)
    bt = model.bt_ninv_d()
    keys = jax.random.split(jax.random.PRNGKey(3), 1500)
    draws = jax.vmap(lambda k: exact_joint_cr(k, model, jnp.asarray(C),
                                              bt)[0])(keys)
    # analytic: P = C^-1 + diag(g); mean = P^-1 b per slot
    from gibbssampler.samplers.joint import expand_cl_blocks
    cov = np.asarray(expand_cl_blocks(jnp.asarray(C), LMAX))
    g = np.asarray(model.harmonic_noise_diag())
    active = ell_mask_state(LMAX, lmin=2) > 0
    bt_np = np.asarray(bt)
    slots = np.where(active)[0]
    for slot in [slots[2], slots[30], slots[77]]:
        P = np.linalg.inv(cov[slot]) + np.diag(g[:, slot])
        Sig = np.linalg.inv(P)
        mean = Sig @ bt_np[:, slot]
        emp_mean = np.asarray(draws[:, :, slot]).mean(axis=0)
        emp_cov = np.cov(np.asarray(draws[:, :, slot]).T)
        se = np.sqrt(np.diag(Sig) / 1500)
        np.testing.assert_allclose(emp_mean, mean, atol=6 * se.max())
        np.testing.assert_allclose(np.diag(emp_cov), np.diag(Sig), rtol=0.3)


def test_invwishart_conjugacy():
    """E[C | s] = S_ell / (nu - k - 1) for the InvWishart(nu = 2l+1, S)."""
    C = theory_blocks(LMAX)
    s = synfast_joint(jax.random.PRNGKey(4), C, LMAX, dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(5), 3000)
    draws = jax.vmap(lambda k: invwishart_cls_sample(k, s, LMAX))(keys)
    mean_draws = np.asarray(draws).mean(axis=0)
    # scatter matrix per ell
    from gibbssampler.samplers.cls_samplers import invwishart_cls_sample as _
    l = 8
    L = LMAX + 1
    ell_state = np.broadcast_to(np.arange(L), (2, L, L)).reshape(-1)
    valid = state_masks(LMAX).valid.reshape(-1) > 0
    slots = np.where((ell_state == l) & valid)[0]
    S = np.zeros((K, K))
    s_np = np.asarray(s)
    for i in slots:
        S += np.outer(s_np[:, i], s_np[:, i])
    nu = 2 * l + 1
    expect = S / (nu - K - 1)
    np.testing.assert_allclose(mean_draws[l], expect, rtol=0.2)


def test_joint_gibbs_recovers_te_correlation():
    """End-to-end: the joint sampler's posterior TE correlation tracks the
    empirical TE of the (high-SNR) data."""
    model, C, s_true = make_joint_model(noise_sigma2=1e-4)
    scheme = JointCenteredGibbs(model)
    out = scheme.run(jax.random.PRNGKey(6), jnp.asarray(C), n_iter=400,
                     nchains=4)
    dl_chain = np.asarray(out["dl_chains"][0])   # (4, 400, lmax+1, 3, 3)
    post = dl_chain[:, 100:].mean(axis=(0, 1))
    # empirical spectra of the true sky
    tt_hat = np.asarray(alm2cl_state(s_true[0], LMAX))
    te_hat = np.asarray(alm2cl_state(s_true[0], LMAX, s_true[1]))
    fac = np.arange(LMAX + 1) * (np.arange(LMAX + 1) + 1.0) / (2 * np.pi)
    for l in range(4, LMAX + 1):
        # posterior mean of InvWishart(nu = 2l+1, S = (2l+1) hat-C):
        # E[C | s] = S / (nu - k - 1) = hat-C (2l+1)/(2l - 3)
        iw_fac = (2 * l + 1.0) / (2 * l - 3.0)
        assert np.isclose(post[l, 0, 0], tt_hat[l] * fac[l] * iw_fac,
                          rtol=0.4), l
        r_post = post[l, 0, 1] / np.sqrt(post[l, 0, 0] * post[l, 1, 1])
        r_hat = te_hat[l] / np.sqrt(
            tt_hat[l] * np.asarray(alm2cl_state(s_true[1], LMAX))[l])
        assert abs(r_post - r_hat) < 0.45, (l, r_post, r_hat)


def make_masked_joint_model(noise_sigma2=0.5, seed=10, band=0.35):
    """Joint model with an equatorial ring mask (masked-sky joint CR)."""
    sht = make_sht(LMAX, dtype=jnp.float64, spin2=True)
    C = theory_blocks(LMAX)
    s_true = synfast_joint(jax.random.PRNGKey(seed), C, LMAX,
                           dtype=jnp.float64)
    lat = np.abs(np.pi / 2 - sht.grid.theta)
    keep = (lat > band).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (sht.grid.nrings, sht.grid.nphi))
    noise = NoiseModel.white(noise_sigma2, sht.grid, nfields=K, mask=mask,
                             dtype=jnp.float64)
    model = SkyModel(sht=sht, noise=noise, bl=jnp.ones(LMAX + 1),
                     spin=3, d=None)
    sky = model.synthesis(s_true)
    inv = noise.inv_noise
    std = jnp.where(inv > 0, 1.0 / jnp.sqrt(jnp.where(inv > 0, inv, 1.0)),
                    0.0)
    d = (sky + std * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                       sky.shape, dtype=jnp.float64))
    model = SkyModel(sht=sht, noise=noise, bl=model.bl, spin=3, d=d)
    return model, C


def test_joint_cg_matches_dense_solve():
    """Block-preconditioned joint CG == dense solve of Q x = b on the active
    subspace, under a ring mask (the masked k x k generalization of
    /root/reference/CenteredGibbs.py:448-491)."""
    from gibbssampler.samplers.joint import joint_block_ops
    from gibbssampler.ops.cg import cg_solve

    model, C = make_masked_joint_model()
    apply_cinv, apply_sqrt, apply_pinv, active = joint_block_ops(
        model, jnp.asarray(C))

    def q_apply(x):
        x = x * active
        out = apply_cinv(x) + model.project_data(
            model.noise.inv_noise * model.forward(x))
        return out * active

    nst = model.nstate
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.normal(size=(K, nst))) * active
    x_cg, info = cg_solve(q_apply, b, precond=apply_pinv, tol=1e-11,
                          maxiter=2000, ndim_sys=2)
    assert bool(info.converged)

    # dense Q on the active subspace
    act = np.asarray(active) > 0
    slots = np.where(act)[0]
    cols = []
    eye_full = np.zeros((K, nst))
    for f in range(K):
        for i in slots:
            e = eye_full.copy()
            e[f, i] = 1.0
            cols.append(np.asarray(q_apply(jnp.asarray(e)))[:, slots].ravel())
    Q = np.stack(cols, axis=1)
    b_red = np.asarray(b)[:, slots].ravel()
    x_red = np.linalg.solve(Q, b_red)
    x_dense = np.zeros((K, nst))
    x_dense[:, slots] = x_red.reshape(K, len(slots))
    np.testing.assert_allclose(np.asarray(x_cg), x_dense, atol=1e-8,
                               rtol=1e-6)

    # the sqrt factor really is a root of C^-1
    xi = jnp.asarray(rng.normal(size=(K, nst)))
    w = apply_sqrt(xi)
    from gibbssampler.samplers.joint import expand_cl_blocks
    cov = np.asarray(expand_cl_blocks(jnp.asarray(C), LMAX))
    slot = slots[40]
    cinv_slot = np.linalg.inv(cov[slot])
    M = np.linalg.cholesky(cinv_slot)
    np.testing.assert_allclose(
        np.asarray(apply_cinv(jnp.asarray(eye_full).at[0, slot].set(1.0))
                   )[:, slot],
        cinv_slot[:, 0], atol=1e-10)
    np.testing.assert_allclose(np.asarray(w)[:, slot], M @ np.asarray(
        xi)[:, slot], atol=1e-10)


def test_joint_scheme_cg_masked_runs():
    """JointCenteredGibbs(cr_method='cg') runs under a mask, finite chain,
    and full-sky cg matches exact moments."""
    model, C = make_masked_joint_model(noise_sigma2=0.1)
    scheme = JointCenteredGibbs(model, cr_method="cg",
                                cr_options={"cg_tol": 1e-8,
                                            "cg_maxiter": 500})
    out = scheme.run(jax.random.PRNGKey(11), jnp.asarray(C), n_iter=30,
                     nchains=2)
    chain = np.asarray(out["dl_chains"][0])
    assert np.isfinite(chain).all()

    # full sky: cg draw moments match the exact sampler's analytic moments
    from gibbssampler.samplers import cg_joint_cr
    model_fs, C_fs, _ = make_joint_model(noise_sigma2=0.5)
    bt = model_fs.bt_ninv_d()
    keys = jax.random.split(jax.random.PRNGKey(12), 800)
    draws = jax.vmap(lambda k: cg_joint_cr(k, model_fs, jnp.asarray(C_fs),
                                           bt, tol=1e-9)[0])(keys)
    from gibbssampler.samplers.joint import expand_cl_blocks
    cov = np.asarray(expand_cl_blocks(jnp.asarray(C_fs), LMAX))
    g = np.asarray(model_fs.harmonic_noise_diag())
    active = ell_mask_state(LMAX, lmin=2) > 0
    bt_np = np.asarray(bt)
    slot = np.where(active)[0][25]
    P = np.linalg.inv(cov[slot]) + np.diag(g[:, slot])
    Sig = np.linalg.inv(P)
    mean = Sig @ bt_np[:, slot]
    emp = np.asarray(draws[:, :, slot])
    se = np.sqrt(np.diag(Sig) / 800)
    np.testing.assert_allclose(emp.mean(axis=0), mean, atol=6 * se.max())
    np.testing.assert_allclose(emp.var(axis=0), np.diag(Sig), rtol=0.35)
