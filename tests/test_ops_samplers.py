"""Operator and conditional-sampler correctness (SURVEY.md 4: the test
pyramid the reference lacks — CG vs dense solve, conditional moments,
RJPO/MALA acceptance behavior)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import (nstate, variance_expansion_state,
                                        unfold_bins)
from gibbssampler.inference import example_dl, simulate_dataset
from gibbssampler.ops import cg_solve
from gibbssampler.samplers import (
    exact_cr, cg_cr, rjpo_cr, aux_gibbs_cr, overrelax_cr, mala_cr,
    cr_precond,
)

LMAX = 8
NF = nstate(LMAX)


def make_model(spin=0, mask=None, sigma2=1.0, fwhm=0.0, seed=0):
    dl = example_dl(LMAX)
    fields = dl[None] if spin == 0 else np.stack([example_dl(LMAX, "ee"),
                                                  example_dl(LMAX, "bb")])
    model, truth = simulate_dataset(
        jax.random.PRNGKey(seed), LMAX, spin=spin, dl_fields=fields,
        noise_sigma2=sigma2, fwhm_radians=fwhm, mask=mask, dtype=jnp.float64)
    return model, truth, fields


def var_cls_of(model, fields):
    return jnp.stack([variance_expansion_state(jnp.asarray(f), LMAX)
                      for f in fields])


def ring_mask(model, frac=0.3):
    """Mask a band of rings (a crude galactic cut)."""
    nr, nphi = model.sht.nrings, model.sht.nphi
    m = np.ones((nr, nphi))
    lo = int(nr * (0.5 - frac / 2)); hi = int(nr * (0.5 + frac / 2))
    m[lo:hi] = 0.0
    return m


def test_q_apply_symmetric_positive():
    model, _, fields = make_model(spin=0)
    var = var_cls_of(model, fields)
    inv_cvar = jnp.where(var > 0, 1.0 / jnp.where(var > 0, var, 1.0), 0.0)
    kx, ky = jax.random.split(jax.random.PRNGKey(1))
    x = jax.random.normal(kx, (1, NF)) * model.ell_mask()
    y = jax.random.normal(ky, (1, NF)) * model.ell_mask()
    qx = model.q_apply(x, inv_cvar)
    qy = model.q_apply(y, inv_cvar)
    lhs, rhs = float(jnp.vdot(qx, y)), float(jnp.vdot(x, qy))
    assert abs(lhs - rhs) < 1e-9 * abs(lhs)
    assert float(jnp.vdot(x, qx)) > 0


@pytest.mark.parametrize("spin", [0, 2])
def test_cg_matches_dense_solve_masked(spin):
    """Build Q densely column by column and check the batched CG against
    numpy.linalg.solve on a masked sky (the reference trusts qcinv blindly;
    reference test analogue: .ipynb_checkpoints/test2-checkpoint.py)."""
    model, _, fields = make_model(spin=spin)
    mask = ring_mask(model)
    model, _, fields = make_model(spin=spin, mask=mask)
    var = var_cls_of(model, fields)
    inv_cvar = jnp.where(var > 0, 1.0 / jnp.where(var > 0, var, 1.0), 0.0)
    nfield = model.nfields
    dim = nfield * NF
    op = jax.jit(lambda x: model.q_apply(x, inv_cvar))
    eye = jnp.eye(dim).reshape(dim, nfield, NF)
    Q = jax.vmap(op)(eye).reshape(dim, dim).T
    Q = np.asarray(Q)
    rng = np.random.default_rng(2)
    active = np.asarray((var > 0)).reshape(-1)
    b = rng.normal(size=dim) * active
    x_dense = np.zeros(dim)
    x_dense[active] = np.linalg.solve(Q[np.ix_(active, active)], b[active])
    x_cg, info = cg_solve(op, jnp.asarray(b.reshape(nfield, NF)),
                          precond_diag=cr_precond(model, var),
                          tol=1e-12, maxiter=2000, ndim_sys=2)
    assert bool(info.converged.all())
    np.testing.assert_allclose(np.asarray(x_cg).reshape(-1), x_dense,
                               atol=1e-8 * np.abs(x_dense).max())


def test_cg_mixed_precision_matches_dense_solve():
    """Mixed-precision CG (fp32 mat-vecs + fp64 vectors/recurrences +
    periodic true-residual replacement, ops/cg.py apply_dtype) must reach
    the same solution as the dense solve on a masked sky — the production
    remedy for the measured fp32 stagnation at lmax=512 (PERF.md;
    reference workhorse path: ConstrainedRealization.py:40-41)."""
    mask = None
    model, _, fields = make_model(spin=2)
    mask = ring_mask(model)
    model, _, fields = make_model(spin=2, mask=mask)
    var = var_cls_of(model, fields)
    inv_cvar = jnp.where(var > 0, 1.0 / jnp.where(var > 0, var, 1.0), 0.0)
    nfield = model.nfields
    dim = nfield * NF
    op = jax.jit(lambda x: model.q_apply(x, inv_cvar))
    eye = jnp.eye(dim).reshape(dim, nfield, NF)
    Q = np.asarray(jax.vmap(op)(eye).reshape(dim, dim).T)
    rng = np.random.default_rng(3)
    active = np.asarray((var > 0)).reshape(-1)
    b = rng.normal(size=dim) * active
    x_dense = np.zeros(dim)
    x_dense[active] = np.linalg.solve(Q[np.ix_(active, active)], b[active])
    x_mx, info = cg_solve(op, jnp.asarray(b.reshape(nfield, NF)),
                          precond_diag=cr_precond(model, var),
                          tol=1e-6, maxiter=2000, ndim_sys=2,
                          apply_dtype=jnp.float32, operator_hi=op,
                          replace_every=10)
    assert bool(info.converged.all())
    scale = np.abs(x_dense).max()
    np.testing.assert_allclose(np.asarray(x_mx).reshape(-1), x_dense,
                               atol=3e-5 * scale)
    # convergence class: comparable iteration count to full fp64
    _, info64 = cg_solve(op, jnp.asarray(b.reshape(nfield, NF)),
                         precond_diag=cr_precond(model, var),
                         tol=1e-6, maxiter=2000, ndim_sys=2)
    assert int(info.iterations) <= 2 * int(info64.iterations) + 10


def test_exact_cr_moments():
    """Full sky: sample many CR draws, check mean and variance against the
    analytic Sigma = (C^-1 + g b^2)^-1, mu = Sigma B A^T N^-1 d."""
    model, _, fields = make_model(spin=0, fwhm=0.1)
    var = var_cls_of(model, fields)
    bt = model.bt_ninv_d()
    inv_cvar = jnp.where(var > 0, 1.0 / jnp.where(var > 0, var, 1.0), 0.0)
    hdiag = model.harmonic_noise_diag()
    sigma = jnp.where(var > 0, 1.0 / (inv_cvar + hdiag), 0.0)
    mean_true = sigma * bt

    keys = jax.random.split(jax.random.PRNGKey(3), 4000)
    draws = jax.vmap(lambda k: exact_cr(k, model, var, bt)[0])(keys)
    emp_mean = jnp.mean(draws, axis=0)
    emp_var = jnp.var(draws, axis=0)
    se = jnp.sqrt(sigma / 4000)
    sl = (0, slice(2, 40))
    np.testing.assert_allclose(np.asarray(emp_mean[sl]),
                               np.asarray(mean_true[sl]),
                               atol=5 * float(jnp.max(se)))
    np.testing.assert_allclose(np.asarray(emp_var[sl]),
                               np.asarray(sigma[sl]), rtol=0.25)


def test_cg_cr_matches_exact_distribution():
    """Full sky: the CG draw and the exact draw are the same distribution;
    with matched RNG pipelines we can only check moments."""
    model, _, fields = make_model(spin=0)
    var = var_cls_of(model, fields)
    bt = model.bt_ninv_d()
    keys = jax.random.split(jax.random.PRNGKey(4), 800)
    d_exact = jax.vmap(lambda k: exact_cr(k, model, var, bt)[0])(keys)
    d_cg = jax.vmap(lambda k: cg_cr(k, model, var, bt, tol=1e-10)[0])(keys)
    m1, m2 = jnp.mean(d_exact, 0), jnp.mean(d_cg, 0)
    v1, v2 = jnp.var(d_exact, 0), jnp.var(d_cg, 0)
    scale = float(jnp.max(jnp.sqrt(v1)))
    np.testing.assert_allclose(np.asarray(m2[0, 2:40]),
                               np.asarray(m1[0, 2:40]),
                               atol=5 * scale / np.sqrt(800))
    np.testing.assert_allclose(np.asarray(v2[0, 2:40]),
                               np.asarray(v1[0, 2:40]), rtol=0.4)


def test_rjpo_accepts_with_tight_solver():
    """With a tight CG tolerance the RJPO residual vanishes -> accept ~ 1
    (reference: CenteredGibbs.py:162-191)."""
    model, _, fields = make_model(spin=0, mask=None)
    mask = ring_mask(model)
    model, _, fields = make_model(spin=0, mask=mask)
    var = var_cls_of(model, fields)
    bt = model.bt_ninv_d()
    s0 = exact_cr(jax.random.PRNGKey(0), model, var, bt)[0]
    keys = jax.random.split(jax.random.PRNGKey(5), 16)
    acc = jax.vmap(lambda k: rjpo_cr(k, model, var, bt, s0,
                                     tol=1e-11)[1].accept)(keys)
    assert float(jnp.mean(acc)) == 1.0


def test_rjpo_loose_solver_correction_is_active():
    """maxiter = 10 (an unconverged solve): the -s_old seeding must make
    the residual correction ACTIVE — strictly negative log-ratios that
    reject the inexact proposals (RJPO as a convergence gate, the
    reference's behavior).  Pins the seeding analysis in rjpo_cr's
    docstring: with the degenerate +s_old seed, PCG orthogonality makes
    log_ratio identically 0 and every inexact solve would be silently
    accepted."""
    model, _, fields = make_model(spin=0, mask=None)
    mask = ring_mask(model)
    model, _, fields = make_model(spin=0, mask=mask)
    var = var_cls_of(model, fields)
    bt = model.bt_ninv_d()
    nch = 64
    keys = jax.random.split(jax.random.PRNGKey(8), nch)
    ref_draws = jax.vmap(lambda k: cg_cr(k, model, var, bt,
                                         tol=1e-10)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(9), nch)
    moved, info = jax.vmap(lambda k, s: rjpo_cr(k, model, var, bt, s,
                                                tol=0.0, maxiter=10))(
        keys2, ref_draws)
    # the correction is far from the +s_old degenerate identically-0 case
    assert float(jnp.median(info.extra)) < -1.0
    # and rejected chains stay exactly put (kernel trivially invariant)
    rej = np.asarray(info.accept) == 0.0
    assert rej.any()
    np.testing.assert_array_equal(np.asarray(moved)[rej],
                                  np.asarray(ref_draws)[rej])


def test_aux_gibbs_preserves_posterior():
    """The aux-variable sweep has the CR conditional as its stationary
    distribution: moments after sweeps started from exact draws must match
    the exact conditional's moments."""
    model, _, fields = make_model(spin=0, sigma2=2.0)
    mask = ring_mask(model, 0.2)
    model_m, _, _ = make_model(spin=0, sigma2=2.0, mask=mask)
    var = var_cls_of(model, fields)
    bt = model_m.bt_ninv_d()
    nch = 600
    keys = jax.random.split(jax.random.PRNGKey(6), nch)
    # exact reference sample for the *masked* posterior via long CG draws
    ref_draws = jax.vmap(lambda k: cg_cr(k, model_m, var, bt,
                                         tol=1e-10)[0])(keys)
    # aux sweeps starting from those draws must stay in distribution
    keys2 = jax.random.split(jax.random.PRNGKey(7), nch)
    moved = jax.vmap(lambda k, s: aux_gibbs_cr(k, model_m, var, bt, s,
                                               n_gibbs=3)[0])(keys2, ref_draws)
    m_ref, m_new = jnp.mean(ref_draws, 0), jnp.mean(moved, 0)
    v_ref, v_new = jnp.var(ref_draws, 0), jnp.var(moved, 0)
    scale = float(jnp.max(jnp.sqrt(v_ref)))
    np.testing.assert_allclose(np.asarray(m_new[0, 2:40]),
                               np.asarray(m_ref[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))
    np.testing.assert_allclose(np.asarray(v_new[0, 2:40]),
                               np.asarray(v_ref[0, 2:40]), rtol=0.5)


@pytest.mark.parametrize("n_gibbs", [1, 3])
def test_overrelax_preserves_posterior(n_gibbs):
    """Stationarity of the overrelaxed auxiliary sampler, incl. the
    multi-sweep form (the reference flagship runs n_gibbs = 20 sweeps per
    CR step, main_polarization.py:126)."""
    model, _, fields = make_model(spin=0)
    mask = ring_mask(model, 0.2)
    model_m, _, _ = make_model(spin=0, mask=mask)
    var = var_cls_of(model, fields)
    bt = model_m.bt_ninv_d()
    nch = 600
    keys = jax.random.split(jax.random.PRNGKey(8), nch)
    ref_draws = jax.vmap(lambda k: cg_cr(k, model_m, var, bt,
                                         tol=1e-10)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(9), nch)
    moved = jax.vmap(lambda k, s: overrelax_cr(
        k, model_m, var, bt, s, n_gibbs=n_gibbs)[0])(keys2, ref_draws)
    m_ref, m_new = jnp.mean(ref_draws, 0), jnp.mean(moved, 0)
    v_ref = jnp.var(ref_draws, 0)
    scale = float(jnp.max(jnp.sqrt(v_ref)))
    np.testing.assert_allclose(np.asarray(m_new[0, 2:40]),
                               np.asarray(m_ref[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))


def test_mala_acceptance_and_invariance():
    """MALA with small tau accepts nearly always and preserves the target."""
    model, _, fields = make_model(spin=0)
    mask = ring_mask(model, 0.2)
    model_m, _, _ = make_model(spin=0, mask=mask)
    var = var_cls_of(model, fields)
    bt = model_m.bt_ninv_d()
    nch = 400
    keys = jax.random.split(jax.random.PRNGKey(10), nch)
    ref_draws = jax.vmap(lambda k: cg_cr(k, model_m, var, bt,
                                         tol=1e-10)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(11), nch)
    moved, infos = jax.vmap(lambda k, s: mala_cr(k, model_m, var, bt, s,
                                                 tau=0.02))(keys2, ref_draws)
    acc = float(jnp.mean(infos.accept))
    assert acc > 0.5, acc
    m_ref, m_new = jnp.mean(ref_draws, 0), jnp.mean(moved, 0)
    v_ref = jnp.var(ref_draws, 0)
    scale = float(jnp.max(jnp.sqrt(v_ref)))
    np.testing.assert_allclose(np.asarray(m_new[0, 2:40]),
                               np.asarray(m_ref[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))


def test_pcn_acceptance_and_invariance():
    """pCN with small beta accepts often and preserves the CR conditional
    (the reference only eyeballed pCN on a 1-d toy, testCN.py:22-41)."""
    from gibbssampler.samplers import pcn_cr
    # weak likelihood (SNR << 1): pCN's prior-reversible proposal is only
    # viable in this regime — at high SNR its acceptance decays
    # exponentially with dimension (why the portfolio also has MALA/aux)
    model, _, fields = make_model(spin=0, sigma2=5e4)
    mask = ring_mask(model, 0.2)
    model_m, _, _ = make_model(spin=0, sigma2=5e4, mask=mask)
    var = var_cls_of(model_m, fields)
    bt = model_m.bt_ninv_d()
    nch = 400
    keys = jax.random.split(jax.random.PRNGKey(20), nch)
    ref_draws = jax.vmap(lambda k: cg_cr(k, model_m, var, bt,
                                         tol=1e-10)[0])(keys)
    keys2 = jax.random.split(jax.random.PRNGKey(21), nch)
    moved, infos = jax.vmap(lambda k, s: __import__(
        "gibbssampler.samplers", fromlist=["pcn_cr"]).pcn_cr(
        k, model_m, var, bt, s, beta=0.05))(keys2, ref_draws)
    acc = float(jnp.mean(infos.accept))
    assert acc > 0.2, acc
    m_ref, m_new = jnp.mean(ref_draws, 0), jnp.mean(moved, 0)
    v_ref = jnp.var(ref_draws, 0)
    scale = float(jnp.max(jnp.sqrt(v_ref)))
    np.testing.assert_allclose(np.asarray(m_new[0, 2:40]),
                               np.asarray(m_ref[0, 2:40]),
                               atol=6 * scale / np.sqrt(nch))


def test_cg_production_mask_iteration_bound():
    """Conditioning evidence for the masked CG: at lmax=128 with the ~80%
    galactic band cut and the diag_cl-style preconditioner (cr_precond),
    the lockstep solve converges to the reference's tolerances well inside
    its 4000-iteration budget (reference descriptor:
    ConstrainedRealization.py:40-41).  This CPU-sized case pins the
    preconditioner's quality in CI; the production-scale iteration counts
    (lmax=512, several band widths, both tolerances, tools/cg_scale.py)
    are summarized in PERF.md."""
    from gibbssampler.inference import example_dl, simulate_dataset
    from gibbssampler.ops import with_cut_decomposition
    from gibbssampler.ops.cg import cg_solve
    from gibbssampler.samplers.cr import (cr_precond, fluctuated_rhs,
                                              _q_op, _safe_inv, _active)
    from gibbssampler.harmonics import variance_expansion_state
    from gibbssampler.harmonics.spectra import unfold_bins
    from gibbssampler.sht import gauss_legendre_grid

    lmax = 128
    grid = gauss_legendre_grid(lmax)
    lat = np.abs(np.pi / 2 - grid.theta)
    keep = (lat > np.radians(11.5)).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    dls = np.stack([example_dl(lmax, "ee", amp=1000.0),
                    example_dl(lmax, "bb", amp=1000.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(0), lmax, spin=2,
                                dl_fields=dls, noise_sigma2=0.2 ** 2,
                                fwhm_radians=np.radians(0.5), mask=mask,
                                dtype=jnp.float64, grid=grid)
    model = with_cut_decomposition(model)
    bins = np.arange(2, lmax + 2)
    var = jnp.stack([variance_expansion_state(
        unfold_bins(jnp.asarray(d[2:]), bins, lmax), lmax) for d in dls])
    bt = model.bt_ninv_d()
    inv_cvar = _safe_inv(var)
    b = fluctuated_rhs(jax.random.PRNGKey(5), model, var, bt)
    x, info = cg_solve(_q_op(model, inv_cvar), b, x0=None,
                       precond_diag=cr_precond(model, var),
                       tol=1e-6, maxiter=4000, ndim_sys=2)
    assert bool(np.all(np.asarray(info.converged))), info
    iters = int(np.asarray(info.iterations))
    # measured ~90 iterations at this scale; 4x headroom against drift
    assert iters <= 350, iters
