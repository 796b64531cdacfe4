"""Runner / checkpoint-resume tests (SURVEY.md 5 rebuild items)."""

import os
import numpy as np
import jax.numpy as jnp
import pytest

from gibbssampler.inference import RunConfig, run_experiment, load_checkpoint


def test_run_experiment_and_resume(tmp_path):
    out = str(tmp_path / "res.npz")
    cfg = RunConfig(lmax=12, spin=0, scheme="centered", cr_method="exact",
                    n_iter=40, nchains=2, segment=15, dtype="float64",
                    out=out, noise_sigma2=1.0)
    logs = []
    res = run_experiment(cfg, verbose=logs.append)
    assert os.path.exists(out)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 40, 11)
    assert np.isfinite(z["dl_chain_0"]).all()
    assert len(z["durations"]) == 3   # 15 + 15 + 10
    assert not os.path.exists(out + ".ckpt.npz")

    # simulate a crash: run 1 segment, then resume to completion
    out2 = str(tmp_path / "res2.npz")
    cfg2 = RunConfig(lmax=12, spin=0, scheme="centered", cr_method="exact",
                     n_iter=30, nchains=2, segment=10, dtype="float64",
                     out=out2, noise_sigma2=1.0)
    # run only the first segment by lying about n_iter, then restore
    cfg_first = RunConfig(**{**cfg2.__dict__, "n_iter": 10})
    run_experiment(cfg_first, verbose=lambda *a: None)
    # re-create the mid-run checkpoint state: run again with full n_iter but
    # pre-seed the checkpoint from the 10-iteration run
    os.rename(out2, out2 + ".bak")
    z10 = np.load(out2 + ".bak")
    from gibbssampler.inference import save_checkpoint
    from gibbssampler.schemes import GibbsState
    import jax
    state = GibbsState(
        s=jnp.zeros((2, 1, 338)),
        dl=(jnp.asarray(z10["dl_chain_0"][:, -1, :]),))
    save_checkpoint(out2 + ".ckpt.npz", jax.random.PRNGKey(9), state,
                    [z10["dl_chain_0"]], 10)
    logs2 = []
    run_experiment(cfg2, resume=True, verbose=logs2.append)
    assert any("resumed at iteration 10" in str(l) for l in logs2)
    z = np.load(out2)
    assert z["dl_chain_0"].shape == (2, 30, 11)


def test_run_experiment_asis_allsph(tmp_path):
    out = str(tmp_path / "asis.npz")
    cfg = RunConfig(lmax=12, spin=0, scheme="asis", cr_method="exact",
                    n_iter=20, nchains=2, segment=20, dtype="float64",
                    out=out, all_sph=True, noise_sigma2=50.0, blocks_size=4)
    res = run_experiment(cfg, verbose=lambda *a: None)
    z = np.load(out)
    assert np.isfinite(z["dl_chain_0"]).all()
    assert z["ess_0"].shape == (11,)


def test_load_cls(tmp_path):
    from gibbssampler.inference import load_cls
    # npy layout
    arr = np.stack([np.arange(20.0), np.ones(20), np.zeros(20), np.ones(20)])
    p = str(tmp_path / "cls.npy"); np.save(p, arr)
    out = load_cls(p, lmax=15)
    assert out["tt"].shape == (16,)
    assert out["tt"][0] == 0 and out["tt"][1] == 0
    assert out["tt"][5] == 5.0
    # CAMB-style text with C_ell input
    txt = str(tmp_path / "cls.txt")
    ell = np.arange(2, 16)
    np.savetxt(txt, np.column_stack([ell, np.ones_like(ell, dtype=float)]))
    out2 = load_cls(txt, lmax=15, columns=("tt",), input_is_dl=False)
    assert np.isclose(out2["tt"][10], 10 * 11 / (2 * np.pi))


def test_run_experiment_healpix_grid(tmp_path):
    out = str(tmp_path / "hp.npz")
    cfg = RunConfig(lmax=16, spin=0, grid="healpix", nside=8,
                    scheme="centered", cr_method="cg",
                    cr_options={"cg_tol": 1e-7, "cg_maxiter": 200},
                    mask_band_deg=10.0, n_iter=20, nchains=2, segment=20,
                    dtype="float64", out=out, noise_sigma2=5.0)
    run_experiment(cfg, verbose=lambda *a: None)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 20, 15)
    assert np.isfinite(z["dl_chain_0"]).all()


def test_run_experiment_mask_fits(tmp_path):
    """Real-mask pipeline end-to-end (reference: config.py:22-28,126-128):
    a HEALPix mask written to FITS at a different nside is read back,
    ud_graded to the analysis nside, and drives the masked run."""
    from gibbssampler.inference.fits_io import write_healpix_map
    from gibbssampler.inference.runner import _build
    from gibbssampler.sht.healpix_pix import galactic_band_mask
    fits = str(tmp_path / "mask.fits")
    write_healpix_map(fits, galactic_band_mask(16, 15.0), ordering="RING")
    out = str(tmp_path / "mf.npz")
    cfg = RunConfig(lmax=16, spin=0, grid="healpix", nside=8,
                    scheme="centered", cr_method="cg",
                    cr_options={"cg_tol": 1e-7, "cg_maxiter": 300},
                    mask_fits=fits, n_iter=10, nchains=2, segment=10,
                    dtype="float64", out=out, noise_sigma2=5.0)
    scheme, _, _ = _build(cfg)
    f_sky = float(np.asarray(scheme.model.noise.f_sky)[0])
    assert 0.5 < f_sky < 0.95        # the FITS mask actually took effect
    run_experiment(cfg, verbose=lambda *a: None)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 10, 15)
    assert np.isfinite(z["dl_chain_0"]).all()
    # HEALPix pixel masks have no meaning on the GL quadrature grid
    with pytest.raises(ValueError, match="mask_fits"):
        _build(RunConfig(lmax=16, grid="gl", mask_fits=fits))


def test_run_experiment_joint(tmp_path):
    """scheme='joint' is a first-class runner path: segmented like every
    other scheme, with per-segment durations, CR acceptance histories,
    per-phase step timings, and ESS/R-hat summaries over the unique
    (l >= lmin, upper-triangle) block entries."""
    out = str(tmp_path / "joint.npz")
    cfg = RunConfig(lmax=10, spin=3, scheme="joint", n_iter=20, nchains=2,
                    segment=8, dtype="float64", out=out, noise_sigma2=0.5,
                    time_steps=True)
    res = run_experiment(cfg, verbose=lambda *a: None)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 20, 11, 3, 3)
    assert np.isfinite(z["dl_chain_0"]).all()
    assert len(z["durations"]) == 3               # 8 + 8 + 4
    assert not os.path.exists(out + ".ckpt.npz")
    assert z["cr_accept_chain"].shape[1] == 20
    assert z["step_time_full"].shape == (3,)
    # summaries over (L - lmin) * k(k+1)/2 = 9 * 6 scalar series
    assert z["ess_0"].shape == (54,)
    assert np.isfinite(z["ess_0"]).all()


def test_run_experiment_joint_crash_resume(tmp_path):
    """Joint runs resume from a mid-run checkpoint exactly like the scalar
    schemes (the scalar path's crash-resume contract)."""
    import jax
    from gibbssampler.inference import save_checkpoint
    from gibbssampler.schemes.joint_scheme import JointState

    out = str(tmp_path / "jr.npz")
    cfg = RunConfig(lmax=10, spin=3, scheme="joint", n_iter=24, nchains=2,
                    segment=8, dtype="float64", out=out, noise_sigma2=0.5)
    # run the first segment only, then rebuild its checkpoint and resume
    cfg_first = RunConfig(**{**cfg.__dict__, "n_iter": 8})
    run_experiment(cfg_first, verbose=lambda *a: None)
    z8 = np.load(out)
    nstate = 2 * 11 * 11
    state = JointState(s=jnp.zeros((2, 3, nstate)),
                       cl=jnp.asarray(z8["dl_chain_0"][:, -1]))
    save_checkpoint(out + ".ckpt.npz", jax.random.PRNGKey(9), state,
                    [z8["dl_chain_0"]], 8)
    logs = []
    run_experiment(cfg, resume=True, verbose=logs.append)
    assert any("resumed at iteration 8" in str(l) for l in logs)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 24, 11, 3, 3)
    assert np.isfinite(z["dl_chain_0"]).all()


def test_run_experiment_joint_te_masked(tmp_path):
    """TE-correlated data through the full runner pipeline on a MASKED sky:
    simulate_dataset draws correlated TQU fields (synfast_joint) and the
    joint scheme's block-preconditioned CG path recovers the TE correlation
    (the reference's 3x3 scaffold intent, variance_expension.pyx:36-61)."""
    out = str(tmp_path / "jte.npz")
    r_te = 0.7
    cfg = RunConfig(lmax=10, spin=3, scheme="joint", cr_method="cg",
                    cr_options={"cg_tol": 1e-8, "cg_maxiter": 400},
                    r_te=r_te, mask_band_deg=15.0, n_iter=150, nchains=4,
                    dtype="float64", out=out, noise_sigma2=1e-3)
    run_experiment(cfg, verbose=lambda *a: None)
    z = np.load(out)
    chain = z["dl_chain_0"]                       # (4, 150, 11, 3, 3)
    assert np.isfinite(chain).all()
    post = chain[:, 50:].mean(axis=(0, 1))
    r = post[4:, 0, 1] / np.sqrt(post[4:, 0, 0] * post[4:, 1, 1])
    # high-SNR: the posterior TE correlation tracks the realization, whose
    # per-ell scatter is ~sqrt((1-r^2)^2/(2l+1)); the ell-average pins r_te
    assert abs(float(r.mean()) - r_te) < 0.25, r
    # the uncorrelated default stays near zero on the same seed
    out2 = str(tmp_path / "jte0.npz")
    cfg0 = RunConfig(**{**cfg.__dict__, "r_te": 0.0, "out": out2,
                        "n_iter": 100})
    run_experiment(cfg0, verbose=lambda *a: None)
    post0 = np.load(out2)["dl_chain_0"][:, 40:].mean(axis=(0, 1))
    r0 = post0[4:, 0, 1] / np.sqrt(post0[4:, 0, 0] * post0[4:, 1, 1])
    assert abs(float(r0.mean())) < 0.3, r0


def test_runner_step_phase_times(tmp_path):
    """time_steps=True stores fenced per-segment CR-step / C_ell-step device
    times with the chain (the reference's per-step timer histories,
    GibbsSampler.py:151-168)."""
    out = str(tmp_path / "pt.npz")
    cfg = RunConfig(lmax=12, spin=0, scheme="asis", cr_method="exact",
                    n_iter=20, nchains=2, segment=10, dtype="float64",
                    out=out, all_sph=True, noise_sigma2=50.0, blocks_size=4,
                    time_steps=True)
    run_experiment(cfg, verbose=lambda *a: None)
    z = np.load(out)
    assert z["step_time_cr"].shape == (2,)        # one entry per segment
    assert z["step_time_cls"].shape == (2,)
    assert (z["step_time_full"] > 0).all()
    assert (z["step_time_cr"] >= 0).all() and (z["step_time_cls"] >= 0).all()


def test_analytic_proposal_sigma_formula():
    """Pins the closed-form heuristic against a direct per-ell computation
    (reference: config.py:119-134)."""
    from gibbssampler.parallel.adapt import analytic_proposal_sigma
    lmax = 16
    bl = np.exp(-0.001 * np.arange(lmax + 1) ** 2)
    omega, n = 4 * np.pi / (12 * 64), 0.04
    bins = np.array([2, 5, 9, 17])
    sig = analytic_proposal_sigma(bl, n, omega, lmax, bins, f_sky=0.8)
    for b, (lo, hi) in enumerate(zip(bins[:-1], bins[1:])):
        acc = []
        for l in range(lo, hi):
            dnl = l * (l + 1) / (2 * np.pi) * omega * n / bl[l] ** 2
            acc.append(2.0 / (2 * l + 1) * dnl ** 2 / 0.8)
        expect = np.sqrt(np.mean(acc) / (hi - lo))
        np.testing.assert_allclose(sig[b], expect, rtol=1e-12)


def test_preliminary_run_proposal_reload(tmp_path):
    """Two-phase workflow round trip (reference: config.py:136-225):
    run a preliminary experiment, pool its saved chains into proposal
    sigmas, feed them to a second run via RunConfig.proposal_from."""
    from gibbssampler.parallel import proposal_sigmas_from_results
    out1 = str(tmp_path / "prelim.npz")
    # noise-dominated regime (the regime the pooled-variance proposal rule
    # is built for — the reference tunes the high-l blocks this way): at
    # lmax=12 the example spectrum needs a large pixel noise to dominate
    # single-bin blocks: the 2.38 sd rule is the 1-d random-walk optimum
    # (the reference's production high-l blocks are single-bin too)
    cfg1 = RunConfig(lmax=12, spin=0, scheme="asis", cr_method="exact",
                     n_iter=60, nchains=4, segment=60, dtype="float64",
                     out=out1, all_sph=True, noise_sigma2=5e3, blocks_size=1)
    run_experiment(cfg1, verbose=lambda *a: None)
    sig = proposal_sigmas_from_results(out1, nfields=1)
    assert len(sig) == 1 and sig[0].shape == (11,) and (sig[0] > 0).all()
    # pins the pooled computation: 2.38 * sd over (chains x post-burn iters)
    z = np.load(out1)
    c = z["dl_chain_0"][:, 12:].reshape(-1, 11)
    np.testing.assert_allclose(
        sig[0], np.maximum(2.38 * c.std(axis=0), 1e-12), rtol=1e-12)
    # phase two: the tuned run completes with sane acceptance
    out2 = str(tmp_path / "tuned.npz")
    cfg2 = RunConfig(**{**cfg1.__dict__, "out": out2, "proposal_from": out1,
                        "n_iter": 30, "segment": 30, "seed": 3})
    run_experiment(cfg2, verbose=lambda *a: None)
    z2 = np.load(out2)
    assert np.isfinite(z2["dl_chain_0"]).all()
    assert z2["mh_accept_0"].mean() > 0.05


def test_runner_saves_acceptance_histories(tmp_path):
    """The results npz carries per-block MH and per-iteration CR acceptance
    arrays, like the reference's result dict (main_polarization.py:175-185)."""
    out = str(tmp_path / "acc.npz")
    cfg = RunConfig(lmax=12, spin=0, scheme="asis", cr_method="exact",
                    n_iter=20, nchains=2, segment=10, dtype="float64",
                    out=out, all_sph=True, noise_sigma2=50.0, blocks_size=4)
    run_experiment(cfg, verbose=lambda *a: None)
    z = np.load(out)
    assert z["cr_accept_chain"].shape == (2, 20)
    nblocks = -(-11 // 4)
    assert z["mh_accept_0"].shape == (2, 20, nblocks)
    a = z["mh_accept_0"]
    assert ((a >= 0) & (a <= 1)).all()
    assert a.mean() > 0.01      # something must get accepted
