"""Multi-device tests on the virtual 8-device CPU mesh (stand-in for a
multi-GPU host; SURVEY.md 4 'Implication for the rebuild')."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gibbssampler.harmonics import nflat
from gibbssampler.inference import example_dl, simulate_dataset
from gibbssampler.ops import SkyModel
from gibbssampler.parallel import make_mesh, shard_sht, sharded_run
from gibbssampler.schemes import CenteredGibbs

LMAX = 8


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_run_matches_unsharded():
    dl = example_dl(LMAX, amp=10.0)
    model, _ = simulate_dataset(jax.random.PRNGKey(0), LMAX, spin=0,
                                dl_fields=dl[None], noise_sigma2=1.0,
                                dtype=jnp.float64)
    bins = np.arange(2, LMAX + 2)
    scheme = CenteredGibbs(model, [bins], cr_method="exact")
    mesh = make_mesh(n_chains=8, n_m=1)
    out_s = sharded_run(scheme, jax.random.PRNGKey(1), (dl[2:],),
                        n_iter=50, nchains=8, mesh=mesh)
    out_u = scheme.run(jax.random.PRNGKey(1), (dl[2:],), n_iter=50, nchains=8)
    np.testing.assert_allclose(np.asarray(out_s["dl_chains"][0]),
                               np.asarray(out_u["dl_chains"][0]),
                               rtol=1e-10)


def test_m_sharded_sht_matches_single_device():
    mesh = make_mesh(n_chains=2, n_m=4)
    from gibbssampler.sht import make_sht
    sht = make_sht(LMAX, dtype=jnp.float64)
    msht = shard_sht(sht, mesh)
    key = jax.random.PRNGKey(2)
    flat = jax.random.normal(key, (4, nflat(LMAX)))

    with mesh:
        maps = jax.jit(msht.synthesis)(flat)
        back = jax.jit(msht.analysis)(maps)
    ref = sht.synthesis(flat)
    np.testing.assert_allclose(np.asarray(maps), np.asarray(ref), atol=1e-12)
    np.testing.assert_allclose(np.asarray(back), np.asarray(flat), atol=1e-11)


def test_sharded_model_gibbs_step():
    """Full Gibbs step jitted over a ('chains', 'm') mesh with the SHT's
    m axis sharded (dp x sp-analogue)."""
    mesh = make_mesh(n_chains=2, n_m=4)
    dl = example_dl(LMAX, amp=10.0)
    model, _ = simulate_dataset(jax.random.PRNGKey(3), LMAX, spin=0,
                                dl_fields=dl[None], noise_sigma2=1.0,
                                dtype=jnp.float64)
    model_sharded = SkyModel(sht=shard_sht(model.sht, mesh),
                             noise=model.noise, bl=model.bl,
                             spin=model.spin, d=model.d)
    bins = np.arange(2, LMAX + 2)
    scheme = CenteredGibbs(model_sharded, [bins], cr_method="cg",
                           cr_options={"cg_tol": 1e-9, "cg_maxiter": 200})
    with mesh:
        out = sharded_run(scheme, jax.random.PRNGKey(4), (dl[2:],),
                          n_iter=10, nchains=4, mesh=mesh)
    chain = np.asarray(out["dl_chains"][0])
    assert chain.shape == (4, 10, LMAX - 1)
    assert np.isfinite(chain).all()


def test_adapt_segments_tunes_sigmas():
    """Warmup adaptation drives the proposal scales toward the pooled
    posterior spread (replacing the reference's offline two-phase tuning,
    config.py:136-225)."""
    from gibbssampler.inference import example_dl, simulate_dataset
    from gibbssampler.parallel import adapt_segments
    from gibbssampler.schemes import NonCenteredGibbs

    lmax = 10
    dl = example_dl(lmax, amp=10.0)
    model, _ = simulate_dataset(jax.random.PRNGKey(0), lmax, spin=0,
                                dl_fields=dl[None], noise_sigma2=50.0,
                                dtype=jnp.float64)
    bins = np.arange(2, lmax + 2)
    nb = len(bins) - 1
    blocks = [(i, min(i + 2, nb)) for i in range(0, nb, 2)]
    d_alm = model.sht.analysis_state(model.d[0])[None]

    def make(sig):
        return NonCenteredGibbs(model, [bins], [blocks], sig, n_iter_mh=1,
                                all_sph=True, d_alm=d_alm[0])

    sig0 = [np.full(nb, 1e-4)]    # absurdly narrow start
    sig, dl_start, out = adapt_segments(
        make, jax.random.PRNGKey(1), (dl[2:],), sig0, n_segments=2,
        seg_iters=150, nchains=4)
    assert np.all(sig[0] > 1e-4)           # scales opened up
    acc = np.asarray(out["mh_accept"][0]).mean()
    assert np.isfinite(acc)


def test_device_rhat_matches_numpy():
    from gibbssampler.parallel import split_rhat_device
    from gibbssampler.diagnostics import split_rhat
    rng = np.random.default_rng(3)
    chains = rng.normal(size=(4, 400, 2))
    chains[2] += 0.5   # introduce between-chain spread
    r_dev = np.asarray(jax.jit(split_rhat_device)(jnp.asarray(chains)))
    for p in range(2):
        r_np = split_rhat(chains[:, :, p])
        assert abs(r_dev[p] - r_np) < 1e-10


def test_device_rhat_sharded():
    """Pooled R-hat inside a jit over a sharded chain axis."""
    from gibbssampler.parallel import make_mesh, chain_sharding, \
        split_rhat_device
    mesh = make_mesh(n_chains=8, n_m=1)
    rng = np.random.default_rng(4)
    chains = jnp.asarray(rng.normal(size=(8, 100, 3)))
    chains = jax.device_put(chains, chain_sharding(mesh, 3))
    with mesh:
        r = jax.jit(split_rhat_device)(chains)
    assert np.all(np.asarray(r) < 1.2)


@pytest.mark.parametrize("method,spin", [("cg", 2), ("rjpo", 2), ("cg", 3)])
def test_m_sharded_cr_matches_unsharded(method, spin):
    """cg / rjpo CR solves under m-sharding (n_m = 4, non-divisible lmax+1)
    reproduce the single-device chains bit-for-bit (same keys)."""
    lmax = 9                     # lmax+1 = 10, not divisible by 4
    if spin == 2:
        fields = np.stack([example_dl(lmax, "ee", amp=10.0),
                           example_dl(lmax, "bb", amp=10.0)])
    else:
        fields = np.stack([example_dl(lmax, "tt", amp=10.0),
                           example_dl(lmax, "ee", amp=10.0),
                           example_dl(lmax, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(5), lmax, spin=spin,
                                dl_fields=fields, noise_sigma2=0.5,
                                dtype=jnp.float64)
    mesh = make_mesh(n_chains=2, n_m=4)
    model_sh = SkyModel(sht=shard_sht(model.sht, mesh), noise=model.noise,
                        bl=model.bl, spin=model.spin, d=model.d)
    bins = np.arange(2, lmax + 2)
    nf = model.nfields
    opts = {"cg_tol": 1e-10, "cg_maxiter": 400}
    dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)
    scheme_u = CenteredGibbs(model, [bins] * nf, cr_method=method,
                             cr_options=opts)
    scheme_s = CenteredGibbs(model_sh, [bins] * nf, cr_method=method,
                             cr_options=opts)
    out_u = scheme_u.run(jax.random.PRNGKey(6), dl0, n_iter=8, nchains=2)
    out_s = sharded_run(scheme_s, jax.random.PRNGKey(6), dl0, n_iter=8,
                        nchains=2, mesh=mesh)
    for f in range(nf):
        np.testing.assert_allclose(np.asarray(out_s["dl_chains"][f]),
                                   np.asarray(out_u["dl_chains"][f]),
                                   rtol=1e-7, atol=1e-10)


def test_sharded_cut_fastpath_matches_unsharded():
    """Flagship configuration (cut decomposition + rank-one blocked MH +
    overrelaxed aux CR) under chain+m sharding reproduces the single-device
    chains with identical keys."""
    from gibbssampler.ops import with_cut_decomposition
    from gibbssampler.schemes import ASISGibbs
    from gibbssampler.sht import gauss_legendre_grid

    lmax = 9
    grid = gauss_legendre_grid(lmax)
    lat = np.abs(np.pi / 2 - grid.theta)
    mask = np.broadcast_to((lat > 0.3)[:, None],
                           (grid.nrings, grid.nphi)).astype(np.float64)
    fields = np.stack([example_dl(lmax, "ee", amp=10.0),
                       example_dl(lmax, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(7), lmax, spin=2,
                                dl_fields=fields, noise_sigma2=0.5,
                                mask=mask, dtype=jnp.float64)
    mesh = make_mesh(n_chains=2, n_m=4)
    model_sh = SkyModel(sht=shard_sht(model.sht, mesh), noise=model.noise,
                        bl=model.bl, spin=model.spin, d=model.d)
    bins = np.arange(2, lmax + 2)
    nb = len(bins) - 1
    blocks = [[(0, nb)], [(0, nb // 2)] + [(i, i + 1)
                                           for i in range(nb // 2, nb)]]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 0.4 for f in fields]
    dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)
    kw = dict(n_iter_mh=1, cr_method="overrelax")
    sch_u = ASISGibbs(with_cut_decomposition(model), [bins] * 2, blocks,
                      sig, **kw)
    sch_s = ASISGibbs(with_cut_decomposition(model_sh), [bins] * 2, blocks,
                      sig, **kw)
    assert sch_u._use_cut_mh and sch_s._use_cut_mh
    out_u = sch_u.run(jax.random.PRNGKey(8), dl0, n_iter=10, nchains=2)
    out_s = sharded_run(sch_s, jax.random.PRNGKey(8), dl0, n_iter=10,
                        nchains=2, mesh=mesh)
    for f in range(2):
        np.testing.assert_allclose(np.asarray(out_s["dl_chains"][f]),
                                   np.asarray(out_u["dl_chains"][f]),
                                   rtol=1e-7, atol=1e-10)
