"""The on-card smoke test's parts that run anywhere: the compile-cache
helper, the GPU guard, and chip_smoke.py's comparison functions at toy
sizes (fp32 transforms against the fp64 NumPy reference; the fast blocked-MH
engines against the direct likelihood)."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from gibbssampler.inference import example_dl, simulate_dataset  # noqa: E402
from gibbssampler.ops import with_cut_decomposition  # noqa: E402
from gibbssampler.utils import runtime  # noqa: E402

LMAX = 16


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    first = runtime.use_compile_cache()
    assert first == os.path.join(repo, ".jax_cache")
    assert runtime.use_compile_cache() == first
    assert jax.config.jax_compilation_cache_dir == first


def test_require_gpu_raises_on_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


# ---------------------------------------------------------------------------
# phase 1: fp32 transforms against the fp64 NumPy reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["matmul", "ct", "fft"])
def test_sht_reference_gl(mode):
    from gibbssampler.sht import make_sht
    lmax = 64          # nphi = 130 = 13 x 10: "ct" keeps its factorization
    sht = make_sht(lmax, dtype=jnp.float32, spin2=True, fft_mode=mode)
    assert sht.fft_mode == mode
    err = chip_smoke.check_grid_sht(sht)
    assert max(err.values()) < chip_smoke.SHT_TOL, err


@pytest.mark.parametrize("layout", ["padded", "ring"])
def test_sht_reference_healpix(layout):
    from gibbssampler.sht.healpix import make_healpix_sht
    sht = make_healpix_sht(8, LMAX, dtype=jnp.float32, spin2=True,
                           layout=layout)
    err = chip_smoke.check_grid_sht(sht)
    assert max(err.values()) < chip_smoke.SHT_TOL, err


def test_sht_reference_points():
    from gibbssampler.sht.healpix import make_healpix_sht
    nside = 8
    sht = make_healpix_sht(nside, LMAX, dtype=jnp.float32, spin2=True)
    mask = np.ones(sht.geo.npix)
    mask[[0, 1, 5, 40, 300, 700, 760, 767]] = 0.0   # caps and belt
    psht, theta, phi = chip_smoke.hole_point_sht(sht, mask, LMAX,
                                                 band_deg=0.0)
    err = chip_smoke.check_point_sht(psht, theta, phi)
    assert err["npts"] == 8
    assert max(err["synth"], err["adjoint"]) < chip_smoke.SHT_TOL, err


def test_reference_adjoint_is_transpose():
    """The fp64 reference pair is itself an exact transpose, so agreement
    with it pins both the transform and its adjoint."""
    from gibbssampler.sht import gauss_legendre_grid
    from gibbssampler.sht.legendre import spin2_lambda_tables
    lmax = 12
    grid = gauss_legendre_grid(lmax)
    lam_p, lam_m = spin2_lambda_tables(lmax, grid.theta)
    sht = type("G", (), {"grid": grid})()
    rings = chip_smoke.rings_of(sht)
    e, b = chip_smoke.random_states(lmax, 2, 4)
    q, u = chip_smoke.ref_synth_spin2(lam_p, lam_m, rings, grid.npix, e, b,
                                      lmax)
    rng = np.random.default_rng(5)
    yq, yu = rng.standard_normal((2, 2, grid.npix))
    ae, ab = chip_smoke.ref_adjoint_spin2(lam_p, lam_m, rings, yq, yu, lmax)
    lhs = np.sum(q * yq) + np.sum(u * yu)
    rhs = np.sum(e * ae) + np.sum(b * ab)
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


# ---------------------------------------------------------------------------
# phase 2: fast blocked-MH engines against the direct likelihood
# ---------------------------------------------------------------------------

def _flagship_shaped_asis(model, lmax):
    """ASIS with the flagship's blocking shape: EE one block, BB one big
    block then per-bin singles (the fast engines' eligibility)."""
    from gibbssampler.schemes import ASISGibbs
    bins = np.arange(2, lmax + 2)
    nb = len(bins) - 1
    blocks = [[(0, nb)], [(0, nb // 2)] + [(i, i + 1)
                                           for i in range(nb // 2, nb)]]
    fields = [example_dl(lmax, "ee", amp=10.0),
              example_dl(lmax, "bb", amp=10.0)]
    sig = [np.maximum(np.abs(f[2:]), 1e-5) * 4.0 for f in fields]
    scheme = ASISGibbs(model, [bins, bins], blocks, sig, n_iter_mh=1,
                       cr_method="aux_mala",
                       cr_options={"n_gibbs": 1, "tau": 0.02})
    dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)
    return scheme, dl0


def _gl_band_model():
    from gibbssampler.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    mask = np.broadcast_to((lat > 0.3)[:, None], (grid.nrings, grid.nphi))
    return mask, dict(grid=grid)


def _healpix_holey_model():
    from gibbssampler.sht.healpix import make_healpix_sht
    from gibbssampler.sht.healpix_pix import galactic_band_mask
    sht = make_healpix_sht(8, LMAX, dtype=jnp.float32, spin2=True,
                           layout="padded")
    mask = galactic_band_mask(8, 20.0)
    mask[0:4] = 0.0                      # cap-ring holes -> sparse points
    mask[-3:] = 0.0
    return mask, dict(sht=sht)


@pytest.mark.parametrize("build", [_gl_band_model, _healpix_holey_model],
                         ids=["gl_band", "healpix_holes"])
def test_mh_engine_check(build):
    mask, kw = build()
    fields = np.stack([example_dl(LMAX, "ee", amp=10.0),
                       example_dl(LMAX, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(0), LMAX, spin=2,
                                dl_fields=fields, noise_sigma2=0.5,
                                fwhm_radians=0.05, mask=mask,
                                dtype=jnp.float32, **kw)
    model = with_cut_decomposition(model)
    scheme, dl0 = _flagship_shaped_asis(model, LMAX)
    r = chip_smoke.mh_engine_check(scheme, dl0, nchains=3)
    assert r["finite"]
    assert r["agree"] >= chip_smoke.MH_AGREE, r
    assert r["dl_rel"] <= chip_smoke.MH_DL_REL, r
    assert 0.0 < r["accept_fast"] < 1.0, r
