"""Pure-numpy FITS HEALPix map I/O (the reference's hp.read_map role,
reference: config.py:126-128)."""

import numpy as np
import pytest

from gibbssampler.inference.fits_io import (
    read_healpix_map, write_healpix_map, nest2ring, ring2nest)
from gibbssampler.sht.healpix_pix import (ang2pix_ring, pix2ang_ring,
                                              ud_grade, galactic_band_mask)


@pytest.mark.parametrize("nside", [1, 2, 4, 8, 16])
def test_nest2ring_is_permutation(nside):
    n2r = nest2ring(nside)
    npix = 12 * nside * nside
    assert sorted(n2r.tolist()) == list(range(npix))
    r2n = ring2nest(nside)
    assert (r2n[n2r] == np.arange(npix)).all()


@pytest.mark.parametrize("nside", [2, 4, 8])
def test_nest_hierarchy_consistency(nside):
    """Nested child q (at 2 nside) sits inside nested parent q // 4 (at
    nside): checked through the independently-pinned ang2pix/pix2ang RING
    formulas — a geometric cross-validation of the bit-deinterleave map."""
    fine = 2 * nside
    q = np.arange(12 * fine * fine)
    th, ph = pix2ang_ring(fine, nest2ring(fine, q))
    parent_ring = ang2pix_ring(nside, th, ph)
    expect = nest2ring(nside, q // 4)
    assert (parent_ring == expect).all()


@pytest.mark.parametrize("ordering", ["RING", "NESTED"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_read_roundtrip(tmp_path, ordering, dtype):
    rng = np.random.default_rng(3)
    nside = 8
    maps = rng.normal(size=(2, 12 * nside * nside))
    path = tmp_path / "map.fits"
    write_healpix_map(path, maps, ordering=ordering, dtype=dtype,
                      names=["I_STOKES", "Q_STOKES"])
    back, hdr = read_healpix_map(path, field=None)
    tol = 1e-6 if dtype == np.float32 else 1e-14
    np.testing.assert_allclose(back, maps, rtol=tol, atol=tol)
    assert hdr["NSIDE"] == nside
    assert hdr["_names"] == ["I_STOKES", "Q_STOKES"]
    one, _ = read_healpix_map(path, field=1)
    np.testing.assert_allclose(one, maps[1], rtol=tol, atol=tol)


def test_mask_pipeline_via_fits(tmp_path):
    """End-to-end reference mask flow: read FITS mask -> ud_grade ->
    NoiseModel (reference: config.py:126-128 + ConstrainedRealization.py:36)."""
    import jax.numpy as jnp
    from gibbssampler.ops import NoiseModel
    from gibbssampler.sht.healpix import healpix_geometry

    m16 = galactic_band_mask(16, 20.0)
    path = tmp_path / "mask.fits"
    write_healpix_map(path, m16, ordering="NESTED", dtype=np.float32)
    m, hdr = read_healpix_map(path)
    np.testing.assert_allclose(m, m16, atol=1e-6)
    m8 = ud_grade(m, 8)
    geo = healpix_geometry(8)
    noise = NoiseModel.white_healpix(0.2 ** 2, geo, nfields=2,
                                     mask=(m8 > 0.5).astype(float),
                                     dtype=jnp.float64)
    f = float(noise.f_sky[0])
    assert 0.55 < f < 0.8
