"""Dataset simulation (the reference's generate_dataset,
main_polarization.py:25-59, and generate_cls, utils.py:17-47).

The reference calls the CLASS Boltzmann code for theory spectra; inside the
MCMC loop spectra are never recomputed, so the framework ships a file loader
plus a CMB-like analytic default (damped acoustic-peak toy spectrum) and
simulates skies with its own SHT (hp.synfast equivalent)."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..harmonics.gridstate import (almxfl_state, nstate,
                                   variance_expansion_state)
from ..harmonics.spectra import gauss_beam
from ..ops.noise import NoiseModel
from ..ops.model import SkyModel
from ..sht.transform import SHT, make_sht

__all__ = ["example_dl", "synfast", "simulate_dataset"]


def example_dl(lmax: int, kind: str = "tt", amp: float = 1000.0) -> np.ndarray:
    """A CMB-like D_ell toy spectrum (muK^2): damped oscillatory acoustic
    structure — stands in for the CLASS/CAMB output the reference loads
    (utils.py:17-47); any positive spectrum exercises the same code paths."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    x = ell / 220.0
    osc = 1.0 + 0.6 * np.cos(np.pi * x)
    damp = np.exp(-((ell / (0.8 * max(lmax, 2))) ** 2))
    sw = (1.0 + x) ** -1.2
    dl = amp * sw * osc * damp + 1e-3 * amp
    if kind == "ee":
        dl = 0.01 * dl * (ell / 100.0) ** 2 / (1.0 + (ell / 100.0) ** 2)
        dl += 1e-5 * amp
    elif kind == "bb":
        dl = 1e-4 * amp * (ell / 80.0) ** 2 / (1.0 + (ell / 80.0) ** 4)
        dl += 1e-6 * amp
    dl[:2] = 0.0
    return dl


def synfast(key, dl_fields, sht: SHT, spin: int):
    """Draw a Gaussian sky: alm ~ N(0, C_l) per field, return (alm, maps).

    dl_fields: (nfields, lmax+1) D_ell.  spin 0 -> T map (1, nr, nphi);
    spin 2 -> (E, B) alm and (Q, U) maps (hp.synfast equivalent,
    main_polarization.py:36)."""
    lmax = sht.lmax
    dl_fields = jnp.asarray(dl_fields, dtype=sht.dtype)
    nf = dl_fields.shape[0]
    var = jax.vmap(lambda d: variance_expansion_state(d, lmax))(dl_fields)
    alm = jnp.sqrt(var) * jax.random.normal(key, (nf, nstate(lmax)),
                                            dtype=sht.dtype)
    if spin == 0:
        maps = sht.synthesis_state(alm[0])[None]
    else:
        q, u = sht.synthesis_spin2_state(alm[0], alm[1])
        maps = jnp.stack([q, u], axis=0)
    return alm, maps


@jax.jit
def _simulate_core(sht, noise, bl, key, dl_fields, mask_arr, dl_blocks=None):
    lmax = sht.lmax
    """One compiled unit for the whole simulation pipeline."""
    spin = {1: 0, 2: 2, 3: 3}[dl_fields.shape[0]]
    ksky, knoise = jax.random.split(key)
    if dl_blocks is not None:
        # correlated fields from per-ell D_ell covariance blocks (e.g. a
        # nonzero TE): s = L_ell xi per slot via samplers.synfast_joint
        from ..samplers.joint import synfast_joint
        ell = jnp.arange(lmax + 1, dtype=bl.dtype)
        cl_fac = jnp.where(ell >= 2, 2.0 * jnp.pi
                           / jnp.where(ell >= 2, ell * (ell + 1.0), 1.0), 0.0)
        alm_true = synfast_joint(ksky, dl_blocks * cl_fac[:, None, None],
                                 lmax, dtype=bl.dtype)
    else:
        var = jax.vmap(lambda dd: variance_expansion_state(dd, lmax))(
            dl_fields)
        alm_true = jnp.sqrt(var) * jax.random.normal(
            ksky, var.shape, dtype=bl.dtype)
    alm_beamed = almxfl_state(alm_true, bl, lmax)
    if spin == 0:
        sky = sht.synthesis_state(alm_beamed[0])[None]
    elif spin == 3:
        t = sht.synthesis_state(alm_beamed[0])
        q, u = sht.synthesis_spin2_state(alm_beamed[1], alm_beamed[2])
        sky = jnp.stack([t, q, u], axis=0)
    else:
        q, u = sht.synthesis_spin2_state(alm_beamed[0], alm_beamed[1])
        sky = jnp.stack([q, u], axis=0)
    inv = noise.inv_noise
    std = jnp.where(inv > 0, 1.0 / jnp.sqrt(jnp.where(inv > 0, inv, 1.0)), 0.0)
    d = sky + std * jax.random.normal(knoise, sky.shape, dtype=bl.dtype)
    if mask_arr is not None:
        d = d * mask_arr
    return alm_true, sky, d


def simulate_dataset(key, lmax: int, spin: int, dl_fields,
                     noise_sigma2, fwhm_radians: float = 0.0,
                     mask=None, dtype=jnp.float32, grid=None, sht=None,
                     dl_blocks=None):
    """Simulate d = A B s + n and return a ready-to-sample SkyModel.

    Mirrors the reference pipeline (generate_dataset,
    main_polarization.py:25-59): theory D_l -> beam-smoothed Gaussian sky ->
    white noise -> optional mask; returns (model, truth dict).

    dl_blocks: optional (lmax+1, nfields, nfields) per-ell D_ell covariance
    blocks — draws the fields *correlated* (e.g. a nonzero TE, the joint
    model the reference scaffolded with its 3x3 variance kernel,
    variance_expension.pyx:36-61).  The diagonal must equal dl_fields."""
    if sht is None:
        sht = make_sht(lmax, grid=grid, dtype=dtype, spin2=(spin >= 2))
    bl = gauss_beam(fwhm_radians, lmax, dtype=dtype) if fwhm_radians > 0 \
        else jnp.ones(lmax + 1, dtype=dtype)
    nf = {0: 1, 2: 2, 3: 3}[spin]
    dl_fields = jnp.asarray(np.asarray(dl_fields), dtype=dtype)
    mask_arr = None if mask is None else jnp.asarray(mask, dtype=dtype)
    from ..sht.healpix import HealpixSHT
    if isinstance(sht, HealpixSHT):
        # HEALPix (ring or padded layout): masks are given in RING order
        noise = NoiseModel.white_healpix(noise_sigma2, sht.geo, nfields=nf,
                                         mask=mask, dtype=dtype, sht=sht)
        if mask_arr is not None and sht.layout == "padded":
            mask_arr = sht.from_ring(mask_arr)
    else:
        noise = NoiseModel.white(noise_sigma2, sht.grid, nfields=nf,
                                 mask=mask, dtype=dtype)
    blocks = (None if dl_blocks is None
              else jnp.asarray(np.asarray(dl_blocks), dtype=dtype))
    alm_true, sky, d = _simulate_core(sht, noise, bl, key, dl_fields,
                                      mask_arr, blocks)
    model = SkyModel(sht=sht, noise=noise, bl=bl, spin=spin, d=d)
    truth = {"alm_true": alm_true, "dl_true": dl_fields, "sky": sky}
    if blocks is not None:
        truth["dl_blocks_true"] = blocks
    return model, truth
