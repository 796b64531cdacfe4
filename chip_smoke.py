"""On-card smoke test of the flagship masked-polarization Gibbs path.

Run from the repository root on a machine with NVIDIA GPUs:

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded flagship only

Phases, in order (each prints its measurements beside their tolerances):

1. device  - ``nvidia-smi`` name and power limit, JAX device kind and
             version, the compile-cache directory in use.
2. sht     - the bench's spin-2 transforms in fp32 (Gauss-Legendre lmax=512
             in all three ``fft_mode``s, HEALPix nside=256, and the
             point-set transform at the planckish mask's hole pixels)
             against a host NumPy fp64 evaluation built from the same
             ``legendre.py`` tables plus ``numpy.fft``; then the Legendre
             and azimuthal stage times at 128 chains.
3. mh      - one blocked-MH C_ell sweep of the flagship ASIS scheme through
             the fast engine (``mh_fast="auto"``) and through the direct
             pixel likelihood (``mh_fast="off"``) on identical inputs and
             keys, band mask (GL) and planckish mask (HEALPix nside=256).
4. flagship- ``bench.build()`` at 128 chains (GL band, then HEALPix
             planckish) through ``_init_scheme``/``_scan_scheme``, and
             ``run_experiment`` at lmax=512 (single-bin MH blocks, so the
             fast engine checked in phase 3) with a checkpoint in a
             temporary directory: finite states, D_ell > 0, acceptance in
             (0, 1), compile seconds, ms/iter, the scan executable's
             device bytes and the process's peak device bytes.

``--four`` runs only the four-card phase: the flagship at 128 chains on a
(chains=4, m=1) mesh in fp32 and on a (chains=2, m=2) mesh in fp64, each
against the same scheme on one card with the same keys, plus the fp32
m-sharded SHT pair against one card; it checks that tables and states sit
on all four cards.

The last line of stdout is ``{"ok": true, "device": {...}}``.  Without a
GPU, or when any check fails, the script exits non-zero and prints no
result line.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

from gibbssampler.harmonics.gridstate import nstate, state_masks
from gibbssampler.sht.legendre import spin2_lambda_tables
from gibbssampler.utils import require_gpu, use_compile_cache

LMAX = 512
NSIDE = 256
NCHAINS = 128

# fp32 transforms against the fp64 reference, relative L2 error: fp32
# rounding (2^-24 ~ 6e-8) grows with the ~L-term Legendre and ~nphi-term
# azimuthal sums to ~1e-6; TF32 inputs (2^-11) would land near 1e-3
SHT_TOL = 2e-5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# ---------------------------------------------------------------------------
# fp64 NumPy reference of the spin-2 synthesis A and its transpose A^T
#
# A: grid-packed (E, B) states -> (Q, U) with a+ = -(E + iB), a- = -(E - iB),
#    F+-_m(theta) = sum_l lambda(+-2)_lm(theta) a+-_lm and
#    Q + iU = sum_{m>=0} F+_m e^{im phi} + sum_{m>0} conj(F-_m) e^{-im phi}.
# A^T is derived from the same algebra (real inner products on both sides).
# ---------------------------------------------------------------------------

def state_to_alm(x, lmax):
    """(..., nstate) grid-packed states -> complex (..., m, l) alm."""
    L = lmax + 1
    g = np.asarray(x, np.float64).reshape(x.shape[:-1] + (2, L, L))
    g = g * state_masks(lmax).in_scale
    return g[..., 0, :, :] + 1j * g[..., 1, :, :]


def alm_to_state(a, lmax):
    """Transpose of :func:`state_to_alm` (real inner products)."""
    g = np.stack([a.real, a.imag], axis=-3) * state_masks(lmax).in_scale
    return g.reshape(a.shape[:-2] + (nstate(lmax),))


def legendre_synth(lam, a):
    """lam (L, L, nr) [m, l, r]; a (b, m, l) -> F (b, nr, m)."""
    L = lam.shape[0]
    F = np.zeros((a.shape[0], lam.shape[2], L), np.complex128)
    for m in range(L):
        t = lam[m, m:, :]
        F[:, :, m] = a[:, m, m:].real @ t + 1j * (a[:, m, m:].imag @ t)
    return F


def legendre_adjoint(lam, C):
    """Transpose of :func:`legendre_synth`: C (b, nr, m) -> (b, m, l)."""
    L = lam.shape[0]
    a = np.zeros((C.shape[0], L, L), np.complex128)
    for m in range(L):
        t = lam[m, m:, :].T
        a[:, m, m:] = C[:, :, m].real @ t + 1j * (C[:, :, m].imag @ t)
    return a


def rings_of(sht):
    """(nphi, phi0, offset) per ring, offsets into ring-major flat maps."""
    geo = sht.grid
    if hasattr(geo, "ring_start"):                       # HEALPix
        return [(int(n), float(p), int(o))
                for n, p, o in zip(geo.nphi, geo.phi0, geo.ring_start)]
    return [(geo.nphi, float(p), r * geo.nphi)
            for r, p in enumerate(geo.phi0)]


def ring_synth(A, Bm, rings, npix):
    """P_j = sum_m A_m e^{im phi_j} + Bm_m e^{-im phi_j} on every ring, by
    numpy.fft with the spectrum folded modulo the ring length."""
    b, _, L = A.shape
    m = np.arange(L)
    out = np.empty((b, npix), np.complex128)
    for r, (n, phi0, off) in enumerate(rings):
        spec = np.zeros((n, b), np.complex128)
        np.add.at(spec, m % n, (A[:, r, :] * np.exp(1j * m * phi0)).T)
        np.add.at(spec, (-m) % n, (Bm[:, r, :] * np.exp(-1j * m * phi0)).T)
        out[:, off:off + n] = n * np.fft.ifft(spec.T, axis=-1)
    return out


def ring_adjoint(y, rings, L):
    """C+_m = sum_j y_j e^{-im phi_j} and C-_m = sum_j y_j e^{+im phi_j}."""
    m = np.arange(L)
    Cp = np.empty((y.shape[0], len(rings), L), np.complex128)
    Cm = np.empty_like(Cp)
    for r, (n, phi0, off) in enumerate(rings):
        yr = y[:, off:off + n]
        Cp[:, r, :] = np.fft.fft(yr, axis=-1)[:, m % n] \
            * np.exp(-1j * m * phi0)
        Cm[:, r, :] = (n * np.fft.ifft(yr, axis=-1))[:, m % n] \
            * np.exp(1j * m * phi0)
    return Cp, Cm


def spin2_F(lam_p, lam_m, e, b, lmax):
    E, B = state_to_alm(e, lmax), state_to_alm(b, lmax)
    Fp = legendre_synth(lam_p, -(E + 1j * B))
    Fm = legendre_synth(lam_m, -(E - 1j * B))
    Fm[..., 0] = 0.0                      # the m > 0 conj(F-) terms only
    return Fp, np.conj(Fm)


def spin2_alm(lam_p, lam_m, Cp, Cm, lmax):
    alpha = legendre_adjoint(lam_p, Cp)
    Cmc = np.conj(Cm)
    Cmc[..., 0] = 0.0
    beta = legendre_adjoint(lam_m, Cmc)
    return (alm_to_state(-(alpha + beta), lmax),
            alm_to_state(1j * (alpha - beta), lmax))


def ref_synth_spin2(lam_p, lam_m, rings, npix, e, b, lmax):
    P = ring_synth(*spin2_F(lam_p, lam_m, e, b, lmax), rings, npix)
    return P.real, P.imag


def ref_adjoint_spin2(lam_p, lam_m, rings, q, u, lmax):
    Cp, Cm = ring_adjoint(q + 1j * u, rings, lmax + 1)
    return spin2_alm(lam_p, lam_m, Cp, Cm, lmax)


def point_synth_spin2(lam_p, lam_m, phi, e, b, lmax):
    """Direct evaluation at rows of points: phi (nrows, p) -> (b, nrows, p)."""
    A, Bm = spin2_F(lam_p, lam_m, e, b, lmax)
    Ep = np.exp(1j * np.arange(lmax + 1)[None, :, None] * phi[:, None, :])
    P = (np.einsum("brm,rmp->brp", A, Ep)
         + np.einsum("brm,rmp->brp", Bm, np.conj(Ep)))
    return P.real, P.imag


def point_adjoint_spin2(lam_p, lam_m, phi, q, u, lmax):
    Ep = np.exp(1j * np.arange(lmax + 1)[None, :, None] * phi[:, None, :])
    y = q + 1j * u
    Cp = np.einsum("brp,rmp->brm", y, np.conj(Ep))
    Cm = np.einsum("brp,rmp->brm", y, Ep)
    return spin2_alm(lam_p, lam_m, Cp, Cm, lmax)


# ---------------------------------------------------------------------------
# checks (each returns its measurements; callers compare with tolerances)
# ---------------------------------------------------------------------------

def random_states(lmax, batch, seed):
    rng = np.random.default_rng(seed)
    valid = state_masks(lmax).valid.reshape(-1)
    return (rng.standard_normal((batch, nstate(lmax))) * valid,
            rng.standard_normal((batch, nstate(lmax))) * valid)


def check_grid_sht(sht, batch=3, seed=0):
    """Spin-2 synthesis and adjoint of a GL ``SHT`` or a ``HealpixSHT``
    against the fp64 NumPy reference: relative L2 errors."""
    lmax = sht.lmax
    healpix = hasattr(sht.grid, "ring_start")
    lam_p, lam_m = spin2_lambda_tables(lmax, sht.grid.theta)
    rings = rings_of(sht)
    npix = sht.grid.npix
    e, b = random_states(lmax, batch, seed)
    dt = sht.dtype

    def flat(x):
        x = sht.to_ring(x) if healpix and sht.layout == "padded" else x
        return np.asarray(x).reshape(batch, npix)

    synth = jax.jit(lambda s, e, b: s.synthesis_spin2_state(e, b))
    q, u = synth(sht, jnp.asarray(e, dt), jnp.asarray(b, dt))
    qr, ur = ref_synth_spin2(lam_p, lam_m, rings, npix, e, b, lmax)
    err_s = rel_err(np.concatenate([flat(q), flat(u)]),
                    np.concatenate([qr, ur]))

    rng = np.random.default_rng(seed + 1)
    yq, yu = rng.standard_normal((2, batch, npix))
    if healpix:
        to_in = lambda y: (sht.from_ring(jnp.asarray(y, dt))
                           if sht.layout == "padded" else jnp.asarray(y, dt))
    else:
        to_in = lambda y: jnp.asarray(y.reshape((batch,) + (sht.nrings,
                                                            sht.nphi)), dt)
    adj = jax.jit(lambda s, q, u: s.adjoint_synthesis_spin2_state(q, u))
    ae, ab = adj(sht, to_in(yq), to_in(yu))
    er, br = ref_adjoint_spin2(lam_p, lam_m, rings, yq, yu, lmax)
    err_a = rel_err(np.concatenate([np.asarray(ae), np.asarray(ab)]),
                    np.concatenate([er, br]))
    return {"synth": err_s, "adjoint": err_a}


def check_point_sht(psht, theta, phi, batch=3, seed=0):
    """``PointSHT`` spin-2 synthesis and adjoint against direct fp64
    evaluation at its points (``theta`` per row, ``phi`` per slot):
    relative L2 errors over the valid slots."""
    lmax = psht.lmax
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    valid = np.asarray(psht.valid) > 0
    lam_p, lam_m = spin2_lambda_tables(lmax, theta)
    e, b = random_states(lmax, batch, seed)
    dt = psht.dtype
    synth = jax.jit(lambda s, e, b: s.synthesis_spin2_state(e, b))
    q, u = synth(psht, jnp.asarray(e, dt), jnp.asarray(b, dt))
    qr, ur = point_synth_spin2(lam_p, lam_m, phi, e, b, lmax)
    err_s = rel_err(np.concatenate([np.asarray(q)[:, valid],
                                    np.asarray(u)[:, valid]]),
                    np.concatenate([qr[:, valid], ur[:, valid]]))
    rng = np.random.default_rng(seed + 1)
    yq, yu = rng.standard_normal((2, batch) + phi.shape) * valid
    adj = jax.jit(lambda s, q, u: s.adjoint_synthesis_spin2_state(q, u))
    ae, ab = adj(psht, jnp.asarray(yq, dt), jnp.asarray(yu, dt))
    er, br = point_adjoint_spin2(lam_p, lam_m, phi, yq, yu, lmax)
    err_a = rel_err(np.concatenate([np.asarray(ae), np.asarray(ab)]),
                    np.concatenate([er, br]))
    return {"synth": err_s, "adjoint": err_a, "npts": int(valid.sum())}


def hole_point_sht(sht, mask_ring, lmax, band_deg=14.5):
    """PointSHT over the zero-weight pixels of a HEALPix RING-order mask
    that lie outside the +-``band_deg`` galactic band (the point-source
    holes); returns (psht, theta per row, phi per slot)."""
    from gibbssampler.sht.healpix_pix import pix2ang_ring
    from gibbssampler.sht.points import PointSHT, group_points_by_ring
    geo = sht.geo
    pix = np.arange(geo.npix)
    theta, phi = pix2ang_ring(geo.nside, pix)
    holes = (np.asarray(mask_ring) == 0) & (
        np.abs(np.pi / 2 - theta) > np.radians(band_deg))
    ring = np.searchsorted(geo.ring_start, pix, side="right") - 1
    th_rows, phi_pad, valid, _ = group_points_by_ring(
        ring[holes], theta[holes], phi[holes], pix[holes])
    psht = PointSHT(th_rows, phi_pad, valid, lmax, dtype=sht.dtype,
                    spin0=False, spin2=True)
    return psht, th_rows, phi_pad


def fp64_twin(model):
    """The same dataset (data, mask, beam, noise) with fp64 operators and
    the cut decomposition rebuilt in fp64.  Call under jax.enable_x64()."""
    from gibbssampler.ops import SkyModel, with_cut_decomposition
    from gibbssampler.ops.noise import NoiseModel
    from gibbssampler.sht import make_sht
    from gibbssampler.sht.healpix import make_healpix_sht
    f64 = jnp.float64
    sht = model.sht
    if hasattr(sht, "geo"):
        sht64 = make_healpix_sht(sht.nside, sht.lmax, dtype=f64, spin2=True,
                                 layout=sht.layout)
    else:
        sht64 = make_sht(sht.lmax, grid=sht.grid, dtype=f64, spin2=True)
    noise = NoiseModel(tau=jnp.asarray(model.noise.tau, f64),
                       q_map=jnp.asarray(model.noise.q_map, f64),
                       omega=model.noise.omega)
    m64 = SkyModel(sht=sht64, noise=noise, bl=jnp.asarray(model.bl, f64),
                   spin=model.spin, d=jnp.asarray(model.d, f64))
    return with_cut_decomposition(m64) if model.has_cut else m64


def mh_engine_check(scheme, dl0, nchains=4, seed=3):
    """One blocked-MH sweep through the scheme's fast engine (fp32, as in
    production) and through the direct pixel likelihood -- the
    ``mh_fast="off"`` path, ``nc_cls_sample`` -- evaluated in fp64 on the
    same dataset, from identical inputs and keys (so identical proposals
    and uniform draws).

    Returns the fraction of (chain, block) accept decisions the two share,
    each side's mean acceptance, and the largest relative D_ell difference
    over the bins whose block decision agreed."""
    from gibbssampler.samplers import cls_samplers as cls_mod
    from gibbssampler.schemes.gibbs import _init_scheme, _nc_cls_step
    if not scheme._use_cut_mh:
        raise RuntimeError("scheme does not take the fast MH engine")
    dt = scheme.model.sht.dtype
    k_init, k_mh = jax.random.split(jax.random.PRNGKey(seed))
    dl0 = tuple(jnp.asarray(d, dt) for d in dl0)
    states = _init_scheme(scheme, jax.random.split(k_init, nchains), dl0)
    s_nc = jax.vmap(lambda s, dl: cls_mod.whiten(
        s, dl, scheme.bins_list, scheme.lmax))(states.s, states.dl)
    keys = jax.random.split(k_mh, nchains)

    fast = jax.jit(jax.vmap(lambda sch, k, d, s: _nc_cls_step(sch, k, d, s),
                            in_axes=(None, 0, 0, 0)))
    dl_f, info_f = fast(scheme, keys, states.dl, s_nc)

    with jax.enable_x64(True):
        model64 = fp64_twin(scheme.model)
        f64 = jnp.float64

        def direct(model64, k, dl, s):
            ll = cls_mod.make_nc_log_likelihood(model64, scheme.bins_list,
                                                all_sph=False)
            return cls_mod.nc_cls_sample(
                k, dl, s, lambda d, x: ll(tuple(v.astype(f64) for v in d),
                                          x.astype(f64)),
                scheme.bins_list, scheme.blocks_list,
                scheme.prop_sigma_list, n_iter=scheme.n_iter_mh)

        ref = jax.jit(jax.vmap(direct, in_axes=(None, 0, 0, 0)))
        dl_d, info_d = ref(model64, keys, states.dl, s_nc)
        dl_d = [np.asarray(d, np.float64) for d in dl_d]
        acc_d = [np.asarray(a, np.float64) for a in info_d.accept]
        del model64
    dl_f = [np.asarray(d, np.float64) for d in dl_f]
    acc_f = [np.asarray(a, np.float64) for a in info_f.accept]
    agree = np.concatenate([(a == b).ravel() for a, b in zip(acc_f, acc_d)])
    worst = 0.0
    for f, blocks in enumerate(scheme.blocks_list):
        for i, (lo, hi) in enumerate(blocks):
            same = acc_f[f][:, i] == acc_d[f][:, i]          # per chain
            d_f, d_d = dl_f[f][same, lo:hi], dl_d[f][same, lo:hi]
            if d_f.size:
                worst = max(worst, float(np.max(
                    np.abs(d_f - d_d) / np.maximum(np.abs(d_d), 1e-30))))
    finite = all(np.isfinite(d).all() for d in dl_f + dl_d)
    return {"agree": float(agree.mean()),
            "accept_fast": float(np.mean(np.concatenate(
                [a.ravel() for a in acc_f]))),
            "accept_direct": float(np.mean(np.concatenate(
                [a.ravel() for a in acc_d]))),
            "dl_rel": worst, "finite": finite,
            "decisions": int(agree.size)}


def run_chains(scheme, dl0, nchains, n_iter, seed=2):
    """Initialize and run ``nchains`` chains for ``n_iter`` iterations
    through ``_init_scheme``/``_scan_scheme``; returns the final states,
    per-iteration infos, compile seconds, steady ms/iter and the scan
    executable's device bytes (arguments + outputs + temporaries, from
    XLA's memory analysis)."""
    from gibbssampler.schemes.gibbs import _init_scheme, _scan_scheme_jit
    dt = scheme.model.sht.dtype
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    dl0 = tuple(jnp.asarray(d, dt) for d in dl0)
    t0 = time.perf_counter()
    states = jax.block_until_ready(
        _init_scheme(scheme, jax.random.split(k_init, nchains), dl0))
    t_init = time.perf_counter() - t0
    keys = jax.random.split(k_run, n_iter)
    t0 = time.perf_counter()
    compiled = _scan_scheme_jit.lower(scheme, states, keys).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(compiled(scheme, states, keys))     # warm
    t0 = time.perf_counter()
    states, infos = jax.block_until_ready(compiled(scheme, states, keys))
    ms = (time.perf_counter() - t0) / n_iter * 1e3
    mem = compiled.memory_analysis()
    exe_bytes = (mem.argument_size_in_bytes + mem.output_size_in_bytes
                 + mem.temp_size_in_bytes - mem.alias_size_in_bytes)
    return states, infos, t_init + t_compile, ms, exe_bytes


def chain_checks(states, infos):
    """Finite states, D_ell > 0 and acceptance rates in (0, 1)."""
    s = np.asarray(states.s)
    dls = [np.asarray(d) for d in infos["dl"]]
    mh = float(np.mean([np.asarray(a).mean() for a in infos["mh_accept"]]))
    cr = float(np.asarray(infos["cr_accept"]).mean())
    ok = (np.isfinite(s).all() and all(np.isfinite(d).all() for d in dls)
          and all((d > 0).all() for d in dls) and 0.0 < mh < 1.0
          and 0.0 < cr <= 1.0)
    return ok, mh, cr


def peak_bytes(device=None) -> int:
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

class Failed(Exception):
    pass


def expect(cond, what):
    if not cond:
        raise Failed(what)


def phase_device(cache_dir):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    d = jax.devices()[0]
    print(f"[device] {smi} | device_kind={d.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__} "
          f"compile_cache={cache_dir}", flush=True)
    return smi


def time_jit(fn, *args, reps=5):
    """(compile s, median run ms) of jax.jit(fn) on args."""
    f = jax.jit(fn)
    t0 = time.perf_counter()
    c = f.lower(*args).compile()
    tc = time.perf_counter() - t0
    jax.block_until_ready(c(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(c(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return tc, float(np.median(ts))


def stage_times(sht, nchains=NCHAINS, legendre=True):
    """Median ms of the spin-2 azimuthal stages (synthesis, adjoint) and,
    with ``legendre``, the Legendre stages at ``nchains`` chains."""
    L = sht.lmax + 1
    rng = np.random.default_rng(0)
    e = jnp.asarray(rng.standard_normal((nchains, nstate(sht.lmax))),
                    sht.dtype)
    F = tuple(jnp.asarray(rng.standard_normal((nchains, sht.nrings, L)),
                          sht.dtype) for _ in range(4))
    maps = jnp.asarray(rng.standard_normal((nchains,) + (sht.nrings,
                                                          sht.nphi)),
                       sht.dtype)
    out = {}
    if legendre:
        out["leg_synth"] = time_jit(lambda s, e: s._spin2_F(e, e), sht, e)[1]
        out["leg_adj"] = time_jit(lambda s, F: s._spin2_alm(*F), sht, F)[1]
    out["azi_synth"] = time_jit(lambda s, F: s._spin2_maps_from_F(*F),
                                sht, F)[1]
    out["azi_adj"] = time_jit(lambda s, m: s._spin2_ring_coefs(m, m),
                              sht, maps)[1]
    return out


def phase_sht(bench):
    from gibbssampler.sht import make_sht
    from gibbssampler.sht.healpix import make_healpix_sht
    from gibbssampler.sht.healpix_pix import pix2ang_ring
    f32 = jnp.float32
    for mode in ("matmul", "ct", "fft"):
        sht = make_sht(LMAX, dtype=f32, spin2=True, table_dtype=f32,
                       fft_mode=mode, ring_split=False)
        err = check_grid_sht(sht)
        t = stage_times(sht, legendre=(mode == "matmul"))
        leg = (f"legendre synth {t['leg_synth']:.3f} ms, legendre adjoint "
               f"{t['leg_adj']:.3f} ms, " if "leg_synth" in t else "")
        print(f"[sht] gl lmax={LMAX} fft_mode={mode}: synth rel err "
              f"{err['synth']:.3e}, adjoint rel err {err['adjoint']:.3e} "
              f"(tol {SHT_TOL:g}); {NCHAINS} chains: {leg}azimuthal synth "
              f"{t['azi_synth']:.3f} ms, azimuthal adjoint "
              f"{t['azi_adj']:.3f} ms", flush=True)
        expect(max(err.values()) < SHT_TOL, f"gl {mode} sht error {err}")
        del sht
    hsht = make_healpix_sht(NSIDE, LMAX, dtype=f32, spin2=True,
                            table_dtype=f32, layout="padded")
    err = check_grid_sht(hsht)
    print(f"[sht] healpix nside={NSIDE} lmax={LMAX} padded: synth rel err "
          f"{err['synth']:.3e}, adjoint rel err {err['adjoint']:.3e} "
          f"(tol {SHT_TOL:g})", flush=True)
    expect(max(err.values()) < SHT_TOL, f"healpix sht error {err}")
    mask = bench.planckish_mask(*pix2ang_ring(NSIDE,
                                              np.arange(hsht.geo.npix)))
    psht, theta, phi = hole_point_sht(hsht, mask, LMAX)
    err = check_point_sht(psht, theta, phi)
    print(f"[sht] points: {err['npts']} planckish hole pixels "
          f"({psht.nrows}x{psht.p} slots): synth rel err {err['synth']:.3e},"
          f" adjoint rel err {err['adjoint']:.3e} (tol {SHT_TOL:g})",
          flush=True)
    expect(max(err["synth"], err["adjoint"]) < SHT_TOL,
           f"point sht error {err}")


# fp64 direct reference vs the fp32 fast engine: the engine's per-block
# log ratios carry fp32 roundoff of its precomputed scalars, which can flip
# only the decisions whose uniform draw lands within that roundoff of the
# ratio (expected well under 1%); agreeing decisions give the same D_ell
MH_AGREE = 0.97
MH_DL_REL = 1e-5


def phase_mh(flagships):
    for label, (scheme, dl0) in flagships.items():
        r = mh_engine_check(scheme, dl0)
        print(f"[mh] {label}: fp32 fast engine vs fp64 direct likelihood: "
              f"decisions agree {r['agree']:.4f} of "
              f"{r['decisions']} (tol >= {MH_AGREE}), accept fast "
              f"{r['accept_fast']:.4f} / direct {r['accept_direct']:.4f}, "
              f"D_ell rel diff where agreed {r['dl_rel']:.2e} "
              f"(tol {MH_DL_REL:g})", flush=True)
        expect(r["finite"] and r["agree"] >= MH_AGREE
               and r["dl_rel"] <= MH_DL_REL, f"mh engines {label}: {r}")


def phase_flagship(flagships, smi, n_iter=20):
    for label, (scheme, dl0) in flagships.items():
        states, infos, tc, ms, exe = run_chains(scheme, dl0, NCHAINS,
                                                n_iter)
        ok, mh, cr = chain_checks(states, infos)
        print(f"[flagship] {label} {NCHAINS} chains x {n_iter} iters: "
              f"compile {tc:.1f} s, {ms:.2f} ms/iter, scan executable "
              f"{exe} bytes, process peak {peak_bytes()} bytes, mh accept "
              f"{mh:.4f}, cr accept "
              f"{cr:.4f} (finite, D_ell > 0, accept in (0, 1): {ok}) "
              f"[{smi}]", flush=True)
        expect(ok, f"flagship {label} chain checks")
        del states, infos


def phase_run_experiment(smi):
    """``run_experiment`` with single-bin MH blocks: the cut-sky fast engine
    that phase 3 checks.  (Multi-bin blocks take the direct likelihood,
    whose fp32 accept ratios are off at lmax=512; PERF.md.)"""
    from gibbssampler.inference.runner import RunConfig, run_experiment
    with tempfile.TemporaryDirectory() as tmp:
        cfg = RunConfig(lmax=LMAX, spin=2, scheme="asis",
                        cr_method="aux_mala",
                        cr_options={"n_gibbs": 1, "tau": 0.02},
                        noise_sigma2=0.2 ** 2, fwhm_deg=0.5,
                        mask_band_deg=11.5, blocks_size=1, n_iter=4,
                        segment=2, nchains=4,
                        out=os.path.join(tmp, "run.npz"))
        t0 = time.perf_counter()
        res = run_experiment(cfg, verbose=log)
        wall = time.perf_counter() - t0
        dls = [res[f"dl_chain_{f}"] for f in range(2)]
        mh = float(np.mean([res[f"mh_accept_{f}"].mean() for f in range(2)]))
        ok = (all(np.isfinite(d).all() and (d > 0).all() for d in dls)
              and 0.0 < mh < 1.0 and os.path.exists(cfg.out))
        seg_ms = [d / cfg.segment * 1e3 for d in res["durations"]]
    print(f"[run_experiment] lmax={LMAX} asis aux_mala band, single-bin "
          f"MH blocks (fast engine), 4 chains x "
          f"{cfg.n_iter} iters: wall {wall:.1f} s (compile included), "
          f"segments {', '.join(f'{m:.1f}' for m in seg_ms)} ms/iter, "
          f"peak {peak_bytes()} bytes, mh accept {mh:.4f} (finite, "
          f"D_ell > 0, accept in (0, 1): {ok}) [{smi}]", flush=True)
    expect(ok, "run_experiment checks")


def build_flagships(bench):
    out = {}
    for grid, mask in (("gl", "band"), ("healpix", "planckish")):
        scheme, (dl_ee, dl_bb, bins) = bench.build(grid, mask)
        dl0 = tuple(bench._binned_mean_np(d, b)
                    for d, b in zip((dl_ee, dl_bb), bins))
        out[f"asis {grid} {mask}"] = (scheme, dl0)
    return out


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

# The chains-only mesh runs each chain's arithmetic unchanged, in fp32 as
# in production: >= 0.95 of the D_ell entries of all iterations within
# 1e-3 of one card.  The m-sharded mesh compiles to a differently
# partitioned program; in fp32 its changed roundoff flips the accept/reject
# decisions (MALA, blocked MH) whose log ratios land within it (measured on
# four H100s: 0.8645 of entries within 1e-3), so its chains are compared
# in fp64 (the same dataset and scheme with fp64 operators), where the
# roundoff is ~1e-16 relative and a flip needs a uniform draw that close
# to the ratio: every D_ell entry within 1e-6 of one card.  The fp32
# m-sharded SHT pair is compared with one card besides (SHT_TOL).
FOUR_AGREE = 0.95
FOUR_REL = 1e-3
FOUR64_REL = 1e-6


def sharded_sht_error(sht, mesh, e, b):
    """Relative error of the m-sharded spin-2 synthesis and adjoint of the
    (nchains, nstate) states ``e``, ``b`` against the same transforms on
    one card."""
    from jax.sharding import NamedSharding, PartitionSpec
    from gibbssampler.parallel import shard_sht
    from gibbssampler.parallel.sharding import chain_sharding
    pair = jax.jit(lambda t, e, b: t.adjoint_synthesis_spin2_state(
        *t.synthesis_spin2_state(e, b)) + t.synthesis_spin2_state(e, b))
    one = jax.devices()[0]
    ref = pair(jax.device_put(sht, one), jax.device_put(e, one),
               jax.device_put(b, one))
    ssh = jax.device_put(shard_sht(sht, mesh),
                         NamedSharding(mesh, PartitionSpec()))
    with mesh:
        got = pair(ssh, jax.device_put(e, chain_sharding(mesh, 2)),
                   jax.device_put(b, chain_sharding(mesh, 2)))
    return max(rel_err(g, r) for g, r in zip(got, ref))


def fp64_scheme(scheme):
    """The ASIS scheme on the same dataset with fp64 operators and
    proposals.  Call under jax.enable_x64()."""
    from gibbssampler.schemes import ASISGibbs
    return ASISGibbs(fp64_twin(scheme.model), scheme.bins_list,
                     scheme.blocks_list,
                     [np.asarray(p, np.float64)
                      for p in scheme.prop_sigma_list],
                     n_iter_mh=scheme.n_iter_mh, cr_method=scheme.cr_method,
                     cr_options=dict(scheme.cr_options))


def mesh_scheme(scheme, mesh):
    """The scheme with its SHT ring-Fourier intermediates m-sharded."""
    from gibbssampler.parallel import shard_sht
    if mesh.shape["m"] == 1:
        return scheme
    model = scheme.model
    model = dataclasses.replace(
        model, sht=shard_sht(model.sht, mesh),
        cut_sht=(shard_sht(model.cut_sht, mesh)
                 if model.cut_sht is not None else None))
    out = copy.copy(scheme)
    out.model = model
    out._rebind()
    return out


def mesh_run(scheme, key, dl0, n_iter, nc, nm):
    """``sharded_run`` of ``scheme`` on a (chains=nc, m=nm) mesh of the four
    cards: (per-field D_ell chains, a report, whether the tables sit on all
    four cards, the states are split into ``NCHAINS // nc``-chain shards on
    all four and the chain checks pass)."""
    from jax.sharding import NamedSharding, PartitionSpec
    from gibbssampler.parallel import make_mesh, sharded_run
    mesh = make_mesh(n_chains=nc, n_m=nm)
    # tables replicated on every card of the mesh, states chain-sharded
    sch = jax.device_put(mesh_scheme(scheme, mesh),
                         NamedSharding(mesh, PartitionSpec()))
    tables_ok = all(len(a.sharding.device_set) == 4
                    for a in jax.tree.leaves(sch) if isinstance(a, jax.Array))
    t0 = time.perf_counter()
    out = sharded_run(sch, key, dl0, n_iter=n_iter, nchains=NCHAINS,
                      mesh=mesh)
    jax.block_until_ready(out["dl_chains"])
    wall = time.perf_counter() - t0
    s = out["final_state"].s
    shard_devs = {sh.device for sh in s.addressable_shards}
    shard_rows = {sh.data.shape[0] for sh in s.addressable_shards}
    peaks = [peak_bytes(d) for d in jax.devices()]
    chains_ok, mh, cr = chain_checks(out["final_state"], {
        "dl": tuple(jnp.moveaxis(d, 1, 0) for d in out["dl_chains"]),
        "mh_accept": tuple(out["mh_accept"]),
        "cr_accept": out["cr_accept"]})
    report = (f"wall {wall:.1f} s (compile included); mh accept {mh:.4f}, "
              f"cr accept {cr:.4f} (finite, D_ell > 0, accept in (0, 1): "
              f"{chains_ok}); state shards on {len(shard_devs)} devices x "
              f"{shard_rows} chains; tables on 4 devices: {tables_ok}; peak "
              f"bytes per device {peaks}")
    ok = (len(shard_devs) == 4 and shard_rows == {NCHAINS // nc}
          and tables_ok and min(peaks) > 0 and chains_ok)
    return [np.asarray(d) for d in out["dl_chains"]], report, ok


def rel_diffs(dl, ref_dl):
    return np.concatenate([(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
                           .ravel() for a, b in zip(dl, ref_dl)])


def one_card_dl(scheme, key, dl0, n_iter):
    with jax.default_device(jax.devices()[0]):
        out = scheme.run(key, dl0, n_iter=n_iter, nchains=NCHAINS)
        return [np.asarray(d) for d in out["dl_chains"]]


def phase_four(bench, smi, n_iter=20, n_iter64=5):
    """The flagship run by ``sharded_run`` on 4-card meshes against
    ``scheme.run`` on one card, same keys: fp32 on (chains=4, m=1); the
    fp32 SHT pair and fp64 chains on (chains=2, m=2)."""
    from gibbssampler.parallel import make_mesh
    expect(len(jax.devices()) == 4,
           f"--four needs 4 devices, found {jax.devices()}")
    card = smi.splitlines()[0]
    scheme, (dl_ee, dl_bb, bins) = bench.build("gl", "band")
    dl0 = tuple(bench._binned_mean_np(d, b)
                for d, b in zip((dl_ee, dl_bb), bins))
    key = jax.random.PRNGKey(4)

    ref_dl = one_card_dl(scheme, key, dl0, n_iter)
    dl, report, ok = mesh_run(scheme, key, dl0, n_iter, 4, 1)
    rel = rel_diffs(dl, ref_dl)
    agree = float(np.mean(rel <= FOUR_REL))
    print(f"[four] fp32 mesh chains=4 m=1: {NCHAINS} chains x {n_iter} iters;"
          f" D_ell within {FOUR_REL:g} of one card: {agree:.4f} of "
          f"{rel.size} (tol >= {FOUR_AGREE}), median rel diff "
          f"{np.median(rel):.2e}; {report} [{card}]", flush=True)
    expect(ok and agree >= FOUR_AGREE, "four-card mesh (4, 1), fp32")

    e, b = random_states(LMAX, NCHAINS, seed=5)
    err = sharded_sht_error(scheme.model.sht, make_mesh(n_chains=2, n_m=2),
                            jnp.asarray(e, jnp.float32),
                            jnp.asarray(b, jnp.float32))
    print(f"[four] fp32 mesh chains=2 m=2: m-sharded SHT pair vs one card, "
          f"{NCHAINS} states: rel err {err:.3e} (tol {SHT_TOL:g}) [{card}]",
          flush=True)
    expect(err < SHT_TOL, "four-card m-sharded SHT pair, fp32")

    with jax.enable_x64(True):
        sch64 = fp64_scheme(scheme)
        expect(sch64._use_cut_mh, "fp64 scheme lost the fast MH engine")
        del scheme
        ref_dl = one_card_dl(sch64, key, dl0, n_iter64)
        dl, report, ok = mesh_run(sch64, key, dl0, n_iter64, 2, 2)
    rel = rel_diffs(dl, ref_dl)
    print(f"[four] fp64 mesh chains=2 m=2: {NCHAINS} chains x {n_iter64} "
          f"iters; D_ell max rel diff from one card {rel.max():.2e} over "
          f"{rel.size} (tol {FOUR64_REL:g}), median {np.median(rel):.2e}; "
          f"{report} [{card}]", flush=True)
    expect(ok and rel.max() <= FOUR64_REL, "four-card mesh (2, 2), fp64")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded flagship phase")
    args = ap.parse_args(argv)
    require_gpu()
    cache_dir = use_compile_cache()
    import bench
    t0 = time.perf_counter()
    smi = phase_device(cache_dir)
    if args.four:
        phase_four(bench, smi)
    else:
        phase_sht(bench)
        flagships = build_flagships(bench)
        phase_mh(flagships)
        phase_flagship(flagships, smi)
        del flagships
        phase_run_experiment(smi)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Failed as e:
        log(f"chip_smoke: FAILED: {e}")
        sys.exit(1)
