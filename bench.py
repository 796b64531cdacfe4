"""Headline benchmark: C_ell-chain ESS/s at the reference's production scale.

Configuration mirrors the reference's live experiment (main_polarization.py:
109-126 at NSIDE=256 / lmax=512, BASELINE.md): polarized (E/B) sky, 0.5 deg
beam, masked (analytic ~80 percent galactic cut standing in for the Planck
HFI mask the reference loads from NERSC scratch), centered Gibbs with the
composed auxiliary-Gibbs + MALA constrained-realization step ("Composition !",
CenteredGibbs.py:833-836) and conjugate inverse-gamma C_ell draws, with
NCHAINS vmapped chains on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
value = median-over-bins pooled ESS per wall-clock second.
vs_baseline: the reference publishes no numbers (BASELINE.md), so the
baseline is an estimate of the same sampler on the reference stack:
ESS/iteration is sampler-determined, and one reference iteration costs
~6 full-sky SHTs at nside=256 on CPU (healpy TQU transforms, ~0.5 s each,
reference test.py micro-bench) => REF_SEC_PER_ITER = 3.0 s single-chain.
"""

import json
import os
import sys
import time

import numpy as np

LMAX = int(os.environ.get("BENCH_LMAX", "512"))
NCHAINS = int(os.environ.get("BENCH_NCHAINS", "128"))
# data grid: "gl" (Gauss-Legendre quadrature grid) or "healpix" (the
# reference's actual production grid, NSIDE = lmax/2; config.py:19-21)
GRID = os.environ.get("BENCH_GRID", "gl")
# operator-table dtype; bfloat16 tables halve the table bytes at ~4e-3
# relative operator error (fp32 is the validated path)
TABLE_DTYPE = os.environ.get("BENCH_TABLE_DTYPE", "float32")
# azimuthal DFT mode: "matmul" (direct folded) or "ct" (mixed-radix factored)
FFT_MODE = os.environ.get("BENCH_FFT_MODE", "matmul")
# north/south ring-parity split of the Legendre tables (1 = on)
RING_SPLIT = bool(int(os.environ.get("BENCH_RING_SPLIT", "0")))
# sampling scheme: "asis" (default — the reference's flagship ASIS run:
# overrelaxed aux CR + non-centered blocked-MH C_ell with the Planck BB
# binning/blocking, main_polarization.py:124-126, config.py:44-55),
# "centered" (aux+MALA CR; the fastest-mixing scheme at this noise level)
# or "pncp" (partially non-centered at BENCH_LCUT — centered conjugate
# draws below l_cut, non-centered blocked MH above; the reference's
# PNCP.py idea, SURVEY.md 2.4).  BENCH_LCUT is "lc" for all fields or
# "lc_ee,lc_bb" per field; "none" = that field fully centered.  Default
# "none,300", picked per the measured per-bin ESS (PERF.md): EE is
# signal-dominated at every multipole (centered wins everywhere; a joint
# NC block over the EE tail mixes 80x SLOWER than the conjugate draw),
# while BB crosses to noise-dominated at ell ~ 300 where the NC move
# mixes 5x+ better.
SCHEME = os.environ.get("BENCH_SCHEME", "asis")
_lcut_raw = os.environ.get("BENCH_LCUT", "none,300")
LCUT = [(-1 if c.strip() == "none" else int(c))
        for c in _lcut_raw.split(",")]
if len(LCUT) == 1:
    LCUT = LCUT * 2
# 300 iterations: ESS estimators on shorter chains truncate the
# autocorrelation sum and overestimate ~2x (measured, PERF.md §6)
N_ITER = int(os.environ.get("BENCH_ITERS", "300"))
# mask shape: "band" (hard ~80% f_sky galactic cut, the default) or
# "planckish" (GL or HEALPix): apodized band + random point-source holes
# at all latitudes — the realistic-mask configuration (the reference's
# actual mask is Planck HFI GalPlane-apo0 + point sources,
# config.py:22-28).  The azimuthal-floor + sparse-hole decomposition
# keeps the fast m/table-domain engines eligible (round 5).
MASK_KIND = os.environ.get("BENCH_MASK", "band")
# BENCH_BASELINE=1: run the same sampler as ONE chain on CPU and print the
# measured sec/iter (the reference's unit of compute: one process of the
# SLURM array, job-script.sh:6).  Results are committed to
# BASELINE_MEASURED.json and picked up below.
BASELINE_MODE = bool(int(os.environ.get("BENCH_BASELINE", "0")))
if BASELINE_MODE:
    # the baseline is a CPU measurement by definition: force the CPU
    # backend before and right after the first jax import
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax as _jax
    _jax.config.update("jax_platforms", "cpu")

# Reference-stack cost of one iteration for the vs_baseline ratio,
# counted from the reference's own code at ~0.5 s per full-sky TQU
# transform at nside=256 (its test.py:11-19 micro-bench):
# - centered aux+MALA: ~6 transforms per iteration => 3.0 s
# - flagship ASIS: the overrelaxed CR costs 1 + 3 transforms per sweep
#   (CenteredGibbs.py:733-825) and the blocked MH pays ONE full TQU
#   synthesis per block likelihood (NonCenteredGibbs.py:333-377; ~136
#   blocks at lmax=512 with the Planck blocking, config.py:51-55)
# If a measured single-process CPU run of the *same* sampler exists
# (BASELINE_MEASURED.json, produced by BENCH_BASELINE=1 on this machine),
# use min(measured, estimate): the baseline is never allowed to be slower
# than the reference's own reported numbers would imply.
BENCH_CR = os.environ.get("BENCH_CR", "aux_mala")
if SCHEME in ("asis", "pncp"):
    _ngibbs = int(os.environ.get("BENCH_NGIBBS", "1"))
    _nmh = int(os.environ.get("BENCH_NITER_MH", "1"))
    _nblocks = 136 if LMAX >= 396 else 12
    if BENCH_CR == "overrelax":
        # overrelaxed CR: 1 + 3 transforms per sweep (CenteredGibbs.py:
        # 733-825) + one full TQU synthesis per MH block likelihood
        _cr_transforms = 2 + 3 * _ngibbs
    else:
        # "Composition !" aux+MALA (CenteredGibbs.py:833-836): 2 transforms
        # per aux sweep (:698-719) + ~4 for the MALA gradient/log-target
        # pair (:505-559)
        _cr_transforms = 2 * _ngibbs + 4
    REF_SEC_PER_ITER = 0.5 * (_cr_transforms + _nblocks * _nmh)
else:
    REF_SEC_PER_ITER = 3.0
_bm_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_MEASURED.json")
if os.path.exists(_bm_path):
    try:
        with open(_bm_path) as _f:
            _bm = json.load(_f)
        # one record per (scheme, grid, lmax); a bare dict is the legacy
        # single-record format
        for _rec in (_bm.get("records", [_bm]) if isinstance(_bm, dict)
                     else _bm):
            if (_rec.get("lmax") == LMAX
                    and _rec.get("grid") == os.environ.get("BENCH_GRID",
                                                           "gl")
                    and _rec.get("scheme", "centered") == SCHEME):
                REF_SEC_PER_ITER = min(REF_SEC_PER_ITER,
                                       float(_rec["cpu_sec_per_iter"]))
    except (ValueError, KeyError):
        pass


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def planckish_mask(theta, phi):
    """The realistic-mask configuration on any pixel set: an apodized
    +-11.5 deg galactic band (3 deg cosine ramp) plus BENCH_NHOLES (200)
    point-source holes (0.35 deg radius) at random positions over the whole
    sphere (reference: config.py:22-28, Planck HFI GalPlane-apo0 + point
    sources).  ``theta``/``phi`` are broadcastable per-pixel
    colatitude/longitude."""
    nholes = int(os.environ.get("BENCH_NHOLES", "200"))
    theta, phi = np.broadcast_arrays(theta, phi)
    lat = np.abs(np.pi / 2 - theta)
    b0, apo = np.radians(11.5), np.radians(3.0)
    x = np.clip((lat - b0) / apo, 0.0, 1.0)
    mask = 0.5 - 0.5 * np.cos(np.pi * x)
    rng = np.random.default_rng(5)
    rhole = np.radians(0.35)
    ct, st = np.cos(theta), np.sin(theta)
    for _ in range(nholes):
        ct0 = rng.uniform(-1.0, 1.0)
        st0 = np.sqrt(1.0 - ct0 * ct0)
        ph0 = rng.uniform(0.0, 2.0 * np.pi)
        cosd = ct0 * ct + st0 * st * np.cos(phi - ph0)
        mask[cosd > np.cos(rhole)] = 0.0
    log(f"planckish mask: apodized band + {nholes} holes, "
        f"f_sky ~= {mask.mean():.3f}")
    return mask


def build(grid_kind=None, mask_kind=None):
    """Build the benchmark's scheme; ``grid_kind`` ("gl" | "healpix") and
    ``mask_kind`` ("band" | "planckish") default to BENCH_GRID/BENCH_MASK."""
    import jax
    import jax.numpy as jnp
    from gibbssampler.inference import example_dl, simulate_dataset
    from gibbssampler.sht import gauss_legendre_grid
    from gibbssampler.schemes import CenteredGibbs

    grid_kind = grid_kind or GRID
    mask_kind = mask_kind or MASK_KIND
    dl_ee = example_dl(LMAX, "ee", amp=1000.0)
    dl_bb = example_dl(LMAX, "bb", amp=1000.0)
    if grid_kind == "healpix":
        # the reference's production grid: HEALPix NSIDE = lmax/2
        # (config.py:19-21), padded map layout (gather-free hot path)
        from gibbssampler.sht.healpix import make_healpix_sht
        from gibbssampler.sht.healpix_pix import (galactic_band_mask,
                                                      pix2ang_ring)
        nside = LMAX // 2
        sht = make_healpix_sht(nside, LMAX, dtype=jnp.float32, spin2=True,
                               table_dtype=jnp.dtype(TABLE_DTYPE),
                               ring_split=RING_SPLIT, layout="padded")
        if mask_kind == "planckish":
            # on the reference's own grid the holes land on cap rings too
            # (handled by the sparse point set of the cut decomposition)
            mask = planckish_mask(*pix2ang_ring(nside,
                                                np.arange(sht.geo.npix)))
        else:
            mask = galactic_band_mask(nside, 11.5)   # ~80% f_sky cut
        log(f"building dataset lmax={LMAX} healpix nside={nside} "
            f"npix={sht.geo.npix} npadded={sht.npadded}")
        grid = None
    else:
        grid = gauss_legendre_grid(LMAX)
        lat = np.abs(np.pi / 2 - grid.theta)
        if mask_kind == "planckish":
            phi = 2.0 * np.pi * np.arange(grid.nphi) / grid.nphi
            mask = planckish_mask(grid.theta[:, None], phi[None, :])
        else:
            # analytic ~80% f_sky galactic cut (the reference's mask role,
            # config.py:22-28)
            ring_keep = (lat > 0.2).astype(np.float64)  # +-11.5 deg band
            mask = np.broadcast_to(ring_keep[:, None],
                                   (grid.nrings, grid.nphi))
        log(f"building dataset lmax={LMAX} grid={grid.nrings}x{grid.nphi} "
            f"npix={grid.npix}")
        from gibbssampler.sht import make_sht
        sht = make_sht(LMAX, dtype=jnp.float32, spin2=True,
                       table_dtype=jnp.dtype(TABLE_DTYPE), fft_mode=FFT_MODE,
                       ring_split=RING_SPLIT)
    model, _ = simulate_dataset(
        jax.random.PRNGKey(0), LMAX, spin=2,
        dl_fields=np.stack([dl_ee, dl_bb]),
        noise_sigma2=0.2 ** 2,                        # reference pol noise
        fwhm_radians=np.radians(0.5), mask=mask, dtype=jnp.float32,
        grid=grid, sht=sht)
    # the CPU baseline stands in for the reference stack, which always
    # transforms the full sphere — never attach our cut decomposition there
    if int(os.environ.get("BENCH_CUT", "1")) and not BASELINE_MODE:
        # cut-sky complement decomposition: masked operators through
        # transforms over the masked rings only (exact on the GL quadrature
        # grid; on HEALPix the smooth full-sphere terms use the reference's
        # own iter=0 omega algebra — ops.model.with_cut_decomposition,
        # both validated in tests/test_cut.py)
        from gibbssampler.ops import with_cut_decomposition
        model = with_cut_decomposition(model)
        log(f"cut decomposition: {model.cut_sht.grid.nrings} of "
            f"{sht.nrings} rings"
            + (f" + sparse holes {model.sp_sht.nrows}x{model.sp_sht.p} "
               f"({int(np.asarray(model.sp_sht.valid).sum())} px)"
               if model.has_sparse else ""))

    if SCHEME in ("asis", "pncp"):
        # the reference's flagship ASIS configuration
        # (main_polarization.py:124-126): overrelaxed aux CR
        # (gibbs_cr + overrelaxation -> overrelaxation_sampler,
        # CenteredGibbs.py:828-830) + NC blocked MH with the Planck bins
        # and the EE one-block / BB big-block + per-bin blocking
        # (config.py:44-55).  "pncp" shares the bins/noise setup but
        # samples only l >= BENCH_LCUT non-centered (PNCPGibbs).
        from gibbssampler.schemes import ASISGibbs, PNCPGibbs
        from gibbssampler.parallel.adapt import analytic_proposal_sigma
        bins_ee = np.arange(2, LMAX + 2)
        if LMAX >= 396:
            wide = [396, 398, 400, 402, 406, 410, 415, 420, 425, 430, 435,
                    440, 445, 460, 475, 495, LMAX + 1]
            bins_bb = np.array(list(range(2, 396)) + wide)
        else:
            bins_bb = np.arange(2, LMAX + 2)   # smoke-test sizes
        nb_ee = len(bins_ee) - 1
        nb_bb = len(bins_bb) - 1
        blocks_ee = [(0, nb_ee)]
        # reference block boundary bin 279-2; at smoke-test sizes keep the
        # production SHAPE (one big block + per-bin singles) so the
        # rank-one MH fast path is exercised
        big = 277 if nb_bb > 277 else max(1, (2 * nb_bb) // 3)
        blocks_bb = [(0, big)] + [(i, i + 1) for i in range(big, nb_bb)]
        sig = [analytic_proposal_sigma(
            np.asarray(model.bl), 0.2 ** 2, model.noise.omega, LMAX, b,
            f_sky=float(np.asarray(model.noise.f_sky)[f]))
            for f, b in enumerate((bins_ee, bins_bb))]
        # tuned proposal scales from the two-phase warmup
        # (tools/tune_flagship.py — the reference's preliminary-run
        # workflow, config.py:136-225); BENCH_TUNED=0 to pin the analytic
        # heuristic
        tuned_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tuned_proposals.json")
        tuned_loaded = False
        if int(os.environ.get("BENCH_TUNED", "1")) \
                and os.path.exists(tuned_path):
            try:
                with open(tuned_path) as f:
                    t = json.load(f)
                # multi-record store (one per scheme/grid/lmax); a bare
                # dict is the legacy single-record format
                trecs = (t.get("records", [t]) if isinstance(t, dict)
                         else t)
                for t in trecs:
                    if (t.get("scheme") == SCHEME
                            and t.get("grid") == grid_kind
                            and t.get("lmax") == LMAX
                            and t.get("nbins") == [len(s) for s in sig]):
                        sig = [np.asarray(x, dtype=np.float64)
                               for x in t["sig"]]
                        tuned_loaded = True
                        log("using tuned proposal sigmas "
                            "(tuned_proposals.json)")
                        break
            except (ValueError, KeyError) as e:
                log(f"ignoring tuned_proposals.json: {e}")
        # CR method inside ASIS.  Both come from the reference's own
        # portfolio: "overrelax" is its flagship constructor argument
        # (overrelaxation=True, n_gibbs=20, main_polarization.py:126);
        # "aux_mala" is its centered sampler's "Composition !" default
        # (CenteredGibbs.py:833-836).  Measured (PERF.md §6):
        # overrelax at alpha=-0.995 compounds to alpha^(3 n_gibbs)
        # correlation with ~1% fresh noise per conditional, so D_ell
        # (quadratic in s) decorrelates very slowly; aux_mala mixes ~3x
        # better per iteration.
        cr = BENCH_CR
        if cr == "overrelax":
            cr_opts = {"alpha": -0.995,
                       # overrelaxed sweeps per CR step; the reference
                       # flagship runs 20 (main_polarization.py:126)
                       "n_gibbs": int(os.environ.get("BENCH_NGIBBS", "1"))}
        else:
            cr_opts = {"n_gibbs": int(os.environ.get("BENCH_NGIBBS", "1")),
                       "tau": float(os.environ.get("BENCH_TAU", "0.02"))}
        n_mh = int(os.environ.get("BENCH_NITER_MH", "1"))
        if SCHEME == "pncp":
            # per-field cut: "none" (-1) = fully centered field (no MH
            # blocks); otherwise blocks above l_cut only — a big joint
            # block for EE (if cut), BB per-bin singles (bigs before
            # singles keeps the fast path eligible)
            lc = [(int(b[-1]) if c < 0 else c)
                  for c, b in zip(LCUT, (bins_ee, bins_bb))]
            cb_ee = int(np.searchsorted(bins_ee, lc[0]))
            cb_bb = int(np.searchsorted(bins_bb, lc[1]))
            if bins_ee[cb_ee] != lc[0] or bins_bb[cb_bb] != lc[1]:
                raise SystemExit(f"BENCH_LCUT={lc} must be a bin boundary")
            blocks_ee = [] if cb_ee >= nb_ee else [(cb_ee, nb_ee)]
            blocks_bb = [(i, i + 1) for i in range(cb_bb, nb_bb)]
            # joint-block 2.38/sqrt(d) scaling of the analytic seed (the
            # EE high-l block is ~200 bins wide; 1-d scales collapse its
            # acceptance — measured for ASIS, PERF.md §6).
            # Tuned sigmas are saved POST-scaling (tune_flagship pulls
            # them off the built scheme), so never rescale those.
            if not tuned_loaded:
                from gibbssampler.parallel.adapt import block_widths
                sig = [s / np.sqrt(block_widths(bl, len(s)))
                       for s, bl in zip(sig, (blocks_ee, blocks_bb))]
            scheme = PNCPGibbs(model, [bins_ee, bins_bb],
                               [blocks_ee, blocks_bb], sig, l_cut=lc,
                               n_iter_mh=n_mh, cr_method=cr,
                               cr_options=cr_opts)
        else:
            scheme = ASISGibbs(model, [bins_ee, bins_bb],
                               [blocks_ee, blocks_bb], sig,
                               n_iter_mh=n_mh,
                               cr_method=cr, cr_options=cr_opts)
        return scheme, (dl_ee, dl_bb, (bins_ee, bins_bb))
    # Planck-style binning: unit bins to l=50, then widening (config.py:45-46)
    edges = list(range(2, 51))
    l = 50
    while l < LMAX + 1:
        w = 10 if l < 200 else 30
        l = min(l + w, LMAX + 1)
        edges.append(l)
    bins = np.array(edges)
    scheme = CenteredGibbs(model, [bins, bins], cr_method="aux_mala",
                           cr_options={"n_gibbs": 1, "tau": 0.02})
    return scheme, (dl_ee, dl_bb, (bins, bins))


def _binned_mean_np(per_ell, bins):
    """Binned mean of a per-ell array, pure numpy (the starting D_ell; no
    eager device ops outside the compiled steps)."""
    per_ell = np.asarray(per_ell, dtype=np.float64)
    bins = np.asarray(bins)
    return np.array([per_ell[lo:hi].mean() for lo, hi in
                     zip(bins[:-1], bins[1:])])


def baseline_main():
    """Measure one CPU process (the reference's SLURM-array unit) running
    the identical sampler: one chain, same masked polarized aux+MALA step.
    Run with JAX_PLATFORMS=cpu.  Writes BASELINE_MEASURED.json."""
    import platform
    import jax
    scheme, (dl_ee, dl_bb, bins_pair) = build()
    dl0 = tuple(_binned_mean_np(d, b) for d, b in zip((dl_ee, dl_bb),
                                                      bins_pair))
    n = max(2, N_ITER)
    log(f"baseline: warmup (compile) {n} iters, 1 chain, cpu...")
    out = scheme.run(jax.random.PRNGKey(1), dl0, n_iter=n, nchains=1)
    jax.block_until_ready(out["dl_chains"])
    t0 = time.time()
    out = scheme.run(jax.random.PRNGKey(2), dl0, n_iter=n, nchains=1)
    jax.block_until_ready(out["dl_chains"])
    sec = (time.time() - t0) / n
    rec = {"cpu_sec_per_iter": round(sec, 4), "lmax": LMAX,
           "grid": GRID, "scheme": SCHEME, "nchains": 1, "n_iter": n,
           "machine": platform.processor() or platform.machine(),
           "ncpu": os.cpu_count(),
           "note": f"same sampler ({SCHEME} scheme, masked pol) as the "
                   "headline bench, one chain on this machine's CPU via "
                   "XLA; stands in for one reference SLURM-array process"}
    recs = []
    if os.path.exists(_bm_path):
        try:
            with open(_bm_path) as f:
                old = json.load(f)
            recs = old.get("records", [old]) if isinstance(old, dict) \
                else old
        except ValueError:
            pass
    key_of = lambda r: (r.get("scheme", "centered"), r.get("grid"),
                        r.get("lmax"))
    recs = [r for r in recs if key_of(r) != key_of(rec)] + [rec]
    with open(_bm_path, "w") as f:
        json.dump({"records": recs}, f, indent=1)
    print(json.dumps(rec))


def main():
    import jax
    import jax.numpy as jnp
    if BASELINE_MODE:
        return baseline_main()
    from gibbssampler.utils import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    scheme, (dl_ee, dl_bb, bins_pair) = build()
    dl0 = tuple(_binned_mean_np(d, b) for d, b in zip((dl_ee, dl_bb),
                                                      bins_pair))

    # the run is segmented at the host level so that the compile covers
    # ONE scan length; segmenting began as a guard against a device
    # watchdog on long programs, which has not been measured on the GPU
    from gibbssampler.schemes.gibbs import _init_scheme, _scan_scheme
    seg = min(int(os.environ.get("BENCH_SEG", "100")), N_ITER)
    nseg = (N_ITER + seg - 1) // seg
    total = seg * nseg
    key = jax.random.PRNGKey(2)
    kinit, key = jax.random.split(key)
    dl0j = tuple(jnp.asarray(d, dtype=scheme.model.sht.dtype) for d in dl0)
    states = _init_scheme(scheme, jax.random.split(kinit, NCHAINS), dl0j)
    jax.block_until_ready(states.s)
    log(f"warmup {seg} iters (compile)...")
    t0 = time.time()
    kw, key = jax.random.split(key)
    warm, _ = _scan_scheme(scheme, states, jax.random.split(kw, seg),
                           NCHAINS)
    jax.block_until_ready(warm.s)
    log(f"warmup done in {time.time() - t0:.1f}s")
    del warm
    import gc       # free the warmup state before the timed run (how
    gc.collect()    # close the graphs run to GPU memory: not measured)

    segs = []
    t0 = time.time()
    for i in range(nseg):
        key, ks = jax.random.split(key)
        states, infos = _scan_scheme(scheme, states,
                                     jax.random.split(ks, seg), NCHAINS)
        jax.block_until_ready(infos["dl"])
        segs.append(infos["dl"])
    wall = time.time() - t0
    out = {"dl_chains": tuple(
        jnp.moveaxis(jnp.concatenate([s[f] for s in segs], axis=0), 0, 1)
        for f in range(2))}
    log(f"{total} iters x {NCHAINS} chains in {wall:.1f}s "
        f"({wall / total * 1e3:.1f} ms/iter)")

    from gibbssampler.diagnostics import summarize_chains
    ess = []
    for f in range(2):
        s = summarize_chains(np.asarray(out["dl_chains"][f]), burn_frac=0.2)
        ess.append(s["ess"])
    if os.environ.get("BENCH_SAVE_ESS"):
        # per-bin pooled ESS arrays for scheme comparisons (PERF.md)
        np.savez(os.environ["BENCH_SAVE_ESS"],
                 ess_0=ess[0], ess_1=ess[1],
                 bins_0=np.asarray(bins_pair[0]),
                 bins_1=np.asarray(bins_pair[1]),
                 wall=wall, n_iter=total, nchains=NCHAINS, scheme=SCHEME)
    # BB-tail (ell >= 300) pooled ESS/s — the B-mode science target where
    # the per-bin analysis shows interweaving pays (PERF.md §6);
    # reported alongside the median so scheme rows are comparable on both
    bb_bins = np.asarray(bins_pair[-1])
    tail_sel = bb_bins[:-1] >= 300
    bb_tail = (float(np.median(np.asarray(ess[-1])[tail_sel])) / wall
               if tail_sel.any() else None)
    ess = np.concatenate(ess)
    ess_med = float(np.median(ess))
    value = ess_med / wall
    # baseline: ONE reference process (one chain on one CPU node, the
    # reference's SLURM-array unit) running the same sampler: its ESS/iter
    # equals our per-chain ESS/iter; one iteration costs ~REF_SEC_PER_ITER
    # of healpy SHTs on CPU.  vs_baseline = one GPU vs one CPU process.
    per_chain_ess_per_iter = ess_med / (0.8 * total * NCHAINS)
    baseline = per_chain_ess_per_iter / REF_SEC_PER_ITER
    log(f"median pooled ESS {ess_med:.1f} over {wall:.1f}s; per-chain "
        f"ESS/iter {per_chain_ess_per_iter:.4f}; "
        f"single-process CPU baseline est {baseline:.5f} ESS/s")
    scheme_label = {
        "asis": f"flagship ASIS: {BENCH_CR} CR + Planck-blocked NC MH",
        "pncp": f"PNCP l_cut={_lcut_raw}: {BENCH_CR} CR, NC MH above "
                f"l_cut (per field)",
        "centered": "centered aux+MALA CR",
    }.get(SCHEME, SCHEME)
    print(json.dumps({
        "metric": f"Cl-chain median pooled ESS/s, polarized masked Gibbs "
                  f"({scheme_label}), "
                  f"lmax={LMAX}, grid={GRID}, {NCHAINS} "
                  f"chains on one chip; vs_baseline = vs one single-chain "
                  f"CPU reference process at ~{REF_SEC_PER_ITER:.0f}s/iter",
        "value": round(value, 3),
        "unit": "ESS/s",
        "vs_baseline": round(value / baseline, 1) if baseline > 0 else None,
        # protocol annotation (VERDICT r4 weak #2: make BENCH rows
        # self-describing so cross-round comparisons are reconstructable)
        "scheme": SCHEME,
        "protocol": {"cr": BENCH_CR, "n_iter": total, "nchains": NCHAINS,
                     "mask": MASK_KIND, "grid": GRID, "lmax": LMAX,
                     "ms_per_iter": round(wall / total * 1e3, 1),
                     "per_chain_ess_per_iter":
                         round(per_chain_ess_per_iter, 5),
                     "bb_tail_ess_per_s":
                         (round(bb_tail, 3) if bb_tail else None),
                     "l_cut": (_lcut_raw if SCHEME == "pncp" else None)},
    }))


if __name__ == "__main__":
    main()
