"""Production-scale masked-CG evidence (VERDICT r2 item 3).

Measures the diagonally-preconditioned CG solver (ops/cg.py — the qcinv
multigrid/PCG replacement, reference descriptor
``[0, ["diag_cl"], lmax, nside, 4000, 1e-6, tr_cg, cache_mem()]``,
/root/reference/ConstrainedRealization.py:40-41) at the reference's
production scale: lmax=512, polarized, 0.5 deg beam, reference noise,
galactic band cuts at several f_sky values, tolerances 1e-5 / 1e-6.

For each (f_sky, tol) cell: CG iteration count (lockstep over a chain
batch) and wall ms/solve on the attached device.  Results go to stdout as
a markdown table + one JSON line for PERF.md.

Usage: python tools/cg_scale.py            # lmax=512, on the GPU
       CG_LMAX=128 CG_NCHAINS=4 python tools/cg_scale.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LMAX = int(os.environ.get("CG_LMAX", "512"))
NCHAINS = int(os.environ.get("CG_NCHAINS", "8"))
# fp64 is the reference's working precision (qcinv on numpy doubles); with
# the cut decomposition the Q apply runs over the masked rings only, so
# fp64 tables stay small even at lmax=512
DTYPE = os.environ.get("CG_DTYPE", "float64")
MAXITER = int(os.environ.get("CG_MAXITER", "4000"))
CUT = bool(int(os.environ.get("CG_CUT", "1")))
# band half-widths (deg) -> approximate f_sky of the kept region
BANDS = [float(x) for x in os.environ.get("CG_BANDS", "5,11.5,25").split(",")]
TOLS = [float(x) for x in os.environ.get("CG_TOLS", "1e-5,1e-6").split(",")]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build(band_deg, dtype=None):
    import jax
    import jax.numpy as jnp
    from gibbssampler.inference import example_dl, simulate_dataset
    from gibbssampler.sht import gauss_legendre_grid

    dl_ee = example_dl(LMAX, "ee", amp=1000.0)
    dl_bb = example_dl(LMAX, "bb", amp=1000.0)
    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    ring_keep = (lat > np.radians(band_deg)).astype(np.float64)
    mask = np.broadcast_to(ring_keep[:, None], (grid.nrings, grid.nphi))
    model, _ = simulate_dataset(
        jax.random.PRNGKey(0), LMAX, spin=2,
        dl_fields=np.stack([dl_ee, dl_bb]),
        noise_sigma2=0.2 ** 2, fwhm_radians=np.radians(0.5), mask=mask,
        dtype=jnp.dtype(dtype or DTYPE), grid=grid)
    if CUT:
        from gibbssampler.ops import with_cut_decomposition
        model = with_cut_decomposition(model)
    return model, (dl_ee, dl_bb)


def measure(model, dls, tol):
    import jax
    import jax.numpy as jnp
    from gibbssampler.harmonics.spectra import unfold_bins
    from gibbssampler.harmonics.gridstate import variance_expansion_state
    from gibbssampler.samplers.cr import (cr_precond, fluctuated_rhs,
                                              _q_op, _safe_inv, _active)
    from gibbssampler.ops.cg import cg_solve

    dt = model.sht.dtype
    bins = np.arange(2, LMAX + 2)
    var = jnp.stack([variance_expansion_state(
        unfold_bins(jnp.asarray(d[2:], dt), bins, LMAX), LMAX)
        for d in dls])
    bt = jax.jit(lambda m: m.bt_ninv_d())(model)

    def one_solve(key, model):
        inv_cvar = _safe_inv(var)
        b = fluctuated_rhs(key, model, var, bt)
        op = _q_op(model, inv_cvar)
        x, info = cg_solve(op, b, x0=None,
                           precond_diag=cr_precond(model, var),
                           tol=tol, maxiter=MAXITER, ndim_sys=2)
        return x * _active(var), info

    solve = jax.jit(jax.vmap(one_solve, in_axes=(0, None)),
                    static_argnums=())
    keys = jax.random.split(jax.random.PRNGKey(7), NCHAINS)
    x, info = solve(keys, model)          # compile + converge
    jax.block_until_ready(x)
    iters = int(np.max(np.asarray(info.iterations)))
    conv = bool(np.all(np.asarray(info.converged)))
    t0 = time.time()
    nrep = 3
    for r in range(nrep):
        keys = jax.random.split(jax.random.PRNGKey(100 + r), NCHAINS)
        x, info = solve(keys, model)
        jax.block_until_ready(x)
    ms = (time.time() - t0) / nrep * 1e3

    # RJPO acceptance at this tolerance: seed the chain at a converged CG
    # draw, then one rjpo_cr step per chain at the tested (tol, maxiter)
    # budget (the reference's MH-corrected PCG, CenteredGibbs.py:606-674)
    from gibbssampler.samplers.cr import rjpo_cr
    rjpo = jax.jit(jax.vmap(
        lambda k, s, m: rjpo_cr(k, m, var, bt, s, tol=tol, maxiter=MAXITER),
        in_axes=(0, 0, None)))
    keys = jax.random.split(jax.random.PRNGKey(200), NCHAINS)
    _, rinfo = rjpo(keys, x, model)
    racc = float(np.mean(np.asarray(rinfo.accept)))
    return iters, conv, ms, racc


def measure_mixed(model64, model32, dls, tol, replace_every):
    """Mixed-precision cell: fp32 Q applies + fp64 vectors/recurrences +
    periodic fp64 true-residual replacement (ops/cg.py apply_dtype)."""
    import jax
    import jax.numpy as jnp
    from gibbssampler.harmonics.spectra import unfold_bins
    from gibbssampler.harmonics.gridstate import variance_expansion_state
    from gibbssampler.samplers.cr import (cr_precond, fluctuated_rhs,
                                              _q_op, _safe_inv, _active)
    from gibbssampler.ops.cg import cg_solve

    bins = np.arange(2, LMAX + 2)
    var64 = jnp.stack([variance_expansion_state(
        unfold_bins(jnp.asarray(d[2:], jnp.float64), bins, LMAX), LMAX)
        for d in dls])
    var32 = var64.astype(jnp.float32)
    bt64 = jax.jit(lambda m: m.bt_ninv_d())(model64)

    # Host-level monotone restarted mixed CG.  Two SMALL device programs:
    # (a) a pure fp32-apply CG segment of `replace_every` iterations
    #     (fp64 vectors, fp32-cast Q applies, no fp64 operator inside the
    #     while-loop body, which keeps each compile small), and
    # (b) one fp64 true-residual program.
    # The van der Vorst replacement + monotone best-point selection runs
    # on the host between segments (ops/cg.py implements the same scheme
    # in one program; its compile time on the GPU is not measured).
    # Operators are built INSIDE the jitted fns from the model arguments —
    # closing over the models would bake their GB-scale tables into the
    # compiled module as constants.

    def rhs(key, model64):
        return fluctuated_rhs(key, model64, var64, bt64)

    def seg_solve(b, x0, seg, model32, model64):
        # HIGHEST matmul precision: reduced-precision fp32 matmuls (TF32
        # on the GPU) floor the attainable residual far above tol on this
        # operator; 'highest' keeps true-fp32 applies
        with jax.default_matmul_precision("highest"):
            op_lo = _q_op(model32, _safe_inv(var32))   # fp32 vectors
            x, info = cg_solve(op_lo, b, x0=x0,
                               precond_diag=cr_precond(model64, var64),
                               tol=tol, maxiter=seg, ndim_sys=2,
                               apply_dtype=jnp.float32, operator_hi=None,
                               replace_every=0)
        return x, info

    def seg_solve64(b, x0, seg, model64):
        op = _q_op(model64, _safe_inv(var64))
        x, info = cg_solve(op, b, x0=x0,
                           precond_diag=cr_precond(model64, var64),
                           tol=tol, maxiter=seg, ndim_sys=2)
        return x, info

    rhs_j = jax.jit(jax.vmap(rhs, in_axes=(0, None)))
    seg_j = jax.jit(jax.vmap(seg_solve, in_axes=(0, 0, None, None, None)),
                    static_argnums=(2,))
    seg64_j = jax.jit(jax.vmap(seg_solve64, in_axes=(0, 0, None, None)),
                      static_argnums=(2,))
    resid_j = jax.jit(jax.vmap(
        lambda b, x, m: b - _q_op(m, _safe_inv(var64))(x),
        in_axes=(0, 0, None)))

    def full_solve(b, x0=None):
        """Iterative-refinement ladder: monotone restarted mixed CG (fp32
        'highest' applies) down to its attainable floor, then fp64 CG
        finishes from that warm start, so the fp64 phase only works the
        last decades of the residual (the fp32 floor on the GPU is not
        measured)."""
        bn = np.sqrt(np.sum(np.asarray(b) ** 2, axis=(1, 2)))
        x = jnp.zeros_like(b) if x0 is None else x0
        best_x, best_rn = np.asarray(x), np.full(bn.shape, np.inf)
        iters = 0
        seg = replace_every
        stall = 0
        prev = np.inf
        while iters < MAXITER:
            xs, info = seg_j(b, x, seg, model32, model64)
            jax.block_until_ready(xs)
            iters += seg
            r_true = np.asarray(resid_j(b, xs, model64))
            rn = np.sqrt(np.sum(r_true ** 2, axis=(1, 2)))
            better = np.isfinite(rn) & (rn < best_rn)
            best_x = np.where(better[:, None, None], np.asarray(xs), best_x)
            best_rn = np.where(better, rn, best_rn)
            cur = float(np.max(best_rn / bn))
            if iters % 500 == 0 and os.environ.get("CG_VERBOSE"):
                log(f"  mixed iters={iters} rel={cur:.3e}")
            if np.all(best_rn <= tol * bn):
                return jnp.asarray(best_x), iters, True
            # fp32 floor detection: < 2% progress over 4 checks
            stall = stall + 1 if cur > 0.98 * prev else 0
            prev = cur
            if stall >= 4:
                break
            x = jnp.asarray(best_x)     # monotone restart (fresh p = z)
        # fp64 finish from the mixed warm start
        x = jnp.asarray(best_x)
        seg64 = int(os.environ.get("CG_SEG64", "100"))
        while iters < MAXITER:
            x, info = seg64_j(b, x, seg64, model64)
            jax.block_until_ready(x)
            it = int(np.max(np.asarray(info.iterations)))
            iters += it
            if os.environ.get("CG_VERBOSE"):
                rn_ = np.max(np.asarray(info.residual_norm) / bn)
                log(f"  fp64 finish iters={iters} rel={rn_:.3e}")
            if bool(np.all(np.asarray(info.converged))):
                return x, iters, True
            if it < seg64:
                break
        return x, iters, False

    keys = jax.random.split(jax.random.PRNGKey(7), NCHAINS)
    b = rhs_j(keys, model64)
    x, iters, conv = full_solve(b)          # compile + converge
    t0 = time.time()
    nrep = 3
    for rr in range(nrep):
        keys = jax.random.split(jax.random.PRNGKey(100 + rr), NCHAINS)
        b = rhs_j(keys, model64)
        x, iters, conv = full_solve(b)
    ms = (time.time() - t0) / nrep * 1e3
    from gibbssampler.samplers.cr import _active as _act
    act = jax.jit(lambda v: v * _act(var64))

    # RJPO acceptance at this budget: re-solve seeded at -x (the
    # reference's seeding, CenteredGibbs.py:161-163) and Metropolis-gate on
    # the fp64 residual: log alpha = -<r, s_old - s_hat>
    s_old = act(x)
    kb, ka = jax.random.split(jax.random.PRNGKey(200))
    b2 = rhs_j(jax.random.split(kb, NCHAINS), model64)
    # same monotone segmented loop, seeded at -s_old
    xh, _, _ = full_solve(b2, x0=-s_old)
    s_hat = act(xh)
    rres = resid_j(b2, s_hat, model64)
    log_ratio = -np.sum(np.asarray(rres * (s_old - s_hat)), axis=(1, 2))
    u = np.log(np.asarray(jax.random.uniform(
        ka, (NCHAINS,), dtype=jnp.float64)))
    racc = float(np.mean(u < log_ratio))
    return iters, conv, ms, racc


def main():
    import jax
    from gibbssampler.utils import use_compile_cache
    use_compile_cache()
    # fp64 is needed in all modes
    jax.config.update("jax_enable_x64", True)
    log(f"device: {jax.devices()}")
    mixed = bool(int(os.environ.get("CG_MIXED", "0")))
    replace_every = int(os.environ.get("CG_REPLACE", "10"))
    rows = []
    mode = (f"mixed fp32-apply/fp64-recur, replace_every={replace_every}"
            if mixed else f"dtype={DTYPE}")
    print(f"lmax={LMAX} pol masked CG, {NCHAINS} lockstep chains, "
          f"cut={CUT}, maxiter={MAXITER}, {mode}")
    print("| band (deg) | f_sky | tol | iters (lockstep max) | converged | "
          "ms/solve (batch) | rjpo accept |")
    print("|---|---|---|---|---|---|---|")
    for band in BANDS:
        if mixed:
            model64, dls = build(band, dtype="float64")
            model32, _ = build(band, dtype="float32")
        else:
            model, dls = build(band)
        for tol in TOLS:
            if mixed:
                fsky = float(np.asarray(model64.noise.f_sky).mean())
                iters, conv, ms, racc = measure_mixed(model64, model32, dls,
                                                      tol, replace_every)
            else:
                fsky = float(np.asarray(model.noise.f_sky).mean())
                iters, conv, ms, racc = measure(model, dls, tol)
            print(f"| {band:.1f} | {fsky:.3f} | {tol:g} | {iters} | "
                  f"{conv} | {ms:.0f} | {racc:.2f} |", flush=True)
            rows.append({"band_deg": band, "f_sky": round(fsky, 4),
                         "tol": tol, "iters": iters, "converged": conv,
                         "ms_per_batch_solve": round(ms, 1),
                         "rjpo_accept": round(racc, 3)})
    print(json.dumps({"lmax": LMAX, "nchains": NCHAINS, "cut": CUT,
                      "dtype": ("mixed" if mixed else DTYPE),
                      "replace_every": (replace_every if mixed else None),
                      "rows": rows}))


if __name__ == "__main__":
    main()
