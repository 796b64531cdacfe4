"""Per-chip roofline for the dominant kernels.

(BASELINE.json north_star: "Per-chip roofline on the CG+SHT kernel";
VERDICT r4 missing #4.)

Everything is measured on the GPU the process runs on (it refuses to run
without one).  XLA's `.compile().cost_analysis()` undercounts loop bodies
(scan trip counts), so workload FLOPs are counted ANALYTICALLY from the
transform algebra (formulas inline below), not from the cost model.

Ingredients:
1. Attainable peaks: chained big matmuls (fp32 and bf16) and an
   `optimization_barrier` triad (read a, read b, write c, read c) for
   device-memory stream bandwidth.
2. Workloads at the bench protocol (lmax=512, 128 vmapped chains):
   the full flagship ASIS step, the CR step, the blocked-MH C_ell
   step, one vmapped cut spin-2 synthesis, and one CG mat-vec batch
   (`q_apply_cut` = cut synthesis + cut adjoint + diagonal ops).

Usage:  python tools/roofline.py            # band mask
        BENCH_MASK=planckish python tools/roofline.py
Prints a markdown table for PERF.md.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

NCHAINS = int(os.environ.get("PROBE_NCHAINS", "128"))
N_ITER = int(os.environ.get("PROBE_ITERS", "20"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure_peaks():
    """Attainable matmul TFLOP/s and device-memory GB/s on this GPU."""
    peaks = {}
    n, reps = 8192, 8
    for name, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        x = jnp.asarray(np.random.default_rng(0)
                        .standard_normal((n, n)).astype(np.float32), dt)

        @jax.jit
        def chain(a):
            y = a
            for _ in range(reps):
                y = y @ a
            return jnp.sum(y.astype(jnp.float32))

        chain(x).block_until_ready()         # compile + warm
        t0 = time.time()
        s = float(chain(x).block_until_ready())
        sec = time.time() - t0
        assert np.isfinite(s)
        peaks[name] = reps * 2 * n**3 / sec / 1e12
        log(f"peak {name} matmul: {peaks[name]:.1f} TF/s "
            f"({reps}x {n}^3, {sec*1e3:.1f} ms)")
    m = 1 << 28                              # 1 GiB fp32 per operand
    a = jnp.ones((m,), jnp.float32)
    b = jnp.ones((m,), jnp.float32)

    @jax.jit
    def triad(a, b):
        c = jax.lax.optimization_barrier(a + 1.5 * b)   # forces the write
        return jnp.sum(c)

    triad(a, b).block_until_ready()
    t0 = time.time()
    triad(a, b).block_until_ready()
    sec = time.time() - t0
    peaks["mem_gbs"] = 4 * 4 * m / sec / 1e9   # read a,b; write c; read c
    log(f"stream memory bandwidth: {peaks['mem_gbs']:.0f} GB/s "
        f"(barrier triad, {sec*1e3:.1f} ms)")
    return peaks


# ---- analytic FLOP counts (per chain, per call) -------------------------
# Real-basis spin-2 SHT, m-major Legendre tables over nr rings at band
# limit L = lmax+1:
#   Legendre stage: for each m, a (nr x (L-m)) x ((L-m),) product per
#   (field E/B) x (lambda_plus/lambda_minus) x (cos/sin output) — the
#   implementation fuses these as (m, l, r) einsum slabs; total
#   multiply-adds ~= 4 * nr * sum_m (L - m) = 4 * nr * L(L+1)/2.
#   FLOPs (mul+add = 2): ~= 4 * nr * L^2   (spin-2, both fields, Q and U)
#   The adjoint costs the same by symmetry.
#   Azimuthal stage ("matmul" DFT mode): (nphi x m) real matmuls per
#   ring pair: ~= 2 * nr * nphi * L FLOPs per map component x 2 (Q,U).
def sht_spin2_flops(L, nr, nphi):
    leg = 4.0 * nr * L * L * 2
    azi = 2.0 * nr * nphi * L * 2 * 2
    return leg + azi


def roofline_row(name, sch, carry, body, peaks, flops_per_chain=None,
                 n=N_ITER):
    """Time a scan of n steps and report achieved TFLOP/s vs the measured
    fp32 peak."""

    @jax.jit
    def run(sch, carry, keys):
        def f(c, k):
            return body(sch, c, k), None
        out, _ = jax.lax.scan(f, carry, keys)
        return out

    keys = jax.random.split(jax.random.PRNGKey(7), n)
    jax.block_until_ready(run(sch, carry, keys))      # compile + warm
    t0 = time.time()
    jax.block_until_ready(run(sch, carry, keys))
    sec = (time.time() - t0) / n
    row = {"name": name, "ms": sec * 1e3}
    if flops_per_chain is not None:
        row["tflops"] = flops_per_chain * NCHAINS / sec / 1e12
        row["fp32_frac"] = row["tflops"] / peaks["fp32"]
    log(f"{name:34s} {sec*1e3:8.1f} ms"
        + (f"  {row['tflops']:6.2f} TF/s ({row['fp32_frac']*100:5.2f}% "
           f"fp32 peak)" if flops_per_chain else ""))
    return row


def main():
    import bench
    from gibbssampler.utils import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    peaks = measure_peaks()
    scheme, (dl_ee, dl_bb, bins_pair) = bench.build()
    dl0 = tuple(bench._binned_mean_np(d, b)
                for d, b in zip((dl_ee, dl_bb), bins_pair))
    from gibbssampler.schemes.gibbs import _init_scheme, _nc_cls_step
    from gibbssampler.samplers import cls_samplers as cls_mod
    dl0j = tuple(jnp.asarray(d, dtype=scheme.model.sht.dtype) for d in dl0)
    states = _init_scheme(scheme, jax.random.split(jax.random.PRNGKey(1),
                                                   NCHAINS), dl0j)
    jax.block_until_ready(states.s)
    nst = jax.tree.leaves(states)[0].shape[0]
    model = scheme.model
    L = model.lmax + 1
    cut = model.cut_sht
    nr_cut, nphi_cut = cut.grid.nrings, cut.grid.nphi
    nr_full, nphi_full = model.sht.nrings, model.sht.nphi
    f_cut = sht_spin2_flops(L, nr_cut, nphi_cut)
    log(f"analytic: cut spin-2 transform {f_cut/1e9:.2f} GF/chain "
        f"({nr_cut} rings), full {sht_spin2_flops(L, nr_full, nphi_full)/1e9:.2f} GF")

    def full_step(sch, sts, key):
        kn, kc = jax.random.split(key)
        pool = sch.draw_noise_pool(kn, nst)
        ks = jax.random.split(kc, nst)
        if pool:
            return jax.vmap(sch.step)(ks, sts, pool)[0]
        return jax.vmap(sch.step)(ks, sts)[0]

    def cr_only(sch, sts, key):
        kn, kc = jax.random.split(key)
        pool = sch.draw_noise_pool(kn, nst)
        ks = jax.random.split(kc, nst)

        def one(k, st, nz):
            s, _ = sch._cr_step(k, st.s, sch.var_cls(st.dl), nz)
            return st._replace(s=s)
        if pool:
            return jax.vmap(one)(ks, sts, pool)
        return jax.vmap(lambda k, st: one(k, st, None))(ks, sts)

    def mh_only(sch, sts, key):
        ks = jax.random.split(key, nst)

        def one(k, st):
            dl_c = cls_mod.centered_cls_sample(k, st.s, sch.bins_list,
                                               sch.lmax)
            s_nc = cls_mod.whiten(st.s, dl_c, sch.bins_list, sch.lmax)
            dl, _ = _nc_cls_step(sch, k, dl_c, s_nc)
            s = cls_mod.recenter(s_nc, dl, sch.bins_list, sch.lmax)
            return st._replace(s=s, dl=dl)
        return jax.vmap(one)(ks, sts)

    s = states.s

    def cut_synth(sch, x, key):
        u = sch.model.beam(x)
        out = jax.vmap(sch.model.synthesis_cut)(u)
        return x + 0 * jnp.sum(out) / (jnp.abs(jnp.sum(out)) + 1.0)

    def q_matvec(sch, x, key):
        m = sch.model
        inv_cvar = m.ell_mask() * 1.0
        out = jax.vmap(lambda v: m.q_apply_cut(v, inv_cvar))(x)
        if isinstance(out, tuple):
            out = out[0]
        return x + 0 * jnp.sum(out) / (jnp.abs(jnp.sum(out)) + 1.0)

    # aux+MALA CR: 2 aux transforms + ~4 MALA transforms, all cut-sized
    # (PERF.md); MH step: 2 cut syntheses (big block + base) + the
    # table-domain singles (scalar cost) + conj/whiten elementwise
    rows = [
        roofline_row("cut spin-2 synthesis", scheme, s, cut_synth, peaks,
                     flops_per_chain=f_cut),
        roofline_row("CG mat-vec (q_apply_cut)", scheme, s, q_matvec, peaks,
                     flops_per_chain=2 * f_cut),
        roofline_row("CR step (aux+MALA)", scheme, states, cr_only, peaks,
                     flops_per_chain=6 * f_cut),
        roofline_row("blocked-MH C_ell step", scheme, states, mh_only,
                     peaks, flops_per_chain=2 * f_cut),
        roofline_row("full flagship step", scheme, states, full_step, peaks,
                     flops_per_chain=8 * f_cut),
    ]
    print("\n| kernel | ms (128 chains) | analytic TFLOP/s | % fp32 peak |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['name']} | {r['ms']:.1f} "
              f"| {r.get('tflops', float('nan')):.2f} "
              f"| {r.get('fp32_frac', float('nan'))*100:.2f} |")
    print(f"\nmeasured peaks: fp32 {peaks['fp32']:.0f} TF/s, "
          f"bf16 {peaks['bf16']:.0f} TF/s, memory {peaks['mem_gbs']:.0f} GB/s")


if __name__ == "__main__":
    main()
