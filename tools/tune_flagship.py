"""Two-phase flagship proposal tuning (the reference's preliminary-run
workflow, config.py:136-225, run in-band on the attached device).

Runs warmup segments of the EXACT bench flagship configuration
(bench.build — ASIS, overrelaxed aux CR, Planck-blocked NC MH at
lmax=512 on the masked polarized sky), pooling chain variances and
per-block MH acceptance across the vmapped chains into tuned
truncated-normal proposal scales (parallel.adapt logic: 2.38 * pooled sd,
rescaled per block toward the 0.2-0.5 acceptance window).  Because
``prop_sigma_list`` is an array leaf of the scheme pytree, segments after
the first reuse the compiled executable — adaptation costs no recompiles.

Writes tuned_proposals.json at the repo root; bench.py picks it up when
(scheme, grid, lmax, nbins) match.  Usage:

    python tools/tune_flagship.py                     # 3 x 150 iters, 64 ch
    TUNE_SEGMENTS=4 TUNE_SEG_ITERS=200 python tools/tune_flagship.py
"""

import json
import os
import sys
import time

os.environ.setdefault("BENCH_SCHEME", "asis")
# always tune from the analytic seed: warm-starting from a stale
# tuned_proposals.json (e.g. tuned under a different CR method) can start
# segment 0 far outside the acceptance window
os.environ.setdefault("BENCH_TUNED", "0")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

NCHAINS = int(os.environ.get("TUNE_NCHAINS", "64"))
SEG_ITERS = int(os.environ.get("TUNE_SEG_ITERS", "150"))
SEGMENTS = int(os.environ.get("TUNE_SEGMENTS", "4"))
TARGET = (0.2, 0.5)     # random-walk acceptance window


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _factor(acc, lo=TARGET[0], hi=TARGET[1]):
    if acc < lo:
        return max(acc / lo, 0.3)
    if acc > hi:
        return min(1.0 + (acc - hi) * 2.0, 3.0)
    return 1.0


def main():
    import bench
    import jax
    import jax.numpy as jnp
    from gibbssampler.utils import use_compile_cache
    use_compile_cache()

    assert bench.SCHEME in ("asis", "pncp"), \
        "tuning targets the MH-bearing bench schemes (asis / pncp)"
    scheme, (dl_ee, dl_bb, bins_pair) = bench.build()
    dl0 = tuple(bench._binned_mean_np(d, b)
                for d, b in zip((dl_ee, dl_bb), bins_pair))
    sig = [np.asarray(s, dtype=np.float64) for s in scheme.prop_sigma_list]
    blocks_list = scheme.blocks_list
    key = jax.random.PRNGKey(int(os.environ.get("TUNE_SEED", "11")))

    # PURE multiplicative per-block adaptation from the analytic seed.
    # (A pooled-chain-sd base was tried and is WRONG for high-SNR joint
    # blocks: the NC conditional p(dl | s_nc, d) is far tighter than the
    # marginal posterior the chains' sd estimates — measured EE acceptance
    # 0.00 from sd-based proposals vs 0.32 from the analytic
    # noise-dominated seed.  Multiplicative feedback toward the window
    # converges regardless of the conditional's width.)
    accs_log = []
    for seg in range(SEGMENTS):
        key, krun = jax.random.split(key)
        # swap the proposal scales as array leaves: no recompile
        scheme.prop_sigma_list = tuple(
            jnp.asarray(s, dtype=scheme.model.sht.dtype) for s in sig)
        t0 = time.time()
        out = scheme.run(krun, dl0, n_iter=SEG_ITERS, nchains=NCHAINS)
        jax.block_until_ready(out["dl_chains"])
        wall = time.time() - t0
        new_sig, seg_acc = [], []
        for f, chain in enumerate(out["dl_chains"]):
            factor = np.ones(len(sig[f]))
            acc_b = np.asarray(out["mh_accept"][f]).reshape(
                -1, len(blocks_list[f])).mean(axis=0)
            for (blo, bhi), a in zip(blocks_list[f], acc_b):
                factor[blo:bhi] = _factor(float(a))
            new_sig.append(np.maximum(sig[f] * factor, 1e-12))
            seg_acc.append(acc_b)
        log(f"segment {seg}: {wall:.1f}s ({wall / SEG_ITERS * 1e3:.0f} "
            f"ms/iter); accept EE {seg_acc[0].mean():.3f} "
            f"BB bigs {seg_acc[1][0]:.3f} "
            f"BB singles {seg_acc[1][1:].mean():.3f}")
        sig = new_sig
        accs_log.append([a.tolist() for a in seg_acc])
        # warm-start the next segment at the pooled last state
        dl0 = tuple(np.asarray(c)[:, -1, :].mean(axis=0)
                    for c in out["dl_chains"])

    rec = {
        "scheme": bench.SCHEME, "grid": bench.GRID, "lmax": bench.LMAX,
        "nbins": [len(s) for s in sig],
        "n_iter_mh": int(os.environ.get("BENCH_NITER_MH", "1")),
        "nchains": NCHAINS, "seg_iters": SEG_ITERS, "segments": SEGMENTS,
        "sig": [s.tolist() for s in sig],
        "dl_warm": [np.asarray(d).tolist() for d in dl0],
        "accept_per_block_per_segment": accs_log,
        "note": "tuned truncated-normal proposal scales for the MH-bearing "
                "bench schemes (tools/tune_flagship.py); bench.py loads the "
                "record whose (scheme, grid, lmax, nbins) match",
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tuned_proposals.json")
    # multi-record store: one tuned record per (scheme, grid, lmax) — a
    # pncp tune must not clobber the flagship's record (and vice versa)
    recs = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                old = json.load(f)
            recs = old.get("records", [old]) if isinstance(old, dict) \
                else old
        except ValueError:
            pass
    key_of = lambda r: (r.get("scheme"), r.get("grid"), r.get("lmax"))
    recs = [r for r in recs if key_of(r) != key_of(rec)] + [rec]
    with open(path, "w") as f:
        json.dump({"records": recs}, f)
    log(f"wrote {path}")
    final_acc = accs_log[-1]
    print(json.dumps({"lmax": bench.LMAX, "grid": bench.GRID,
                      "ee_accept": float(np.mean(final_acc[0])),
                      "bb_big_accept": float(final_acc[1][0]),
                      "bb_singles_accept": float(np.mean(final_acc[1][1:]))}))


if __name__ == "__main__":
    main()
