"""Polarization (EE/BB) Gibbs sampling — the reference's main experiment
(main_polarization.py) as a framework run.

The reference entry point builds a simulated masked Q/U dataset, constructs
centered / non-centered / ASIS samplers, runs one, and pickles the chains
(main_polarization.py:62-185).  Here the same experiment is a RunConfig:

    python examples/run_polarization.py [--scheme asis] [--lmax 256]

On the reference's SLURM cluster each array task ran one chain
(job-script.sh); here the chains are vmapped on one chip (and shard over a
mesh with gibbssampler.parallel for pods).
"""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="asis",
                    choices=["centered", "noncentered", "asis", "pncp"])
    ap.add_argument("--cr", default="aux_gibbs",
                    help="CR method (exact|cg|rjpo|aux_gibbs|overrelax|"
                         "mala|ula|aux_mala|pcn)")
    ap.add_argument("--lmax", type=int, default=128)
    ap.add_argument("--n-iter", type=int, default=1000)
    ap.add_argument("--nchains", type=int, default=4)
    ap.add_argument("--mask-band-deg", type=float, default=10.0)
    ap.add_argument("--noise-sigma2", type=float, default=0.04,
                    help="pol pixel noise variance (reference: 0.2^2)")
    ap.add_argument("--fwhm-deg", type=float, default=0.5)
    ap.add_argument("--out", default="pol_run.npz")
    args = ap.parse_args()

    from gibbssampler.inference import RunConfig, run_experiment

    cfg = RunConfig(
        lmax=args.lmax, spin=2, scheme=args.scheme, cr_method=args.cr,
        cr_options={"n_gibbs": 20} if "aux" in args.cr else {},
        noise_sigma2=args.noise_sigma2, fwhm_deg=args.fwhm_deg,
        mask_band_deg=args.mask_band_deg, n_iter=args.n_iter,
        nchains=args.nchains, out=args.out)
    res = run_experiment(cfg)
    ess = np.concatenate([res["ess_0"], res["ess_1"]])
    print(f"done: median ESS {np.median(ess):.1f}, "
          f"total wall {res['durations'].sum():.1f}s -> {args.out}")


if __name__ == "__main__":
    main()
