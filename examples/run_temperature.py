"""Temperature-only Gibbs sampling — the reference's historical TT entry
point (main.py, surviving as .ipynb_checkpoints/main-checkpoint.py) rebuilt
as a framework run.

    python examples/run_temperature.py --scheme centered --cr cg --lmax 128
"""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="centered",
                    choices=["centered", "noncentered", "asis", "pncp"])
    ap.add_argument("--cr", default="exact")
    ap.add_argument("--grid", default="gl", choices=["gl", "healpix"])
    ap.add_argument("--lmax", type=int, default=128)
    ap.add_argument("--n-iter", type=int, default=1000)
    ap.add_argument("--nchains", type=int, default=4)
    ap.add_argument("--mask-band-deg", type=float, default=0.0)
    ap.add_argument("--noise-sigma2", type=float, default=1600.0,
                    help="reference TT noise: 40^2")
    ap.add_argument("--out", default="tt_run.npz")
    args = ap.parse_args()

    from gibbssampler.inference import RunConfig, run_experiment

    cfg = RunConfig(
        lmax=args.lmax, spin=0, grid=args.grid, scheme=args.scheme,
        cr_method=args.cr, noise_sigma2=args.noise_sigma2,
        fwhm_deg=0.5, mask_band_deg=args.mask_band_deg,
        n_iter=args.n_iter, nchains=args.nchains, out=args.out)
    res = run_experiment(cfg)
    print(f"done: median ESS {np.median(res['ess_0']):.1f}, "
          f"total wall {res['durations'].sum():.1f}s -> {args.out}")


if __name__ == "__main__":
    main()
