"""Joint TT/TE/EE/BB sampling with per-ell covariance blocks.

The reference only scaffolded this mode (3x3 Cython kernel + invwishart
import, SURVEY.md 2.6.8); here it is a first-class scheme:

    python examples/run_joint_tqu.py --lmax 64 --n-iter 500
"""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lmax", type=int, default=64)
    ap.add_argument("--n-iter", type=int, default=500)
    ap.add_argument("--nchains", type=int, default=4)
    ap.add_argument("--noise-sigma2", type=float, default=0.01)
    ap.add_argument("--r-te", type=float, default=0.5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from gibbssampler.inference import example_dl
    from gibbssampler.ops import NoiseModel, SkyModel
    from gibbssampler.samplers import synfast_joint
    from gibbssampler.schemes import JointCenteredGibbs
    from gibbssampler.sht import make_sht

    lmax = args.lmax
    tt = example_dl(lmax, "tt", amp=100.0)
    ee = example_dl(lmax, "ee", amp=100.0)
    bb = example_dl(lmax, "bb", amp=100.0)
    ell = np.arange(lmax + 1, dtype=float)
    fac = np.where(ell >= 2, 2 * np.pi / np.maximum(ell * (ell + 1), 1), 0.0)
    C = np.zeros((lmax + 1, 3, 3))
    C[:, 0, 0], C[:, 1, 1], C[:, 2, 2] = tt * fac, ee * fac, bb * fac
    C[:, 0, 1] = C[:, 1, 0] = args.r_te * np.sqrt(C[:, 0, 0] * C[:, 1, 1])

    sht = make_sht(lmax, spin2=True)
    s_true = synfast_joint(jax.random.PRNGKey(0), C, lmax)
    noise = NoiseModel.white(args.noise_sigma2, sht.grid, nfields=3)
    model = SkyModel(sht=sht, noise=noise, bl=jnp.ones(lmax + 1), spin=3,
                     d=None)
    sky = model.synthesis(s_true)
    d = sky + np.sqrt(args.noise_sigma2) * jax.random.normal(
        jax.random.PRNGKey(1), sky.shape)
    model = SkyModel(sht=sht, noise=noise, bl=model.bl, spin=3, d=d)

    scheme = JointCenteredGibbs(model)
    out = scheme.run(jax.random.PRNGKey(2), jnp.asarray(C),
                     n_iter=args.n_iter, nchains=args.nchains)
    dl = np.asarray(out["dl_chains"][0])
    post = dl[:, args.n_iter // 4:].mean(axis=(0, 1))
    l = min(20, lmax)
    r = post[l, 0, 1] / np.sqrt(post[l, 0, 0] * post[l, 1, 1])
    print(f"posterior TE correlation at l={l}: {r:.3f} "
          f"(input {args.r_te})")


if __name__ == "__main__":
    main()
