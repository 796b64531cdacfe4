"""Cross-chain proposal adaptation.

Replaces the reference's offline two-phase workflow — run preliminary chains,
reload all SLURM-array outputs, pool their variances, hand-tune per-block
fudge factors, relaunch (config.py:136-225) — with in-band warmup segments:
pooled posterior variances across the (possibly device-sharded) chain axis
set the truncated-normal proposal scales, targeting the standard
random-walk-optimal acceptance."""

from __future__ import annotations

import numpy as np

__all__ = ["analytic_proposal_sigma", "pooled_proposal_sigmas",
           "block_widths", "proposal_sigmas_from_results", "adapt_segments"]


def analytic_proposal_sigma(bl, noise_sigma2, omega, lmax: int, bins,
                            f_sky: float = 1.0):
    """Closed-form noise-dominated proposal std-devs for the non-centered
    blocked MH over binned D_ell (the reference's warmup seed,
    config.py:119-134).

    Per ell the posterior variance of D_ell in the noise-dominated limit is
    Var(D_l) ~= 2/(2l+1) * (l(l+1)/(2 pi) * omega * N / b_l^2)^2 / f_sky
    (omega = 4 pi / Npix, N = per-pixel noise variance); a bin's proposal
    variance is the mean of its ells' variances divided by the bin length
    (variance of the bin average).  Returns (nbins,) std devs."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    bl = np.asarray(bl, dtype=np.float64)
    scale = (ell * (ell + 1.0)) ** 2 * 2.0 / (4.0 * np.pi ** 2
                                              * (2.0 * ell + 1.0))
    unbinned = (omega * float(noise_sigma2) / bl ** 2) ** 2 * scale \
        / max(float(f_sky), 1e-6)
    bins = np.asarray(bins)
    var = np.array([unbinned[lo:hi].mean() / (hi - lo)
                    for lo, hi in zip(bins[:-1], bins[1:])])
    return np.sqrt(np.maximum(var, 1e-24))


def pooled_proposal_sigmas(dl_chains, scale: float = 2.38,
                           floor: float = 1e-12, block_width=None):
    """Proposal sd per bin from pooled chain variance:
    2.38 * sd(D_bin) / sqrt(d) with d the width (in bins) of the MH block
    the bin belongs to — the optimal random-walk scaling 2.38/sqrt(d) for
    a d-dimensional joint block update (the reference's production
    blocking has 394-bin joint blocks, config.py:51-55, where the 1-d
    scale collapses acceptance to ~0.02; measured in tools/tune_flagship).
    ``block_width``: per-bin d (default 1).  Pooling over chains and
    iterations replaces config.py:161-189's file pooling."""
    dl_chains = np.asarray(dl_chains, dtype=np.float64)
    sd = dl_chains.reshape(-1, dl_chains.shape[-1]).std(axis=0)
    if block_width is not None:
        sd = sd / np.sqrt(np.maximum(np.asarray(block_width,
                                                dtype=np.float64), 1.0))
    return np.maximum(scale * sd, floor)


def block_widths(blocks, nbins: int):
    """(nbins,) width of the MH block each bin belongs to (1 for bins not
    covered by any block)."""
    w = np.ones(nbins)
    for (lo, hi) in blocks:
        w[lo:hi] = hi - lo
    return w


def proposal_sigmas_from_results(npz_path, nfields: int | None = None,
                                 scale: float = 2.38, burn_frac: float = 0.2,
                                 blocks_list=None):
    """Proposal std-devs pooled from a previous run's saved chains — the
    reference's two-phase preliminary-run workflow
    (get_proposal_variances_preliminary, config.py:136-225), reading the
    results npz written by inference.run_experiment.

    ``blocks_list`` (per-field [(lo, hi)] MH blocks): when given, each
    bin's sd is scaled by 2.38/sqrt(d_block) — without it a 394-bin joint
    block at the 1-d scale collapses acceptance to ~0.02 (measured,
    PERF.md §6)."""
    z = np.load(str(npz_path))
    fields = [k for k in z.files if k.startswith("dl_chain_")]
    fields.sort(key=lambda k: int(k.split("_")[-1]))
    if nfields is not None:
        fields = fields[:nfields]
    out = []
    for fi, k in enumerate(fields):
        c = np.asarray(z[k], dtype=np.float64)     # (nchains, n_iter, nbins)
        c = c[:, int(burn_frac * c.shape[1]):]
        bw = (block_widths(blocks_list[fi], c.shape[-1])
              if blocks_list is not None else None)
        out.append(pooled_proposal_sigmas(c, scale=scale, block_width=bw))
    return out


def adapt_segments(make_scheme, key, dl_init_tuple, sigma0_list,
                   n_segments: int = 3, seg_iters: int = 200,
                   nchains: int = 8, target_accept=(0.2, 0.5)):
    """Warmup loop: run a segment, pool per-block acceptance across chains,
    rescale the proposal sigmas multiplicatively toward the target window,
    rebuild the scheme, and return the tuned sigmas plus the warm state.

    make_scheme(prop_sigma_list) -> scheme with an MH C_ell step.

    The rescale is applied *per block* from the per-block acceptance
    histories — the reference's workflow hand-tunes per-block fudge
    factors exactly this way (config.py:192-225) — falling back to one
    global factor when the scheme exposes no block structure.  The update
    is PURELY multiplicative from the seed sigmas: re-estimating a base
    from pooled chain sd is wrong for high-SNR joint blocks, where the NC
    conditional p(dl | s_nc, d) is far tighter than the marginal posterior
    the chain sd measures (measured at lmax=512: sd-based EE proposals
    collapse acceptance to 0.00 where the analytic seed sits at 0.32;
    PERF.md §6)."""
    import jax

    def _factor(acc):
        lo, hi = target_accept
        if acc < lo:
            return max(acc / lo, 0.3)
        if acc > hi:
            return min(1.0 + (acc - hi) * 2.0, 3.0)
        return 1.0

    sig = [np.asarray(s, dtype=np.float64) for s in sigma0_list]
    out = None
    for seg in range(n_segments):
        key, krun = jax.random.split(key)
        scheme = make_scheme([s.copy() for s in sig])
        blocks_list = getattr(scheme, "blocks_list", None)
        out = scheme.run(krun, dl_init_tuple, n_iter=seg_iters,
                         nchains=nchains)
        new_sig = []
        for f, chain in enumerate(out["dl_chains"]):
            factor = np.ones(len(sig[f]))
            if "mh_accept" in out and blocks_list is not None:
                # (nchains, n_iter, nblocks_f) -> per-block acceptance
                acc_b = np.asarray(out["mh_accept"][f]).reshape(
                    -1, len(blocks_list[f])).mean(axis=0)
                for (blo, bhi), a in zip(blocks_list[f], acc_b):
                    factor[blo:bhi] = _factor(float(a))
            elif "mh_accept" in out:
                factor[:] = _factor(float(np.asarray(
                    out["mh_accept"][f]).mean()))
            new_sig.append(np.maximum(sig[f] * factor, 1e-12))
        sig = new_sig
        dl_init_tuple = tuple(
            np.asarray(c)[:, -1, :].mean(axis=0)
            for c in out["dl_chains"])
    return sig, dl_init_tuple, out
