"""Experiment runner: typed config, segmented runs, checkpoint/resume.

Replaces the reference's entry-point script + import-time config module +
end-of-run pickle (main_polarization.py:62-185, config.py, SURVEY.md 5):

- configuration is an explicit dataclass (no import-time I/O, no module
  globals, no `and False` dispatch)
- the run is segmented: every segment appends to the chain history and
  writes a resumable snapshot (PRNG key, current state, chain so far) —
  the reference had no mid-run checkpointing (a crashed SLURM task lost
  everything, SURVEY.md 5 'Failure detection')
- results are saved as an .npz with the reference's result-dict fields
  (chains, acceptances, per-segment durations, full configuration;
  main_polarization.py:175-185)
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..diagnostics import summarize_chains
from ..harmonics.spectra import bin_sum
from ..ops import NoiseModel, SkyModel
from ..schemes import CenteredGibbs, NonCenteredGibbs, ASISGibbs, PNCPGibbs
from .simulate import example_dl, simulate_dataset

__all__ = ["RunConfig", "run_experiment", "save_checkpoint", "load_checkpoint"]


@dataclass
class RunConfig:
    """Everything the reference scattered over config.py, as one value."""

    lmax: int = 64
    spin: int = 0                        # 0: TT, 2: EE/BB, 3: joint TQU
    grid: str = "gl"                     # gl | healpix (reference data grid)
    nside: int = 0                       # healpix nside (default lmax // 2)
    scheme: str = "centered"             # centered | noncentered | asis | pncp
                                         # | joint (spin=3, exact full sky)
    cr_method: str = "exact"             # see schemes.CR_METHODS
    cr_options: dict = field(default_factory=dict)
    r_te: float = 0.0                    # TE correlation for spin=3 data:
                                         # D_TE = r_te sqrt(D_TT D_EE); the
                                         # simulated fields are drawn
                                         # correlated (synfast_joint) and the
                                         # joint scheme recovers the blocks
    noise_sigma2: float = 1.0            # reference: 40^2 TT / 0.2^2 pol
    fwhm_deg: float = 0.0                # reference: 0.5 deg
    mask_band_deg: float = 0.0           # analytic galactic cut half-width
    mask_fits: str = ""                  # HEALPix mask FITS file (RING or
                                         # NESTED), ud_graded to the run's
                                         # nside — the reference's real-mask
                                         # pipeline (config.py:22-28,126-128);
                                         # healpix grid only
    bins: Optional[np.ndarray] = None    # default: unit bins from l=2
    blocks_size: int = 8                 # MH block width in bins
    n_iter_mh: int = 1
    l_cut: int = 0                       # PNCP split
    n_iter: int = 1000
    nchains: int = 4
    segment: int = 500                   # iterations per checkpoint segment
    seed: int = 0
    dtype: str = "float32"
    all_sph: bool = False
    cut: bool = True                     # cut-sky complement decomposition
                                         # on masked quadrature grids
    time_steps: bool = False             # fenced per-phase (CR / C_ell) step
                                         # timings once per segment, stored
                                         # with the chain (the reference's
                                         # per-step duration histories,
                                         # GibbsSampler.py:151-168)
    proposal_from: str = ""              # path to a previous run's results
                                         # npz: pool its chains into MH
                                         # proposal sigmas (the reference's
                                         # two-phase preliminary-run workflow,
                                         # config.py:136-225)
    out: str = "run_results.npz"

    def bins_list(self):
        bins = (self.bins if self.bins is not None
                else np.arange(2, self.lmax + 2))
        nf = 2 if self.spin == 2 else 1
        return [np.asarray(bins)] * nf


def _build(cfg: RunConfig):
    dtype = jnp.dtype(cfg.dtype)
    if cfg.spin == 0:
        fields = example_dl(cfg.lmax, amp=1000.0)[None]
    elif cfg.spin == 3:
        fields = np.stack([example_dl(cfg.lmax, "tt", amp=1000.0),
                           example_dl(cfg.lmax, "ee", amp=1000.0),
                           example_dl(cfg.lmax, "bb", amp=1000.0)])
    else:
        fields = np.stack([example_dl(cfg.lmax, "ee", amp=1000.0),
                           example_dl(cfg.lmax, "bb", amp=1000.0)])
    dl_blocks = None
    if cfg.r_te != 0.0:
        if cfg.spin != 3:
            raise ValueError("r_te requires spin=3 (joint TQU data)")
        dl_blocks = np.zeros((cfg.lmax + 1, 3, 3))
        for f in range(3):
            dl_blocks[:, f, f] = fields[f]
        te = cfg.r_te * np.sqrt(fields[0] * fields[1])
        dl_blocks[:, 0, 1] = dl_blocks[:, 1, 0] = te
    if cfg.grid == "healpix":
        from ..sht.healpix import make_healpix_sht
        from ..sht.healpix_pix import galactic_band_mask, ud_grade
        nside = cfg.nside or max(cfg.lmax // 2, 1)
        sht = make_healpix_sht(nside, cfg.lmax, dtype=dtype,
                               spin2=(cfg.spin >= 2))
        if cfg.mask_fits:
            # the reference's real-mask pipeline: read the HEALPix FITS
            # mask and ud_grade it to the analysis nside
            # (config.py:22-28,126-128); fractional boundary values scale
            # N^-1 exactly like the reference's N^-1 * mask
            from .fits_io import read_healpix_map
            mask_in, _ = read_healpix_map(cfg.mask_fits)
            mask = ud_grade(mask_in, nside)
        else:
            mask = (galactic_band_mask(nside, cfg.mask_band_deg)
                    if cfg.mask_band_deg > 0 else None)
        model, truth = simulate_dataset(
            jax.random.PRNGKey(cfg.seed), cfg.lmax, spin=cfg.spin,
            dl_fields=fields, noise_sigma2=cfg.noise_sigma2,
            fwhm_radians=np.radians(cfg.fwhm_deg), mask=mask, dtype=dtype,
            sht=sht, dl_blocks=dl_blocks)
        if cfg.cut and mask is not None:
            # belt-row cut decomposition (omega-level full-sphere algebra,
            # the reference's own HEALPix approximation; ops.model).  Real
            # masks can have zeros off the equatorial belt (point-source
            # holes, cap cuts): those fall back to the full-transform paths.
            from ..ops import with_cut_decomposition
            try:
                model = with_cut_decomposition(model)
            except ValueError:
                pass
    else:
        if cfg.mask_fits:
            raise ValueError("mask_fits requires grid='healpix' (HEALPix "
                             "pixel masks); use mask_band_deg on the GL grid")
        mask = None
        if cfg.mask_band_deg > 0:
            from ..sht import gauss_legendre_grid
            grid = gauss_legendre_grid(cfg.lmax)
            lat = np.abs(np.pi / 2 - grid.theta)
            keep = (lat > np.radians(cfg.mask_band_deg)).astype(np.float64)
            mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
        model, truth = simulate_dataset(
            jax.random.PRNGKey(cfg.seed), cfg.lmax, spin=cfg.spin,
            dl_fields=fields, noise_sigma2=cfg.noise_sigma2,
            fwhm_radians=np.radians(cfg.fwhm_deg), mask=mask, dtype=dtype,
            dl_blocks=dl_blocks)
        if cfg.cut and mask is not None:
            from ..ops import with_cut_decomposition
            model = with_cut_decomposition(model)

    bins_list = cfg.bins_list()
    nb = len(bins_list[0]) - 1
    blocks = [(i, min(i + cfg.blocks_size, nb))
              for i in range(0, nb, cfg.blocks_size)]
    counts = np.asarray(bin_sum(jnp.ones(cfg.lmax + 1), bins_list[0],
                                cfg.lmax))
    dl0 = tuple(np.asarray(bin_sum(jnp.asarray(f), b, cfg.lmax)) / counts
                for f, b in zip(fields, bins_list))
    # analytic noise-dominated proposal seed (the reference's heuristic,
    # config.py:119-134), with the observed f_sky correction
    from ..parallel.adapt import analytic_proposal_sigma
    f_sky = np.asarray(model.noise.f_sky)
    sig = [analytic_proposal_sigma(model.bl, cfg.noise_sigma2,
                                   model.noise.omega, cfg.lmax, b,
                                   f_sky=float(f_sky[min(f, len(f_sky) - 1)]))
           for f, b in enumerate(bins_list)]
    if cfg.proposal_from:
        # preliminary-run reload: pool a previous run's chains into the
        # proposal scales (reference: get_proposal_variances_preliminary,
        # config.py:136-225)
        from ..parallel.adapt import proposal_sigmas_from_results
        sig = proposal_sigmas_from_results(
            cfg.proposal_from, nfields=len(bins_list),
            # thread the MH block widths so wide joint blocks get the
            # 2.38/sqrt(d) scaling (without it a 394-bin block collapses
            # acceptance to ~0.02; PERF.md §6)
            blocks_list=[blocks] * len(bins_list))
        if len(sig) != len(bins_list) or any(
                len(s) != len(b) - 1 for s, b in zip(sig, bins_list)):
            raise ValueError(
                f"proposal_from={cfg.proposal_from!r} has incompatible "
                f"binning for this config")

    kw = dict(cr_method=cfg.cr_method, cr_options=dict(cfg.cr_options))
    d_alm = None
    if cfg.all_sph:
        if cfg.spin == 0:
            d_alm = model.sht.analysis_state(model.d[0])[None]
        else:
            e, b = model.sht.analysis_spin2_state(model.d[0], model.d[1])
            d_alm = jnp.stack([e, b])
    if cfg.scheme == "joint":
        if cfg.spin != 3:
            raise ValueError("scheme='joint' requires spin=3 (TQU)")
        from ..schemes import JointCenteredGibbs
        from ..harmonics.spectra import dl_to_cl_factor
        scheme = JointCenteredGibbs(
            model, cr_method=("cg" if cfg.cr_method == "cg" else "exact"),
            cr_options=dict(cfg.cr_options))
        # initial blocks: diagonal from the per-field theory D_ell
        fac = np.asarray(dl_to_cl_factor(cfg.lmax, jnp.float64))
        C0 = np.zeros((cfg.lmax + 1, 3, 3))
        for f in range(3):
            C0[:, f, f] = np.asarray(fields[f]) * fac
        return scheme, (C0,), truth
    if cfg.scheme == "centered":
        scheme = CenteredGibbs(model, bins_list, **kw)
    elif cfg.scheme == "noncentered":
        scheme = NonCenteredGibbs(model, bins_list, [blocks] * len(bins_list),
                                  sig, n_iter_mh=cfg.n_iter_mh,
                                  all_sph=cfg.all_sph, d_alm=d_alm, **kw)
    elif cfg.scheme == "asis":
        scheme = ASISGibbs(model, bins_list, [blocks] * len(bins_list), sig,
                           n_iter_mh=cfg.n_iter_mh, all_sph=cfg.all_sph,
                           d_alm=d_alm, **kw)
    elif cfg.scheme == "pncp":
        scheme = PNCPGibbs(model, bins_list, [blocks] * len(bins_list), sig,
                           l_cut=cfg.l_cut, n_iter_mh=cfg.n_iter_mh, **kw)
    else:
        raise ValueError(f"unknown scheme {cfg.scheme!r}")
    return scheme, dl0, truth


def save_checkpoint(path, key, state, chains, iters_done):
    """Resumable snapshot: PRNG key + sampler state + chain history so far
    (the rebuild of the missing mid-run checkpointing, SURVEY.md 5).
    Handles both scalar-spectrum states (GibbsState: s + per-field dl) and
    joint block states (JointState: s + (lmax+1, k, k) cl)."""
    flat = {"iters_done": iters_done, "key": np.asarray(key)}
    for f, c in enumerate(chains):
        flat[f"chain_{f}"] = np.asarray(c)
    flat["state_s"] = np.asarray(state.s)
    if hasattr(state, "cl"):
        flat["state_cl"] = np.asarray(state.cl)
    else:
        for f, d in enumerate(state.dl):
            flat[f"state_dl_{f}"] = np.asarray(d)
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, str(path))


def load_checkpoint(path):
    if not os.path.exists(str(path)):
        return None
    z = np.load(str(path))
    if "state_cl" in z.files:
        from ..schemes.joint_scheme import JointState
        state = JointState(s=jnp.asarray(z["state_s"]),
                           cl=jnp.asarray(z["state_cl"]))
        nf = len([k for k in z.files if k.startswith("chain_")])
    else:
        nf = len([k for k in z.files if k.startswith("state_dl_")])
        from ..schemes import GibbsState
        state = GibbsState(
            s=jnp.asarray(z["state_s"]),
            dl=tuple(jnp.asarray(z[f"state_dl_{f}"]) for f in range(nf)))
    chains = [z[f"chain_{f}"] for f in range(nf)]
    return dict(iters_done=int(z["iters_done"]), key=jnp.asarray(z["key"]),
                state=state, chains=chains)


def _joint_summary_chain(chain, lmin: int):
    """(nchains, n_iter, L, k, k) joint block chain -> (nchains, n_iter,
    nscalar) over the unique (l >= lmin, upper-triangle) entries, the
    scalar series the ESS/R-hat diagnostics run on."""
    c = np.asarray(chain, dtype=np.float64)
    k = c.shape[-1]
    iu, ju = np.triu_indices(k)
    flat = c[..., iu, ju][:, :, lmin:, :]     # (nc, ni, L-lmin, k(k+1)/2)
    return flat.reshape(c.shape[0], c.shape[1], -1)


def run_experiment(cfg: RunConfig, resume: bool = True, verbose=print):
    """Segmented run with checkpoint/resume; returns the results dict and
    writes it to cfg.out.  Every scheme — including ``joint`` — goes
    through the same segmented loop: checkpoint/resume, acceptance
    histories, and optional per-phase step timings (the reference's
    result-dict contract, main_polarization.py:175-185)."""
    scheme, dl0, truth = _build(cfg)
    joint = cfg.scheme == "joint"
    ckpt_path = cfg.out + ".ckpt.npz"
    ck = load_checkpoint(ckpt_path) if resume else None

    key = jax.random.PRNGKey(cfg.seed + 1)
    if ck is None:
        iters_done = 0
        chains = None
        from ..schemes.gibbs import _init_scheme
        kinit, key = jax.random.split(key)
        init_keys = jax.random.split(kinit, cfg.nchains)
        if joint:
            scheme.check_cl_init(dl0[0])
            dl0j = jnp.asarray(dl0[0], dtype=scheme.model.sht.dtype)
        else:
            dl0j = tuple(jnp.asarray(d, dtype=scheme.model.sht.dtype)
                         for d in dl0)
        states = _init_scheme(scheme, init_keys, dl0j)
    else:
        iters_done = ck["iters_done"]
        chains = ck["chains"]
        states = ck["state"]
        key = ck["key"]
        verbose(f"resumed at iteration {iters_done}")

    durations = []
    accepts = []
    cr_hist = []          # per-iteration CR acceptance (nchains, n_iter)
    mh_hist = None        # per-field per-block MH acceptance histories
    phase_times = []      # per-segment fenced (cr, cls, full) step seconds
    while iters_done < cfg.n_iter:
        seg = min(cfg.segment, cfg.n_iter - iters_done)
        key, krun = jax.random.split(key)
        t0 = time.time()
        states, out = _run_segment(scheme, states, krun, seg, cfg.nchains)
        jax.block_until_ready(out["dl"])
        dt = time.time() - t0
        durations.append(dt)
        seg_chains = [np.moveaxis(np.asarray(out["dl"][f]), 0, 1)
                      for f in range(len(dl0))]
        if "cr_accept" in out:
            accepts.append(np.asarray(out["cr_accept"]).mean())
            cr_hist.append(np.moveaxis(np.asarray(out["cr_accept"]), 0, 1))
        if "mh_accept" in out:
            # per field: (n_iter, nchains, nblocks) -> (nchains, n_iter, nb)
            seg_mh = [np.moveaxis(np.asarray(out["mh_accept"][f]), 0, 1)
                      for f in range(len(out["mh_accept"]))]
            mh_hist = (seg_mh if mh_hist is None else
                       [np.concatenate([m, s], axis=1)
                        for m, s in zip(mh_hist, seg_mh)])
        chains = (seg_chains if chains is None else
                  [np.concatenate([c, s], axis=1)
                   for c, s in zip(chains, seg_chains)])
        iters_done += seg
        if cfg.time_steps:
            from ..diagnostics import step_phase_times
            key, kt = jax.random.split(key)
            pt = step_phase_times(scheme, states, kt)
            phase_times.append((pt["cr"], pt["cls"], pt["full"]))
        save_checkpoint(ckpt_path, key, jax.tree.map(lambda a: a, states),
                        chains, iters_done)
        verbose(f"segment done: {iters_done}/{cfg.n_iter} iters "
                f"({dt:.1f}s, {dt / seg * 1e3:.0f} ms/iter)")

    summaries = [summarize_chains(_joint_summary_chain(c, scheme.lmin)
                                  if joint else c) for c in chains]
    results = {
        "config": json.dumps({k: (v.tolist() if isinstance(v, np.ndarray)
                                  else v)
                              for k, v in dataclasses.asdict(cfg).items()}),
        "durations": np.asarray(durations),
        "cr_accepts": np.asarray(accepts),
    }
    # full acceptance histories, saved with the chain like the reference's
    # result dict (main_polarization.py:175-185)
    if cr_hist:
        results["cr_accept_chain"] = np.concatenate(cr_hist, axis=1)
    if phase_times:
        # per-segment fenced device seconds of the CR step / C_ell step /
        # full iteration (diagnostics.step_phase_times; the reference's
        # per-step timer histories, GibbsSampler.py:151-168)
        pt = np.asarray(phase_times)
        results["step_time_cr"] = pt[:, 0]
        results["step_time_cls"] = pt[:, 1]
        results["step_time_full"] = pt[:, 2]
    if mh_hist is not None:
        for f, m in enumerate(mh_hist):
            results[f"mh_accept_{f}"] = m
    for f, c in enumerate(chains):
        results[f"dl_chain_{f}"] = c
        results[f"ess_{f}"] = summaries[f]["ess"]
        results[f"rhat_{f}"] = summaries[f]["rhat"]
        results[f"mean_{f}"] = summaries[f]["mean"]
    np.savez(cfg.out, **results)
    try:
        os.remove(ckpt_path)
    except OSError:
        pass
    return results


def _run_segment(scheme, states, key, n_iter, nchains):
    from ..schemes.gibbs import _scan_scheme
    keys = jax.random.split(key, n_iter)
    return _scan_scheme(scheme, states, keys, nchains)
