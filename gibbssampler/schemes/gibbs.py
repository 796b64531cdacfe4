"""Full Gibbs sampling schemes: centered, non-centered, ASIS, PNCP.

Compiled drivers replacing the reference's python loops (GibbsSampler.py:
76-180, NonCenteredGibbs.py:449-582, ASIS.py:16-232, PNCP — historical,
SURVEY.md 2.4/2.6.7): each scheme's iteration is a pure ``step`` function,
the outer MCMC loop is a ``lax.scan``, and independent chains are ``vmap``ed
so every SHT becomes a batched matmul.  The chain axis can additionally be
sharded over a device mesh (gibbssampler.parallel).

CR algorithm selection is an explicit enum-like string, replacing the
reference's boolean-flag dispatch tangle (CenteredGibbs.py:828-850).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..harmonics.gridstate import (expand_cl_state,
                                   variance_expansion_state)
from ..harmonics.spectra import unfold_bins
from ..ops.model import SkyModel
from ..samplers import cr as cr_mod
from ..samplers import cls_samplers as cls_mod
from ..utils.pytree import register_arrays_pytree


def _freeze_bins(bins_list):
    return tuple(tuple(int(b) for b in bins) for bins in bins_list)


def _freeze_blocks(blocks_list):
    return tuple(tuple((int(lo), int(hi)) for lo, hi in blocks)
                 for blocks in blocks_list)

__all__ = ["GibbsState", "GibbsScheme", "CenteredGibbs", "NonCenteredGibbs",
           "ASISGibbs", "PNCPGibbs", "CR_METHODS"]


class GibbsState(NamedTuple):
    s: jnp.ndarray        # (nfields, nstate) — centered or non-centered map
    dl: tuple             # per-field (nbins_f,) binned D_ell


CR_METHODS = ("exact", "cg", "rjpo", "aux_gibbs", "overrelax", "mala", "ula",
              "aux_mala", "pcn")


def _cut_mh_eligible(model, blocks_list, all_sph: bool) -> bool:
    """True when the rank-one blocked-MH fast path applies: cut model,
    pixel-domain likelihood, at least one single-bin block, and every
    multi-bin block preceding the single-bin ones (the reference's
    production layout, config.py:44-55)."""
    if not getattr(model, "has_cut", False) or all_sph:
        return False
    kinds = [hi - lo == 1 for blocks in blocks_list for (lo, hi) in blocks]
    if not any(kinds):
        return False
    first_single = kinds.index(True)
    return all(kinds[first_single:])


def _nc_cls_step(scheme, key, dl, s_nc):
    """Dispatch the blocked-MH C_ell step to the rank-one fast path when
    eligible (set up in _rebind), else the direct evaluation."""
    if scheme._use_cut_mh:
        # mh_fast="phi" pins the phi-domain rank-one path; "auto" lets the
        # sampler pick the m-domain sweep when the cut weights allow it
        return cls_mod.nc_cls_sample_cut(
            key, dl, s_nc, scheme.model, scheme.bins_list,
            scheme.blocks_list, scheme.prop_sigma_list,
            n_iter=scheme.n_iter_mh,
            mdomain=(getattr(scheme, "mh_fast", "auto") != "phi"))
    return cls_mod.nc_cls_sample(
        key, dl, s_nc, scheme.log_like, scheme.bins_list,
        scheme.blocks_list, scheme.prop_sigma_list, n_iter=scheme.n_iter_mh)

_BT_JIT = jax.jit(lambda m: m.bt_ninv_d())


def _make_cr_step(method: str, model: SkyModel, bt_ninv_d, opts: dict):
    """Bind a CR method name to a (key, s, var_cls, noise=None) -> (s, info)
    function.  ``noise`` is one chain's slice of the pre-drawn noise pool
    (draw_noise_pool) — absent, the sampler draws per-key."""
    if method == "exact":
        return lambda key, s, var, noise=None: cr_mod.exact_cr(
            key, model, var, bt_ninv_d, noise=noise)
    if method == "cg":
        return lambda key, s, var, noise=None: cr_mod.cg_cr(
            key, model, var, bt_ninv_d,
            tol=opts.get("cg_tol", 1e-6), maxiter=opts.get("cg_maxiter", 4000),
            noise=noise)
    if method == "rjpo":
        return lambda key, s, var, noise=None: cr_mod.rjpo_cr(
            key, model, var, bt_ninv_d, s,
            tol=opts.get("cg_tol", 1e-5), maxiter=opts.get("cg_maxiter", 4000),
            noise=noise)
    if method == "aux_gibbs":
        return lambda key, s, var, noise=None: cr_mod.aux_gibbs_cr(
            key, model, var, bt_ninv_d, s, n_gibbs=opts.get("n_gibbs", 1),
            noise=noise)
    if method == "overrelax":
        return lambda key, s, var, noise=None: cr_mod.overrelax_cr(
            key, model, var, bt_ninv_d, s, alpha=opts.get("alpha", -0.995),
            n_gibbs=opts.get("n_gibbs", 1), noise=noise)
    if method == "mala":
        return lambda key, s, var, noise=None: cr_mod.mala_cr(
            key, model, var, bt_ninv_d, s, tau=opts.get("tau", 0.02),
            accept=True, noise=noise)
    if method == "ula":
        return lambda key, s, var, noise=None: cr_mod.mala_cr(
            key, model, var, bt_ninv_d, s, tau=opts.get("tau", 0.02),
            accept=opts.get("ula_mh_correct", True), noise=noise)
    if method == "aux_mala":
        return lambda key, s, var, noise=None: cr_mod.aux_then_mala_cr(
            key, model, var, bt_ninv_d, s, n_gibbs=opts.get("n_gibbs", 1),
            tau=opts.get("tau", 0.02), noise=noise)
    if method == "pcn":
        return lambda key, s, var, noise=None: cr_mod.pcn_cr(
            key, model, var, bt_ninv_d, s, beta=opts.get("beta", 0.1),
            noise=noise)
    raise ValueError(f"unknown CR method {method!r}; one of {CR_METHODS}")


@dataclass
class GibbsScheme:
    """Shared driver machinery (the reference's GibbsSampler base,
    GibbsSampler.py:8-192)."""

    model: SkyModel
    bins_list: Sequence[np.ndarray]
    cr_method: str = "exact"
    cr_options: dict = field(default_factory=dict)

    def __post_init__(self):
        # normalize static config to hashable forms (pytree aux data)
        self.bins_list = _freeze_bins(self.bins_list)
        if isinstance(self.cr_options, dict):
            self.cr_options = tuple(sorted(self.cr_options.items()))
        self.lmax = self.model.lmax
        # one compiled unit; the model rides through jit as a pytree
        self.bt_ninv_d = _BT_JIT(self.model)
        self._rebind()

    def _rebind(self):
        """Rebuild derived closures (called after pytree unflatten)."""
        self._cr_step = _make_cr_step(self.cr_method, self.model,
                                      self.bt_ninv_d, dict(self.cr_options))

    # -- helpers ---------------------------------------------------------

    def var_cls(self, dl_tuple):
        """(nfields, nstate) prior variance from per-field binned D_ell."""
        dt = self.model.sht.dtype
        vars_ = [variance_expansion_state(
            unfold_bins(dl.astype(dt), bins, self.lmax), self.lmax)
            for dl, bins in zip(dl_tuple, self.bins_list)]
        return jnp.stack(vars_, axis=0)

    def init_state(self, key, dl_init_tuple) -> GibbsState:
        """Initial CR draw at the starting spectrum (the reference always
        performs an initial CR draw, GibbsSampler.py:136-138)."""
        dl0 = tuple(jnp.asarray(d, dtype=self.model.sht.dtype)
                    for d in dl_init_tuple)
        s, _ = self._cr_step(key, jnp.zeros(
            (self.model.nfields, self.model.nstate),
            dtype=self.model.sht.dtype), self.var_cls(dl0))
        return GibbsState(s=s, dl=dl0)

    def step(self, key, state: GibbsState, noise=None):
        raise NotImplementedError

    def draw_noise_pool(self, key, nchains: int):
        """Pre-draw the CR step's Gaussian fields for ALL chains from one
        key: {kind: (nchains, K, *shape)}.  A single-key batched draw fuses
        into its consumer, which per-chain-key draws inside the vmap do not
        (samplers.cr noise-pool notes).  The scan body draws this each
        iteration and vmaps the per-chain slices into ``step``."""
        try:
            spec = cr_mod.noise_pool_spec(self.cr_method,
                                          dict(self.cr_options))
        except KeyError:
            return {}
        m = self.model
        dt = m.sht.dtype
        aux_shape = (tuple(m.w_cut.shape) if m.has_cut
                     else tuple(m.noise.tau.shape))
        shapes = {"state": (m.nfields, m.nstate),
                  "aux": aux_shape,
                  "pix": tuple(m.noise.tau.shape)}
        if getattr(m, "has_sparse", False):
            # sparse-split models: the auxiliary field's hole-point block
            shapes["sp"] = tuple(m.w_sp.shape)
        else:
            spec = {k: v for k, v in spec.items() if k != "sp"}
        # memory guard: the pool is nchains * K * field-size; many-sweep CR
        # configurations (e.g. overrelax n_gibbs=20 -> K=40 state fields)
        # at 128 chains would pre-draw tens of GB.  Past the cap, fall
        # back to per-key draws inside the sampler (slower dispatch, no
        # blow-up).  The 4 GB cap was sized for a 16 GB device; the right
        # cap for the GPU's 80 GB is not measured.
        import os as _os
        cap = float(_os.environ.get("GS_NOISE_POOL_MAX_GB", "4")) * 2 ** 30
        kinds = ("state", "aux", "pix", "sp")
        total = sum(int(spec.get(kind, 0)) * int(np.prod(shapes[kind]))
                    for kind in kinds if kind in shapes) \
            * nchains * jnp.dtype(dt).itemsize
        if total > cap:
            return {}
        pool = {}
        keys = jax.random.split(key, len(kinds))
        for i, kind in enumerate(kinds):
            k = int(spec.get(kind, 0)) if kind in shapes else 0
            if k:
                pool[kind] = jax.random.normal(
                    keys[i], (nchains, k) + shapes[kind], dtype=dt)
        return pool

    # -- outer loop ------------------------------------------------------

    def run(self, key, dl_init_tuple, n_iter: int, nchains: int = 1):
        """Run ``nchains`` vmapped chains for ``n_iter`` iterations.

        Returns dict with per-field D_ell chains (nchains, n_iter/thin,
        nbins_f) and per-step diagnostics (the reference saves the same
        histories, main_polarization.py:175-185)."""
        kinit, krun = jax.random.split(key)
        init_keys = jax.random.split(kinit, nchains)
        dl0 = tuple(jnp.asarray(d, dtype=self.model.sht.dtype)
                    for d in dl_init_tuple)
        states = _init_scheme(self, init_keys, dl0)
        keys = jax.random.split(krun, n_iter)
        # the scheme itself is a pytree argument: operator tables enter the
        # compiled program as runtime parameters, not baked constants
        states, infos = _scan_scheme(self, states, keys, nchains)
        out = {"dl_chains": tuple(
            jnp.moveaxis(infos["dl"][f], 0, 1) for f in range(len(self.bins_list)))}
        for k, v in infos.items():
            if k == "dl":
                continue
            out[k] = jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), v)
        out["final_state"] = states
        return out


@jax.jit
def _init_scheme(scheme, keys, dl_init_tuple):
    """Vmapped chain initialization as ONE compiled unit (a bare vmap would
    dispatch eagerly, primitive by primitive)."""
    return jax.vmap(lambda k: scheme.init_state(k, dl_init_tuple))(keys)


@jax.jit
def _scan_scheme_jit(scheme, states, keys):
    nchains = jax.tree.leaves(states)[0].shape[0]

    def one_iter(states, key):
        kn, kc = jax.random.split(key)
        pool = (scheme.draw_noise_pool(kn, nchains)
                if hasattr(scheme, "draw_noise_pool") else {})
        ks = jax.random.split(kc, nchains)
        if pool:
            return jax.vmap(scheme.step)(ks, states, pool)
        return jax.vmap(scheme.step)(ks, states)

    return jax.lax.scan(one_iter, states, keys)


def _scan_scheme(scheme, states, keys, nchains=None):
    # nchains retained for call-site compatibility; inferred from states
    return _scan_scheme_jit(scheme, states, keys)


# ---------------------------------------------------------------------------

class CenteredGibbs(GibbsScheme):
    """CR step + conjugate inverse-gamma C_ell step (reference:
    CenteredGibbs.py:859-876)."""

    def step(self, key, state: GibbsState, noise=None):
        k1, k2 = jax.random.split(key)
        s, cr_info = self._cr_step(k1, state.s, self.var_cls(state.dl),
                                   noise)
        dl = cls_mod.centered_cls_sample(k2, s, self.bins_list, self.lmax)
        info = {"dl": dl, "cr_accept": cr_info.accept}
        return GibbsState(s=s, dl=dl), info


class NonCenteredGibbs(GibbsScheme):
    """CR step re-expressed non-centered (whitened) + blocked MH C_ell step
    (reference: NonCenteredGibbs.py:449-582).  State.s holds s_nc."""

    def __init__(self, model, bins_list, blocks_list, prop_sigma_list,
                 n_iter_mh: int = 1, all_sph: bool = False,
                 d_alm: Optional[jnp.ndarray] = None,
                 mh_fast: str = "auto", **kw):
        super().__init__(model, bins_list, **kw)
        self.blocks_list = _freeze_blocks(blocks_list)
        self.prop_sigma_list = tuple(jnp.asarray(p) for p in prop_sigma_list)
        self.n_iter_mh = n_iter_mh
        self.all_sph = all_sph
        self.d_alm = d_alm
        self.mh_fast = mh_fast      # "auto" | "phi" | "off" (static):
                                    # auto = rank-one fast path (m-domain
                                    # sweep when eligible); phi = force the
                                    # phi-domain fast path; off = direct
        self._rebind()

    def _rebind(self):
        super()._rebind()
        if not hasattr(self, "all_sph"):
            return  # first call from dataclass __post_init__, before
                    # subclass fields exist; __init__ rebinds again
        self.log_like = cls_mod.make_nc_log_likelihood(
            self.model, self.bins_list, all_sph=self.all_sph,
            d_alm=self.d_alm)
        self._use_cut_mh = (self.mh_fast != "off"
                            and _cut_mh_eligible(self.model, self.blocks_list,
                                                 self.all_sph))

    def init_state(self, key, dl_init_tuple):
        st = super().init_state(key, dl_init_tuple)
        s_nc = cls_mod.whiten(st.s, st.dl, self.bins_list, self.lmax)
        return GibbsState(s=s_nc, dl=st.dl)

    def step(self, key, state: GibbsState, noise=None):
        k1, k2 = jax.random.split(key)
        # centered CR draw at current spectrum, then whiten
        s, cr_info = self._cr_step(
            k1, cls_mod.recenter(state.s, state.dl, self.bins_list, self.lmax),
            self.var_cls(state.dl), noise)
        s_nc = cls_mod.whiten(s, state.dl, self.bins_list, self.lmax)
        dl, mh_info = _nc_cls_step(self, k2, state.dl, s_nc)
        info = {"dl": dl, "cr_accept": cr_info.accept,
                "mh_accept": mh_info.accept}
        return GibbsState(s=s_nc, dl=dl), info


class ASISGibbs(GibbsScheme):
    """Ancillarity–Sufficiency Interweaving: centered CR -> centered
    inverse-gamma draw -> whiten -> non-centered MH draw -> recenter
    (reference: ASIS.py:69-131 TT, :134-226 pol)."""

    def __init__(self, model, bins_list, blocks_list, prop_sigma_list,
                 n_iter_mh: int = 1, all_sph: bool = False,
                 d_alm: Optional[jnp.ndarray] = None,
                 mh_fast: str = "auto", **kw):
        super().__init__(model, bins_list, **kw)
        self.blocks_list = _freeze_blocks(blocks_list)
        self.prop_sigma_list = tuple(jnp.asarray(p) for p in prop_sigma_list)
        self.n_iter_mh = n_iter_mh
        self.all_sph = all_sph
        self.d_alm = d_alm
        self.mh_fast = mh_fast      # "auto" | "phi" | "off" (static):
                                    # auto = rank-one fast path (m-domain
                                    # sweep when eligible); phi = force the
                                    # phi-domain fast path; off = direct
        self._rebind()

    def _rebind(self):
        super()._rebind()
        if not hasattr(self, "all_sph"):
            return  # first call from dataclass __post_init__, before
                    # subclass fields exist; __init__ rebinds again
        self.log_like = cls_mod.make_nc_log_likelihood(
            self.model, self.bins_list, all_sph=self.all_sph,
            d_alm=self.d_alm)
        self._use_cut_mh = (self.mh_fast != "off"
                            and _cut_mh_eligible(self.model, self.blocks_list,
                                                 self.all_sph))

    def step(self, key, state: GibbsState, noise=None):
        k1, k2, k3 = jax.random.split(key, 3)
        s, cr_info = self._cr_step(k1, state.s, self.var_cls(state.dl),
                                   noise)
        dl_c = cls_mod.centered_cls_sample(k2, s, self.bins_list, self.lmax)
        s_nc = cls_mod.whiten(s, dl_c, self.bins_list, self.lmax)
        dl, mh_info = _nc_cls_step(self, k3, dl_c, s_nc)
        s = cls_mod.recenter(s_nc, dl, self.bins_list, self.lmax)
        info = {"dl": dl, "cr_accept": cr_info.accept,
                "mh_accept": mh_info.accept}
        return GibbsState(s=s, dl=dl), info


class PNCPGibbs(GibbsScheme):
    """Partially non-centered parametrization: multipoles below l_cut sampled
    centered (conjugate inverse-gamma), above l_cut non-centered (blocked MH)
    — rebuilt from the intent of the reference's deleted PNCP.py
    (bytecode __pycache__/PNCP.cpython-38.pyc; SURVEY.md 2.4: sample_low_l /
    sample_high_l split, l_cut must not fall inside a block).

    ``l_cut`` may be a single int or one per field: the signal/noise
    crossover that makes non-centered moves pay is field-dependent
    (measured per-bin ESS, PERF.md §6: EE is signal-dominated
    to the highest multipoles — centered wins everywhere — while BB
    crosses at ell ~ 300).  A field whose l_cut equals its last bin edge
    is sampled fully centered (its MH block list must then be empty)."""

    def __init__(self, model, bins_list, blocks_list, prop_sigma_list,
                 l_cut, n_iter_mh: int = 1, all_sph: bool = False,
                 d_alm: Optional[jnp.ndarray] = None, mh_fast: str = "auto",
                 **kw):
        super().__init__(model, bins_list, **kw)
        bins_list = self.bins_list
        lcs = (tuple(int(c) for c in l_cut)
               if isinstance(l_cut, (tuple, list, np.ndarray))
               else (int(l_cut),) * len(bins_list))
        if len(lcs) != len(bins_list):
            raise ValueError(f"l_cut={l_cut}: need one value or one per "
                             f"field ({len(bins_list)})")
        self.l_cut = lcs
        # split bins into low (centered) and high (MH) parts; l_cut must be
        # a bin boundary (the reference raises when l_cut is inside a block)
        cut_bin = []
        for bins, lc in zip(bins_list, lcs):
            if lc not in list(bins):
                raise ValueError(
                    f"l_cut={lc} must be a bin boundary (got bins={bins})")
            cut_bin.append(int(np.searchsorted(bins, lc)))
        self.cut_bin = tuple(cut_bin)
        # keep only high-l blocks, re-indexed over the full bin vector
        self.blocks_list = _freeze_blocks([
            [(lo, hi) for (lo, hi) in blocks
             if lo >= cb] for blocks, cb in zip(blocks_list, self.cut_bin)])
        self.prop_sigma_list = tuple(jnp.asarray(p) for p in prop_sigma_list)
        self.n_iter_mh = n_iter_mh
        self.all_sph = all_sph
        self.mh_fast = mh_fast
        self._rebind()

    def _rebind(self):
        super()._rebind()
        if not hasattr(self, "all_sph") or not hasattr(self, "mh_fast"):
            return  # dataclass __post_init__ call; __init__ rebinds again
        self._use_cut_mh = (self.mh_fast != "off"
                            and _cut_mh_eligible(self.model, self.blocks_list,
                                                 self.all_sph))

    def _var_high(self, dl_tuple, dtype):
        """Prior variance with 1 on valid l < l_cut slots (identity
        re-centering; invalid layout slots keep variance 0).  Per-field
        l_cut: one low-ell mask row per field."""
        var = self.var_cls(dl_tuple).astype(dtype)
        low = jnp.stack([
            expand_cl_state(
                (jnp.arange(self.lmax + 1) < lc).astype(dtype),
                self.lmax) > 0
            for lc in self.l_cut])
        return jnp.where(low, 1.0, var)

    def step(self, key, state: GibbsState, noise=None):
        k1, k2, k3 = jax.random.split(key, 3)
        s, cr_info = self._cr_step(k1, state.s, self.var_cls(state.dl),
                                   noise)
        # low-l: centered conjugate draw
        dl_c = cls_mod.centered_cls_sample(k2, s, self.bins_list, self.lmax)
        dl = tuple(
            jnp.where(jnp.arange(len(dl_c[f])) < self.cut_bin[f],
                      dl_c[f], state.dl[f])
            for f in range(len(dl_c)))
        # high-l: whiten only the high multipoles, blocked MH, recenter
        dt = s.dtype
        var_h = self._var_high(dl, dt)
        inv_sqrt = jnp.where(var_h > 0, 1.0 / jnp.sqrt(
            jnp.where(var_h > 0, var_h, 1.0)), 0.0)
        s_pnc = s * inv_sqrt

        if self._use_cut_mh:
            # rank-one fast path with identity re-centering below l_cut
            # (u_base support is disjoint from every high-l block)
            dl, mh_info = cls_mod.nc_cls_sample_cut(
                k3, dl, s_pnc, self.model, self.bins_list,
                self.blocks_list, self.prop_sigma_list,
                n_iter=self.n_iter_mh,
                mdomain=(getattr(self, "mh_fast", "auto") != "phi"),
                l_cut_identity=self.l_cut)
        else:
            def pncp_like(dl_tuple, s_pnc_):
                var = self._var_high(dl_tuple, dt)
                s_full = jnp.sqrt(var) * s_pnc_
                if self.model.has_cut:
                    return self.model.data_loglike_cut(
                        self.model.beam(s_full))
                resid = self.model.d - self.model.forward(s_full)
                return -0.5 * jnp.sum(self.model.noise.inv_noise
                                      * resid * resid)

            dl, mh_info = cls_mod.nc_cls_sample(
                k3, dl, s_pnc, pncp_like, self.bins_list,
                self.blocks_list, self.prop_sigma_list,
                n_iter=self.n_iter_mh)
        s = jnp.sqrt(self._var_high(dl, dt)) * s_pnc
        info = {"dl": dl, "cr_accept": cr_info.accept,
                "mh_accept": mh_info.accept}
        return GibbsState(s=s, dl=dl), info


for _cls, _extra_arrays, _extra_static in (
    (CenteredGibbs, (), ()),
    (NonCenteredGibbs, ("prop_sigma_list", "d_alm"),
     ("blocks_list", "n_iter_mh", "all_sph", "mh_fast")),
    (ASISGibbs, ("prop_sigma_list", "d_alm"),
     ("blocks_list", "n_iter_mh", "all_sph", "mh_fast")),
    (PNCPGibbs, ("prop_sigma_list",),
     ("blocks_list", "n_iter_mh", "all_sph", "l_cut", "cut_bin",
      "mh_fast")),
):
    register_arrays_pytree(
        _cls,
        array_fields=("model", "bt_ninv_d") + _extra_arrays,
        static_fields=("bins_list", "cr_method", "cr_options",
                       "lmax") + _extra_static,
    )
