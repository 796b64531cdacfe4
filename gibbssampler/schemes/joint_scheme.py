"""Joint correlated-field Gibbs scheme (TT/TE/EE[/BB]).

One iteration: exact joint CR draw of (T, E, B) given the C_ell blocks, then
a conjugate per-ell inverse-Wishart draw of the blocks given the fields —
the full-sky joint sampler the reference explored only in comments
(main-checkpoint.py:332-347) with its 3x3 Cython variance kernel
(variance_expension.pyx:36-61).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..samplers.joint import exact_joint_cr, cg_joint_cr, blocks_to_dl
from ..samplers.cls_samplers import invwishart_cls_sample
from ..utils.pytree import register_arrays_pytree
from .gibbs import _scan_scheme

__all__ = ["JointState", "JointCenteredGibbs"]


class JointState(NamedTuple):
    s: jnp.ndarray           # (k, nstate)
    cl: jnp.ndarray          # (lmax+1, k, k) C_ell blocks


class JointCenteredGibbs:
    """Centered Gibbs over per-ell covariance blocks of k correlated fields.

    cr_method: "exact" (full-sky diagonal-in-slot solve) or "cg" (masked-sky
    block-preconditioned CG — the joint generalization of the reference's
    qcinv path, CenteredGibbs.py:448-491)."""

    def __init__(self, model, lmin: int = 2, cr_method: str = "exact",
                 cr_options: dict = ()):
        self.model = model
        self.lmin = lmin
        self.lmax = model.lmax
        if cr_method not in ("exact", "cg"):
            raise ValueError(f"joint cr_method must be exact|cg, got "
                             f"{cr_method!r}")
        self.cr_method = cr_method
        self.cr_options = tuple(sorted(dict(cr_options).items())) \
            if isinstance(cr_options, dict) else tuple(cr_options)
        from .gibbs import _BT_JIT
        self.bt_ninv_d = _BT_JIT(model)

    def _cr(self, key, cl):
        if self.cr_method == "cg":
            opts = dict(self.cr_options)
            return cg_joint_cr(key, self.model, cl, self.bt_ninv_d,
                               tol=opts.get("cg_tol", 1e-6),
                               maxiter=opts.get("cg_maxiter", 4000))
        return exact_joint_cr(key, self.model, cl, self.bt_ninv_d)

    def init_state(self, key, cl_init) -> JointState:
        cl0 = jnp.asarray(cl_init, dtype=self.model.sht.dtype)
        s, _ = self._cr(key, cl0)
        return JointState(s=s, cl=cl0)

    def step(self, key, state: JointState):
        k1, k2 = jax.random.split(key)
        s, cr_info = self._cr(k1, state.cl)
        cl = invwishart_cls_sample(k2, s, self.lmax, lmin=self.lmin)
        info = {"dl": (blocks_to_dl(cl, self.lmax),),
                "cr_accept": cr_info.accept}
        return JointState(s=s, cl=cl), info

    def check_cl_init(self, cl_init):
        """Validate the (host-side) initial spectrum: non-SPD blocks make
        the per-slot Cholesky silently NaN."""
        ev = np.linalg.eigvalsh(np.asarray(cl_init)[self.lmin:])
        if not (ev >= -1e-12 * max(1.0, float(np.abs(ev).max()))).all():
            raise ValueError(
                "cl_init has non-positive-semidefinite blocks (e.g. |TE| > "
                "sqrt(TT*EE)); min eigenvalue "
                f"{float(ev.min()):.3e} at l>={self.lmin}")

    def run(self, key, cl_init, n_iter: int, nchains: int = 1):
        self.check_cl_init(cl_init)
        from .gibbs import _init_scheme
        kinit, krun = jax.random.split(key)
        init_keys = jax.random.split(kinit, nchains)
        states = _init_scheme(self, init_keys,
                              jnp.asarray(cl_init,
                                          dtype=self.model.sht.dtype))
        keys = jax.random.split(krun, n_iter)
        states, infos = _scan_scheme(self, states, keys, nchains)
        out = {"dl_chains": (jnp.moveaxis(infos["dl"][0], 0, 1),),
               "cr_accept": jnp.moveaxis(infos["cr_accept"], 0, 1),
               "final_state": states}
        return out


register_arrays_pytree(JointCenteredGibbs,
                       array_fields=("model", "bt_ninv_d"),
                       static_fields=("lmin", "lmax", "cr_method",
                                      "cr_options"))
