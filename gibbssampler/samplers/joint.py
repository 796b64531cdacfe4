"""Joint correlated-field sampling: per-ell k x k covariance blocks.

The reference prepared but never wired joint TT/TE/EE sampling: the 3x3
Cython variance-expansion kernel (variance_expension.pyx:36-61), the
invwishart import (CenteredGibbs.py:7), and an exact-conditional exploration
in comments (main-checkpoint.py:332-347).  Here it is first-class:

- ``exact_joint_cr``: full-sky exact draw of k correlated fields per slot,
  posterior precision P_i = C_ell(i)^-1 + diag_f(g_f b_l^2), via batched
  k x k Cholesky factorizations (vmapped over the (lmax+1)^2 slots)
- ``invwishart_cls_sample`` (cls_samplers): conjugate per-ell inverse-Wishart
  draw of the C_ell blocks
- ``synfast_joint``: simulate correlated fields from C_ell blocks

Fields are ordered (T, E[, B]); T uses the spin-0 transform and (E, B) the
spin-2 transform of the same SHT (see ops.model.SkyModel spin="tqu").
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..harmonics.gridstate import ell_mask_state, nstate, state_masks
from ..ops.cg import cg_solve
from ..utils.precision import PRECISION
from .cr import CRInfo

__all__ = ["expand_cl_blocks", "exact_joint_cr", "cg_joint_cr",
           "synfast_joint", "blocks_to_dl", "joint_block_ops"]


def expand_cl_blocks(cl_blocks: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """(lmax+1, k, k) C_ell blocks -> (nstate, k, k) per-slot covariance
    (broadcast over the grid-packed layout; invalid slots get zero)."""
    L = lmax + 1
    k = cl_blocks.shape[-1]
    valid = jnp.asarray(state_masks(lmax).valid, dtype=cl_blocks.dtype)
    out = cl_blocks[None, None, :, :, :] * valid[..., None, None]
    return out.reshape(2 * L * L, k, k)


def blocks_to_dl(cl_blocks: jnp.ndarray, lmax: int) -> jnp.ndarray:
    """C_ell blocks -> D_ell blocks (l(l+1)/2pi scaling elementwise)."""
    ell = jnp.arange(lmax + 1, dtype=cl_blocks.dtype)
    fac = ell * (ell + 1.0) / (2.0 * jnp.pi)
    return cl_blocks * fac[:, None, None]


def _slot_chol_sample(key, P, b, active):
    """Draw x ~ N(P^-1 b, P^-1) per slot; P: (n, k, k), b: (n, k).

    Inactive slots (monopole/dipole) get x = 0."""
    n, k = b.shape
    eye = jnp.eye(k, dtype=P.dtype)
    P_safe = jnp.where(active[:, None, None] > 0, P, eye)
    L = jnp.linalg.cholesky(P_safe)
    # mean = P^-1 b  via two triangular solves
    y = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)
    mean = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False)[..., 0]
    # fluctuation = L^-T xi  (covariance P^-1)
    xi = jax.random.normal(key, (n, k, 1), dtype=P.dtype)
    fluc = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), xi, lower=False)[..., 0]
    return (mean + fluc) * active[:, None]


def exact_joint_cr(key, model, cl_blocks, bt_ninv_d):
    """Full-sky exact joint CR draw.

    model : SkyModel with spin="tqu" (k = 3) or spin=2 (k = 2, correlated E/B)
    cl_blocks : (lmax+1, k, k) prior C_ell covariance blocks (zero below l=2)
    bt_ninv_d : (k, nstate) data term B A^T N^-1 d

    Per real-packed slot i the posterior over the k-vector s_i is
    N(P^-1 b_i, P^-1) with P = C_ell(i)^-1 + diag_f(g_f b_l(i)^2)
    (the joint generalization of the reference's diagonal solve,
    CenteredGibbs.py:108-132 / main-checkpoint.py:332-347)."""
    lmax = model.lmax
    k = bt_ninv_d.shape[0]
    dt = bt_ninv_d.dtype
    cov = expand_cl_blocks(cl_blocks.astype(dt), lmax)        # (nstate, k, k)
    active = jnp.asarray(ell_mask_state(lmax, lmin=2), dtype=dt)
    eye = jnp.eye(k, dtype=dt)
    cov_safe = jnp.where(active[:, None, None] > 0, cov, eye)
    cinv = jnp.linalg.inv(cov_safe)
    hdiag = model.harmonic_noise_diag().astype(dt)            # (k, nflat)
    P = cinv + jax.vmap(jnp.diag, in_axes=1)(hdiag)
    x = _slot_chol_sample(key, P, bt_ninv_d.T, active)        # (nstate, k)
    s = x.T
    return s, CRInfo(accept=jnp.ones((), dt), extra=jnp.zeros((), dt))


def joint_block_ops(model, cl_blocks, fsky_scale: bool = True):
    """Per-slot k x k operator bundle for the masked joint CR solve.

    Returns (apply_cinv, apply_sqrt_cinv, apply_precond, active):
    C^-1, a root M with M M^T = C^-1 (for the fluctuation RHS), and the
    block-diagonal preconditioner (C^-1 + diag_f(f_sky g_f b_l^2))^-1 —
    the k x k generalization of cr.cr_precond / qcinv's diag_cl.  All
    applications are batched einsum matvecs over the nstate slots (the
    factorizations happen once per solve, not per CG iteration)."""
    lmax = model.lmax
    dt = cl_blocks.dtype
    k = cl_blocks.shape[-1]
    cov = expand_cl_blocks(cl_blocks, lmax)                  # (n, k, k)
    active = jnp.asarray(ell_mask_state(lmax, lmin=2), dtype=dt)
    eye = jnp.eye(k, dtype=dt)
    act3 = active[:, None, None] > 0
    cinv = jnp.linalg.inv(jnp.where(act3, cov, eye))
    cinv = jnp.where(act3, cinv, 0.0)
    M = jnp.linalg.cholesky(jnp.where(act3, cinv, eye))
    M = jnp.where(act3, M, 0.0)
    hdiag = model.harmonic_noise_diag().astype(dt)           # (k, n)
    if fsky_scale:
        hdiag = hdiag * model.noise.f_sky[:, None].astype(dt)
    P = cinv + hdiag.T[..., None] * eye                      # (n, k, k)
    pinv = jnp.linalg.inv(jnp.where(act3, P, eye))
    pinv = jnp.where(act3, pinv, 0.0)

    def mv(blocks):
        def apply_(x):                                       # x: (k, n)
            return jnp.einsum("nij,jn->in", blocks, x, precision=PRECISION)
        return apply_

    return mv(cinv), mv(M), mv(pinv), active


def cg_joint_cr(key, model, cl_blocks, bt_ninv_d, tol=1e-6, maxiter=4000):
    """Masked-sky joint CR draw via block-preconditioned CG:
    Q s = C^-1 s + B A^T N^-1 A B s with per-slot k x k C — the joint
    generalization of the reference's masked PCG step
    (CenteredGibbs.py:448-491), which the reference never had.

    Perturbation-optimization RHS: b = B A^T N^-1 d + M om0
    + B A^T N^-1/2 om1 with M M^T = C^-1, so the exact solve is a draw from
    N(Q^-1 b_mean, Q^-1)."""
    dt = bt_ninv_d.dtype
    apply_cinv, apply_sqrt_cinv, apply_pinv, active = joint_block_ops(
        model, cl_blocks.astype(dt))
    k0, k1 = jax.random.split(key)
    om0 = jax.random.normal(k0, bt_ninv_d.shape, dtype=dt)
    om1 = jax.random.normal(k1, model.noise.tau.shape, dtype=dt)
    b = bt_ninv_d + apply_sqrt_cinv(om0)
    b = b + model.project_data(jnp.sqrt(model.noise.inv_noise) * om1)
    b = b * active

    def q_apply(x):
        x = x * active
        # qn_apply routes through the cut-ring complement transforms when
        # the model carries the cut decomposition (exact; ops.model)
        out = apply_cinv(x) + model.qn_apply(x)
        return out * active

    x, info = cg_solve(q_apply, b, x0=None, precond=apply_pinv,
                       tol=tol, maxiter=maxiter, ndim_sys=2)
    x = x * active
    return x, CRInfo(accept=jnp.ones((), dt),
                     extra=info.iterations.astype(dt))


def synfast_joint(key, cl_blocks, lmax: int, dtype=jnp.float32):
    """Draw correlated real-packed alm fields from C_ell blocks:
    s_i = L_ell(i) xi with L the Cholesky factor (k, nstate)."""
    cl_blocks = jnp.asarray(cl_blocks, dtype=dtype)
    k = cl_blocks.shape[-1]
    active = jnp.asarray(ell_mask_state(lmax, lmin=2), dtype=dtype)
    cov = expand_cl_blocks(cl_blocks, lmax)
    eye = jnp.eye(k, dtype=dtype)
    L = jnp.linalg.cholesky(jnp.where(active[:, None, None] > 0, cov, eye))
    xi = jax.random.normal(key, (nstate(lmax), k, 1), dtype=dtype)
    s = jnp.matmul(L, xi, precision=PRECISION)[..., 0] * active[:, None]
    return s.T
