"""Batched preconditioned conjugate gradients on the accelerator.

Replaces the reference's qcinv multigrid/PCG chain (descriptor
[0, ["diag_cl"], lmax, nside, 4000, 1e-6, tr_cg, cache_mem()], reference:
ConstrainedRealization.py:40-41): a diagonally preconditioned CG where each
operator application costs two SHTs, expressed as a ``lax.while_loop`` so the
whole solve stays on device, and batched over chains — all chains iterate in
lockstep until every chain's residual passes the tolerance (converged chains
keep iterating on already-converged systems, which is free in lockstep SPMD
and keeps shapes static).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["cg_solve", "CGInfo"]


class CGInfo(NamedTuple):
    iterations: jnp.ndarray     # scalar int32 — iterations executed
    residual_norm: jnp.ndarray  # (...,) final ||b - Q x|| per batch element
    converged: jnp.ndarray      # (...,) bool per batch element


def _batch_dot(a, b, ndim_sys: int):
    """Sum over the trailing ndim_sys axes (the per-system axes)."""
    axes = tuple(range(-ndim_sys, 0))
    return jnp.sum(a * b, axis=axes)


def cg_solve(
    operator: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    precond_diag: jnp.ndarray | None = None,
    tol: float = 1e-6,
    maxiter: int = 4000,
    ndim_sys: int = 2,
    precond: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
    apply_dtype=None,
    operator_hi: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
    replace_every: int = 10,
):
    """Solve operator(x) = b for SPD ``operator``.

    Parameters
    ----------
    operator : linear map on arrays shaped like ``b``
    b : (..., *system_shape) right-hand side(s); leading axes are batch
    x0 : initial guess (0 if None; RJPO seeds with the previous sample,
         reference: CenteredGibbs.py:162-191)
    precond_diag : elementwise M^-1 (same shape as b broadcastable); the
         diag_cl-style preconditioner
    precond : general SPD preconditioner callable M^-1 v (e.g. the
         block-diagonal k x k preconditioner of the joint sampler);
         overrides precond_diag
    tol : relative tolerance on ||r|| / ||b|| per batch element.
         Precision note (tools/cg_scale.py): at production scale
         (lmax=512 masked polarized sky) plain fp32 CG stagnated before
         ||r||/||b|| = 1e-5 (4000 iters, no convergence) while fp64
         converged in ~200-400 iterations, on the hardware this code was
         first tuned on (not yet measured on the GPU).  The mixed scheme
         below (fp32 mat-vecs + fp64 vectors/recurrences + periodic
         true-residual replacement) aims at fp64-class convergence at fp32
         apply cost; plain fp64 is the reference-parity path.
    maxiter : iteration cap (reference budget: 4000)
    ndim_sys : how many trailing axes form one linear system
    apply_dtype : run ``operator`` at this LOWER dtype (cast in/out per
         apply) while keeping x/r/p and all recurrence scalars at
         ``b.dtype`` — mixed-precision CG.  The hot mat-vec (two SHTs)
         then runs at the fp32 rate instead of the fp64 rate.
    operator_hi : optional full-precision operator used only for the
         periodic residual replacement (defaults to the low-precision
         apply, which still removes recurrence drift, the dominant fp32
         failure mode).
    replace_every : with ``apply_dtype``: every K iterations recompute the
         TRUE residual r = b - Q x and restart the search direction
         (p = z) — van der Vorst-style residual replacement; removes the
         accumulated recurrence error that makes plain fp32 stagnate.
         The mixed path is a MONOTONE restarted CG (see the inline
         comment): non-positive-curvature steps are skipped, growth past
         4x since the last replacement forces one, and every replacement
         restarts from the best (x, true residual) pair seen so far, so
         a diverged stretch costs iterations, never correctness.
         Default 10 — measured at lmax=128/512: the compiled fp32
         recurrence on the production-conditioned operator is
         trustworthy for ~10 iterations; coarser cadences stagnate
         (monotonically, thanks to the safeguard) instead of converging.
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    if precond is not None:
        minv = precond
    elif precond_diag is not None:
        minv = lambda v: precond_diag * v
    else:
        minv = lambda v: v

    hi = b.dtype
    lo = None if apply_dtype is None else jnp.dtype(apply_dtype)
    if lo is not None and lo == hi:
        lo = None

    def apply_op(v):
        if lo is None:
            return operator(v)
        return operator(v.astype(lo)).astype(hi)

    rep_op = operator_hi if operator_hi is not None else apply_op

    r = b - rep_op(x)
    z = minv(r)
    p = z
    rz = _batch_dot(r, z, ndim_sys)
    bnorm = jnp.sqrt(_batch_dot(b, b, ndim_sys))
    bnorm = jnp.where(bnorm == 0, 1.0, bnorm)
    i0 = jnp.asarray(0, dtype=jnp.int32)
    nb = (...,) + (None,) * ndim_sys

    if lo is None or not replace_every:
        def cond(state):
            i, x, r, p, rz = state
            rnorm = jnp.sqrt(_batch_dot(r, r, ndim_sys))
            return jnp.logical_and(i < maxiter,
                                   jnp.any(rnorm > tol * bnorm))

        def body(state):
            i, x, r, p, rz = state
            qp = apply_op(p)
            denom = _batch_dot(p, qp, ndim_sys)
            alpha = rz / jnp.where(denom == 0, 1.0, denom)
            x = x + alpha[nb] * p
            r = r - alpha[nb] * qp
            z = minv(r)
            rz_new = _batch_dot(r, z, ndim_sys)
            beta = rz_new / jnp.where(rz == 0, 1.0, rz)
            p = z + beta[nb] * p
            return i + 1, x, r, p, rz_new

        i, x, r, p, rz = lax.while_loop(cond, body, (i0, x, r, p, rz))
        rnorm = jnp.sqrt(_batch_dot(r, r, ndim_sys))
        return x, CGInfo(iterations=i, residual_norm=rnorm,
                         converged=rnorm <= tol * bnorm)

    # ---- mixed-precision path: monotone restarted CG ------------------
    # With an inexact fp32 apply on an ill-conditioned operator the plain
    # recurrence is not merely inaccurate — it can turn anti-descent and
    # diverge by orders of magnitude between fixed-cadence replacements
    # (measured at lmax=128/512 under jit).  Three safeguards make it
    # robust at any cadence:
    #   1. non-positive curvature <p, Qp> (or <r, z>): skip the step and
    #      force a replacement (one such step injects inf/NaN);
    #   2. growth trigger: replace as soon as ||r|| grows 4x past its
    #      value at the last replacement;
    #   3. MONOTONE restart: the carry holds the best (x, true residual)
    #      pair seen at any replacement; every replacement restarts from
    #      it, so the true residual at restarts is non-increasing and a
    #      diverged stretch costs iterations, never correctness.
    rn0 = jnp.sqrt(_batch_dot(r, r, ndim_sys))

    def cond(state):
        i, x, r, p, rz, rref, xb, rb, rbn = state
        rnorm = jnp.sqrt(_batch_dot(r, r, ndim_sys))
        return jnp.logical_and(i < maxiter, jnp.any(rnorm > tol * bnorm))

    def body(state):
        i, x, r, p, rz, rref, xb, rb, rbn = state
        qp = apply_op(p)
        denom = _batch_dot(p, qp, ndim_sys)
        bad = jnp.logical_or(denom <= 0, rz <= 0)
        alpha = jnp.where(bad, 0.0,
                          rz / jnp.where(denom == 0, 1.0, denom))
        x = x + alpha[nb] * p
        r = r - alpha[nb] * qp

        def repl(args):
            x_, r_, xb_, rb_, rbn_ = args
            rr = b - rep_op(x_)                    # true residual at x_
            rn = jnp.sqrt(_batch_dot(rr, rr, ndim_sys))
            better = (rn < rbn_)[nb]
            xb_n = jnp.where(better, x_, xb_)
            rb_n = jnp.where(better, rr, rb_)
            rbn_n = jnp.minimum(rn, rbn_)
            zz = minv(rb_n)
            rz_n = _batch_dot(rb_n, zz, ndim_sys)
            return (xb_n, rb_n, zz, rz_n, jnp.max(rbn_n),
                    xb_n, rb_n, rbn_n)

        def norepl(args):
            x_, r_, xb_, rb_, rbn_ = args
            zz = minv(r_)
            rzn = _batch_dot(r_, zz, ndim_sys)
            beta = rzn / jnp.where(rz == 0, 1.0, rz)
            return (x_, r_, zz + beta[nb] * p, rzn, rref, xb_, rb_, rbn_)

        rnow = jnp.max(jnp.sqrt(_batch_dot(r, r, ndim_sys)))
        do_repl = jnp.logical_or((i + 1) % replace_every == 0,
                                 rnow > 4.0 * rref)
        do_repl = jnp.logical_or(do_repl, jnp.any(bad))
        x, r, p, rz_new, rref, xb, rb, rbn = lax.cond(
            do_repl, repl, norepl, (x, r, xb, rb, rbn))
        return i + 1, x, r, p, rz_new, rref, xb, rb, rbn

    i, x, r, p, rz, _, xb, rb, rbn = lax.while_loop(
        cond, body, (i0, x, r, p, rz, jnp.max(rn0), x, r, rn0))
    # pick the better of (current iterate, best replacement point)
    rnorm = jnp.sqrt(_batch_dot(r, r, ndim_sys))
    take_cur = (rnorm <= rbn)[nb]
    x = jnp.where(take_cur, x, xb)
    rnorm = jnp.minimum(rnorm, rbn)
    return x, CGInfo(iterations=i, residual_norm=rnorm,
                     converged=rnorm <= tol * bnorm)
