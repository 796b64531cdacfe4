"""Constrained-realization (CR) conditional samplers.

Draws s | C_ell, d  ~  N(Q^-1 b, Q^-1),   Q = C^-1 + B A^T N^-1 A B.

The full algorithm portfolio of the reference (SURVEY.md 2.3), each as a pure
jittable function (key, s_old, var_cls, ...) -> (s_new, info):

- exact_cr        : full-sky exact diagonal solve
                    (reference: CenteredGibbs.py:108-132, :317-353)
- cg_cr           : masked-sky preconditioned CG solve
                    (reference qcinv path: CenteredGibbs.py:135-176, :448-491)
- rjpo_cr         : reversible-jump perturbation-optimization — CG seeded at
                    the previous sample + Metropolis residual correction
                    (reference: CenteredGibbs.py:162-191, :606-674)
- aux_gibbs_cr    : auxiliary-variable Gibbs ("gibbs change of variable")
                    (reference: CenteredGibbs.py:193-212, :676-729)
- overrelax_cr    : overrelaxed auxiliary-variable sweep, alpha = -0.995
                    (reference: CenteredGibbs.py:733-825)
- mala_cr         : preconditioned MALA (reference: CenteredGibbs.py:494-603);
                    with accept=False it is ULA (reference:
                    CenteredGibbs.py:417-446 — note the reference ULA applies
                    the MH correction anyway; pass accept=True for parity)
- aux_then_mala_cr: composed aux-Gibbs sweep then MALA step
                    ("Composition !", reference: CenteredGibbs.py:833-836)

State s and var_cls are (nfields, nstate) grid-packed vectors
(harmonics.gridstate); all functions vmap over leading
chain axes at the scheme level.  Slots with var_cls = 0 (monopole/dipole and
any pinned multipoles) stay exactly 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.model import SkyModel
from ..ops.cg import cg_solve

__all__ = [
    "exact_cr", "cg_cr", "rjpo_cr", "aux_gibbs_cr", "overrelax_cr",
    "mala_cr", "aux_then_mala_cr", "pcn_cr", "fluctuated_rhs", "cr_precond",
    "noise_pool_spec",
]


# ---------------------------------------------------------------------------
# Pre-drawn noise pools
#
# Every CR step consumes a few large Gaussian fields.  Drawn once for the
# whole chain batch from a single key, XLA vectorizes the counter stream
# and fuses it into the consumer; drawing them inside the per-chain vmap
# (one PRNG key per chain) defeats that (the cost of each on the GPU is
# not measured).  The schemes therefore
# pre-draw a per-iteration "noise pool" with one key (schemes.gibbs.
# GibbsScheme.draw_noise_pool) and pass each chain's slice into the step;
# the functions below accept it via ``noise`` and fall back to in-place
# per-key draws when it is absent (direct calls, tests).
# ---------------------------------------------------------------------------


def noise_pool_spec(method: str, opts: dict) -> dict:
    """Number of pre-drawn N(0,1) fields each CR method consumes per step,
    by kind: "state" (nfields, nstate), "aux" (the auxiliary pixel field's
    shape — the cut rows under the cut decomposition, the full pixel grid
    otherwise), "sp" (the sparse-hole point block of the auxiliary field,
    present only for sparse-split models), "pix" (full pixel grid)."""
    n_g = int(opts.get("n_gibbs", 1))
    return {
        "exact": {"state": 1},
        "cg": {"state": 1, "pix": 1},
        "rjpo": {"state": 1, "pix": 1},
        "aux_gibbs": {"state": n_g, "aux": n_g, "sp": n_g},
        "overrelax": {"state": 2 * n_g, "aux": 1 + n_g, "sp": 1 + n_g},
        "mala": {"state": 1},
        "ula": {"state": 1},
        "aux_mala": {"state": n_g + 1, "aux": n_g, "sp": n_g},
        "pcn": {"state": 1},
    }[method]


class _Pool:
    """Static cursor over a pre-drawn noise dict {kind: (K, *shape)}."""

    def __init__(self, noise):
        self.noise = noise or {}
        self._i = {}

    def has(self, kind) -> bool:
        return kind in self.noise

    def take(self, kind, count: int = None):
        """Next ``count`` fields of ``kind`` (static slice); count=None -> 1
        field without the leading axis."""
        j = self._i.get(kind, 0)
        n = 1 if count is None else count
        self._i[kind] = j + n
        block = self.noise[kind][j: j + n]
        return block[0] if count is None else block


def _as_pool(noise):
    if isinstance(noise, _Pool):
        return noise
    return _Pool(noise) if noise else None


def _safe_inv(v):
    return jnp.where(v > 0, 1.0 / jnp.where(v > 0, v, 1.0), 0.0)


def _active(var_cls):
    return (var_cls > 0).astype(var_cls.dtype)


def fluctuated_rhs(key, model: SkyModel, var_cls, bt_ninv_d, noise=None):
    """b = B A^T N^-1 d + C^-1/2 om0 + B A^T N^-1/2 om1 — the random RHS whose
    exact solve is a draw from N(Q^-1 b_mean, Q^-1) (perturbation-optimization;
    used by both the plain CG and RJPO steps)."""
    pool = _as_pool(noise)
    k0, k1 = jax.random.split(key)
    inv_cvar = _safe_inv(var_cls)
    om0 = (pool.take("state") if pool else
           jax.random.normal(k0, var_cls.shape, dtype=var_cls.dtype))
    om1 = (pool.take("pix") if pool else
           jax.random.normal(k1, model.noise.tau.shape, dtype=var_cls.dtype))
    b = bt_ninv_d + jnp.sqrt(inv_cvar) * om0
    b = b + model.project_data(jnp.sqrt(model.noise.inv_noise) * om1)
    return b * _active(var_cls)


def cr_precond(model: SkyModel, var_cls, fsky_scale=True):
    """Diagonal preconditioner 1/(C^-1 + f_sky g b_l^2) (qcinv's diag_cl
    analogue, reference: ConstrainedRealization.py:41)."""
    inv_cvar = _safe_inv(var_cls)
    hdiag = model.harmonic_noise_diag().astype(var_cls.dtype)
    if fsky_scale:
        hdiag = hdiag * model.noise.f_sky[:, None].astype(var_cls.dtype)
    return _safe_inv(inv_cvar + hdiag) * _active(var_cls)


class CRInfo(NamedTuple):
    accept: jnp.ndarray          # 1.0 if the move was accepted (always for
                                 # exact/CG/aux samplers)
    extra: jnp.ndarray           # algorithm-specific scalar (CG iterations,
                                 # MH log-ratio, ...)


# ---------------------------------------------------------------------------
# Exact full-sky diagonal solve
# ---------------------------------------------------------------------------

def exact_cr(key, model: SkyModel, var_cls, bt_ninv_d, noise=None):
    """Full-sky exact draw: Sigma = (C^-1 + g b_l^2)^-1 elementwise; exact on
    a quadrature grid with quadrature-scaled white noise (the reference's
    full-sky solve is the HEALPix approximation of this,
    CenteredGibbs.py:108-132)."""
    inv_cvar = _safe_inv(var_cls)
    hdiag = model.harmonic_noise_diag().astype(var_cls.dtype)
    sigma = _safe_inv(inv_cvar + hdiag) * _active(var_cls)
    pool = _as_pool(noise)
    xi = (pool.take("state") if pool else
          jax.random.normal(key, var_cls.shape, dtype=var_cls.dtype))
    s = sigma * bt_ninv_d + jnp.sqrt(sigma) * xi
    return s, CRInfo(accept=jnp.ones((), var_cls.dtype),
                     extra=jnp.zeros((), var_cls.dtype))


# ---------------------------------------------------------------------------
# Masked-sky CG solve (and RJPO variant)
# ---------------------------------------------------------------------------

def _q_op(model, inv_cvar):
    """The CG operator: the cut-ring complement form when attached (exact on
    a quadrature grid, transforms only over the masked rings) else the plain
    masked apply."""
    if model.has_cut:
        return lambda x: model.q_apply_cut(x, inv_cvar)
    return lambda x: model.q_apply(x, inv_cvar)


def cg_cr(key, model: SkyModel, var_cls, bt_ninv_d, s_old=None,
          tol=1e-6, maxiter=4000, noise=None):
    """Perturbation-optimization CG draw, seeded at zero (reference seeds the
    qcinv solution at 0, CenteredGibbs.py:154-171); treated as exact."""
    inv_cvar = _safe_inv(var_cls)
    b = fluctuated_rhs(key, model, var_cls, bt_ninv_d, noise=noise)
    op = _q_op(model, inv_cvar)
    x, info = cg_solve(op, b, x0=None,
                       precond_diag=cr_precond(model, var_cls),
                       tol=tol, maxiter=maxiter, ndim_sys=2)
    x = x * _active(var_cls)
    return x, CRInfo(accept=jnp.ones((), var_cls.dtype),
                     extra=info.iterations.astype(var_cls.dtype))


def rjpo_cr(key, model: SkyModel, var_cls, bt_ninv_d, s_old,
            tol=1e-5, maxiter=4000, noise=None):
    """RJPO: solve the fluctuated system approximately and Metropolis-correct
    with the residual:
    log alpha = -<r, s_old - s_hat>, r = b - Q s_hat
    (reference: CenteredGibbs.py:162-191 TT, :606-674 pol).

    The solver is seeded at MINUS the current state, matching the reference
    exactly (CenteredGibbs.py:161-163: ``soltn_complex =
    -real_to_complex(s_old)``) — and that sign is load-bearing, not a
    quirk: (P)CG leaves its final residual orthogonal to the Krylov span,
    and s_hat - x0 lies in that span, so

        log alpha = -<r, s_old - s_hat> = <r, x0 - s_old>

    vanishes IDENTICALLY when x0 = +s_old (measured: log_ratio == 0 and
    accept == 1 at every budget down to maxiter = 1, i.e. a silently
    uncorrected truncated solve — an invalid kernel at loose tolerance).
    With x0 = -s_old the correction is <r, -2 s_old>, a genuine measure of
    the unconverged residual: measured accept == 1 once the solve is tight
    (maxiter ~ 40 here) and ~0 when it is not (median log_ratio -244 at
    maxiter = 10 on the lmax=8 masked test model) — RJPO degenerates to a
    convergence gate, which is exactly the reference's behavior and keeps
    the kernel invariant at every budget."""
    kb, ka = jax.random.split(key)
    inv_cvar = _safe_inv(var_cls)
    b = fluctuated_rhs(kb, model, var_cls, bt_ninv_d, noise=noise)
    op = _q_op(model, inv_cvar)
    s_hat, info = cg_solve(op, b, x0=-s_old * _active(var_cls),
                           precond_diag=cr_precond(model, var_cls),
                           tol=tol, maxiter=maxiter, ndim_sys=2)
    s_hat = s_hat * _active(var_cls)
    r = b - op(s_hat)
    log_ratio = -jnp.sum(r * (s_old - s_hat))
    u = jax.random.uniform(ka, dtype=var_cls.dtype)
    accept = jnp.log(u) < log_ratio
    s_new = jnp.where(accept, s_hat, s_old)
    return s_new, CRInfo(accept=accept.astype(var_cls.dtype),
                         extra=log_ratio.astype(var_cls.dtype))


# ---------------------------------------------------------------------------
# Auxiliary-variable Gibbs and overrelaxation
# ---------------------------------------------------------------------------

def _normal_like(key, tree, dt):
    """N(0,1) draws matching an arbitrary pytree of arrays (one key split
    per leaf)."""
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(
        treedef, [jax.random.normal(k, l.shape, dtype=dt)
                  for k, l in zip(keys, leaves)])


def _aux_ops(model: SkyModel, var_cls, eps=1e-7):
    """Shared pieces: the pixel gap operator (mu - N^-1), the harmonic
    posterior variance Sigma = (C^-1 + mu_bar/omega b_l^2)^-1, and the
    forward/project maps the two conditionals use.

    With the cut decomposition attached, mu is taken *exactly* at
    max(N^-1) (eps = 0): the gap then vanishes off the masked rings, the
    auxiliary field v lives on the cut rings only (zero-variance components
    are almost surely zero and drop out of both conditionals), and both
    conditionals run through cut-ring transforms.

    With the sparse split (floor + holes) the gap splits further:
    mu - N^-1 = w_floor + w_sp as nonnegative pixel-diagonal parts, each
    with its OWN independent auxiliary field — the augmentation identity
    exp(-1/2 s^T B A^T diag(w1 + w2) A B s) = the product of two
    independent augmentations, so the Gibbs sweep targets the same
    posterior.  ``gap`` / the fwd output / the proj input are then
    (floor, sparse) tuples; all gap arithmetic in the conditionals is
    tree-mapped."""
    from ..harmonics.gridstate import expand_cl_state
    noise = model.noise
    dt = var_cls.dtype
    inv_cvar = _safe_inv(var_cls)
    bl2 = expand_cl_state(model.bl.astype(dt) ** 2, model.lmax)
    if model.has_cut and model.has_sparse:
        gap = (model.w_cut.astype(dt), model.w_sp.astype(dt))
        mu_bar = noise.tau_max.astype(dt)

        def fwd(s):
            return model.synthesis_cut_sp(model.beam(s))

        def proj(v):
            return model.beam(model.adjoint_cut_sp(v[0], v[1]))
    elif model.has_cut:
        gap = model.w_cut.astype(dt)
        mu_bar = noise.tau_max.astype(dt)
        fwd = lambda s: model.synthesis_cut(model.beam(s))
        proj = lambda v: model.beam(model.adjoint_synthesis_cut(v))
    else:
        mu_bar = noise.tau_max.astype(dt) + eps      # (nfields,)
        gap = (noise.q_map * (noise.field_bcast(mu_bar)
                              - noise.tau)).astype(dt)   # (nfields, *pix)
        gap = jnp.maximum(gap, 0.0)
        fwd = model.forward
        proj = model.project_data
    hdiag = (mu_bar[:, None] / noise.omega) * bl2[None, :]
    sigma = _safe_inv(inv_cvar + hdiag) * _active(var_cls)
    return gap, sigma, fwd, proj


def aux_gibbs_cr(key, model: SkyModel, var_cls, bt_ninv_d, s_old,
                 n_gibbs: int = 1, eps=1e-7, noise=None):
    """Auxiliary-variable Gibbs: augment with pixel field
    v | s ~ N((mu - N^-1) A B s, mu - N^-1); then s | v, d is diagonal in
    harmonic space (reference: CenteredGibbs.py:193-212, :676-729;
    mu = max(N^-1) + 1e-7, ConstrainedRealization.py:44).  ``n_gibbs`` inner
    sweeps per call (reference runs 20 inside ASIS, main_polarization.py:126)."""
    gap, sigma, fwd, proj = _aux_ops(model, var_cls, eps)
    pool = _as_pool(noise)

    def sweep(s, xs):
        k, xi_v, xi_s = xs
        if xi_v is None:
            kv, ks = jax.random.split(k)
            xi_v = _normal_like(kv, gap, var_cls.dtype)
            xi_s = jax.random.normal(ks, var_cls.shape, dtype=var_cls.dtype)
        v = jax.tree.map(lambda g, f, x: g * f + jnp.sqrt(g) * x,
                         gap, fwd(s), xi_v)
        s = sigma * (proj(v) + bt_ninv_d) + jnp.sqrt(sigma) * xi_s
        return s, None

    keys = jax.random.split(key, n_gibbs)
    if pool:
        xi_v = pool.take("aux", n_gibbs)
        if isinstance(gap, tuple):
            xi_v = (xi_v, pool.take("sp", n_gibbs))
        xs = (keys, xi_v, pool.take("state", n_gibbs))
    else:
        xs = (keys, None, None)
    s, _ = jax.lax.scan(sweep, s_old * _active(var_cls), xs)
    return s, CRInfo(accept=jnp.ones((), var_cls.dtype),
                     extra=jnp.zeros((), var_cls.dtype))


def overrelax_cr(key, model: SkyModel, var_cls, bt_ninv_d, s_old,
                 alpha: float = -0.995, n_gibbs: int = 1, eps=1e-7,
                 noise=None):
    """Overrelaxed auxiliary sampler: one plain v|s draw to define the
    auxiliary chain state, then ``n_gibbs`` overrelaxed sweeps of
    (s|v, v|s, s|v) with
    x <- m + alpha (x - m) + sqrt(1 - alpha^2) sqrt(Sigma) xi, alpha = -0.995
    (reference: CenteredGibbs.py:733-825, alpha at :244; the flagship ASIS
    configuration runs n_gibbs = 20 sweeps per CR step,
    main_polarization.py:126)."""
    gap, sigma, fwd, proj = _aux_ops(model, var_cls, eps)
    pool = _as_pool(noise)
    dt = var_cls.dtype
    sq = jnp.sqrt(jnp.asarray(1.0 - alpha * alpha, dt))
    kinit, kscan = jax.random.split(key)
    s = s_old * _active(var_cls)

    # initial v draw (plain) to define the chain state
    if pool:
        xi = pool.take("aux")
        if isinstance(gap, tuple):
            xi = (xi, pool.take("sp"))
    else:
        xi = _normal_like(kinit, gap, dt)
    v = jax.tree.map(lambda g, f, x: g * f + jnp.sqrt(g) * x,
                     gap, fwd(s), xi)

    def sweep(carry, xs):
        s, v = carry
        k, xi_s1, xi_v, xi_s2 = xs
        if xi_s1 is None:
            k1, k2, k3 = jax.random.split(k, 3)
            xi_s1 = jax.random.normal(k1, var_cls.shape, dtype=dt)
            xi_v = _normal_like(k2, gap, dt)
            xi_s2 = jax.random.normal(k3, var_cls.shape, dtype=dt)
        m = sigma * (proj(v) + bt_ninv_d)
        s = m + alpha * (s - m) + sq * jnp.sqrt(sigma) * xi_s1
        v = jax.tree.map(
            lambda g, f, vv, x: (lambda mv: mv + alpha * (vv - mv)
                                 + sq * jnp.sqrt(g) * x)(g * f),
            gap, fwd(s), v, xi_v)
        m = sigma * (proj(v) + bt_ninv_d)
        s = m + alpha * (s - m) + sq * jnp.sqrt(sigma) * xi_s2
        return (s, v), None

    keys = jax.random.split(kscan, n_gibbs)
    if pool:
        st = pool.take("state", 2 * n_gibbs)
        xi_v = pool.take("aux", n_gibbs)
        if isinstance(gap, tuple):
            xi_v = (xi_v, pool.take("sp", n_gibbs))
        xs = (keys, st[0::2], xi_v, st[1::2])
    else:
        xs = (keys, None, None, None)
    (s, v), _ = jax.lax.scan(sweep, (s, v), xs)
    return s, CRInfo(accept=jnp.ones((), dt), extra=jnp.zeros((), dt))


# ---------------------------------------------------------------------------
# Langevin samplers (preconditioned ULA / MALA)
# ---------------------------------------------------------------------------

def mala_cr(key, model: SkyModel, var_cls, bt_ninv_d, s_old,
            tau: float = 0.02, accept: bool = True, noise=None):
    """Preconditioned MALA: s' = s + tau Sigma grad + sqrt(2 tau Sigma) xi,
    Sigma = full-sky posterior diagonal, tau = 0.02 (reference:
    CenteredGibbs.py:494-603; tau at :294).  accept=False gives unadjusted
    ULA (the reference's ULA path MH-corrects anyway, :436-446).

    Each state's forward map A B s is computed once and shared between the
    gradient and the log-target (2 transforms per state instead of 3 —
    the reference recomputes the SHT for each, CenteredGibbs.py:505-559).
    With the cut decomposition attached both the gradient's noise term and
    the log-target run through cut-ring transforms (complement identity)."""
    inv_cvar = _safe_inv(var_cls)
    hdiag = model.harmonic_noise_diag().astype(var_cls.dtype)
    sigma = _safe_inv(inv_cvar + hdiag) * _active(var_cls)
    dt = var_cls.dtype
    kp, ka = jax.random.split(key)
    d = model.d
    inv_noise = model.noise.inv_noise

    if model.has_cut:
        def fwd_grad_logp(x):
            """one cut synthesis + one cut adjoint (fused with the
            sparse-point pair when the floor+sparse split is attached) ->
            (gradient, log target)."""
            u = model.beam(x)
            au_cut, au_sp = model.synthesis_cut_sp(u)
            if model.has_sparse:
                corr = model.adjoint_cut_sp(model.w_cut * au_cut,
                                            model.w_sp * au_sp)
            else:
                corr = model.adjoint_synthesis_cut(model.w_cut * au_cut)
            qs = hdiag * x - model.beam(corr)
            grad = (-inv_cvar * x - qs + bt_ninv_d) * _active(var_cls)
            logp = (-0.5 * jnp.sum(inv_cvar * x * x)
                    + model.data_loglike_cut(u, au_cut, au_sp))
            return grad, logp
    else:
        def fwd_grad_logp(x):
            """forward once -> (gradient, log target)."""
            fwd = model.forward(x)
            resid = d - fwd
            qs = model.project_data(inv_noise * fwd)
            grad = (-inv_cvar * x - qs + bt_ninv_d) * _active(var_cls)
            logp = (-0.5 * jnp.sum(inv_cvar * x * x)
                    - 0.5 * jnp.sum(inv_noise * resid * resid))
            return grad, logp

    pool = _as_pool(noise)
    s = s_old * _active(var_cls)
    g, logp_s = fwd_grad_logp(s)
    xi = (pool.take("state") if pool else
          jax.random.normal(kp, var_cls.shape, dtype=dt))
    prop_mean = s + tau * sigma * g
    s_prop = prop_mean + jnp.sqrt(2.0 * tau * sigma) * xi

    if not accept:
        return s_prop, CRInfo(accept=jnp.ones((), dt),
                              extra=jnp.zeros((), dt))

    g_prop, logp_p = fwd_grad_logp(s_prop)
    rev_mean = s_prop + tau * sigma * g_prop
    inv_step = _safe_inv(2.0 * tau * sigma)

    def logq(x_to, mean):
        return -0.5 * jnp.sum(inv_step * (x_to - mean) ** 2)

    log_ratio = (logp_p - logp_s
                 + logq(s, rev_mean) - logq(s_prop, prop_mean))
    u = jax.random.uniform(ka, dtype=dt)
    acc = jnp.log(u) < log_ratio
    s_new = jnp.where(acc, s_prop, s)
    return s_new, CRInfo(accept=acc.astype(dt), extra=log_ratio.astype(dt))


def aux_then_mala_cr(key, model: SkyModel, var_cls, bt_ninv_d, s_old,
                     n_gibbs: int = 1, tau: float = 0.02, noise=None):
    """One auxiliary-Gibbs sweep followed by a MALA step — the reference's
    "Composition !" branch (CenteredGibbs.py:833-836)."""
    pool = _as_pool(noise)
    k1, k2 = jax.random.split(key)
    s, _ = aux_gibbs_cr(k1, model, var_cls, bt_ninv_d, s_old,
                        n_gibbs=n_gibbs, noise=pool)
    return mala_cr(k2, model, var_cls, bt_ninv_d, s, tau=tau, accept=True,
                   noise=pool)


def pcn_cr(key, model: SkyModel, var_cls, bt_ninv_d, s_old,
           beta: float = 0.1, noise=None):
    """Preconditioned Crank–Nicolson step: prior-reversible proposal
    s' = sqrt(1 - beta^2) s + beta C^{1/2} xi, accepted on the likelihood
    ratio alone (dimension-robust).  The reference validated pCN only on a
    1-d toy (testCN.py:22-41); here it joins the CR portfolio as a
    first-class algorithm."""
    dt = var_cls.dtype
    kp, ka = jax.random.split(key)
    act = _active(var_cls)
    s = s_old * act
    pool = _as_pool(noise)
    xi = (pool.take("state") if pool else
          jax.random.normal(kp, var_cls.shape, dtype=dt))
    s_prop = (jnp.sqrt(1.0 - beta * beta) * s
              + beta * jnp.sqrt(var_cls) * xi) * act

    d = model.d

    if model.has_cut:
        log_like = lambda x: model.data_loglike_cut(model.beam(x))
    else:
        def log_like(x):
            resid = d - model.forward(x)
            return -0.5 * jnp.sum(model.noise.inv_noise * resid * resid)

    log_ratio = log_like(s_prop) - log_like(s)
    u = jax.random.uniform(ka, dtype=dt)
    acc = jnp.log(u) < log_ratio
    s_new = jnp.where(acc, s_prop, s)
    return s_new, CRInfo(accept=acc.astype(dt), extra=log_ratio.astype(dt))
