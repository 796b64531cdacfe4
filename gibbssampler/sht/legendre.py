"""Associated-Legendre / Wigner-d table precomputation.

The SHT is a per-m Legendre matmul followed by ring FFTs.  This module
builds the (m, l, ring) operator tensors once per (lmax, grid) in float64
numpy, using stable upward recurrences; the transform code loads them to
device in the compute dtype.  This replaces the role of libsharp's on-the-fly
Legendre recurrences (used by the reference through healpy everywhere, e.g.
reference: utils.py:89-104, CenteredGibbs.py:505-513) with precomputed,
matmul-friendly operator blocks — the "dense-Y_lm done right" idea the reference
abandoned in sph_computing (reference: .ipynb_checkpoints/
sph_computing-checkpoint.py:31-76).

Conventions
-----------
- ``lambda_lm(x)`` is the orthonormal spherical-harmonic latitude factor:
  Y_lm(theta, phi) = lambda_lm(cos theta) e^{i m phi},
  lambda_lm = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) P_lm (Condon–Shortley in P_lm).
- Spin-weighted: sY_lm(theta, phi) = sLambda_lm(cos theta) e^{i m phi} with
  sLambda_lm = (-1)^s sqrt((2l+1)/(4 pi)) d^l_{m,-s}(theta),
  matching the standard (Goldberg / healpy / ssht) convention — validated in
  tests against the analytic l=2 spin-2 harmonics.

An optional C++ backend (gibbssampler.native) accelerates the fp64
precompute for large lmax; the numpy path is the reference implementation.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np
from scipy.special import gammaln


def _cache_dir() -> pathlib.Path:
    d = pathlib.Path(os.environ.get("XDG_CACHE_HOME",
                                    os.path.expanduser("~/.cache")))
    d = d / "gibbssampler" / "tables"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _cached(kind: str, lmax: int, extra, nodes: np.ndarray, compute):
    """Disk-cache fp64 operator tables keyed by (kind, lmax, extra, nodes):
    the precompute is O(lmax^2 nrings) host work, identical across runs of
    the same configuration (bench, tests, production)."""
    h = hashlib.sha1(np.ascontiguousarray(nodes).tobytes()).hexdigest()[:16]
    f = _cache_dir() / f"{kind}_{lmax}_{extra}_{h}.npy"
    if f.exists():
        try:
            return np.load(f, mmap_mode=None)
        except Exception:
            pass
    out = compute()
    try:
        tmp = f.with_suffix(".tmp.npy")
        np.save(tmp, out)
        os.replace(tmp, f)
    except Exception:
        pass
    return out

__all__ = [
    "legendre_table",
    "wigner_d_table",
    "spin2_lambda_tables",
]


def legendre_table(lmax: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal lambda_lm(x) for all 0 <= m <= l <= lmax.

    Parameters
    ----------
    lmax : band limit
    x : (nr,) array of cos(theta) ring nodes

    Returns
    -------
    (lmax+1, lmax+1, nr) float64 array, [m, l, r]; entries with l < m are 0.

    Dispatches to the native C++/OpenMP engine when available
    (gibbssampler.native); the numpy recurrence below is the reference
    implementation and fallback.
    """
    x = np.asarray(x, dtype=np.float64)

    def compute():
        from .. import native
        out = native.legendre_table(lmax, x)
        return out if out is not None else _legendre_table_np(lmax, x)

    return _cached("leg", lmax, 0, x, compute)


def _legendre_table_np(lmax: int, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    nr = x.shape[0]
    L = lmax + 1
    out = np.zeros((L, L, nr))
    sx = np.sqrt(np.maximum(0.0, 1.0 - x * x))  # sin(theta)

    # lambda_mm via stable iteration:
    # lambda_00 = sqrt(1/4pi); lambda_{m+1,m+1} = -sqrt((2m+3)/(2m+2)) sx lambda_mm
    lam_mm = np.full(nr, np.sqrt(1.0 / (4.0 * np.pi)))
    for m in range(L):
        out[m, m] = lam_mm
        if m + 1 < L:
            # lambda_{m+1, m} = x sqrt(2m+3) lambda_mm
            out[m, m + 1] = x * np.sqrt(2.0 * m + 3.0) * lam_mm
        # upward recurrence in l
        for l in range(m + 2, L):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            out[m, l] = a * (x * out[m, l - 1] - b * out[m, l - 2])
        if m + 1 < L:
            lam_mm = -np.sqrt((2.0 * m + 3.0) / (2.0 * m + 2.0)) * sx * lam_mm
    return out


def _d_top_row(j: int, mp: np.ndarray | int, beta: np.ndarray) -> np.ndarray:
    """d^j_{j, mp}(beta) = sqrt((2j)!/((j+mp)!(j-mp)!)) c^{j+mp} (-s)^{j-mp},
    c = cos(beta/2), s = sin(beta/2).  Computed in log space (stable for
    large j); underflow to 0 near the poles is benign (true values are
    astronomically small there)."""
    beta = np.asarray(beta, dtype=np.float64)
    c = np.cos(beta / 2.0)
    s = np.sin(beta / 2.0)
    mp = np.asarray(mp)
    lognorm = 0.5 * (gammaln(2 * j + 1) - gammaln(j + mp + 1) - gammaln(j - mp + 1))
    with np.errstate(divide="ignore"):
        logc = np.where(c > 0, np.log(np.maximum(c, 1e-300)), -np.inf)
        logs = np.where(s > 0, np.log(np.maximum(s, 1e-300)), -np.inf)
    mag = np.exp(lognorm + (j + mp) * logc + (j - mp) * logs)
    # handle exact pole values (c or s == 0) where the power may be 0
    mag = np.where((c == 0.0) & (j + mp > 0), 0.0, mag)
    mag = np.where((s == 0.0) & (j - mp > 0), 0.0, mag)
    mag = np.where((c == 0.0) & (j + mp == 0), np.exp(lognorm), mag)
    mag = np.where((s == 0.0) & (j - mp == 0), np.exp(lognorm), mag)
    return mag * ((-1.0) ** (j - mp))


def wigner_d_table(lmax: int, s: int, beta: np.ndarray) -> np.ndarray:
    """d^l_{m, s}(beta) for all m = 0..lmax, l = max(m,|s|)..lmax.

    Returns (lmax+1, lmax+1, nr) float64 array [m, l, r]; entries with
    l < max(m, |s|) are 0.  Upward three-term recurrence in l, seeded at
    l0 = max(m, |s|) with the closed-form top-row values (the l0-1 term of
    the recurrence has a vanishing coefficient at l = l0, so no second seed
    is needed)."""
    beta = np.asarray(beta, dtype=np.float64)
    x = np.cos(beta)
    nr = beta.shape[0]
    L = lmax + 1
    sa = abs(s)
    out = np.zeros((L, L, nr))

    for m in range(L):
        l0 = max(m, sa)
        if l0 > lmax:
            break
        # seed d^{l0}_{m, s}
        if m >= sa:
            seed = _d_top_row(m, s, beta)  # d^m_{m, s}
        else:
            # use symmetries to reach the top row:
            # d^l_{m,s} = (-1)^{m-s} d^l_{s,m};   d^l_{m,-|s|} = d^l_{|s|,-m}
            if s >= 0:
                seed = ((-1.0) ** (m - s)) * _d_top_row(s, m, beta)
            else:
                seed = _d_top_row(sa, -m, beta)
        out[m, l0] = seed
        dl_m1 = np.zeros(nr)  # d^{l0-1} (coefficient vanishes at l = l0)
        dl = seed
        for l in range(l0, lmax):
            # d^{l+1} = ((2l+1)(l(l+1)x - m s) d^l
            #            - (l+1) sqrt((l^2-m^2)(l^2-s^2)) d^{l-1})
            #           / (l sqrt(((l+1)^2-m^2)((l+1)^2-s^2)))
            if l == 0:
                # only reachable for m = s = 0; the generic recurrence is 0/0
                # there, but d^1_{00} = cos(beta) = x * d^0_{00}.
                dl_m1, dl = dl, x * dl
                out[m, l + 1] = dl
                continue
            num = ((2 * l + 1.0) * (l * (l + 1.0) * x - m * s) * dl
                   - (l + 1.0) * np.sqrt(max(l * l - m * m, 0.0)
                                         * max(l * l - s * s, 0.0)) * dl_m1)
            den = l * np.sqrt(((l + 1.0) ** 2 - m * m) * ((l + 1.0) ** 2 - s * s))
            dl_m1, dl = dl, num / den
            out[m, l + 1] = dl
    return out


def spin2_lambda_tables(lmax: int, theta: np.ndarray):
    """(2Lambda, -2Lambda) tables for m >= 0: sLambda[m, l, r].

    sLambda_lm(theta) = (-1)^s sqrt((2l+1)/4pi) d^l_{m,-s}(theta), so
      +2Lambda uses d^l_{m,-2} and -2Lambda uses d^l_{m,+2} (both x (+1),
    since (-1)^s = 1 for s = +/-2).
    """
    theta = np.asarray(theta, dtype=np.float64)
    L = lmax + 1
    norm = np.sqrt((2.0 * np.arange(L) + 1.0) / (4.0 * np.pi))[None, :, None]
    lam_p2 = wigner_d_table(lmax, -2, theta) * norm   # s = +2  uses d_{m,-2}
    lam_m2 = wigner_d_table(lmax, +2, theta) * norm   # s = -2  uses d_{m,+2}
    return lam_p2, lam_m2
