"""Per-phase timing and profiling helpers.

The reference wraps every Gibbs sub-step in wall/CPU timers and stores the
histories with the chain (GibbsSampler.py:101-113,151-168, ASIS.py:92-123).
On an accelerator the analogue is fenced timing around compiled calls plus
optional jax.profiler traces.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field

import jax

__all__ = ["PhaseTimer", "profile_trace", "step_phase_times"]


@dataclass
class PhaseTimer:
    """Accumulates fenced wall-clock per named phase.

    with timer("cr_step"):
        out = step(...)          # blocks on exit => honest device time
    """

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    history: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        self.history.setdefault(name, []).append(dt)

    def summary(self) -> dict:
        return {
            name: {"total_s": tot, "count": self.counts[name],
                   "mean_ms": 1e3 * tot / self.counts[name]}
            for name, tot in self.totals.items()
        }


_CR_ONLY_JIT = None
_STEP_ONLY_JIT = None


def step_phase_times(scheme, states, key, reps: int = 3):
    """Fenced device time of the Gibbs sub-steps at the current state:
    mean seconds of (a) the CR step alone and (b) the full iteration,
    vmapped over the chain batch; the C_ell-step share is the difference.

    This is the accelerator analogue of the reference's per-step wall/CPU
    timers around each conditional (GibbsSampler.py:151-168, ASIS.py:92-123)
    — under ``lax.scan`` individual iterations cannot be timed from the
    host, so the runner records these fenced per-step means once per
    segment instead (stored with the chain like the reference's duration
    histories, main_polarization.py:175-185)."""
    global _CR_ONLY_JIT, _STEP_ONLY_JIT
    import jax.random as jr
    if _CR_ONLY_JIT is None:
        import jax as _jax

        def _cr_only(scheme, keys, states):
            if hasattr(states, "cl"):
                # joint scheme: state carries (lmax+1, k, k) C_ell blocks
                return _jax.vmap(lambda k, st: scheme._cr(
                    k, st.cl)[0])(keys, states)
            return _jax.vmap(lambda k, st: scheme._cr_step(
                k, st.s, scheme.var_cls(st.dl))[0])(keys, states)

        def _step_only(scheme, keys, states):
            return _jax.vmap(scheme.step)(keys, states)

        _CR_ONLY_JIT = _jax.jit(_cr_only)
        _STEP_ONLY_JIT = _jax.jit(_step_only)
    nchains = jax.tree_util.tree_leaves(states)[0].shape[0]
    keys = jr.split(key, nchains)
    out = {}
    for name, fn in (("cr", _CR_ONLY_JIT), ("full", _STEP_ONLY_JIT)):
        jax.block_until_ready(fn(scheme, keys, states))  # compile
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(fn(scheme, keys, states))
        out[name] = (time.perf_counter() - t0) / reps
    out["cls"] = max(out["full"] - out["cr"], 0.0)
    return out


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard / xprof).  Where the
    profiler cannot start or stop, the body still runs and the failure is
    reported on stderr (the trace is then missing or incomplete)."""
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except RuntimeError as e:
        print(f"profile_trace: profiler did not start ({e}); no trace "
              f"written to {logdir}", file=sys.stderr)
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except RuntimeError as e:
                print(f"profile_trace: stopping the profiler failed ({e}); "
                      f"the trace in {logdir} may be incomplete",
                      file=sys.stderr)
