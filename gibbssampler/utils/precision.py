"""Matmul precision of the fp32 contractions.

Every Legendre, azimuthal-DFT, point-set and blocked-MH contraction passes
``precision=PRECISION``.  At JAX's default precision an fp32 matmul on an
NVIDIA GPU may run in TF32 (10-bit mantissa inputs), which moves the fp32
transforms ~1e-3 away from their fp64 values and perturbs MH accept ratios
that are differences of large quadratic forms; HIGHEST keeps true fp32.
PERF.md holds the error and time measured at both settings.  fp64
contractions are unaffected (they never use TF32).
"""

import jax

PRECISION = jax.lax.Precision.HIGHEST
