"""gibbssampler — a Bayesian CMB power-spectrum inference engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
research code Gabriel-Ducrocq/GibbsSampler (see SURVEY.md):
Gibbs sampling of (sky map s, power spectrum C_ell) under the model

    d = A B s + n

where A is spherical-harmonic synthesis, B a Gaussian beam, and n Gaussian
pixel noise.  Everything runs as pure jittable functions on the
accelerator (an NVIDIA GPU; the tests run on the CPU): the
spherical-harmonic transforms are blocked Legendre/FFT matmuls, the
constrained-realization solvers are batched (vmapped over chains) and the
chain axis shards over a device mesh.

Subpackages
-----------
harmonics   alm packing conventions, D_ell <-> C_ell, variance expansion, bins
sht         spherical harmonic transforms (Gauss-Legendre + HEALPix)
ops         linear operators (beam, noise, Q = C^-1 + B A^T N^-1 A B), batched CG
samplers    conditional samplers: constrained-realization portfolio + C_ell steps
schemes     full Gibbs drivers: centered, non-centered, ASIS, PNCP
parallel    mesh/chain sharding, cross-chain collectives, adaptation
diagnostics ESS, R-hat, ESJD, acceptance tracking, timers
inference   config dataclasses, dataset simulation, run scripts, checkpointing
utils       pytree registration, compile-cache placement, GPU guard
"""

__version__ = "0.1.0"
