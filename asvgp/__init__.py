"""ASVGP: Actually Sparse Variational Gaussian Processes in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference ASVGP implementation (Cunningham et al., AISTATS 2023,
arXiv:2304.05091): inter-domain sparse variational GP regression with
compactly-supported B-spline inducing features and banded linear algebra.

Layers (bottom-up):
  banded/    — structured (banded) linear algebra with custom autodiff
  basis/     — B-spline basis engine (orders 1-6) on a uniform mesh
  features/  — RKHS Gram (Kuu) assembly + sparse design (Kuf) features
  stats/     — on-device sufficient-statistic assembly (shardable over N)
  models/    — GPR1D / GPRAdditive / GPRKron, kernels, likelihoods
  train/     — L-BFGS / Adam loops, metrics, checkpointing
  parallel/  — device-mesh sharding helpers (data-parallel psum reduction)

Everything is pure-functional JAX: models are pytrees, training steps are
jittable, and the numerical core runs as fused XLA/Pallas programs in
native float64 (on a GPU or the CPU).
"""

from asvgp import banded, basis, features, models, stats, train, parallel

__version__ = "0.1.0"

__all__ = [
    "banded",
    "basis",
    "features",
    "models",
    "stats",
    "train",
    "parallel",
]
