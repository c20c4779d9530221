"""Model classes: GPR1D (flagship), GPRKron, GPRAdditive, oracles."""

from asvgp.models.kernels import Matern, Matern12, Matern32, Matern52
from asvgp.models.likelihoods import Gaussian
from asvgp.models.gpr1d import GPR1D, Posterior1D
from asvgp.models.kron import GPRKron
from asvgp.models.additive import GPRAdditive
from asvgp.models.exact_gp import ExactGPR
from asvgp.models.svgp import SVGP1D

__all__ = [
    "Matern",
    "Matern12",
    "Matern32",
    "Matern52",
    "Gaussian",
    "GPR1D",
    "Posterior1D",
    "GPRKron",
    "GPRAdditive",
    "ExactGPR",
    "SVGP1D",
]
