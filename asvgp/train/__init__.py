"""Training loops, metrics, checkpointing."""

from asvgp.train.lbfgs import fit_lbfgs
from asvgp.train.adam import fit_adam_minibatch
from asvgp.train.metrics import mse, nlpd
from asvgp.train.checkpoint import save_pytree, load_pytree

__all__ = [
    "fit_lbfgs",
    "fit_adam_minibatch",
    "mse",
    "nlpd",
    "save_pytree",
    "load_pytree",
]
