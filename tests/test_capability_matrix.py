"""Acceptance surface (SURVEY.md §7.4): every valid kernel x spline-order
combination builds, evaluates a finite ELBO that lower-bounds the exact GP,
and rejects invalid combinations with clear errors.

Coverage beyond the reference: Matérn-5/2 x order 6 works here (the
reference's B6Spline lacks the BC_ggrad matrices and would crash,
reference asvgp/basis.py:664-666 vs inducing_features.py:40-42).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from asvgp.basis import BSplineBasis
from asvgp.features.spline_features import MIN_ORDER
from asvgp.models import ExactGPR, GPR1D, Matern12, Matern32, Matern52

KERNELS = {"matern12": Matern12, "matern32": Matern32, "matern52": Matern52}


def snelson_subset(n=80):
    import os

    d = os.path.join(os.path.dirname(__file__), "..", "data", "snelson")
    X = np.loadtxt(os.path.join(d, "train_inputs"))[:n].reshape(-1, 1)
    y = np.loadtxt(os.path.join(d, "train_outputs"))[:n].reshape(-1, 1)
    return X, y


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("name", ["matern12", "matern32", "matern52"])
def test_kernel_order_combination(name, order):
    X, y = snelson_subset()
    kernel = KERNELS[name](variance=0.9, lengthscales=0.8)
    basis = BSplineBasis(-3.5, 10.5, 30, order)
    if order < MIN_ORDER[name]:
        # must raise AT CONSTRUCTION, before any precompute (verify-skill
        # regression: the check used to fire only at the first ELBO eval)
        with pytest.raises(ValueError, match="requires spline order"):
            GPR1D((X, y), kernel, basis, noise_variance=0.2)
        return
    model = GPR1D((X, y), kernel, basis, noise_variance=0.2)
    elbo = float(model.elbo(model.init_params()))
    assert np.isfinite(elbo)
    exact = ExactGPR((X, y), kernel, noise_variance=0.2)
    logz = float(exact.log_marginal_likelihood(exact.init_params()))
    assert elbo <= logz + 1e-6
    # prediction works and gives positive variances
    mean, var = model.predict_f(model.init_params(), X[:10])
    assert np.all(np.isfinite(np.asarray(mean))) and np.all(np.asarray(var) > 0)


@pytest.mark.parametrize("dx", [0, 1, 2, 3])
def test_basis_derivative_exposure(dx):
    """evaluate_basis dx ∈ {0..3} is part of the public surface
    (reference asvgp/basis.py:61-70)."""
    basis = BSplineBasis(0.0, 1.0, 20, 3)
    vals, start = basis.evaluate_basis(jnp.linspace(0.05, 0.95, 7), dx=dx)
    assert vals.shape == (7, 4)
    assert np.all(np.isfinite(np.asarray(vals)))


def test_basis_derivative_rejects_dx4():
    basis = BSplineBasis(0.0, 1.0, 20, 3)
    with pytest.raises(NotImplementedError):
        basis.evaluate_basis(jnp.asarray([0.5]), dx=4)
