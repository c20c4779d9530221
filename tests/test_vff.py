"""VFF baseline (features/fourier.py, models/vff.py): Kuu validated by
quadrature against the Matérn interval RKHS norms, ELBO validated as a
lower bound of the exact GP on Snelson."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp.features.fourier import FourierBasis1D, make_kuu_vff
from asvgp.models.kernels import Matern
from asvgp.models.vff import GPRVFF

A, B_ = -0.3, 1.7
_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def _phi_np(fb, x, dx):
    """Analytic dx-th derivatives of the Fourier features, numpy."""
    w = fb.omegas
    t = x[:, None] - fb.a
    F = fb.n_frequencies
    ang = w[None, :] * t
    if dx == 0:
        return np.concatenate([np.ones((len(x), 1)), np.cos(ang), np.sin(ang)], 1)
    if dx == 1:
        return np.concatenate(
            [np.zeros((len(x), 1)), -w * np.sin(ang), w * np.cos(ang)], 1
        )
    if dx == 2:
        return np.concatenate(
            [np.zeros((len(x), 1)), -w**2 * np.cos(ang), -w**2 * np.sin(ang)], 1
        )
    if dx == 3:
        return np.concatenate(
            [np.zeros((len(x), 1)), w**3 * np.sin(ang), -w**3 * np.cos(ang)], 1
        )
    raise ValueError


def _quadrature_kuu(fb, name, var, ell):
    """Kuu by Gauss-Legendre quadrature of the interval RKHS norms
    (the formulas at features/spline_features.py:11-15)."""
    xg, wg = np.polynomial.legendre.leggauss(400)
    x = 0.5 * (B_ - A) * xg + 0.5 * (B_ + A)
    w = 0.5 * (B_ - A) * wg

    def l2(d):
        p = _phi_np(fb, x, d)
        return (p * w[:, None]).T @ p

    def bnd(d1, d2):
        pa = _phi_np(fb, np.array([A]), d1)[0]
        qa = _phi_np(fb, np.array([A]), d2)[0]
        pb = _phi_np(fb, np.array([B_]), d1)[0]
        qb = _phi_np(fb, np.array([B_]), d2)[0]
        return np.outer(pa, qa) + np.outer(pb, qb)

    if name == "matern12":
        return (l2(0) / ell + ell * l2(1) + bnd(0, 0)) / (2.0 * var)
    if name == "matern32":
        return (
            _SQRT3 / (4 * ell * var) * l2(0)
            + ell / (2 * _SQRT3 * var) * l2(1)
            + ell**3 / (12 * _SQRT3 * var) * l2(2)
            + 1.0 / (2 * var) * bnd(0, 0)
            + ell**2 / (2 * var) * bnd(1, 1)
        )
    return (
        3 * _SQRT5 / (16 * ell * var) * l2(0)
        + 9 * ell / (16 * _SQRT5 * var) * l2(1)
        + 9 * ell**3 / (80 * _SQRT5 * var) * l2(2)
        + 3 * ell**5 / (400 * _SQRT5 * var) * l2(3)
        + 9.0 / (16 * var) * bnd(0, 0)
        + 3 * ell**2 / (10 * var) * bnd(1, 1)
        + 9 * ell**4 / (400 * var) * bnd(2, 2)
        + 3 * ell**2 / (80 * var) * (bnd(2, 0) + bnd(0, 2))
    )


@pytest.mark.parametrize("nu2,name", [(1, "matern12"), (3, "matern32"), (5, "matern52")])
def test_kuu_vff_matches_quadrature(nu2, name):
    fb = FourierBasis1D(A, B_, 4)
    var, ell = 1.7, 0.31
    got = np.asarray(make_kuu_vff(Matern(var, ell, nu2=nu2), fb))
    want = _quadrature_kuu(fb, name, var, ell)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_vff_elbo_lower_bounds_exact_gp_snelson():
    from asvgp.models import ExactGPR, Matern32
    from asvgp.train import fit_lbfgs

    root = os.path.join(os.path.dirname(__file__), "..")
    X = np.loadtxt(os.path.join(root, "data/snelson/train_inputs")).reshape(-1)
    y = np.loadtxt(os.path.join(root, "data/snelson/train_outputs")).reshape(-1)

    eg = ExactGPR((X, y), Matern32())
    pe, le, _ = fit_lbfgs(jax.jit(eg.training_loss), eg.init_params(), max_iters=60)
    logz = -float(le)

    model = GPRVFF((X, y), Matern32(), FourierBasis1D(-3.5, 10.5, 20))
    p, loss, _ = fit_lbfgs(
        jax.jit(model.training_loss), model.init_params(), max_iters=60
    )
    elbo = -float(loss)
    assert elbo <= logz + 1e-6
    assert elbo > logz - 2.0  # tight-ish for 20 harmonics on Snelson

    mean, var = model.predict_f(p, X[:20])
    assert np.all(np.isfinite(np.asarray(mean)))
    assert np.all(np.asarray(var) > 0)

    ld = model.predict_log_density(p, (X[:20], y[:20]))
    assert np.all(np.isfinite(np.asarray(ld)))


def test_vff_capability_errors():
    x = np.linspace(0.1, 0.9, 50)
    y = np.sin(x)
    with pytest.raises(ValueError):
        GPRVFF((x, y), Matern(1.0, 0.2, nu2=3), FourierBasis1D(0.2, 2.0, 4))
    model = GPRVFF((x, y), Matern(1.0, 0.2, nu2=3), FourierBasis1D(0.0, 1.0, 4))
    with pytest.raises(NotImplementedError):
        model.predict_f(model.init_params(), x, full_cov=True)
