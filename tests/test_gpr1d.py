"""GPR1D model tests (SURVEY.md §4): dense-oracle ELBO/prediction equivalence,
ELBO lower-bounds the exact-GP log marginal likelihood (the reference's
de-facto correctness check, experiments/snelson/example.py), end-to-end
L-BFGS training on the Snelson fixture, and sharded-stats equivalence.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp import banded
from asvgp.basis import B3Spline, BSplineBasis
from asvgp.features.spline_features import make_kuu
from asvgp.models import ExactGPR, GPR1D, Matern12, Matern32, Matern52
from asvgp.models.parameters import positive_inverse
from asvgp.stats.sufficient import compute_stats, compute_stats_sharded
from asvgp.train import fit_lbfgs

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data", "snelson")


def snelson():
    X = np.loadtxt(os.path.join(DATA_DIR, "train_inputs")).reshape(-1, 1)
    y = np.loadtxt(os.path.join(DATA_DIR, "train_outputs")).reshape(-1, 1)
    Xt = np.loadtxt(os.path.join(DATA_DIR, "test_inputs")).reshape(-1, 1)
    return jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xt)


def dense_collapsed_elbo(model, params):
    """Dense SGPR/Titsias ELBO oracle: log N(y | 0, Qff + σ²I) − tr(Kff−Qff)/2σ²."""
    kernel, lik = model._build(params)
    basis = model.basis
    X = snelson()[0][:, 0]
    y = snelson()[1][:, 0]
    n = y.shape[0]
    Kuu = banded.band_to_dense(
        banded.symmetrise_lower_band(make_kuu(kernel, basis)), basis.order, basis.order
    )
    Kuf = np.asarray(basis.evaluate_basis_dense(X))  # (m, n)
    Q = Kuf.T @ np.linalg.solve(np.asarray(Kuu), Kuf)
    cov = Q + np.asarray(lik.variance) * np.eye(n)
    sign, logdet = np.linalg.slogdet(cov)
    quad = y @ np.linalg.solve(cov, np.asarray(y))
    logN = -0.5 * (n * math.log(2 * math.pi) + logdet + quad)
    trace = np.sum(np.asarray(kernel.K_diag(X))) - np.trace(Q)
    return logN - 0.5 * trace / np.asarray(lik.variance)


@pytest.mark.parametrize("kern_fn,order", [(Matern12, 1), (Matern32, 3), (Matern52, 3), (Matern32, 4)])
def test_elbo_matches_dense_oracle(kern_fn, order):
    X, y, _ = snelson()
    basis = BSplineBasis(-3.5, 10.5, 24, order)
    model = GPR1D((X, y), kern_fn(variance=0.8, lengthscales=1.3), basis,
                  noise_variance=0.3)
    params = model.init_params()
    got = float(model.elbo(params))
    want = float(dense_collapsed_elbo(model, params))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("kern_fn,order", [(Matern12, 2), (Matern32, 3), (Matern52, 4)])
def test_elbo_lower_bounds_exact_gp(kern_fn, order):
    """The Titsias bound must hold for *any* hyperparameters — a sharp test of
    the Kuu RKHS formulas (a wrong Kuu breaks Kff ⪰ Qff)."""
    X, y, _ = snelson()
    basis = BSplineBasis(-3.5, 10.5, 60, order)
    for var, ell, noise in [(1.0, 1.0, 0.1), (0.5, 0.4, 0.05), (2.0, 2.5, 0.7)]:
        kernel = kern_fn(variance=var, lengthscales=ell)
        model = GPR1D((X, y), kernel, basis, noise_variance=noise)
        exact = ExactGPR((X, y), kernel, noise_variance=noise)
        params = model.init_params()
        elbo = float(model.elbo(params))
        logz = float(exact.log_marginal_likelihood(params))
        assert elbo <= logz + 1e-6, (var, ell, noise, elbo, logz)


def test_elbo_converges_to_exact_with_m():
    X, y, _ = snelson()
    kernel = Matern32(variance=1.0, lengthscales=0.8)
    exact = ExactGPR((X, y), kernel, noise_variance=0.1)
    logz = float(exact.log_marginal_likelihood(exact.init_params()))
    gaps = []
    for m in [20, 50, 150]:
        model = GPR1D((X, y), kernel, B3Spline(-3.5, 10.5, m), noise_variance=0.1)
        gaps.append(logz - float(model.elbo(model.init_params())))
    assert gaps[0] > gaps[1] > gaps[2] >= 0
    assert gaps[2] < 0.5  # nats: m=150 nearly saturates the bound


def test_predict_matches_dense_oracle():
    X, y, Xt = snelson()
    basis = B3Spline(-3.5, 10.5, 30)
    model = GPR1D((X, y), Matern32(0.9, 1.1), basis, noise_variance=0.2)
    params = model.init_params()
    mean, var = model.predict_f(params, Xt)

    kernel, lik = model._build(params)
    Kuu = np.asarray(
        banded.band_to_dense(
            banded.symmetrise_lower_band(make_kuu(kernel, basis)),
            basis.order,
            basis.order,
        )
    )
    Kuf = np.asarray(basis.evaluate_basis_dense(X[:, 0]))
    Kus = np.asarray(basis.evaluate_basis_dense(Xt[:, 0]))
    s2 = float(lik.variance)
    P = Kuu + Kuf @ Kuf.T / s2
    w = np.linalg.solve(P, Kuf @ np.asarray(y)[:, 0]) / s2
    mean_want = Kus.T @ w
    var_want = (
        float(kernel.variance)
        + np.sum(Kus * np.linalg.solve(P, Kus), axis=0)
        - np.sum(Kus * np.linalg.solve(Kuu, Kus), axis=0)
    )
    np.testing.assert_allclose(np.asarray(mean)[:, 0], mean_want, atol=1e-9)
    np.testing.assert_allclose(np.asarray(var)[:, 0], var_want, atol=1e-9)
    assert np.all(np.asarray(var) > 0)

    with pytest.raises(NotImplementedError):
        model.predict_f(params, Xt, full_cov=True)


def test_train_snelson_lbfgs_approaches_exact_gp():
    """End-to-end: the reference's Snelson protocol (example.py:17-33) —
    trained ASVGP ELBO must be close below the trained exact-GP logZ."""
    X, y, _ = snelson()
    exact = ExactGPR((X, y), Matern32())
    p_exact, loss_exact, _ = fit_lbfgs(jax.jit(exact.training_loss), exact.init_params())
    logz = -float(loss_exact)

    model = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100))
    p0 = model.init_params()
    elbo0 = float(model.elbo(p0))
    p_fit, loss_fit, iters = fit_lbfgs(jax.jit(model.training_loss), p0)
    elbo = -float(loss_fit)
    assert iters > 2
    assert elbo > elbo0 + 1.0  # actually optimized
    assert elbo <= logz + 1e-6  # still a valid bound
    assert logz - elbo < 1.0  # and tight (paper: ASVGP ≈ exact on Snelson)


def test_sharded_stats_match_single_device():
    X, y, _ = snelson()
    basis = B3Spline(-3.5, 10.5, 40)
    single = jax.jit(lambda x, yy: compute_stats(basis, x, yy))(X[:, 0], y[:, 0])
    mesh = jax.make_mesh((8,), ("data",))
    sharded = compute_stats_sharded(basis, X[:, 0], y[:, 0], mesh)
    np.testing.assert_allclose(np.asarray(single.kuf_y), np.asarray(sharded.kuf_y), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(single.kufkfu_band), np.asarray(sharded.kufkfu_band), atol=1e-12
    )
    np.testing.assert_allclose(float(single.yty), float(sharded.yty), rtol=1e-14)
    assert float(single.n) == float(sharded.n) == 200.0


def test_predict_log_density_matches_normal():
    X, y, _ = snelson()
    model = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 30), noise_variance=0.15)
    params = model.init_params()
    ld = model.predict_log_density(params, (X[:5], y[:5]))
    mean, var = model.predict_f(params, X[:5])
    from scipy.stats import norm

    want = norm.logpdf(
        np.asarray(y[:5])[:, 0],
        loc=np.asarray(mean)[:, 0],
        scale=np.sqrt(np.asarray(var)[:, 0] + 0.15),
    )
    np.testing.assert_allclose(np.asarray(ld)[:, 0], want, atol=1e-10)


def test_input_validation():
    X, y, _ = snelson()
    with pytest.raises(ValueError):
        GPR1D((X, y), Matern32(), B3Spline(0.0, 5.0, 30))  # data outside domain
    with pytest.raises(ValueError):
        GPR1D((jnp.ones((5, 2)), jnp.ones((5, 1))), Matern32(), B3Spline(-3.5, 10.5, 30))
    with pytest.raises(ValueError):
        # Matern52 needs order >= 3
        m = GPR1D((X, y), Matern52(), BSplineBasis(-3.5, 10.5, 30, 2))
        m.elbo(m.init_params())
