"""SVGP1D tests.

The killer test: the banded-precision family contains the Titsias-optimal
posterior (precision_ν = P, bandwidth k), so plugging the optimal
(mu, R) into the uncollapsed ELBO must reproduce the collapsed GPR1D ELBO
*exactly* — a sharp joint check of the KL, the expected likelihood, the
gap term and the parameterization.
"""

import jax
import jax.numpy as jnp
import numpy as np

from asvgp import banded
from asvgp.basis import B3Spline
from asvgp.features.spline_features import make_kuu
from asvgp.models import GPR1D, Matern32
from asvgp.models.parameters import positive_inverse
from asvgp.models.svgp import SVGP1D, fit_svgp


def make_data(n=400, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.02, 0.98, n)
    y = np.sin(8 * x) + 0.1 * rng.randn(n)
    return x, y


def test_optimal_q_recovers_collapsed_elbo():
    x, y = make_data()
    basis = B3Spline(0.0, 1.0, 28)
    kernel = Matern32(0.8, 0.3)
    noise = 0.15
    gpr = GPR1D((x, y), kernel, basis, noise_variance=noise)
    p = gpr.init_params()
    collapsed = float(gpr.elbo(p))

    # build the optimal (mu_ν, C) from the collapsed sufficient statistics:
    # precision*_ν = P = Kuu + KufKfu/σ²  ⇒  C* = chol(KufKfu)/σ
    kuu = make_kuu(kernel, basis)
    p_band = gpr.stats.kufkfu_band / noise + kuu
    l_p = banded.cholesky_band(p_band)
    mu = banded.cholesky_solve_band(l_p, gpr.stats.kuf_y) / noise

    svgp = SVGP1D(kernel, basis, noise_variance=noise, num_data=x.shape[0])
    sp = svgp.init_params()
    c_star = banded.cholesky_band(gpr.stats.kufkfu_band) / np.sqrt(noise)
    sp = {**sp, "q_mu": mu, "q_prec_corr": c_star}

    uncollapsed = float(svgp.elbo(sp, x, y))
    np.testing.assert_allclose(uncollapsed, collapsed, rtol=1e-9)

    # any other q must not beat the collapsed bound
    sp_bad = {**sp, "q_mu": mu * 1.1}
    assert float(svgp.elbo(sp_bad, x, y)) < collapsed


def test_svgp_predict_matches_gpr_at_optimum():
    x, y = make_data()
    basis = B3Spline(0.0, 1.0, 24)
    kernel = Matern32(0.9, 0.25)
    noise = 0.2
    gpr = GPR1D((x, y), kernel, basis, noise_variance=noise)
    mean_g, var_g = gpr.predict_f(gpr.init_params(), x[:50])

    kuu = make_kuu(kernel, basis)
    p_band = gpr.stats.kufkfu_band / noise + kuu
    l_p = banded.cholesky_band(p_band)
    mu = banded.cholesky_solve_band(l_p, gpr.stats.kuf_y) / noise
    svgp = SVGP1D(kernel, basis, noise_variance=noise, num_data=x.shape[0])
    sp = svgp.init_params()
    sp = {
        **sp,
        "q_mu": mu,
        "q_prec_corr": banded.cholesky_band(gpr.stats.kufkfu_band)
        / np.sqrt(noise),
    }
    mean_s, var_s = svgp.predict_f(sp, x[:50])
    np.testing.assert_allclose(np.asarray(mean_s), np.asarray(mean_g), atol=1e-10)
    np.testing.assert_allclose(np.asarray(var_s), np.asarray(var_g), atol=1e-10)


def test_predict_log_density_closed_form():
    """predict_log_density must be the closed-form Gaussian log density
    N(y; mean, var + σ²) — rules out a metric bug in the NLPD table."""
    x, y = make_data(n=200, seed=5)
    basis = B3Spline(0.0, 1.0, 20)
    svgp = SVGP1D(Matern32(0.7, 0.3), basis, noise_variance=0.12, num_data=200)
    sp = svgp.init_params()
    xs, ys = x[:40], y[:40]
    ld = np.asarray(svgp.predict_log_density(sp, (xs, ys))).ravel()
    mean, var = svgp.predict_f(sp, xs)
    s = np.asarray(var).ravel() + 0.12
    expect = -0.5 * np.log(2 * np.pi * s) - (ys - np.asarray(mean).ravel()) ** 2 / (2 * s)
    np.testing.assert_allclose(ld, expect, rtol=1e-12)


def test_init_is_prior():
    """init_params puts q(ν) at the prior: KL = 0 and predictive variance =
    prior variance (the reachability contract of the log-scale R)."""
    basis = B3Spline(0.0, 1.0, 20)
    kernel = Matern32(0.9, 0.25)
    svgp = SVGP1D(kernel, basis, noise_variance=0.1, num_data=100)
    sp = svgp.init_params()
    np.testing.assert_allclose(float(svgp.kl(sp)), 0.0, atol=1e-8)
    xs = np.linspace(0.2, 0.8, 30)
    _, var = svgp.predict_f(sp, xs)
    np.testing.assert_allclose(
        np.asarray(var).ravel(), float(kernel.variance), rtol=1e-9
    )


import pytest


@pytest.mark.slow
def test_svgp_minibatch_training_improves_and_approaches_collapsed():
    x, y = make_data(n=1500, seed=3)
    basis = B3Spline(0.0, 1.0, 24)
    kernel = Matern32(1.0, 0.2)
    svgp = SVGP1D(kernel, basis, noise_variance=0.2, num_data=1500)
    p0 = svgp.init_params()
    e0 = float(svgp.elbo(p0, x, y))
    params, losses = fit_svgp(
        svgp, x, y, p0, batch_size=256, steps=800, learning_rate=0.03
    )
    e1 = float(svgp.elbo(params, x, y))
    assert np.isfinite(e1) and e1 > e0 + 10.0
    # the trained predictive mean must explain the signal
    mean, _ = svgp.predict_f(params, x)
    mse_model = float(np.mean((np.asarray(mean)[:, 0] - y) ** 2))
    assert mse_model < 0.5 * float(np.mean(y**2))
    # ... and the predictive VARIANCE must calibrate: with noise std 0.1 a
    # calibrated Gaussian predictive has NLPD ≈ ½log(2πe·0.01) ≈ -1.27.
    # The pre-fix parameterization (softplus/linear precision, unreachable
    # optimum) trains the mean but leaves NLPD near the prior's (~ +0.9).
    xh, yh = make_data(n=300, seed=11)
    ld = np.asarray(svgp.predict_log_density(params, (xh, yh)))
    assert float(-ld.mean()) < -0.8, f"miscalibrated NLPD {-ld.mean():.3f}"
