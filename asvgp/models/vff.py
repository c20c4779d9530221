"""GPRVFF — collapsed-ELBO regression with Variational Fourier Features.

Baseline parity with the reference's VFF comparison model (reference
experiments/large_regression/electricity.py:12-13,76-79: `vff.vgps.GPR_1d`
from the external VFF package).  Same collapsed (Titsias/SGPR) bound as
GPR1D — the ONLY differences are the feature family (global Fourier
features, features/fourier.py) and consequently dense linear algebra:

  precompute  O(N m²)   (vs ASVGP's O(N k²))
  ELBO step   O(m³)     (vs ASVGP's O(m k²))

Dense f64 algebra is plain XLA (cuSOLVER/cuBLAS on a GPU).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax import lax

from asvgp.features.fourier import FourierBasis1D, make_kuu_vff
from asvgp.models.gpr1d import (
    default_params,
    params_to_kernel,
    params_to_likelihood,
)
from asvgp.models.kernels import Matern

_LOG2PI = math.log(2.0 * math.pi)


def _vff_stats(fb: FourierBasis1D, x, y, chunk: int = 8192):
    """(Kuf·y, Kuf·Kufᵀ, yᵀy, n) accumulated over N in chunks (the data are
    never resident as an (n, m) feature matrix)."""
    n = x.shape[0]
    m = fb.m
    pad = (-n) % chunk
    xp = jnp.pad(x, (0, pad))
    yp = jnp.pad(y, (0, pad))
    wp = jnp.pad(jnp.ones_like(y), (0, pad))
    xc = xp.reshape(-1, chunk)
    yc = yp.reshape(-1, chunk)
    wc = wp.reshape(-1, chunk)

    def body(carry, inp):
        kufy, kk = carry
        xi, yi, wi = inp
        phi = fb.evaluate(xi) * wi[:, None]  # (chunk, m), zero rows for pad
        kufy = kufy + phi.T @ yi
        kk = kk + phi.T @ phi
        return (kufy, kk), None

    init = (jnp.zeros((m,), x.dtype), jnp.zeros((m, m), x.dtype))
    (kufy, kk), _ = lax.scan(body, init, (xc, yc, wc))
    return kufy, kk, jnp.sum(y * y), jnp.asarray(n, x.dtype)


class GPRVFF:
    """1-D VFF regression with the collapsed bound (dense algebra)."""

    def __init__(self, data, kernel: Matern, basis: FourierBasis1D, *,
                 noise_variance=1.0, chunk: int = 8192):
        X, y = data
        x = jnp.reshape(jnp.asarray(X), (-1,))
        yf = jnp.reshape(jnp.asarray(y), (-1,))
        if not (float(jnp.min(x)) > basis.a and float(jnp.max(x)) < basis.b):
            raise ValueError(
                f"inputs must lie strictly inside [{basis.a}, {basis.b}]"
            )
        self.basis = basis
        self.nu2 = kernel.nu2
        self.kernel_init = kernel
        self.noise_variance_init = noise_variance
        self.kuf_y, self.kufkfu, self.yty, self.n = jax.jit(
            lambda xx, yy: _vff_stats(basis, xx, yy, chunk)
        )(x, yf)

    def init_params(self):
        return default_params(self.kernel_init, self.noise_variance_init)

    def _build(self, params):
        return params_to_kernel(params, self.nu2), params_to_likelihood(params)

    def _factors(self, params):
        kernel, lik = self._build(params)
        sigma2 = lik.variance
        kuu = make_kuu_vff(kernel, self.basis)
        l_kuu = jnp.linalg.cholesky(kuu)
        p = kuu + self.kufkfu / sigma2
        l_p = jnp.linalg.cholesky(p)
        return kernel, lik, sigma2, l_kuu, l_p

    def elbo(self, params):
        kernel, lik, sigma2, l_kuu, l_p = self._factors(params)
        log_det_kuu = 2.0 * jnp.sum(jnp.log(jnp.diagonal(l_kuu)))
        log_det_p = 2.0 * jnp.sum(jnp.log(jnp.diagonal(l_p)))
        c = jsl.solve_triangular(l_p, self.kuf_y, lower=True) / sigma2
        # trace(Kuu^{-1} KufKfu) = || L_kuu^{-1} KufKfu^{1/2} ||² — use the
        # cho_solve form: sum(Kuu^{-1} ∘ KufKfu) via one dense solve
        t = jsl.cho_solve((l_kuu, True), self.kufkfu)
        trace_term = jnp.trace(t)
        kdiag_sum = self.n * kernel.variance

        elbo = -0.5 * self.n * (_LOG2PI + jnp.log(sigma2))
        elbo -= 0.5 * log_det_p
        elbo += 0.5 * log_det_kuu
        elbo -= 0.5 * self.yty / sigma2
        elbo += 0.5 * jnp.sum(jnp.square(c))
        elbo -= 0.5 * kdiag_sum / sigma2
        elbo += 0.5 * trace_term / sigma2
        return elbo

    def maximum_log_likelihood_objective(self, params):
        return self.elbo(params)

    def training_loss(self, params):
        return -self.elbo(params)

    def predict_f(self, params, Xnew, full_cov: bool = False):
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        if not hasattr(self, "_predict_jit"):
            self._predict_jit = jax.jit(self._predict_f_arrays)
        return self._predict_jit(params, jnp.asarray(Xnew))

    def _predict_f_arrays(self, params, Xnew):
        kernel, lik, sigma2, l_kuu, l_p = self._factors(params)
        phi = self.basis.evaluate(Xnew)  # (n*, m)
        c = jsl.solve_triangular(l_p, self.kuf_y, lower=True) / sigma2
        tmp = jsl.solve_triangular(l_p, phi.T, lower=True)  # (m, n*)
        mean = tmp.T @ c
        ki = jsl.solve_triangular(l_kuu, phi.T, lower=True)
        var = (
            kernel.variance
            + jnp.sum(jnp.square(tmp), axis=0)
            - jnp.sum(jnp.square(ki), axis=0)
        )
        return mean[:, None], var[:, None]

    def predict_y(self, params, Xnew):
        _, lik = self._build(params)
        mean, var = self.predict_f(params, Xnew)
        return lik.predict_mean_and_var(mean, var)

    def predict_log_density(self, params, data):
        Xnew, ynew = data
        _, lik = self._build(params)
        mean, var = self.predict_f(params, Xnew)
        return lik.predict_log_density(
            mean, var, jnp.reshape(jnp.asarray(ynew), mean.shape)
        )
