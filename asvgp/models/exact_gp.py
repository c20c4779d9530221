"""Exact GP regression (dense) — correctness oracle and experiment baseline.

Equivalent of ``gpflow.models.GPR`` as used by the reference's Snelson
experiment (experiments/snelson/example.py:19-22): the ASVGP ELBO must
lower-bound and approach this model's log marginal likelihood
(SURVEY.md §4).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from asvgp.models.gpr1d import (
    default_params,
    params_to_kernel,
    params_to_likelihood,
)

_LOG2PI = math.log(2.0 * math.pi)


class ExactGPR:
    def __init__(self, data, kernel, *, noise_variance=1.0):
        X, y = data
        self.X = jnp.reshape(jnp.asarray(X), (-1,))
        self.y = jnp.reshape(jnp.asarray(y), (-1,))
        self.nu2 = kernel.nu2
        self.kernel_init = kernel
        self.noise_variance_init = noise_variance

    def init_params(self):
        return default_params(self.kernel_init, self.noise_variance_init)

    def _build(self, params):
        return params_to_kernel(params, self.nu2), params_to_likelihood(params)

    def log_marginal_likelihood(self, params):
        kernel, lik = self._build(params)
        n = self.y.shape[0]
        K = kernel.K(self.X) + lik.variance * jnp.eye(n, dtype=self.y.dtype)
        L = jnp.linalg.cholesky(K)
        alpha = jnp.linalg.solve(L, self.y)
        return (
            -0.5 * jnp.sum(jnp.square(alpha))
            - jnp.sum(jnp.log(jnp.diagonal(L)))
            - 0.5 * n * _LOG2PI
        )

    def maximum_log_likelihood_objective(self, params):
        return self.log_marginal_likelihood(params)

    def training_loss(self, params):
        return -self.log_marginal_likelihood(params)

    def predict_f(self, params, Xnew):
        kernel, lik = self._build(params)
        x2 = jnp.reshape(jnp.asarray(Xnew), (-1,))
        n = self.y.shape[0]
        K = kernel.K(self.X) + lik.variance * jnp.eye(n, dtype=self.y.dtype)
        L = jnp.linalg.cholesky(K)
        Ks = kernel.K(self.X, x2)  # (n, n*)
        A = jnp.linalg.solve(L, Ks)
        mean = A.T @ jnp.linalg.solve(L, self.y)
        var = kernel.K_diag(x2) - jnp.sum(jnp.square(A), axis=0)
        return mean[:, None], var[:, None]

    def predict_log_density(self, params, data):
        Xnew, ynew = data
        _, lik = self._build(params)
        mean, var = self.predict_f(params, Xnew)
        return lik.predict_log_density(
            mean, var, jnp.reshape(jnp.asarray(ynew), mean.shape)
        )
