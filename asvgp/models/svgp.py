"""SVGP1D — uncollapsed sparse variational GP with banded precision q.

The reference uses gpflow's SVGP (dense (m, m) q_sqrt) as its minibatch
baseline (experiments/large_regression/electricity.py:115-116, SURVEY.md
§2.3).  This model is the equivalent, built on the banded
structure of spline features.

Parameterization.  Instead of q(u) directly, we parameterize
ν = Kuu⁻¹ u (the "information" transform).  Under the prior,
ν ~ N(0, Kuu⁻¹), and the conditional of f simplifies because
cov(f(x), u) = φ(x) (reproducing property):

    E[f(x) | ν]   = φ(x)ᵀ ν                       (no Kuu solve per point!)
    var[f(x) | ν] = k(x,x) − φᵀ Kuu⁻¹ φ           (prior gap)

We take q(ν) = N(mu, Λ⁻¹) with the precision ANCHORED AT THE PRIOR:

    Λ(θ, C) = Kuu(θ) + C Cᵀ,   C lower-banded, bandwidth k, trainable.

The Titsias-optimal posterior is q*(u) = N(σ⁻²Kuu P⁻¹Kuf y, Kuu P⁻¹Kuu)
with P = Kuu + KufKfuᵀ/σ², so in ν-space precision*_ν = P and the optimal
correction is C* = chol(KufKfu)/σ — lower-banded with bandwidth exactly
k.  The anchored banded family therefore CONTAINS the exact optimum while
costing O(m·k) parameters instead of gpflow's O(m²).

Why anchored and not a free banded Cholesky factor R?  κ(Kuu) reaches
1e10-1e12 at production scales (CLAUDE.md numerics), and a generic R
initialized at chol(Kuu) is catastrophically sensitive there: one Adam
step (|δ| ~ lr) tilts RRᵀ off its Kuu-dominance and Σ = (RRᵀ)⁻¹ blows
past Kuu⁻¹ by factors of κ — the KL trace hit 1e27 within 10 steps of
batch-100 training (CPU f64, so not a precision artifact).  With Λ = Kuu + CCᵀ ≽ Kuu for EVERY C, Σ ≼ Kuu⁻¹ in the PSD
order, hence tr(Kuu Σ) ≤ m identically — the explosion is structurally
impossible, while gradients still reach the exact optimum.

Every ELBO term is banded (R below = chol(Λ), a banded Cholesky):

    KL(q(ν) ‖ p(ν)) = ½[ tr(Kuu Σ) + muᵀ Kuu mu − m − log|Kuu| − log|Σ| ]
      tr(Kuu Σ)  = band-Frobenius(Kuu, Takahashi band of R)   (exact: Kuu
                   is banded, so only Σ's band enters)
      muᵀ Kuu mu = banded matvec, log|Σ| = −2 Σ log R_ii,
      log|Kuu|   = banded Cholesky
    var_q[f_i]   = φ_iᵀ Σ φ_i                    (Takahashi window of R)

Each training step is an unbiased minibatch estimate — true SVGP-style
stochastic training (the BASELINE.md minibatch-ELBO capability).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import optax

from asvgp import banded
from asvgp.basis.splines import BSplineBasis
from asvgp.features.spline_features import make_kuf, make_kuu
from asvgp.models.gpr1d import (
    params_to_kernel,
    params_to_likelihood,
    window_dot,
    window_quadratic_form,
)
from asvgp.models.kernels import Matern
from asvgp.models.parameters import positive_inverse

_LOG2PI = math.log(2.0 * math.pi)


class SVGP1D:
    """1-D spline-feature SVGP with banded-precision variational posterior."""

    def __init__(self, kernel: Matern, basis: BSplineBasis, *,
                 noise_variance=1.0, num_data=None, q_bandwidth=None):
        self.basis = basis
        self.nu2 = kernel.nu2
        self.kernel_init = kernel
        self.noise_variance_init = noise_variance
        self.num_data = num_data
        # bandwidth k contains the exact optimal posterior (precision_ν = P)
        self.q_bandwidth = basis.order if q_bandwidth is None else q_bandwidth

    def init_params(self):
        """Initialize q(ν) at the PRIOR p(ν) = N(0, Kuu⁻¹): C = 0, so
        Λ = Kuu, KL = 0, predictive variance = prior variance.  NOTE:
        C = 0 is an exact stationary point of the ELBO in C (every
        C-dependence factors through CCᵀ, so ∂/∂C vanishes at 0) —
        gradient training must NOT start exactly here; ``fit_svgp``
        replaces an all-zero C with the data-optimal correction
        chol(KufKfu)/σ before stepping."""
        m = self.basis.m
        raw = jnp.zeros((self.q_bandwidth + 1, m), jnp.result_type(float))
        return {
            "kernel": {
                "raw_variance": positive_inverse(self.kernel_init.variance),
                "raw_lengthscales": positive_inverse(self.kernel_init.lengthscales),
            },
            "likelihood": {"raw_variance": positive_inverse(self.noise_variance_init)},
            "q_mu": jnp.zeros((m,), jnp.result_type(float)),
            "q_prec_corr": raw,
        }

    def _build(self, params):
        return params_to_kernel(params, self.nu2), params_to_likelihood(params)

    def _r_band(self, params, kuu):
        """R = chol(Λ) with Λ = Kuu + CCᵀ (see module docstring): the
        banded Cholesky of the prior-anchored variational precision."""
        c = banded.mask_lower_band(params["q_prec_corr"])
        k = c.shape[0] - 1
        cct = banded.product_band_band(
            c, banded.transpose_lower_band(c),
            a_lower=k, a_upper=0, b_lower=0, b_upper=k,
            out_lower=k, out_upper=0,
        )
        lam = kuu
        if cct.shape[0] > lam.shape[0]:
            pad = jnp.zeros(
                (cct.shape[0] - lam.shape[0], lam.shape[1]), lam.dtype
            )
            lam = jnp.concatenate([lam, pad], axis=0)
        elif cct.shape[0] < lam.shape[0]:
            pad = jnp.zeros(
                (lam.shape[0] - cct.shape[0], cct.shape[1]), cct.dtype
            )
            cct = jnp.concatenate([cct, pad], axis=0)
        return banded.cholesky_band(lam + cct)

    # ---- KL(q(ν) || p(ν)), p(ν) = N(0, Kuu⁻¹) ------------------------------
    def kl(self, params):
        kernel, _ = self._build(params)
        kuu = make_kuu(kernel, self.basis)
        m = self.basis.m
        R = self._r_band(params, kuu)
        mu = params["q_mu"]

        l_kuu = banded.cholesky_band(kuu)
        log_det_kuu = banded.log_det_from_cholesky(l_kuu)
        log_det_sigma = -2.0 * jnp.sum(jnp.log(R[0]))
        sigma_band = banded.takahashi_inverse_band(R)
        trace = banded.band_frobenius(kuu, sigma_band[: kuu.shape[0]])
        quad = jnp.sum(mu * banded.matvec_symmetric_band(kuu, mu))
        return 0.5 * (trace + quad - m - log_det_kuu - log_det_sigma)

    # ---- stochastic ELBO ---------------------------------------------------
    def elbo(self, params, X, y):
        """Unbiased minibatch ELBO estimate (scaled by num_data/batch)."""
        kernel, lik = self._build(params)
        sigma2 = lik.variance
        yf = jnp.reshape(jnp.asarray(y), (-1,))
        b = yf.shape[0]
        scale = (
            jnp.asarray(self.num_data, yf.dtype) / b
            if self.num_data is not None
            else jnp.asarray(1.0, yf.dtype)
        )

        kuu = make_kuu(kernel, self.basis)
        R = self._r_band(params, kuu)
        sigma_band = banded.takahashi_inverse_band(R)

        l_kuu = banded.cholesky_band(kuu)
        kuu_inv_band = banded.takahashi_inverse_band(l_kuu)

        vals, start = make_kuf(self.basis, X)
        f_mean = window_dot(params["q_mu"], vals, start)
        f_var = window_quadratic_form(sigma_band, vals, start)
        gap = kernel.variance - window_quadratic_form(kuu_inv_band, vals, start)

        exp_ll = (
            -0.5 * (_LOG2PI + jnp.log(sigma2)) * b
            - 0.5 * jnp.sum(jnp.square(yf - f_mean) + f_var + gap) / sigma2
        )
        return scale * exp_ll - self.kl(params)

    def training_loss(self, params, X, y):
        return -self.elbo(params, X, y)

    # ---- prediction ---------------------------------------------------------
    def predict_f(self, params, Xnew, full_cov: bool = False):
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        if not hasattr(self, "_predict_jit"):
            self._predict_jit = jax.jit(self._predict_f_arrays)
        return self._predict_jit(
            params, jnp.reshape(jnp.asarray(Xnew), (-1,))
        )

    def _predict_f_arrays(self, params, Xnew):
        kernel, _ = self._build(params)
        kuu = make_kuu(kernel, self.basis)
        R = self._r_band(params, kuu)
        sigma_band = banded.takahashi_inverse_band(R)
        l_kuu = banded.cholesky_band(kuu)
        kuu_inv_band = banded.takahashi_inverse_band(l_kuu)

        vals, start = make_kuf(self.basis, jnp.reshape(jnp.asarray(Xnew), (-1,)))
        mean = window_dot(params["q_mu"], vals, start)
        var = (
            kernel.variance
            - window_quadratic_form(kuu_inv_band, vals, start)
            + window_quadratic_form(sigma_band, vals, start)
        )
        return mean[:, None], var[:, None]

    def predict_log_density(self, params, data):
        Xnew, ynew = data
        _, lik = self._build(params)
        mean, var = self.predict_f(params, Xnew)
        return lik.predict_log_density(
            mean, var, jnp.reshape(jnp.asarray(ynew), mean.shape)
        )


def fit_svgp(model: SVGP1D, X, y, params, *, batch_size=1024, steps=2000,
             learning_rate=1e-3, seed=0, chunk=2000):
    """Minibatch Adam training of the SVGP (jitted lax.scan loop).

    ``learning_rate`` defaults to 1e-3 = the reference baseline's
    ``tf.optimizers.Adam()`` default (electricity.py:57); at the reference
    protocol's batch of 100, 1e-2 diverges (NaN within 2000 steps on the
    log-scale precision diagonal — tools/svgp_fault_probe.py).

    ``chunk``: maximum scan length per executable call.  The full 10k-step
    protocol is many minutes of continuous device time in ONE call at
    m=1000; chunking bounds each call at a few minutes with identical math
    (the optimizer state and PRNG key are carried across calls).
    """
    x = jnp.reshape(jnp.asarray(X), (-1,))
    yf = jnp.reshape(jnp.asarray(y), (-1,))
    n = x.shape[0]
    if model.num_data is None:
        model.num_data = int(n)

    if not bool(jnp.any(params["q_prec_corr"])):
        # C = 0 (the prior) is an exact stationary point in C — seed the
        # correction at the Titsias-optimal C* = chol(KufKfu)/σ for the
        # initial hyperparameters (O(N k²) one-time, same sufficient
        # statistic GPR1D precomputes).  Adam then refines around the
        # optimum instead of being stuck at the prior.
        from asvgp.models.parameters import positive
        from asvgp.stats.sufficient import compute_stats

        stats = jax.jit(
            lambda xx, yy: compute_stats(model.basis, xx, yy)
        )(x, yf)
        sigma0 = jnp.sqrt(positive(params["likelihood"]["raw_variance"]))
        band = stats.kufkfu_band
        jitter = 1e-10 * jnp.max(band[0])
        band = band.at[0].add(jitter)
        c0 = banded.cholesky_band(band) / sigma0
        kq = params["q_prec_corr"].shape[0] - 1
        ko = c0.shape[0] - 1
        if kq > ko:
            c0 = jnp.concatenate(
                [c0, jnp.zeros((kq - ko, c0.shape[1]), c0.dtype)], axis=0
            )
        params = {**params, "q_prec_corr": c0[: kq + 1]}

    opt = optax.adam(learning_rate)

    def step(carry, _):
        params, state, key = carry
        key, sub = jax.random.split(key)
        idx = jax.random.randint(sub, (batch_size,), 0, n)
        loss, grads = jax.value_and_grad(model.training_loss)(
            params, x[idx], yf[idx]
        )
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        return (params, state, key), loss

    @partial(jax.jit, static_argnames=("length",))
    def run_chunk(carry, length):
        return jax.lax.scan(step, carry, None, length=length)

    carry = (params, opt.init(params), jax.random.PRNGKey(seed))
    chunks = []
    done = 0
    while done < steps:
        length = min(chunk, steps - done)
        carry, losses = run_chunk(carry, length)
        chunks.append(losses)
        done += length
    return carry[0], jnp.concatenate(chunks)
