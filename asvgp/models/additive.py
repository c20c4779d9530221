"""GPRAdditive — sum of 1-D Matérn GPs over D input dimensions.

Equivalent of the reference ``GPR_additive``
(asvgp/gpr.py:139-236).  Improvements over the reference's implementation:

  * log|Kuu| and the trace term use the *banded* structure of the per-dim
    Kuu blocks (the reference densifies the block-diagonal, gpr.py:185-188);
    only the genuinely dense coupling matrix P is factorized densely.
  * prediction gathers (k+1)-windows of P⁻¹ and the per-dim Takahashi bands
    of Kuu_d⁻¹, O(D² k²) per test point, instead of dense (M, n_test)
    triangular solves (gpr.py:226-232).

The reference's constructor bug of passing the loop-leaked ``kernel`` to
``super().__init__`` (gpr.py:155, SURVEY.md §7.3 item 6) is fixed by
construction: every kernel is carried explicitly.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from asvgp import banded
from asvgp.features.spline_features import make_kuu
from asvgp.models.kernels import Matern
from asvgp.models.likelihoods import Gaussian
from asvgp.models.parameters import positive, positive_inverse
from asvgp.models.gpr1d import window_dot, window_quadratic_form
from asvgp.stats.additive import (
    compute_additive_stats,
    compute_additive_stats_sharded,
)

_LOG2PI = math.log(2.0 * math.pi)

def _dense_p(bases, stats, kuu_bands, sigma2):
    P = stats.kufkfu / sigma2
    for d, kb in enumerate(kuu_bands):
        kd = banded.band_to_dense(
            banded.symmetrise_lower_band(kb), bases[d].order, bases[d].order
        )
        o = sum(b.m for b in bases[:d])
        P = P.at[o:o + bases[d].m, o:o + bases[d].m].add(kd)
    return P


def additive_collapsed_elbo(bases, nu2s, params, stats):
    """Collapsed ELBO of the additive model from its sufficient statistics
    (stats-parameterized so the data-parallel step in parallel/dp.py can
    psum sharded statistics before calling it).  Mirrors the reference
    GPR_additive objective (asvgp/gpr.py:139-236): per-dim banded
    logdet/trace terms, dense only for the genuinely dense coupling P."""
    kernels = [
        Matern(
            variance=positive(p["raw_variance"]),
            lengthscales=positive(p["raw_lengthscales"]),
            nu2=nu2,
        )
        for p, nu2 in zip(params["kernels"], nu2s)
    ]
    lik = Gaussian(variance=positive(params["likelihood"]["raw_variance"]))
    sigma2 = lik.variance
    kuu_bands = [make_kuu(k, b) for k, b in zip(kernels, bases)]
    l_bands = [banded.cholesky_band(kb) for kb in kuu_bands]
    log_det_kuu = sum(banded.log_det_from_cholesky(lb) for lb in l_bands)

    # trace(Kuu⁻¹ KufKfu): Kuu is block-diag ⇒ only the banded diagonal
    # blocks of KufKfu enter, via per-dim Takahashi bands
    trace_term = 0.0
    for d, lb in enumerate(l_bands):
        s_band = banded.takahashi_inverse_band(lb)
        o = sum(b.m for b in bases[:d])
        blk = jax.lax.dynamic_slice(
            stats.kufkfu, (o, o), (bases[d].m, bases[d].m)
        )
        blk_band = banded.dense_to_lower_band(blk, bases[d].order)
        trace_term = trace_term + banded.band_frobenius(s_band, blk_band)

    # the coupling P is dense (M×M): one f64 Cholesky (cuSOLVER on a GPU)
    P = _dense_p(bases, stats, kuu_bands, sigma2)
    L = jnp.linalg.cholesky(P)
    log_det_p = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    c = jsl.solve_triangular(L, stats.kuf_y, lower=True) / sigma2
    total_variance = sum(k.variance for k in kernels)

    elbo = -0.5 * stats.n * (_LOG2PI + jnp.log(sigma2))
    elbo -= 0.5 * log_det_p
    elbo += 0.5 * log_det_kuu
    elbo -= 0.5 * stats.yty / sigma2
    elbo += 0.5 * jnp.sum(jnp.square(c))
    elbo -= 0.5 * stats.n * total_variance / sigma2
    elbo += 0.5 * trace_term / sigma2
    return elbo


class GPRAdditive:
    def __init__(self, data, kernels, bases, *, noise_variance=1.0,
                 mesh=None, axis="data", backend=None):
        import numpy as _np

        X_in, y = data
        X = jnp.asarray(X_in)
        y = jnp.asarray(y)
        if X.ndim != 2 or X.shape[1] != len(bases) or len(kernels) != len(bases):
            raise ValueError(
                "need X of shape (n, D) with one kernel and one basis per dim"
            )
        # host-side domain validation (see gpr1d.py)
        xv = X_in if isinstance(X_in, _np.ndarray) else _np.asarray(X)
        for d, basis in enumerate(bases):
            lo, hi = float(xv[:, d].min()), float(xv[:, d].max())
            if not (lo > basis.a and hi < basis.b):
                raise ValueError(
                    f"dim {d}: inputs must lie strictly inside "
                    f"[{basis.a}, {basis.b}], got [{lo}, {hi}]"
                )
        from asvgp.features.spline_features import validate_kernel_basis

        for k, b in zip(kernels, bases):
            validate_kernel_basis(k, b)
        self.bases = list(bases)
        self.nu2s = [k.nu2 for k in kernels]
        self.kernels_init = list(kernels)
        self.noise_variance_init = noise_variance
        from asvgp.banded import ops as _bops

        _bops.impl_scope(backend)  # validates the name eagerly
        self.backend = backend
        self.D = len(bases)
        self._offsets = [0]
        for b in bases:
            self._offsets.append(self._offsets[-1] + b.m)
        yf = jnp.reshape(y, (-1,))
        if mesh is not None:
            self.stats = compute_additive_stats_sharded(self.bases, X, yf, mesh, axis)
        else:
            self.stats = jax.jit(
                lambda xx, yy: compute_additive_stats(self.bases, xx, yy)
            )(X, yf)

    def init_params(self):
        # host-side softplus-inverse + one batched device_put
        from asvgp.models.parameters import positive_inverse_host as inv
        from asvgp.utils import exec_cache as _ec

        params = {
            "kernels": [
                {
                    "raw_variance": inv(k.variance),
                    "raw_lengthscales": inv(k.lengthscales),
                }
                for k in self.kernels_init
            ],
            "likelihood": {"raw_variance": inv(self.noise_variance_init)},
        }
        dev = _ec.init_device(self.stats)
        return jax.device_put(params, dev) if dev is not None else params

    def _build(self, params):
        kernels = [
            Matern(
                variance=positive(p["raw_variance"]),
                lengthscales=positive(p["raw_lengthscales"]),
                nu2=nu2,
            )
            for p, nu2 in zip(params["kernels"], self.nu2s)
        ]
        lik = Gaussian(variance=positive(params["likelihood"]["raw_variance"]))
        return kernels, lik

    def _dense_p(self, kuu_bands, sigma2):
        return _dense_p(self.bases, self.stats, kuu_bands, sigma2)

    def elbo(self, params):
        from asvgp.banded import ops as _bops

        with _bops.impl_scope(self.backend):
            return additive_collapsed_elbo(
                self.bases, self.nu2s, params, self.stats
            )

    def _elbo_inner(self, params):
        return additive_collapsed_elbo(
            self.bases, self.nu2s, params, self.stats
        )

    def maximum_log_likelihood_objective(self, params):
        return self.elbo(params)

    def training_loss(self, params):
        return -self.elbo(params)

    def predict_f(self, params, Xnew, full_cov: bool = False):
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        from asvgp.banded import ops as _bops

        with _bops.impl_scope(self.backend):
            if not hasattr(self, "_predict_jit"):
                self._predict_jit = jax.jit(self._predict_f_inner)
            return self._predict_jit(params, jnp.asarray(Xnew))

    def _predict_f_inner(self, params, Xnew):
        kernels, lik = self._build(params)
        sigma2 = lik.variance
        kuu_bands = [make_kuu(k, b) for k, b in zip(kernels, self.bases)]
        l_bands = [banded.cholesky_band(kb) for kb in kuu_bands]
        s_bands = [banded.takahashi_inverse_band(lb) for lb in l_bands]

        P = self._dense_p(kuu_bands, sigma2)
        L = jnp.linalg.cholesky(P)
        w = jsl.cho_solve((L, True), self.stats.kuf_y) / sigma2
        Pinv = jsl.cho_solve((L, True), jnp.eye(P.shape[0], dtype=P.dtype))

        x = jnp.asarray(Xnew)
        evals = [b.evaluate_basis(x[:, d], dx=0) for d, b in enumerate(self.bases)]
        n = x.shape[0]

        mean = jnp.zeros((n,), P.dtype)
        quad_p = jnp.zeros((n,), P.dtype)
        quad_kuu = jnp.zeros((n,), P.dtype)
        idxs = []
        for d, (v, c) in enumerate(evals):
            kp1 = v.shape[1]
            idx = self._offsets[d] + c[:, None] + jnp.arange(kp1, dtype=c.dtype)
            idxs.append(idx)
            mean = mean + jnp.sum(v * w[idx], axis=1)
            quad_kuu = quad_kuu + window_quadratic_form(s_bands[d], v, c)
        for d in range(self.D):
            vd, _ = evals[d]
            for e in range(self.D):
                ve, _ = evals[e]
                win = Pinv[idxs[d][:, :, None], idxs[e][:, None, :]]
                quad_p = quad_p + jnp.einsum("na,nab,nb->n", vd, win, ve)

        kdiag = sum(k.variance for k in kernels)
        var = kdiag + quad_p - quad_kuu
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
