"""GPR1D — the flagship 1-D banded ASVGP regression model.

Equivalent of the reference ``GPR_1d`` (asvgp/gpr.py:18-136).
The collapsed (Titsias/SGPR) ELBO is computed entirely in banded arithmetic,
O(m·k²) per evaluation independent of N; the data enter only through the
sufficient statistics computed once at construction (and reducible over a
device mesh — see stats/sufficient.py).

Prediction is *algorithmically improved* over the reference: instead of
CHOLMOD sparse solves against an (m, n_test) right-hand side
(reference asvgp/gpr.py:91-136, O(m·k·n_test) memory-heavy), we use the
locality of Kus: each test point touches only a (k+1)-window of the band of
P⁻¹ and Kuu⁻¹ (both exact via the Takahashi recursion), so

  mean_i = kus_iᵀ (P⁻¹ Kuf y)/σ²              — one banded solve, O(m k)
  var_i  = σ_f² + kus_iᵀ (P⁻¹ − Kuu⁻¹) kus_i   — banded gathers, O(k²) per pt

This is mathematically identical to the reference's predictor (same q(u))
but runs as fully-vectorized gathers with no per-batch factorization
and no remainder-dropping 10k-chunk loop (reference quirk at gpr.py:130-134,
fixed here; SURVEY.md §7.3 item 6).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from asvgp import banded
from asvgp.basis.splines import BSplineBasis
from asvgp.features.spline_features import make_kuf, make_kuu
from asvgp.models.kernels import Matern
from asvgp.models.likelihoods import Gaussian
from asvgp.models.parameters import positive, positive_inverse
from asvgp.stats.sufficient import (
    SufficientStats,
    compute_stats,
    compute_stats_sharded,
)

_LOG2PI = math.log(2.0 * math.pi)


def params_to_kernel(params, nu2: int) -> Matern:
    return Matern(
        variance=positive(params["kernel"]["raw_variance"]),
        lengthscales=positive(params["kernel"]["raw_lengthscales"]),
        nu2=nu2,
    )


def params_to_likelihood(params) -> Gaussian:
    return Gaussian(variance=positive(params["likelihood"]["raw_variance"]))


def default_params(kernel: Matern, noise_variance=1.0):
    # host-side math (parameters.positive_inverse_host): no chain of tiny
    # eager device ops; callers device_put the pytree in one batch
    from asvgp.models.parameters import positive_inverse_host as inv

    return {
        "kernel": {
            "raw_variance": inv(kernel.variance),
            "raw_lengthscales": inv(kernel.lengthscales),
        },
        "likelihood": {"raw_variance": inv(noise_variance)},
    }


def collapsed_elbo_banded(stats: SufficientStats, kuu_band, sigma2, kdiag_sum):
    """The collapsed ELBO from banded Kuu + sufficient statistics.

    Mirrors reference asvgp/gpr.py:49-89 term by term, with the trace
    computed as a banded Frobenius product (see banded.band_frobenius).
    """
    p_band = stats.kufkfu_band / sigma2 + kuu_band
    # the whole banded portion in one call (banded.collapsed_core routes it)
    log_det_kuu, log_det_p, quad, trace_term = banded.collapsed_core(
        kuu_band, p_band, stats.kuf_y, stats.kufkfu_band
    )

    elbo = -0.5 * stats.n * (_LOG2PI + jnp.log(sigma2))
    elbo -= 0.5 * log_det_p
    elbo += 0.5 * log_det_kuu
    elbo -= 0.5 * stats.yty / sigma2
    elbo += 0.5 * quad / (sigma2 * sigma2)
    elbo -= 0.5 * kdiag_sum / sigma2
    elbo += 0.5 * trace_term / sigma2
    return elbo


def collapsed_elbo_matern(stats: SufficientStats, basis, nu2, var, ell,
                          sigma2, kdiag_sum):
    """As ``collapsed_elbo_banded`` but with the Matérn θ-structure exposed
    to the banded core: on the "sweep" route the trace term's gradient
    runs as a fused forward-mode direction inside the two primal sweeps
    (banded/sweep.py) and the whole backward is elementwise."""

    def kuu_fn(v, l):
        return make_kuu(Matern.tree_unflatten((nu2,), (v, l)), basis)

    p_band = stats.kufkfu_band / sigma2 + kuu_fn(var, ell)
    log_det_kuu, log_det_p, quad, trace_term = banded.collapsed_core_matern(
        kuu_fn, var, ell, p_band, stats.kuf_y, stats.kufkfu_band
    )
    elbo = -0.5 * stats.n * (_LOG2PI + jnp.log(sigma2))
    elbo -= 0.5 * log_det_p
    elbo += 0.5 * log_det_kuu
    elbo -= 0.5 * stats.yty / sigma2
    elbo += 0.5 * quad / (sigma2 * sigma2)
    elbo -= 0.5 * kdiag_sum / sigma2
    elbo += 0.5 * trace_term / sigma2
    return elbo


def _basis_tag(basis) -> str:
    """Stable string identifying a basis for executable cache keys (the
    tables are deterministic in (order, m, a, b))."""
    return f"o{basis.order}m{basis.m}r{basis.a!r}:{basis.b!r}"


@partial(jax.jit, static_argnums=0)
def _stats_jit(basis, x, yy):
    return compute_stats(basis, x, yy)


def window_quadratic_form(band, vals, start):
    """q_i = kus_iᵀ M kus_i where M is symmetric with lower band ``band`` and
    kus_i is supported on rows start_i .. start_i + k.

    q_i = Σ_s v_s² M[0, start+s] + 2 Σ_{j>=1} Σ_s v_s v_{s+j} M[j, start+s].
    """
    kp1 = vals.shape[1]
    s_idx = start[:, None] + jnp.arange(kp1, dtype=start.dtype)[None, :]
    q = jnp.sum(jnp.square(vals) * band[0][s_idx], axis=1)
    for j in range(1, kp1):
        w = vals[:, : kp1 - j] * vals[:, j:]
        q = q + 2.0 * jnp.sum(w * band[j][s_idx[:, : kp1 - j]], axis=1)
    return q


def window_dot(vec, vals, start):
    """d_i = kus_iᵀ vec (windowed sparse dot)."""
    kp1 = vals.shape[1]
    idx = start[:, None] + jnp.arange(kp1, dtype=start.dtype)[None, :]
    return jnp.sum(vals * vec[idx], axis=1)


@partial(jax.jit, static_argnames=("basis", "nu2", "backend"))
def _posterior_core(basis, nu2, backend, kufkfu_band, kuf_y, var, ell,
                    sigma2):
    """One jitted posterior factorization (module-level → trace shared
    across models/processes via the jit + persistent caches).  Both
    Takahashi bands and the posterior mean weights come out of one
    banded.banded_posterior call."""
    from asvgp.banded import ops as _bops

    with _bops.impl_scope(backend):
        kernel = Matern.tree_unflatten((nu2,), (var, ell))
        kuu = make_kuu(kernel, basis)
        p_band = kufkfu_band / sigma2 + kuu
        kuu_inv_band, p_inv_band, u = banded.banded_posterior(
            kuu, p_band, kuf_y
        )
        return u / sigma2, p_inv_band - kuu_inv_band


@partial(jax.jit, static_argnames=("basis",))
def _predict_chunk(basis, w, diff_band, variance, x):
    """One jitted windowed-gather predict over a chunk of test points.

    Module-level so its trace (and persistent-cache executable) is shared
    across every Posterior1D / model / call site with the same basis and
    chunk shape, instead of one eager dispatch per op."""
    vals, start = make_kuf(basis, x)
    mean = window_dot(w, vals, start)
    var = variance + window_quadratic_form(diff_band, vals, start)
    return mean, var


@jax.jit
def _log_density(lik, mean, var, y):
    return lik.predict_log_density(mean, var, y)


class Posterior1D:
    """Cached GPR1D posterior: the banded factorizations are done ONCE at
    construction; every ``predict_f`` call afterwards is pure windowed
    gathers, O(k²) per test point.  (The reference re-factorizes inside
    every ``predict_f`` call — asvgp/gpr.py:94-108; so did our round-1
    ``GPR1D.predict_f``, which now routes through this object.)"""

    def __init__(self, kernel, lik, basis, w, diff_band):
        self.kernel = kernel
        self.likelihood = lik
        self.basis = basis
        self.w = w
        self.diff_band = diff_band

    def predict_f(self, Xnew, full_cov: bool = False, batch: int | None = None):
        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        x = jnp.reshape(Xnew, (-1,))

        def chunk_predict(xc):
            from asvgp.utils import exec_cache as _ec

            dyn = (self.w, self.diff_band, self.kernel.variance, xc)
            compiled = _ec.cached_compile(
                _predict_chunk, (self.basis,), dyn,
                tag=f"pred1d-{_basis_tag(self.basis)}",
                device=_ec.params_device(dyn),
            )
            return compiled(*dyn)

        if not batch or x.shape[0] <= batch:
            mean, var = chunk_predict(x)
            return mean[:, None], var[:, None]

        # pad the remainder chunk to the batch size (ONE compiled chunk
        # shape — no per-remainder retrace), then cut.  Unlike the reference
        # the remainder points are NOT dropped (gpr.py:130-134 quirk).
        n = x.shape[0]
        n_pad = (-n) % batch
        xp = jnp.pad(
            x, (0, n_pad),
            constant_values=0.5 * (self.basis.a + self.basis.b),
        )
        means, vars_ = [], []
        for lo in range(0, n + n_pad, batch):
            mc, vc = chunk_predict(xp[lo:lo + batch])
            means.append(mc)
            vars_.append(vc)
        return (
            jnp.concatenate(means)[:n, None],
            jnp.concatenate(vars_)[:n, None],
        )

    def predict_y(self, Xnew):
        mean, var = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(mean, var)

    def predict_log_density(self, data):
        Xnew, ynew = data
        mean, var = self.predict_f(Xnew)
        return _log_density(
            self.likelihood, mean, var,
            jnp.reshape(jnp.asarray(ynew), mean.shape),
        )


class GPR1D:
    """1-D ASVGP regression with B-spline inducing features.

    Functional-JAX surface: hyperparameters live in a separate ``params``
    pytree (unconstrained); all methods taking ``params`` are pure and
    jittable.  Construction performs the one-time O(N k²) sufficient-
    statistic precompute on device (optionally sharded over a mesh).
    """

    def __init__(self, data, kernel: Matern, basis: BSplineBasis, *,
                 noise_variance=1.0, mesh=None, axis="data", dtype=None,
                 backend=None, timings: dict | None = None):
        import numpy as _np

        X_in, y = data
        X = jnp.asarray(X_in)
        y = jnp.asarray(y)
        if X.ndim == 2:
            if X.shape[1] != 1:
                raise ValueError("GPR1D requires 1-D inputs of shape (n,) or (n, 1)")
            X = X[:, 0]
        yf = jnp.reshape(y, (-1,))
        if X.shape[0] != yf.shape[0]:
            raise ValueError("X and y must have the same number of points")
        # domain check (reference asserts a < X < b, gpr.py:25-26) —
        # host-side when the caller passed host data (no eager device
        # reductions at N=1e6)
        xv = X_in if isinstance(X_in, _np.ndarray) else _np.asarray(X)
        xmin, xmax = float(xv.min()), float(xv.max())
        if not (xmin > basis.a and xmax < basis.b):
            raise ValueError(
                f"all inputs must lie strictly inside [{basis.a}, {basis.b}], "
                f"got range [{xmin}, {xmax}]"
            )
        from asvgp.features.spline_features import validate_kernel_basis

        validate_kernel_basis(kernel, basis)
        self.basis = basis
        self.nu2 = kernel.nu2
        self.kernel_init = kernel
        self.noise_variance_init = noise_variance
        # explicit banded-op backend: overrides the ambient platform
        # sniffing under ANY device context (banded/ops.py impl_scope)
        from asvgp.banded import ops as _bops

        _bops.impl_scope(backend)  # validates the name eagerly
        self.backend = backend
        if mesh is not None:
            self.stats = compute_stats_sharded(basis, X, yf, mesh, axis)
        else:
            # exec-cached stats build: the in-process memo dedupes the
            # retrace across model constructions (the refit/steady regime
            # builds a model per split), and with ASVGP_EXEC_CACHE_DIR set
            # a warm process skips trace+compile entirely (``timings``
            # records the trace/load split like fit_lbfgs)
            from asvgp.utils import exec_cache as _ec

            compiled = _ec.cached_compile(
                _stats_jit, (basis,), (X, yf),
                tag=f"stats1d-{_basis_tag(basis)}",
                device=_ec.params_device((X, yf)),
                timings=timings,
            )
            self.stats = compiled(X, yf)
        # optional compute dtype for the training/prediction hot path; stats
        # are always *accumulated* at input precision, then cast once
        self.dtype = dtype
        if dtype is not None:
            self.stats = jax.tree.map(lambda a: a.astype(dtype), self.stats)

    # ---- parameters -------------------------------------------------------
    def init_params(self):
        params = default_params(self.kernel_init, self.noise_variance_init)
        if self.dtype is not None:
            params = jax.tree.map(lambda a: a.astype(self.dtype), params)
        # one batched transfer onto the model's device (host-side values —
        # see default_params); keeps the committed-device platform correct
        # for fit_lbfgs's executable-cache keys
        from asvgp.utils import exec_cache as _ec

        dev = _ec.init_device(self.stats)
        return jax.device_put(params, dev) if dev is not None else params

    def _build(self, params):
        return params_to_kernel(params, self.nu2), params_to_likelihood(params)

    # ---- training objective ------------------------------------------------
    def elbo(self, params):
        from asvgp.banded import ops as _bops

        with _bops.impl_scope(self.backend):
            kernel, lik = self._build(params)
            kdiag_sum = self.stats.n * kernel.variance  # Σ K_diag for Matérn
            return collapsed_elbo_matern(
                self.stats, self.basis, self.nu2,
                kernel.variance, kernel.lengthscales,
                lik.variance, kdiag_sum,
            )

    def maximum_log_likelihood_objective(self, params):
        return self.elbo(params)

    def training_loss(self, params):
        return -self.elbo(params)

    def loss_args(self):
        """(pure_loss, data_args, key_tag) for ``fit_lbfgs(data_args=...)``:
        ``pure_loss(params, *data_args) == training_loss(params)`` with the
        sufficient statistics as explicit arguments, so a warm process can
        load the compiled fit loop from disk WITHOUT paying the 60-75 s
        closure-hoist loss trace.  Everything else the loss structure
        depends on (basis tables, nu2, backend, dtype) is baked into the
        executable, so it is folded into key_tag."""
        basis, nu2, backend = self.basis, self.nu2, self.backend
        from asvgp.banded import ops as _bops

        def pure_loss(params, kufkfu_band, kuf_y, yty, n):
            with _bops.impl_scope(backend):
                kernel = params_to_kernel(params, nu2)
                lik = params_to_likelihood(params)
                stats = SufficientStats(
                    kuf_y=kuf_y, kufkfu_band=kufkfu_band, yty=yty, n=n
                )
                kdiag_sum = n * kernel.variance
                return -collapsed_elbo_matern(
                    stats, basis, nu2, kernel.variance, kernel.lengthscales,
                    lik.variance, kdiag_sum,
                )

        s = self.stats
        tag = f"gpr1d-{_basis_tag(basis)}-nu{nu2}-be{backend}-dt{self.dtype}"
        return pure_loss, (s.kufkfu_band, s.kuf_y, s.yty, s.n), tag

    # ---- prediction ---------------------------------------------------------
    def _posterior_bands(self, params):
        from asvgp.utils import exec_cache as _ec

        kernel, lik = self._build(params)
        dyn = (
            self.stats.kufkfu_band, self.stats.kuf_y,
            kernel.variance, kernel.lengthscales, lik.variance,
        )
        # compiled via the cross-process executable cache (when
        # ASVGP_EXEC_CACHE_DIR is set): a warm process skips the posterior
        # factorization's trace and compile
        compiled = _ec.cached_compile(
            _posterior_core, (self.basis, self.nu2, self.backend), dyn,
            tag=f"post1d-{_basis_tag(self.basis)}-nu{self.nu2}-be{self.backend}",
            device=_ec.params_device(dyn),
        )
        w, diff_band = compiled(*dyn)
        return kernel, w, diff_band

    def posterior(self, params) -> Posterior1D:
        """Factor once, predict many: returns a cached posterior object."""
        _, lik = self._build(params)
        kernel, w, diff_band = self._posterior_bands(params)
        return Posterior1D(kernel, lik, self.basis, w, diff_band)

    def predict_f(self, params, Xnew, full_cov: bool = False, batch: int | None = None):
        """Posterior mean and marginal variance at Xnew.

        ``full_cov`` is not implemented, matching the reference
        (asvgp/gpr.py:112-113 raises NotImplementedError).  ``batch``
        optionally chunks the test points (reference parity with
        gpr.py:122-136, but the remainder chunk is NOT dropped here —
        SURVEY.md §7.3 item 6); with the windowed O(k²)/point predictor
        chunking is rarely needed.
        """
        return self.posterior(params).predict_f(
            Xnew, full_cov=full_cov, batch=batch
        )

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
