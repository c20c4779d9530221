"""GPRKron — tensor-product (Kronecker) spline features for D>=2 inputs.

Equivalent of the reference ``GPR_kron`` (asvgp/gpr.py:239-359),
with the structure the reference leaves on the table (SURVEY.md §3.4): the
reference densifies Kuu and P to m^d x m^d (utils.py:45-51, gpr.py:272,
292-293) — an O(m^6) dense Cholesky for d=2.  Here everything stays
factorized/banded:

  log|Kuu|   — per-factor banded Cholesky + Kronecker determinant identity
  trace term — per-factor Takahashi bands against the Kronecker multiband
               of KufKfu (stats/kron.py), fully elementwise
  P          — block-banded (block = i1, bandwidth k1): blocked Cholesky,
               O(m1 k1² m2³) instead of O((m1 m2)³)
  predict    — block-Takahashi band of P⁻¹ + per-point windowed gathers,
               O((k+1)⁴) per test point; replaces both reference predict
               paths (dense gpr.py:310-334 and CHOLMOD gpr.py:336-359)
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from asvgp import banded
from asvgp.banded import block
from asvgp.features.spline_features import make_kuu
from asvgp.models.kernels import Matern
from asvgp.models.likelihoods import Gaussian
from asvgp.models.parameters import positive, positive_inverse
from asvgp.stats.kron import (
    KronStats,
    compute_kron_stats,
    compute_kron_stats_sharded,
    t_band_to_blocks,
    t_band_trace_against_kron,
)

_LOG2PI = math.log(2.0 * math.pi)


def _trailing_dense(bases, kuu_bands):
    """Dense Kronecker product of the trailing (d >= 2) Kuu factors."""
    dense = banded.band_to_dense(
        banded.symmetrise_lower_band(kuu_bands[1]),
        bases[1].order,
        bases[1].order,
    )
    for d in range(2, len(bases)):
        fd = banded.band_to_dense(
            banded.symmetrise_lower_band(kuu_bands[d]),
            bases[d].order,
            bases[d].order,
        )
        dense = jnp.einsum("ab,cd->acbd", dense, fd).reshape(
            dense.shape[0] * fd.shape[0], dense.shape[1] * fd.shape[1]
        )
    return dense


def _p_blocks_from(bases, kuu_bands, sigma2, t_band):
    """Block-banded P = Kuu ⊗ ... + KufKfu/σ² from a multiband T tensor."""
    trailing = _trailing_dense(bases, kuu_bands)
    if len(bases) == 2:
        return t_band_to_blocks(t_band, kuu_bands[0], trailing, sigma2)
    from asvgp.stats.kron_nd import t_band_to_blocks_nd

    return t_band_to_blocks_nd(t_band, kuu_bands[0], trailing, sigma2)


def kron_collapsed_elbo(bases, nu2s, params, stats):
    """Collapsed ELBO from precomputed Kronecker sufficient statistics.

    Factored out of GPRKron so the data-parallel minibatch step
    (parallel/dp.py make_dp_train_step_kron) can evaluate the bound on
    freshly psum-assembled batch statistics; GPRKron.elbo routes here with
    the model's cached full-data stats.  Term-for-term the reference bound
    (asvgp/gpr.py:264-309), but P stays block-banded instead of dense m^d.
    """
    D = len(bases)
    kernels = kron_params_to_kernels(params, nu2s)
    sigma2 = positive(params["likelihood"]["raw_variance"])
    ms = [b.m for b in bases]

    kuu_bands = [make_kuu(k, b) for k, b in zip(kernels, bases)]
    l_bands = [banded.cholesky_band(kb) for kb in kuu_bands]
    # Kronecker determinant identity:
    #   log|⊗_d A_d| = Σ_d (Π_{e≠d} m_e) log|A_d|
    log_det_kuu = sum(
        math.prod(ms) // ms[d] * banded.log_det_from_cholesky(l_bands[d])
        for d in range(D)
    )
    s_bands = [banded.takahashi_inverse_band(lb) for lb in l_bands]
    if D == 2:
        trace_term = t_band_trace_against_kron(
            stats.t_band, s_bands[0], s_bands[1]
        )
    else:
        from asvgp.stats.kron_nd import t_band_trace_against_kron_nd

        trace_term = t_band_trace_against_kron_nd(stats.t_band, s_bands)

    p_blocks = _p_blocks_from(bases, kuu_bands, sigma2, stats.t_band)
    l_p = block.cholesky_block_banded(p_blocks)
    log_det_p = block.log_det_from_block_cholesky(l_p)
    c = block.solve_lower_block_banded(l_p, stats.kuf_y) / sigma2

    kdiag_sum = stats.n * math.prod(k.variance for k in kernels)

    elbo = -0.5 * stats.n * (_LOG2PI + jnp.log(sigma2))
    elbo -= 0.5 * log_det_p
    elbo += 0.5 * log_det_kuu
    elbo -= 0.5 * stats.yty / sigma2
    elbo += 0.5 * jnp.sum(jnp.square(c))
    elbo -= 0.5 * kdiag_sum / sigma2
    elbo += 0.5 * trace_term / sigma2
    return elbo


def kron_params_to_kernels(params, nu2s):
    return [
        Matern(
            variance=positive(p["raw_variance"]),
            lengthscales=positive(p["raw_lengthscales"]),
            nu2=nu2,
        )
        for p, nu2 in zip(params["kernels"], nu2s)
    ]


@partial(jax.jit, static_argnums=0)
def _kron_stats_jit(bases, x, yy):
    return compute_kron_stats(list(bases), x, yy)


@partial(jax.jit, static_argnums=0)
def _kron_stats_nd_jit(bases, x, yy):
    from asvgp.stats.kron_nd import compute_kron_stats_nd

    return compute_kron_stats_nd(list(bases), x, yy)


class GPRKron:
    """D-dimensional ASVGP regression with tensor-product B-spline inducing
    features.  D=2 is the flagship (eNATL60) path; D>=3 routes through the
    generic-D statistics in stats/kron_nd.py (block-banded P with the
    trailing dims flattened dense — the reference is unusable past D=2, see
    stats/kron_nd.py docstring for the scaling envelope)."""

    def __init__(self, data, kernels, bases, *, noise_variance=1.0,
                 mesh=None, axis="data", backend=None,
                 timings: dict | None = None):
        import numpy as _np

        X_in, y = data
        X = jnp.asarray(X_in)
        y = jnp.asarray(y)
        if X.ndim != 2 or X.shape[1] < 2:
            raise ValueError("GPRKron requires inputs of shape (n, D) with D >= 2")
        D = X.shape[1]
        if len(kernels) != D or len(bases) != D:
            raise ValueError("need one kernel and one basis per input dimension")
        # host-side domain validation (see gpr1d.py)
        xv = X_in if isinstance(X_in, _np.ndarray) else _np.asarray(X)
        for d, basis in enumerate(bases):
            lo = float(xv[:, d].min())
            hi = float(xv[:, d].max())
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
        self.D = D
        yf = jnp.reshape(y, (-1,))
        # exec-cached stats build (like GPR1D): the in-process memo dedupes
        # retraces across model constructions, and with ASVGP_EXEC_CACHE_DIR
        # set a warm process skips trace+compile of the pair-product build
        from asvgp.utils import exec_cache as _ec

        btag = "-".join(
            f"o{b.order}m{b.m}r{b.a!r}:{b.b!r}" for b in self.bases
        )
        if D == 2:
            if mesh is not None:
                self.stats = compute_kron_stats_sharded(self.bases, X, yf, mesh, axis)
            else:
                compiled = _ec.cached_compile(
                    _kron_stats_jit, (tuple(self.bases),), (X, yf),
                    tag=f"statskron-{btag}",
                    device=_ec.params_device((X, yf)), timings=timings,
                )
                self.stats = compiled(X, yf)
        else:
            from asvgp.stats.kron_nd import (
                compute_kron_stats_nd,
                compute_kron_stats_nd_sharded,
            )

            if mesh is not None:
                self.stats = compute_kron_stats_nd_sharded(
                    self.bases, X, yf, mesh, axis
                )
            else:
                compiled = _ec.cached_compile(
                    _kron_stats_nd_jit, (tuple(self.bases),), (X, yf),
                    tag=f"statskronnd-{btag}",
                    device=_ec.params_device((X, yf)), timings=timings,
                )
                self.stats = compiled(X, yf)

    # ---- parity helpers ----------------------------------------------------
    @property
    def bandwidth(self) -> int:
        """Joint scalar bandwidth of P under row-major flattening (reference
        computes the equal-m special case at asvgp/gpr.py:262); informational
        — we use the block-banded form."""
        bw = 0
        for d in range(self.D):
            trailing = math.prod(b.m for b in self.bases[d + 1:])
            bw += self.bases[d].order * trailing
        return bw

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
        kernels = kron_params_to_kernels(params, self.nu2s)
        lik = Gaussian(variance=positive(params["likelihood"]["raw_variance"]))
        return kernels, lik

    # ---- ELBO ---------------------------------------------------------------
    def _factor_bands(self, kernels):
        return [make_kuu(k, b) for k, b in zip(kernels, self.bases)]

    def _trailing_dense(self, kuu_bands):
        return _trailing_dense(self.bases, kuu_bands)

    def _p_blocks(self, kuu_bands, sigma2, t_band=None):
        t_band = self.stats.t_band if t_band is None else t_band
        return _p_blocks_from(self.bases, kuu_bands, sigma2, t_band)

    def elbo(self, params):
        from asvgp.banded import ops as _bops

        with _bops.impl_scope(self.backend):
            return self._elbo_inner(params)

    def _elbo_inner(self, params):
        return kron_collapsed_elbo(self.bases, self.nu2s, params, self.stats)

    def maximum_log_likelihood_objective(self, params):
        return self.elbo(params)

    def training_loss(self, params):
        return -self.elbo(params)

    def loss_args(self):
        """(pure_loss, data_args, key_tag) for ``fit_lbfgs(data_args=...)``
        — see GPR1D.loss_args.  The statistics (t_band is the big one) are
        explicit arguments; basis tables / nu2s / backend are baked into
        the executable and folded into key_tag."""
        bases, nu2s, backend = self.bases, self.nu2s, self.backend
        from asvgp.banded import ops as _bops
        from asvgp.models.gpr1d import _basis_tag

        def pure_loss(params, kuf_y, t_band, yty, n):
            with _bops.impl_scope(backend):
                stats = KronStats(kuf_y=kuf_y, t_band=t_band, yty=yty, n=n)
                return -kron_collapsed_elbo(bases, nu2s, params, stats)

        s = self.stats
        tag = "kron-" + "-".join(
            f"{_basis_tag(b)}nu{nu}" for b, nu in zip(bases, nu2s)
        ) + f"-be{backend}"
        return pure_loss, (s.kuf_y, s.t_band, s.yty, s.n), tag

    # ---- prediction -----------------------------------------------------------
    def posterior(self, params) -> "PosteriorKron":
        """Factor once, predict many (mirrors GPR1D.posterior): the block-
        banded factorization, posterior mean weights and block-Takahashi
        band are computed once and cached in the returned object."""
        from asvgp.banded import ops as _bops

        with _bops.impl_scope(self.backend):
            return self._posterior_inner(params)

    def _posterior_arrays(self, params, t_band, kuf_y):
        kernels, lik = self._build(params)
        sigma2 = lik.variance
        m1 = self.bases[0].m

        kuu_bands = self._factor_bands(kernels)
        l_bands = [banded.cholesky_band(kb) for kb in kuu_bands]
        s_bands = [banded.takahashi_inverse_band(lb) for lb in l_bands]

        p_blocks = self._p_blocks(kuu_bands, sigma2, t_band=t_band)
        l_p = block.cholesky_block_banded(p_blocks)
        w = block.cholesky_solve_block_banded(l_p, kuf_y) / sigma2
        w_flat = w.reshape(m1, -1)  # (m1, Π_{d>=2} m_d)
        sp = block.takahashi_inverse_block_banded(l_p)  # (k1+1, m1, M2, M2)
        return w_flat, sp, tuple(s_bands)

    def _cache_tag(self, what: str) -> str:
        from asvgp.models.gpr1d import _basis_tag

        return "-".join(
            [what, f"D{self.D}"]
            + [_basis_tag(b) for b in self.bases]
            + [f"nu{'.'.join(map(str, self.nu2s))}", f"be{self.backend}"]
        )

    def _posterior_inner(self, params) -> "PosteriorKron":
        from asvgp.utils import exec_cache as _ec

        kernels, lik = self._build(params)
        # jit with the sufficient statistics as ARGUMENTS (not closure
        # constants): keeps the cache keys independent of the data values
        # and the executable free of embedded MB constants.  Compiled via
        # the cross-process executable cache (ASVGP_EXEC_CACHE_DIR).
        if not hasattr(self, "_post_jit"):
            self._post_jit = jax.jit(self._posterior_arrays)
        dyn = (params, self.stats.t_band, self.stats.kuf_y)
        compiled = _ec.cached_compile(
            self._post_jit, (), dyn,
            tag=self._cache_tag("kronpost"),
            device=_ec.params_device(dyn),
        )
        w_flat, sp, s_bands = compiled(*dyn)
        return PosteriorKron(kernels, lik, self.bases, w_flat, sp, s_bands,
                             cache_tag=self._cache_tag("kronpred"))

    def predict_f(self, params, Xnew, full_cov: bool = False):
        return self.posterior(params).predict_f(Xnew, full_cov=full_cov)

    # unified efficient path replaces the reference's separate sparse predictor
    predict_f_sparse = predict_f

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


class PosteriorKron:
    """Cached GPRKron posterior (block factorization done once at
    construction; predictions are windowed gathers, O(Π(k_d+1)²) per point)."""

    def __init__(self, kernels, lik, bases, w_flat, sp, s_bands,
                 cache_tag: str = "kronpred"):
        self.kernels = kernels
        self.likelihood = lik
        self.bases = bases
        self.w_flat = w_flat  # (m1, Π_{d>=2} m_d)
        self.sp = sp
        self.s_bands = tuple(s_bands)
        self.cache_tag = cache_tag

    def predict_f(self, Xnew, full_cov: bool = False):
        from asvgp.utils import exec_cache as _ec

        if full_cov:
            raise NotImplementedError("full_cov prediction is not implemented")
        # jit over the posterior arrays as arguments (stable cache key, no
        # embedded constants); the basis tables closed over are small and
        # value-stable.  Cross-process executable cache as in
        # GPRKron._posterior_inner (eNATL first-predict was 60 s of
        # compile for 1.3 s of math).
        if not hasattr(self, "_predict_jit"):
            self._predict_jit = jax.jit(self._predict_arrays)
        kdiag = math.prod(k.variance for k in self.kernels)
        dyn = (jnp.asarray(Xnew), self.w_flat, self.sp, self.s_bands, kdiag)
        compiled = _ec.cached_compile(
            self._predict_jit, (), dyn,
            tag=self.cache_tag,
            device=_ec.params_device(dyn),
        )
        return compiled(*dyn)

    def _predict_arrays(self, x, w_flat, sp, s_bands, kdiag):
        from asvgp.models.gpr1d import window_quadratic_form

        bases = self.bases
        k1 = bases[0].order

        v1, c1 = bases[0].evaluate_basis(x[:, 0], dx=0)
        n = v1.shape[0]
        r1 = c1[:, None] + jnp.arange(k1 + 1, dtype=c1.dtype)[None, :]  # (n, k1+1)

        # kusᵀ Kuu⁻¹ kus = Π_d (per-dim window quadratic forms); meanwhile
        # build the flattened trailing window: indices r_t (n, T) into the
        # row-major Π_{d>=2} m_d axis and values v_t (n, T), T = Π(k_d+1)
        q_prod = window_quadratic_form(s_bands[0], v1, c1)
        v_t = r_t = None
        for d in range(1, len(bases)):
            vd, cd = bases[d].evaluate_basis(x[:, d], dx=0)
            kd = bases[d].order
            rd = cd[:, None] + jnp.arange(kd + 1, dtype=cd.dtype)[None, :]
            q_prod = q_prod * window_quadratic_form(s_bands[d], vd, cd)
            if v_t is None:
                v_t, r_t = vd, rd
            else:
                r_t = (r_t[:, :, None] * bases[d].m + rd[:, None, :]).reshape(n, -1)
                v_t = (v_t[:, :, None] * vd[:, None, :]).reshape(n, -1)

        # mean = Σ v1[s1] v_t[t] w[c1+s1, r_t[t]]
        w_win = w_flat[r1[:, :, None], r_t[:, None, :]]  # (n, k1+1, T)
        mean = jnp.einsum("na,nat,nt->n", v1, w_win, v_t)

        # kusᵀ P⁻¹ kus via block-Takahashi windows
        quad_p = jnp.zeros((n,), v1.dtype)
        for d in range(k1 + 1):
            mult = 1.0 if d == 0 else 2.0
            sp_d = sp[d]  # (m1, M2, M2)
            for s1 in range(k1 + 1 - d):
                j1 = c1 + s1
                win = sp_d[
                    j1[:, None, None],
                    r_t[:, :, None],
                    r_t[:, None, :],
                ]  # (n, T, T) — block (c1+s1+d, c1+s1) window
                val = jnp.einsum("nt,ntu,nu->n", v_t, win, v_t)
                quad_p = quad_p + mult * v1[:, s1 + d] * v1[:, s1] * val

        var = kdiag + quad_p - q_prod
        return mean[:, None], var[:, None]

    def predict_y(self, Xnew):
        mean, var = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(mean, var)

    def predict_log_density(self, data):
        Xnew, ynew = data
        mean, var = self.predict_f(Xnew)
        return self.likelihood.predict_log_density(
            mean, var, jnp.reshape(jnp.asarray(ynew), mean.shape)
        )
