"""Core banded linear-algebra ops (scan-based, differentiable).

Replacements for the reference's C++ ``banded_matrices`` custom ops with
registered gradients (reference call sites: asvgp/gpr.py:56-75):

  cholesky_band             <- banded.cholesky_band
  takahashi_inverse_band    <- banded.inverse_from_cholesky_band
  product_band_band         <- banded.product_band_band
  solve_lower_band          <- banded.solve_triang_mat
  band_frobenius            <- the (result bandwidth 0) product + reduce_sum
                               trace trick at asvgp/gpr.py:60-70

Sequential recursions (Cholesky, triangular solves, Takahashi) run as
``lax.scan`` over the m columns carrying a k-column window; the per-step
work is O(k^2) with k <= 6, so the scan body is tiny.  Band products and
matvecs are *parallel* diagonal convolutions (static shifts), no scan.  Everything is differentiable via
JAX's native scan autodiff; numerical gradient checks live in
tests/test_banded.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from asvgp.banded.layout import mask_band, shift_cols

# Route selection.  Every route is native float64 (or the input dtype):
#   "scan"  — the sequential lax.scan recursions below (the CPU reference);
#   "cr"    — block cyclic reduction (banded/cyclic.py), log depth in m;
#   "sweep" — the fused Pallas/Triton sweeps (banded/sweep.py), Matérn
#             collapsed core and posterior only;
#   "auto"  — the platform's measured choice (_auto_impl).
_IMPL = "auto"
_VALID_IMPLS = ("auto", "scan", "cr", "sweep")
# trace-time scope stack: an explicit backend threaded from a model
# constructor (GPR1D(..., backend=...)) overrides both the global set_impl
# state and the platform default — dispatch is decided while tracing, so a
# context manager around the traced call is sufficient and composes with
# jit caching.
_IMPL_SCOPE: list = []


def set_impl(impl: str) -> None:
    """Select the banded-op route: "auto", "scan", "cr" or "sweep"."""
    global _IMPL
    if impl not in _VALID_IMPLS:
        raise ValueError(f"unknown banded impl {impl!r}")
    _IMPL = impl


class impl_scope:
    """Context manager: force a banded-op route for the enclosed trace.

    ``impl=None`` is a no-op (ambient dispatch).  Nesting is allowed; the
    innermost scope wins."""

    def __init__(self, impl):
        if impl is not None and impl not in _VALID_IMPLS:
            raise ValueError(f"unknown banded impl {impl!r}")
        self.impl = impl

    def __enter__(self):
        if self.impl is not None:
            _IMPL_SCOPE.append(self.impl)
        return self

    def __exit__(self, *exc):
        if self.impl is not None:
            _IMPL_SCOPE.pop()
        return False


def _current_impl() -> str:
    return _IMPL_SCOPE[-1] if _IMPL_SCOPE else _IMPL


def _target_platform() -> str:
    """Best-effort trace-time target platform: honors an active mesh
    (``jax.set_mesh``) or ``jax.default_device(...)`` context, else the
    default backend."""
    try:
        mesh = jax.sharding.get_mesh()
        if mesh is not None and getattr(mesh, "devices", None) is not None:
            devs = list(mesh.devices.flat)
            if devs:
                return devs[0].platform
    except Exception:
        pass
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev.platform
    return jax.default_backend()


def _auto_impl() -> str:
    """The "auto" route for the current target platform."""
    return "scan" if _target_platform() == "cpu" else GPU_IMPL


# the "auto" route on a GPU, chosen from value+grad timings on the card
# (PERF.md, "Kernel decisions")
GPU_IMPL = "sweep"


def _route() -> str:
    impl = _current_impl()
    return _auto_impl() if impl == "auto" else impl


def _use_cr(x) -> bool:
    """Block cyclic reduction for the collapsed core / posterior:
    log depth in m and autodiff end to end (banded/cyclic.py)."""
    return _route() == "cr"


def _use_sweep(x) -> bool:
    """The fused sweep kernels (banded/sweep.py) for the Matérn collapsed
    core and the posterior; they cover bandwidths 1 <= k <= 7."""
    from asvgp.banded import sweep

    return _route() == "sweep" and sweep.supports(x.shape[0] - 1)


def _col_mask(i, k: int, m: int, dtype):
    """Mask (k+1,) of valid band rows for column i: row j valid iff i + j < m."""
    return (i + jnp.arange(k + 1) < m).astype(dtype)


def cholesky_band(a_band: jnp.ndarray) -> jnp.ndarray:
    """Banded Cholesky: lower band of L with A = L L^T.

    Args:
      a_band: (k+1, m) lower band of a symmetric positive-definite matrix.
    Returns:
      (k+1, m) lower band of L, right-padding slots zeroed.
    """
    k = a_band.shape[0] - 1
    m = a_band.shape[1]
    dtype = a_band.dtype

    if k == 0:
        return jnp.sqrt(a_band)

    def step(carry, inp):
        # carry C: (k, k+1), C[p-1, :] = L_band[:, i-p] (zeros if i-p < 0)
        C = carry
        a_col, i = inp
        Cpad = jnp.pad(C, ((0, 0), (0, k)))  # (k, 2k+1)
        # g_p = L[i, i-p] = C[p-1, p]
        # s_j = sum_p g_p * L[i+j, i-p] = sum_p g_p * Cpad[p-1, j+p]
        s = jnp.zeros((k + 1,), dtype)
        for p in range(1, k + 1):
            g_p = C[p - 1, p]
            s = s + g_p * lax.dynamic_slice(Cpad[p - 1], (p,), (k + 1,))
        l0 = jnp.sqrt(a_col[0] - s[0])
        col = jnp.concatenate([l0[None], (a_col[1:] - s[1:]) / l0])
        col = col * _col_mask(i, k, m, dtype)
        C_new = jnp.concatenate([col[None, :], C[:-1]], axis=0)
        return C_new, col

    init = jnp.zeros((k, k + 1), dtype)
    _, cols = lax.scan(step, init, (a_band.T, jnp.arange(m)))
    return cols.T


def log_det_from_cholesky(l_band: jnp.ndarray) -> jnp.ndarray:
    """log|A| = 2 sum_i log L[i, i] given the banded Cholesky factor."""
    return 2.0 * jnp.sum(jnp.log(l_band[0]))


def solve_lower_band(l_band: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L x = b for banded lower-triangular L (forward substitution).

    Args:
      l_band: (k+1, m) lower band of L.
      b: (m,) or (m, r) right-hand side.
    Returns:
      x with the same shape as b.
    """
    k = l_band.shape[0] - 1
    m = l_band.shape[1]
    dtype = l_band.dtype
    vec = b.ndim == 1

    b2 = b[:, None] if vec else b
    r = b2.shape[1]

    if k == 0:
        x = b2 / l_band[0][:, None]
        return x[:, 0] if vec else x

    # G[p-1, i] = L[i, i-p] = l_band[p, i-p]
    G = jnp.stack([shift_cols(l_band[p], -p) for p in range(1, k + 1)], axis=0)

    def step(X, inp):
        # X: (k, r), X[p-1] = x[i-p]
        g_col, l0, b_row = inp
        s = jnp.sum(g_col[:, None] * X, axis=0)
        xi = (b_row - s) / l0
        X_new = jnp.concatenate([xi[None, :], X[:-1]], axis=0)
        return X_new, xi

    init = jnp.zeros((k, r), dtype)
    _, x = lax.scan(step, init, (G.T, l_band[0], b2))
    return x[:, 0] if vec else x


def solve_upper_band_transpose(l_band: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L^T x = b for banded lower-triangular L (backward substitution)."""
    k = l_band.shape[0] - 1
    dtype = l_band.dtype
    vec = b.ndim == 1

    b2 = b[:, None] if vec else b
    r = b2.shape[1]

    if k == 0:
        x = b2 / l_band[0][:, None]
        return x[:, 0] if vec else x

    def step(X, inp):
        # X: (k, r), X[p-1] = x[i+p]
        l_col, b_row = inp
        s = jnp.sum(l_col[1:, None] * X, axis=0)
        xi = (b_row - s) / l_col[0]
        X_new = jnp.concatenate([xi[None, :], X[:-1]], axis=0)
        return X_new, xi

    init = jnp.zeros((k, r), dtype)
    _, x = lax.scan(step, init, (l_band.T, b2), reverse=True)
    return x[:, 0] if vec else x


def cholesky_solve_band(l_band: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given the banded Cholesky factor L of A."""
    return solve_upper_band_transpose(l_band, solve_lower_band(l_band, b))


def takahashi_inverse_band(l_band: jnp.ndarray) -> jnp.ndarray:
    """Band of A^{-1} from the banded Cholesky factor L (Takahashi recursion).

    Computes the entries of S = A^{-1} on the band |i - j| <= k *exactly*
    (the sparse-inverse-subset recursion is exact on the sparsity pattern of
    L^T + L).  Equivalent of the reference's
    ``banded.inverse_from_cholesky_band`` (asvgp/gpr.py:59).

    Args:
      l_band: (k+1, m) lower band of L (right-padding must be zero, as
        produced by :func:`cholesky_band`).
    Returns:
      (k+1, m) lower band of A^{-1}.
    """
    k = l_band.shape[0] - 1
    m = l_band.shape[1]
    dtype = l_band.dtype

    if k == 0:
        return 1.0 / (l_band * l_band)

    def step(CS, inp):
        # CS: (k, k+1), CS[p-1, :] = S_band[:, j+p] (zeros beyond the end).
        l_col, j = inp
        d = 1.0 / l_col[0]
        w = l_col[1:]  # w[p-1] = L[j+p, j]
        # M[q-1, p-1] = S[j+max(p,q), j+min(p,q)] = CS[min(p,q)-1, |q-p|]
        M = jnp.stack(
            [
                jnp.stack([CS[min(p, q) - 1, abs(q - p)] for p in range(1, k + 1)])
                for q in range(1, k + 1)
            ]
        )
        # k <= 6: an elementwise contraction, not a dot_general
        s = -d * jnp.sum(M * w[None, :], axis=1)  # off-diag S[j+q, j], q=1..k
        sjj = d * d - d * jnp.sum(w * s)
        col = jnp.concatenate([sjj[None], s])
        col = col * _col_mask(j, k, m, dtype)
        CS_new = jnp.concatenate([col[None, :], CS[:-1]], axis=0)
        return CS_new, col

    init = jnp.zeros((k, k + 1), dtype)
    _, cols = lax.scan(step, init, (l_band.T, jnp.arange(m)), reverse=True)
    return cols.T


def collapsed_core(kuu_band, p_band, b, big_band):
    """The banded heart of the collapsed ELBO in one differentiable call:

        (log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹ B))

    Mirrors the banded portion of the reference ELBO (asvgp/gpr.py:49-89;
    its C++ ops cholesky_band, inverse_from_cholesky_band, product_band_band
    and solve_triang_mat).  Block cyclic reduction on the "cr" route; the
    composed scan ops (autodiff through lax.scan) otherwise.
    """
    if (
        kuu_band.shape == p_band.shape == big_band.shape
        and b.ndim == 1
        and _use_cr(kuu_band)
    ):
        from asvgp.banded import cyclic

        ld_p, u = cyclic.cr_logdet_solve(p_band, b)
        return (
            cyclic.cr_logdet(kuu_band),
            ld_p,
            jnp.vdot(b, u),
            # tr(Kuu⁻¹B) = ⟨∇log|Kuu|, B⟩ (the gradient IS w∘band(Kuu⁻¹));
            # cr_trace's custom VJP takes the second derivative as a
            # forward-over-reverse HVP
            cyclic.cr_trace(kuu_band, big_band),
        )
    l_kuu, l_p = cholesky_band(kuu_band), cholesky_band(p_band)
    s_kuu = takahashi_inverse_band(l_kuu)
    c0 = solve_lower_band(l_p, b)
    return (
        log_det_from_cholesky(l_kuu),
        log_det_from_cholesky(l_p),
        jnp.sum(jnp.square(c0)),
        band_frobenius(s_kuu, big_band),
    )


def collapsed_core_matern(kuu_fn, var, ell, p_band, b, big_band):
    """``collapsed_core`` with the Matérn hyperparameter structure exposed:
    Kuu = kuu_fn(var, ell) with kuu_fn(var, ell) = var⁻¹·G(ell) (true for
    every Matérn RKHS Gram band — spline_features.make_kuu).

    On the "sweep" route this runs the two fused sweeps of banded/sweep.py,
    which carry the trace term's lengthscale derivative as one forward-mode
    direction, so the backward pass is elementwise.  Elsewhere it is
    ``collapsed_core`` on the assembled band (plain autodiff).
    """
    if (
        p_band.shape == big_band.shape
        and b.ndim == 1
        and _use_sweep(p_band)
    ):
        from asvgp.banded import sweep

        return sweep.collapsed_core_matern(
            kuu_fn, var, ell, p_band, b, big_band
        )
    return collapsed_core(kuu_fn(var, ell), p_band, b, big_band)


def banded_posterior(kuu_band, p_band, b):
    """(band of Kuu⁻¹, band of P⁻¹, P⁻¹ b) — the prediction-time posterior
    quantities (reference asvgp/gpr.py:94-118, minus the CHOLMOD detour).
    Not differentiated (prediction leaves autodiff in the reference too,
    SURVEY.md §3.3)."""
    if kuu_band.shape == p_band.shape and b.ndim == 1:
        if _use_cr(kuu_band):
            from asvgp.banded import cyclic

            k = kuu_band.shape[0] - 1
            m = kuu_band.shape[1]
            w = cyclic.band_weights(k, m, kuu_band.dtype)
            s_kuu = jax.grad(cyclic.cr_logdet)(kuu_band) / w
            s_p = jax.grad(cyclic.cr_logdet)(p_band) / w
            u = cyclic.cr_solve(p_band, b)
            return s_kuu, s_p, u
        if _use_sweep(kuu_band):
            from asvgp.banded import sweep

            return sweep.posterior(kuu_band, p_band, b)
    l_kuu, l_p = cholesky_band(kuu_band), cholesky_band(p_band)
    s_kuu = takahashi_inverse_band(l_kuu)
    s_p = takahashi_inverse_band(l_p)
    u = cholesky_solve_band(l_p, b)
    return s_kuu, s_p, u


def band_frobenius(a_band: jnp.ndarray, b_band: jnp.ndarray) -> jnp.ndarray:
    """trace(A @ B) for symmetric A, B given as lower bands.

    Replaces the reference's product_band_band(..., result bandwidth 0) +
    reduce_sum trace trick (asvgp/gpr.py:60-70) with a single fused
    elementwise reduction: tr(AB) = sum_i a0_i b0_i + 2 sum_{j>=1,i} aj_i bj_i.
    """
    kw = min(a_band.shape[0], b_band.shape[0])
    a = a_band[:kw]
    b = b_band[:kw]
    diag = jnp.sum(a[0] * b[0])
    off = jnp.sum(a[1:] * b[1:])
    return diag + 2.0 * off


def product_band_band(
    a_band: jnp.ndarray,
    b_band: jnp.ndarray,
    *,
    a_lower: int,
    a_upper: int,
    b_lower: int,
    b_upper: int,
    out_lower: int,
    out_upper: int,
) -> jnp.ndarray:
    """C = A @ B restricted to a requested output band.

    All operands use general-band storage (see banded/__init__.py).  This is
    a parallel diagonal convolution over static offsets — no scan.
    Equivalent of the reference's ``banded.product_band_band``
    (asvgp/gpr.py:60-69) including the caller-specified result bandwidth.
    """
    m = a_band.shape[1]
    dtype = a_band.dtype
    out = jnp.zeros((out_lower + out_upper + 1, m), dtype)
    rows = []
    for c in range(-out_upper, out_lower + 1):
        row = jnp.zeros((m,), dtype)
        for s in range(-b_upper, b_lower + 1):
            a_off = c - s
            if not (-a_upper <= a_off <= a_lower):
                continue
            # C[j + c, j] += A[j + c, j + s] * B[j + s, j]
            a_row = a_band[a_off + a_upper]
            b_row = b_band[s + b_upper]
            row = row + shift_cols(a_row, s) * b_row
        rows.append(row)
    out = jnp.stack(rows, axis=0)
    return mask_band(out, out_lower, out_upper)


def matvec_band(band: jnp.ndarray, x: jnp.ndarray, *, lower: int, upper: int) -> jnp.ndarray:
    """y = M x for M in general-band storage; x is (m,)."""
    y = jnp.zeros_like(x)
    for r in range(lower + upper + 1):
        off = r - upper  # y[i + off] += band[r, i] * x[i]
        y = y + shift_cols(band[r] * x, -off)
    return y


def matvec_symmetric_band(lower_band: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y = M x for symmetric M given as a lower band; x is (m,)."""
    k = lower_band.shape[0] - 1
    y = lower_band[0] * x
    for j in range(1, k + 1):
        row = lower_band[j]
        y = y + shift_cols(row * x, -j)      # lower part: y[i+j] += row[i] x[i]
        y = y + row * shift_cols(x, j)       # upper part: y[i] += row[i] x[i+j]
    return y
