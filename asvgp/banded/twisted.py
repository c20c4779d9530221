"""Twisted (two-ended) banded factorization — the halved-depth collapsed core.

Every sequential banded recursion is a serial column walk whose latency
grows with m however wide the machine is.  The classical BABE ("burn at
both ends") / twisted factorization halves the *sequential depth*: factor
the matrix forward from the top AND backward from the bottom
simultaneously, meeting at a k×k middle block.  The two streams are
independent, so a sweep kernel can run them side by side — same
instruction count per step, half the steps.

Block picture (left block size h, middle size k, right size g = m - h - k;
P13 = 0 because the bandwidth is k):

    P = [[P11, P12,   0],        S22 = P22 − P21 P11⁻¹ P12 − P23 P33⁻¹ P32
         [P21, P22, P23],             = P22 − L21 L21ᵀ − J L21' L21'ᵀ J
         [  0, P32, P33]]

with L11 the (global) Cholesky of the leading block, L21 = P21 L11⁻ᵀ its
in-band spill into the middle (both produced by the forward stream), and
primed quantities from the backward stream = the forward factorization of
the index-reversed matrix JPJ.  Then *exactly*:

    log|P|  = log|P11| + log|P33| + log|S22|
    bᵀP⁻¹b  = ‖L11⁻¹b1‖² + ‖L33'⁻¹b3'‖² + b2ᶜᵀ S22⁻¹ b2ᶜ,
              b2ᶜ = b2 − L21 y1ᵗᵃⁱˡ − J L21' y3ᵗᵃⁱˡ
    band(P⁻¹): dense Z22 = S22⁻¹ seeds a Takahashi recursion running
              *outward* on each side (left uses global L columns < h, right
              uses the reversed factor), and the three pieces tile the band
              exactly (left: cols < h; dense middle: row AND col in the
              middle block; right: rows ≥ h+k).
    P⁻¹b:     back-substitution outward on both sides seeded with
              x2 = S22⁻¹ b2ᶜ.

This module is the float64/XLA *reference implementation* — the semantics
oracle for a future two-ended sweep kernel.  The middle coupling is k×k
dense (k ≤ 7), negligible at any size.

Reference parity: same quantities as the forward-only sweeps, i.e. the
C++ ``banded_matrices`` ops the reference composes in asvgp/gpr.py:49-89 —
this file cites them via ops.py.  The twisting itself has no counterpart
in the reference (its C++ ops are serial single-ended scans); it buys a
2× depth reduction.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_solve

from asvgp.banded.layout import shift_cols


def flip_band(band: jnp.ndarray) -> jnp.ndarray:
    """Lower band of the index-reversed matrix JAJ (an involution).

    band'[r, j] = A'[j+r, j] = A[m-1-j, m-1-j-r] = band[r, m-1-r-j].
    """
    k = band.shape[0] - 1
    return jnp.stack(
        [shift_cols(band[r][::-1], r) for r in range(k + 1)], axis=0
    )


def _lower_tail_dense(tail_cols: jnp.ndarray) -> jnp.ndarray:
    """Dense k×k spill block L21 from the last k factor columns.

    tail_cols: (k+1, k) = global L columns h-k..h-1 (rows within band).
    Returns L21 with L21[a, t] = L[h+a, h-k+t] = tail_cols[k+a-t, t]
    (zero when the offset k+a-t exceeds the bandwidth, i.e. a > t).
    """
    k = tail_cols.shape[1]
    a = jnp.arange(k)[:, None]
    t = jnp.arange(k)[None, :]
    r = k + a - t
    valid = r <= k
    r_c = jnp.clip(r, 0, k)
    t_b = jnp.broadcast_to(t, (k, k))
    return jnp.where(valid, tail_cols[r_c, t_b], 0.0).astype(tail_cols.dtype)


def _middle_dense(band: jnp.ndarray, h: int) -> jnp.ndarray:
    """Dense k×k middle block P[h:h+k, h:h+k] from the lower band."""
    k = band.shape[0] - 1
    a = jnp.arange(k)[:, None]
    b = jnp.arange(k)[None, :]
    r = jnp.abs(a - b)
    c = h + jnp.minimum(a, b)
    return band[r, c]


def _solve_upper_seeded(l_band: jnp.ndarray, y: jnp.ndarray,
                        x_seed: jnp.ndarray) -> jnp.ndarray:
    """Back-substitution Lᵀx = y over columns h-1..0 of the global factor,
    seeded with the already-known x[h..h+k-1] (x_seed).  ``l_band`` must be
    the (k+1, h) slice of the *extended* factor: its columns near h carry
    rows that reach into the middle block, and they are used."""

    def step(X, inp):
        l_col, y_i = inp
        s = jnp.sum(l_col[1:] * X)
        xi = (y_i - s) / l_col[0]
        return jnp.concatenate([xi[None], X[:-1]]), xi

    _, x = lax.scan(step, x_seed, (l_band.T, y), reverse=True)
    return x


def _takahashi_seeded(l_band: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Takahashi band recursion over columns h-1..0, seeded with the dense
    middle inverse.  seed: (k, k+1) with seed[p-1, r] = Z[h-1+p+r, h-1+p]
    (entries with p+r > k are never read; pass zeros).  No end-of-matrix
    masking — columns near h legitimately spill into the middle rows."""
    k = l_band.shape[0] - 1

    def step(CS, l_col):
        d = 1.0 / l_col[0]
        w = l_col[1:]
        M = jnp.stack(
            [
                jnp.stack(
                    [CS[min(p, q) - 1, abs(q - p)] for p in range(1, k + 1)]
                )
                for q in range(1, k + 1)
            ]
        )
        s = -d * jnp.sum(M * w[None, :], axis=1)
        sjj = d * d - d * jnp.sum(w * s)
        col = jnp.concatenate([sjj[None], s])
        return jnp.concatenate([col[None, :], CS[:-1]], axis=0), col

    _, cols = lax.scan(step, seed, l_band.T, reverse=True)
    return cols.T


def _seed_from_mid(z_mid: jnp.ndarray) -> jnp.ndarray:
    """(k, k+1) Takahashi seed window from the dense middle inverse:
    seed[p-1, r] = Z22[p-1+r, p-1] where in range, else 0."""
    k = z_mid.shape[0]
    p = jnp.arange(k)[:, None]
    r = jnp.arange(k + 1)[None, :]
    valid = p + r <= k - 1
    row = jnp.clip(p + r, 0, k - 1)
    p_b = jnp.broadcast_to(p, (k, k + 1))
    return jnp.where(valid, z_mid[row, p_b], 0.0).astype(z_mid.dtype)


def split_point(m: int, k: int) -> int:
    """Left-block size h: both streams within one column of equal length."""
    return (m - k + 1) // 2


def twisted_pieces(band: jnp.ndarray, h: int):
    """Both Cholesky streams + the middle Schur complement for one SPD band.

    Returns (l_left, l_right_flipped, s_mid, fb) where l_left is the
    extended forward factor over columns 0..h+k-1 (global in 0..h-1),
    l_right_flipped the same for the reversed matrix (g+k columns), s_mid
    the k×k dense middle Schur complement, fb the flipped band.
    """
    from asvgp.banded.ops import cholesky_band

    k = band.shape[0] - 1
    m = band.shape[1]
    g = m - h - k
    if not (k >= 1 and h >= k and g >= k):
        raise ValueError(f"twisted split needs h,g >= k >= 1; got m={m}, "
                         f"k={k}, h={h}, g={g}")
    fb = flip_band(band)
    l_left = cholesky_band(band[:, : h + k])
    l_right = cholesky_band(fb[:, : g + k])
    l21_f = _lower_tail_dense(l_left[:, h - k : h])
    l21_r = _lower_tail_dense(l_right[:, g - k : g])
    c_f = l21_f @ l21_f.T
    c_r = (l21_r @ l21_r.T)[::-1, ::-1]
    s_mid = _middle_dense(band, h) - c_f - c_r
    return l_left, l_right, s_mid, fb


def twisted_inverse_band(band: jnp.ndarray, h: int | None = None):
    """(log|A|, band of A⁻¹) via the twisted factorization.  Exact."""
    k = band.shape[0] - 1
    m = band.shape[1]
    if h is None:
        h = split_point(m, k)
    g = m - h - k
    l_left, l_right, s_mid, _ = twisted_pieces(band, h)
    m_chol = jnp.linalg.cholesky(s_mid)
    ld = (
        2.0 * jnp.sum(jnp.log(l_left[0, :h]))
        + 2.0 * jnp.sum(jnp.log(l_right[0, :g]))
        + 2.0 * jnp.sum(jnp.log(jnp.diagonal(m_chol)))
    )
    eye = jnp.eye(k, dtype=band.dtype)
    z_mid = cho_solve((m_chol, True), eye)
    zl = _takahashi_seeded(l_left[:, :h], _seed_from_mid(z_mid))
    zr = _takahashi_seeded(l_right[:, :g], _seed_from_mid(z_mid[::-1, ::-1]))
    return ld, _assemble_band(zl, zr, z_mid, m)


def _assemble_band(zl, zr, z_mid, m):
    """Tile the inverse band from (left cols, flipped right cols, middle)."""
    k = zl.shape[0] - 1
    h = zl.shape[1]
    g = zr.shape[1]
    zr_full = flip_band(
        jnp.pad(zr, ((0, 0), (0, m - g)))
    )  # nonzero exactly where the row index is >= h+k
    # dense middle entries: rows AND cols inside the middle block
    t = jnp.arange(k)[None, :]
    r = jnp.arange(k + 1)[:, None]
    valid = (t + r <= k - 1)
    row = jnp.clip(t + r, 0, k - 1)
    t_b = jnp.broadcast_to(t, (k + 1, k))
    mid_patch = jnp.where(valid, z_mid[row, t_b], 0.0).astype(zl.dtype)
    rest = zr_full[:, h:]
    rest = rest.at[:, :k].add(mid_patch)
    return jnp.concatenate([zl, rest], axis=1)


def twisted_solve_core(band: jnp.ndarray, b: jnp.ndarray,
                       h: int | None = None):
    """(log|A|, bᵀA⁻¹b, A⁻¹b, band of A⁻¹) in twisted form.  Exact."""
    from asvgp.banded.ops import solve_lower_band

    k = band.shape[0] - 1
    m = band.shape[1]
    if h is None:
        h = split_point(m, k)
    g = m - h - k
    l_left, l_right, s_mid, _ = twisted_pieces(band, h)
    l21_f = _lower_tail_dense(l_left[:, h - k : h])
    l21_r = _lower_tail_dense(l_right[:, g - k : g])

    bf = b[::-1]
    y1 = solve_lower_band(l_left[:, :h], b[:h])
    y3 = solve_lower_band(l_right[:, :g], bf[:g])
    b2c = b[h : h + k] - l21_f @ y1[h - k :] - (l21_r @ y3[g - k :])[::-1]

    m_chol = jnp.linalg.cholesky(s_mid)
    ld = (
        2.0 * jnp.sum(jnp.log(l_left[0, :h]))
        + 2.0 * jnp.sum(jnp.log(l_right[0, :g]))
        + 2.0 * jnp.sum(jnp.log(jnp.diagonal(m_chol)))
    )
    x2 = cho_solve((m_chol, True), b2c)
    quad = jnp.sum(y1 * y1) + jnp.sum(y3 * y3) + jnp.sum(b2c * x2)

    x1 = _solve_upper_seeded(l_left[:, :h], y1, x2)
    x3 = _solve_upper_seeded(l_right[:, :g], y3, x2[::-1])
    u = jnp.concatenate([x1, x2, x3[::-1]])

    eye = jnp.eye(k, dtype=band.dtype)
    z_mid = cho_solve((m_chol, True), eye)
    zl = _takahashi_seeded(l_left[:, :h], _seed_from_mid(z_mid))
    zr = _takahashi_seeded(l_right[:, :g], _seed_from_mid(z_mid[::-1, ::-1]))
    return ld, quad, u, _assemble_band(zl, zr, z_mid, m)


def twisted_collapsed_core(kuu_band, p_band, b, big_band,
                           h: int | None = None):
    """The collapsed-ELBO scalars (log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹B))
    plus the gradient bands (S_Kuu, S_P, u) — twisted-form f64 oracle.
    Same contract as ops.collapsed_core
    (reference asvgp/gpr.py:49-89) with the byproducts exposed."""
    from asvgp.banded.ops import band_frobenius

    ld_kuu, s_kuu = twisted_inverse_band(kuu_band, h)
    ld_p, quad, u, s_p = twisted_solve_core(p_band, b, h)
    trace = band_frobenius(s_kuu, big_band)
    return (ld_kuu, ld_p, quad, trace), (s_kuu, s_p, u)
