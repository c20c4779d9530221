"""Block-banded linear algebra (large-bandwidth systems, Kronecker models).

The Kronecker model's coupling matrix P = Kuu_1 ⊗ Kuu_2 + KufKfu/σ² is not
Kronecker but *is* banded with joint bandwidth ~ m_2·k_1 + k_2
(reference computes this at asvgp/gpr.py:262 and then densifies the whole
m^d x m^d system, asvgp/gpr.py:272,292-293).  We instead treat it as a
block-banded matrix: blocks of size B = m_2 indexed by i_1, block lower
bandwidth W = k_1.  Factorization is a scan over m_1 block columns carrying
a W-block window; the per-step work is dense B x B matrix algebra (batched
cuBLAS/cuSOLVER calls on a GPU) — O(m_1 W² B³) total instead of the reference's
O((m_1 B)³) dense Cholesky.

Storage: ``blocks`` array of shape (W+1, nb, B, B):
  blocks[p, J] = A[(J+p)·B:(J+p+1)·B, J·B:(J+1)·B]   (block column J, p-th
  sub-block-diagonal; out-of-range slots zero).  The diagonal blocks of the
  input must contain the full symmetric block (not just its lower
  triangle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _tri_solve_right(L, X):
    """Solve Y L^T = X for Y, i.e. Y = X L^{-T}; L (B,B), X batched (..., B, B)."""
    Lb = jnp.broadcast_to(L, X.shape)
    return lax.linalg.triangular_solve(
        Lb, X, left_side=False, lower=True, transpose_a=True
    )


def _mm(a, b):
    """Dense matmul at the operands' precision."""
    return jnp.matmul(a, b, preferred_element_type=a.dtype)


def _diag_block_inverses(l0_blocks):
    """(nb, B, B) lower-triangular inverses of all diagonal blocks (zero
    padding blocks guarded to the identity)."""
    B = l0_blocks.shape[-1]
    eye = jnp.eye(B, dtype=l0_blocks.dtype)
    good = jnp.abs(l0_blocks).sum(axis=(-1, -2), keepdims=True) > 0
    safe = jnp.where(good, l0_blocks, eye)
    return jax.vmap(
        lambda L: lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    )(safe)


def _cholesky_block_banded_impl(blocks: jnp.ndarray) -> jnp.ndarray:
    Wp1, nb, B, _ = blocks.shape
    W = Wp1 - 1
    dtype = blocks.dtype

    if W == 0:
        return jax.vmap(jnp.linalg.cholesky)(blocks[0])[None]

    def step(carry, inp):
        # carry C: (W, W+1, B, B) — C[p-1] = L blocks of column J-p
        C, = carry,
        a_col, j = inp  # a_col: (W+1, B, B)
        # S_q = A[J+q, J] - sum_{p=1..W} L[J+q, J-p] @ L[J, J-p]^T, q = 0..W
        # L[J+q, J-p] lives in C[p-1, q+p] (zero when q+p > W).
        s = a_col
        for p in range(1, W + 1):
            g = C[p - 1, p]  # L[J, J-p], (B, B)
            # L[J+q, J-p] = C[p-1, q+p], valid for q = 0..W-p
            upd = jnp.matmul(C[p - 1, p:], g.T[None], preferred_element_type=dtype)
            s = s.at[: W - p + 1].add(-upd)
        ljj = jnp.linalg.cholesky(s[0])
        off = _tri_solve_right(ljj, s[1:])  # (W, B, B)
        col = jnp.concatenate([ljj[None], off], axis=0)
        # zero out blocks past the end
        mask = (j + jnp.arange(W + 1) < nb).astype(dtype)[:, None, None]
        col = col * mask
        C_new = jnp.concatenate([col[None], C[:-1]], axis=0)
        return C_new, col

    init = jnp.zeros((W, W + 1, B, B), dtype)
    _, cols = lax.scan(step, init, (jnp.moveaxis(blocks, 1, 0), jnp.arange(nb)))
    return jnp.moveaxis(cols, 0, 1)


def _phi_block(x, B, dtype):
    """Lower triangle with halved diagonal (Cholesky-adjoint projector),
    applied over the last two dims."""
    return jnp.tril(x) - 0.5 * x * jnp.eye(B, dtype=dtype)


def _chol_block_adjoint(l_blocks: jnp.ndarray, lbar: jnp.ndarray) -> jnp.ndarray:
    """Ā from (L, L̄) for the block-banded Cholesky — reverse block
    recursion mirroring the forward scan (the equivalent of the C++
    cholesky_band registered gradient, reference asvgp/gpr.py:56).

    Derivation: reverse-mode of the forward step
      S_q(J) = A_q(J) - Σ_p L[q+p, J-p] L[p, J-p]ᵀ ;
      L0 = chol(S_0);  L_q = S_q L0^{-T}
    processed at column K (reverse), gathering the Schur-update cotangent
    contributions from the already-processed columns K+1..K+W (carried as
    a window of S̄ columns):
      L̄[a,K] += -Σ_p S̄_{a-p}(K+p) L[p,K]  - Σ_q S̄_q(K+a)ᵀ L[q+a,K]
      S̄_q(K)  = L̄_q L0^{-1}   (q ≥ 1)
      S̄_0(K)  = ½ L0^{-T}(Φ(L0ᵀ M)+Φ(L0ᵀ M)ᵀ)L0^{-1},
                M = tril(L̄_0 - Σ_q S̄_qᵀ L_q)
      Ā_q(K)  = S̄_q(K).
    """
    Wp1, nb, B, _ = l_blocks.shape
    W = Wp1 - 1
    dtype = l_blocks.dtype
    linv = _diag_block_inverses(l_blocks[0])  # (nb, B, B)

    if W == 0:
        lb0 = jnp.tril(lbar[0])
        m = _phi_block(_mm(jnp.swapaxes(l_blocks[0], -1, -2), lb0), B, dtype)
        sym = m + jnp.swapaxes(m, -1, -2)
        abar0 = 0.5 * _mm(jnp.swapaxes(linv, -1, -2), _mm(sym, linv))
        return abar0[None]

    zero_blk = jnp.zeros((B, B), dtype)

    def step(sb, inp):
        # sb: (W, W+1, B, B) — sb[p-1] = S̄ column K+p
        l_col, li, yb, k = inp
        g = l_col[1:].reshape(W * B, B)  # [L[1,K]; ...; L[W,K]]
        r = jnp.stack(
            [
                jnp.concatenate(
                    [
                        sb[p - 1, a - p] if a - p >= 0 else zero_blk
                        for p in range(1, W + 1)
                    ],
                    axis=-1,
                )
                for a in range(W + 1)
            ],
            axis=0,
        )  # (W+1, B, W*B)
        t1 = -_mm(r, g)  # (W+1, B, B)
        t = jnp.stack(
            [
                jnp.concatenate(
                    [jnp.swapaxes(sb[a - 1, q], -1, -2) for q in range(W + 1)],
                    axis=-1,
                )
                for a in range(1, W + 1)
            ],
            axis=0,
        )  # (W, B, (W+1)*B)
        h = jnp.stack(
            [
                jnp.concatenate(
                    [
                        l_col[q + a] if q + a <= W else zero_blk
                        for q in range(W + 1)
                    ],
                    axis=0,
                )
                for a in range(1, W + 1)
            ],
            axis=0,
        )  # (W, (W+1)*B, B)
        t2 = -_mm(t, h)  # (W, B, B)
        lb = yb + t1
        lb = lb.at[1:].add(t2)
        keep = (k + jnp.arange(W + 1) < nb)[:, None, None]
        lb = jnp.where(keep, lb, 0.0)
        sbar_off = _mm(lb[1:], jnp.broadcast_to(li, (W, B, B)))  # S̄_q, q>=1
        # L̄_0 -= Σ_q S̄_qᵀ L_q   (tr(M dL0ᵀ) = ⟨M, dL0⟩ with M = S̄_qᵀ L_q)
        extra = _mm(
            jnp.swapaxes(sbar_off.reshape(W * B, B), 0, 1),
            l_col[1:].reshape(W * B, B),
        )
        m = _phi_block(
            _mm(jnp.swapaxes(l_col[0], -1, -2), jnp.tril(lb[0] - extra)),
            B,
            dtype,
        )
        sym = m + jnp.swapaxes(m, -1, -2)
        sbar0 = 0.5 * _mm(jnp.swapaxes(li, -1, -2), _mm(sym, li))
        col = jnp.concatenate([sbar0[None], sbar_off], axis=0)
        col = jnp.where(keep, col, 0.0)
        sb_new = jnp.concatenate([col[None], sb[:-1]], axis=0)
        return sb_new, col

    init = jnp.zeros((W, W + 1, B, B), dtype)
    _, cols = lax.scan(
        step,
        init,
        (
            jnp.moveaxis(l_blocks, 1, 0),
            linv,
            jnp.moveaxis(lbar, 1, 0),
            jnp.arange(nb),
        ),
        reverse=True,
    )
    return jnp.moveaxis(cols, 0, 1)


@jax.custom_vjp
def cholesky_block_banded(blocks: jnp.ndarray) -> jnp.ndarray:
    """Block-banded Cholesky: A = L L^T, same block-band structure.

    Args:
      blocks: (W+1, nb, B, B) block-lower storage of symmetric positive-
        definite A (diagonal blocks full-symmetric).
    Returns:
      (W+1, nb, B, B) block-lower storage of L (diagonal blocks lower-
      triangular).

    Differentiable via a registered reverse block recursion
    (:func:`_chol_block_adjoint`), cheaper than scan-transpose autodiff.
    """
    return _cholesky_block_banded_impl(blocks)


def _chol_block_fwd(blocks):
    l = _cholesky_block_banded_impl(blocks)
    return l, l


def _chol_block_bwd(l, lbar):
    return (_chol_block_adjoint(l, lbar),)


cholesky_block_banded.defvjp(_chol_block_fwd, _chol_block_bwd)


def log_det_from_block_cholesky(l_blocks: jnp.ndarray) -> jnp.ndarray:
    """log|A| = 2 Σ log diag(L): sum over diagonal blocks' diagonals.

    Padding blocks are zero; their diagonals would produce -inf, so mask by
    taking only strictly-positive diagonal entries into the sum — valid
    because a Cholesky diagonal is positive.
    """
    diags = jax.vmap(jnp.diagonal)(l_blocks[0])  # (nb, B)
    safe = jnp.where(diags > 0, diags, 1.0)
    return 2.0 * jnp.sum(jnp.log(safe))


def _solve_lower_block_banded_impl(l_blocks: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    Wp1, nb, B, _ = l_blocks.shape
    W = Wp1 - 1
    dtype = l_blocks.dtype
    vec = b.ndim == 1

    b2 = b[:, None] if vec else b
    r = b2.shape[1]
    b_blocks = b2.reshape(nb, B, r)

    if W == 0:
        x = jax.vmap(
            lambda L, bb: lax.linalg.triangular_solve(L, bb, left_side=True, lower=True)
        )(l_blocks[0], b_blocks).reshape(nb * B, r)
        return x[:, 0] if vec else x

    # G[p-1, J] = L[J, J-p] = l_blocks[p, J-p]
    G = jnp.stack(
        [jnp.roll(l_blocks[p], p, axis=0).at[:p].set(0.0) for p in range(1, W + 1)],
        axis=0,
    )

    def step(X, inp):
        # X: (W, B, r) — X[p-1] = x block J-p
        g_col, ljj, b_blk = inp  # (W, B, B), (B, B), (B, r)
        s = b_blk - jnp.sum(
            jnp.matmul(g_col, X, preferred_element_type=dtype), axis=0
        )
        # guard padded (zero) diagonal blocks: solve against I instead
        eye = jnp.eye(B, dtype=dtype)
        ljj_safe = jnp.where(jnp.abs(ljj).sum() > 0, ljj, eye)
        xj = lax.linalg.triangular_solve(ljj_safe, s, left_side=True, lower=True)
        X_new = jnp.concatenate([xj[None], X[:-1]], axis=0)
        return X_new, xj

    init = jnp.zeros((W, B, r), dtype)
    _, x = lax.scan(
        step, init, (jnp.moveaxis(G, 1, 0), l_blocks[0], b_blocks)
    )
    x = x.reshape(nb * B, r)
    return x[:, 0] if vec else x


def _solve_upper_block_banded_transpose_impl(l_blocks: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    Wp1, nb, B, _ = l_blocks.shape
    W = Wp1 - 1
    dtype = l_blocks.dtype
    vec = b.ndim == 1

    b2 = b[:, None] if vec else b
    r = b2.shape[1]
    b_blocks = b2.reshape(nb, B, r)

    if W == 0:
        x = jax.vmap(
            lambda L, bb: lax.linalg.triangular_solve(
                L, bb, left_side=True, lower=True, transpose_a=True
            )
        )(l_blocks[0], b_blocks).reshape(nb * B, r)
        return x[:, 0] if vec else x

    def step(X, inp):
        # X: (W, B, r) — X[p-1] = x block J+p; L[J+p, J] = l_blocks[p, J]
        l_col, b_blk = inp  # (W+1, B, B), (B, r)
        s = b_blk - jnp.sum(
            jnp.matmul(
                jnp.swapaxes(l_col[1:], -1, -2), X, preferred_element_type=dtype
            ),
            axis=0,
        )
        eye = jnp.eye(B, dtype=dtype)
        ljj = l_col[0]
        ljj_safe = jnp.where(jnp.abs(ljj).sum() > 0, ljj, eye)
        xj = lax.linalg.triangular_solve(
            ljj_safe, s, left_side=True, lower=True, transpose_a=True
        )
        X_new = jnp.concatenate([xj[None], X[:-1]], axis=0)
        return X_new, xj

    init = jnp.zeros((W, B, r), dtype)
    _, x = lax.scan(step, init, (jnp.moveaxis(l_blocks, 1, 0), b_blocks), reverse=True)
    x = x.reshape(nb * B, r)
    return x[:, 0] if vec else x


def _band_outer_blocks(u: jnp.ndarray, v: jnp.ndarray, Wp1: int, nb: int, B: int):
    """Block band of -u vᵀ: out[p, J] = -u_block[J+p] v_block[J]ᵀ (zero for
    J+p ≥ nb, diagonal blocks tril-masked — the L storage convention)."""
    r = u.shape[1]
    ub = u.reshape(nb, B, r)
    vb = v.reshape(nb, B, r)
    outs = []
    for p in range(Wp1):
        shifted = jnp.roll(ub, -p, axis=0)
        if p:
            shifted = shifted.at[max(nb - p, 0):].set(0.0)
        blk = -jnp.einsum("jbr,jcr->jbc", shifted, vb)
        if p == 0:
            blk = jnp.tril(blk)
        outs.append(blk)
    return jnp.stack(outs, axis=0)


@jax.custom_vjp
def solve_lower_block_banded(l_blocks: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L x = b with L block-banded lower (from cholesky_block_banded).

    b: (nb*B,) or (nb*B, r).  Differentiable via the registered algebraic
    adjoint (b̄ = L⁻ᵀ x̄, L̄ = -b̄ xᵀ on the block band).
    """
    return _solve_lower_block_banded_impl(l_blocks, b)


def _solve_lower_fwd(l_blocks, b):
    x = _solve_lower_block_banded_impl(l_blocks, b)
    return x, (l_blocks, x)


def _solve_lower_bwd(res, xbar):
    l_blocks, x = res
    Wp1, nb, B, _ = l_blocks.shape
    vec = x.ndim == 1
    bbar = _solve_upper_block_banded_transpose_impl(l_blocks, xbar)
    x2 = x[:, None] if vec else x
    bb2 = bbar[:, None] if vec else bbar
    lbar = _band_outer_blocks(bb2, x2, Wp1, nb, B)
    return lbar, bbar


solve_lower_block_banded.defvjp(_solve_lower_fwd, _solve_lower_bwd)


@jax.custom_vjp
def solve_upper_block_banded_transpose(l_blocks: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L^T x = b (backward block substitution).  Differentiable via
    the registered algebraic adjoint (b̄ = L⁻¹ x̄, L̄ = -x b̄ᵀ on the band)."""
    return _solve_upper_block_banded_transpose_impl(l_blocks, b)


def _solve_upper_fwd(l_blocks, b):
    x = _solve_upper_block_banded_transpose_impl(l_blocks, b)
    return x, (l_blocks, x)


def _solve_upper_bwd(res, xbar):
    l_blocks, x = res
    Wp1, nb, B, _ = l_blocks.shape
    vec = x.ndim == 1
    bbar = _solve_lower_block_banded_impl(l_blocks, xbar)
    x2 = x[:, None] if vec else x
    bb2 = bbar[:, None] if vec else bbar
    lbar = _band_outer_blocks(x2, bb2, Wp1, nb, B)
    return lbar, bbar


solve_upper_block_banded_transpose.defvjp(_solve_upper_fwd, _solve_upper_bwd)


def cholesky_solve_block_banded(l_blocks: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return solve_upper_block_banded_transpose(
        l_blocks, solve_lower_block_banded(l_blocks, b)
    )


def takahashi_inverse_block_banded(l_blocks: jnp.ndarray) -> jnp.ndarray:
    """Block band of A^{-1} from the block-banded Cholesky factor.

    Block generalization of the scalar Takahashi recursion
    (banded/ops.py:takahashi_inverse_band); exact on the block band.
    Returns (W+1, nb, B, B) block-lower storage of A^{-1} (diagonal blocks
    full-symmetric).
    """
    Wp1, nb, B, _ = l_blocks.shape
    W = Wp1 - 1
    dtype = l_blocks.dtype
    eye = jnp.eye(B, dtype=dtype)

    if W == 0:
        def inv_block(L):
            Linv = lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
            return Linv.T @ Linv

        return jax.vmap(inv_block)(l_blocks[0])[None]

    def step(CS, inp):
        # CS: (W, W+1, B, B) — CS[p-1] = S block column J+p
        l_col, j = inp
        ljj = l_col[0]
        ljj_safe = jnp.where(jnp.abs(ljj).sum() > 0, ljj, eye)
        # Linv_jj = L[J,J]^{-1}
        linv = lax.linalg.triangular_solve(ljj_safe, eye, left_side=True, lower=True)
        w = l_col[1:]  # (W, B, B): w[p-1] = L[J+p, J]
        # M[q-1, p-1] = S_sym[J+q, J+p]:
        #   p <= q: S[J+q, J+p] = CS[p-1, q-p]
        #   p > q : S[J+p, J+q]^T = CS[q-1, p-q]^T
        rows = []
        for q in range(1, W + 1):
            cols = []
            for p in range(1, W + 1):
                if p <= q:
                    cols.append(CS[p - 1, q - p])
                else:
                    cols.append(jnp.swapaxes(CS[q - 1, p - q], -1, -2))
            rows.append(jnp.stack(cols, axis=0))
        M = jnp.stack(rows, axis=0)  # (W, W, B, B)
        # From Z L = L^{-T}, block column J, rows I > J:
        #   S[J+q, J] = -(sum_p S_sym[J+q, J+p] L[J+p, J]) L[J,J]^{-1}
        t = jnp.einsum("qpij,pjk->qik", M, w, preferred_element_type=dtype)
        s_off = -jnp.matmul(t, linv[None], preferred_element_type=dtype)  # (W, B, B)
        # Row I = J:
        #   S[J,J] = (L[J,J]^{-T} - sum_p S[J+p, J]^T L[J+p, J]) L[J,J]^{-1}
        acc = jnp.einsum("pji,pjk->ik", s_off, w, preferred_element_type=dtype)
        sjj = (linv.T - acc) @ linv
        sjj = 0.5 * (sjj + sjj.T)
        col = jnp.concatenate([sjj[None], s_off], axis=0)
        mask = (j + jnp.arange(W + 1) < nb).astype(dtype)[:, None, None]
        col = col * mask
        CS_new = jnp.concatenate([col[None], CS[:-1]], axis=0)
        return CS_new, col

    init = jnp.zeros((W, W + 1, B, B), dtype)
    _, cols = lax.scan(
        step, init, (jnp.moveaxis(l_blocks, 1, 0), jnp.arange(nb)), reverse=True
    )
    return jnp.moveaxis(cols, 0, 1)


def block_band_to_dense(blocks: jnp.ndarray) -> jnp.ndarray:
    """Expand block-lower storage to the dense symmetric (nb*B, nb*B) matrix."""
    Wp1, nb, B, _ = blocks.shape
    W = Wp1 - 1
    n = nb * B
    out = jnp.zeros((n, n), blocks.dtype)
    for p in range(W + 1):
        for j in range(nb - p):
            blk = blocks[p, j]
            out = out.at[(j + p) * B:(j + p + 1) * B, j * B:(j + 1) * B].add(blk)
            if p > 0:
                out = out.at[j * B:(j + 1) * B, (j + p) * B:(j + p + 1) * B].add(blk.T)
    return out


def dense_to_block_band(dense: jnp.ndarray, W: int, B: int) -> jnp.ndarray:
    """Extract block-lower storage from a dense symmetric matrix."""
    n = dense.shape[0]
    nb = n // B
    out = jnp.zeros((W + 1, nb, B, B), dense.dtype)
    for p in range(W + 1):
        for j in range(nb - p):
            out = out.at[p, j].set(
                dense[(j + p) * B:(j + p + 1) * B, j * B:(j + 1) * B]
            )
    return out
