"""Block-banded linalg tests vs dense oracles (Kronecker-model machinery)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp.banded import block


def random_block_banded_spd(key, nb, B, W):
    """SPD with exact block bandwidth W via A = L0 L0^T in block storage."""
    rng = np.random.RandomState(key)
    L0 = np.zeros((nb * B, nb * B))
    for j in range(nb):
        for p in range(min(W, nb - 1 - j) + 1):
            blk = 0.25 * rng.randn(B, B)
            if p == 0:
                blk = np.tril(blk)
                blk[np.arange(B), np.arange(B)] = 1.0 + rng.rand(B)
            L0[(j + p) * B:(j + p + 1) * B, j * B:(j + 1) * B] = blk
    A = L0 @ L0.T
    blocks = block.dense_to_block_band(jnp.asarray(A), W, B)
    return blocks, A


@pytest.mark.parametrize("nb,B,W", [(1, 3, 0), (4, 3, 0), (5, 4, 1), (6, 3, 2), (7, 2, 3)])
def test_block_cholesky_and_logdet(nb, B, W):
    blocks, A = random_block_banded_spd(0, nb, B, W)
    lb = block.cholesky_block_banded(blocks)
    L = np.asarray(block.block_band_to_dense(lb))
    # block_band_to_dense symmetrizes; compare L L^T instead of L itself
    Ld = np.linalg.cholesky(A)
    want = np.tril(Ld)
    got = np.tril(L)
    np.testing.assert_allclose(got, want, atol=1e-9)
    np.testing.assert_allclose(
        float(block.log_det_from_block_cholesky(lb)),
        np.linalg.slogdet(A)[1],
        rtol=1e-11,
    )


@pytest.mark.parametrize("nb,B,W,r", [(4, 3, 1, 2), (6, 3, 2, 1), (5, 2, 3, 4)])
def test_block_solves(nb, B, W, r):
    blocks, A = random_block_banded_spd(1, nb, B, W)
    lb = block.cholesky_block_banded(blocks)
    Ld = np.linalg.cholesky(A)
    b = np.random.RandomState(2).randn(nb * B, r)

    x = block.solve_lower_block_banded(lb, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(Ld, b), atol=1e-9)

    y = block.solve_upper_block_banded_transpose(lb, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(y), np.linalg.solve(Ld.T, b), atol=1e-9)

    z = block.cholesky_solve_block_banded(lb, jnp.asarray(b[:, 0]))
    np.testing.assert_allclose(np.asarray(z), np.linalg.solve(A, b[:, 0]), atol=1e-8)


@pytest.mark.parametrize("nb,B,W", [(1, 3, 0), (4, 3, 0), (5, 4, 1), (6, 3, 2), (5, 2, 3)])
def test_block_takahashi(nb, B, W):
    blocks, A = random_block_banded_spd(3, nb, B, W)
    lb = block.cholesky_block_banded(blocks)
    sb = block.takahashi_inverse_block_banded(lb)
    Ainv = np.linalg.inv(A)
    want = np.asarray(block.dense_to_block_band(jnp.asarray(Ainv), W, B))
    np.testing.assert_allclose(np.asarray(sb), want, atol=1e-8)


def test_block_roundtrip():
    blocks, A = random_block_banded_spd(4, 5, 3, 2)
    back = block.block_band_to_dense(blocks)
    np.testing.assert_allclose(np.asarray(back), A, atol=1e-12)


def test_block_pipeline_differentiable():
    blocks, A = random_block_banded_spd(5, 4, 2, 1)
    from jax.test_util import check_grads

    def f(blk):
        lb = block.cholesky_block_banded(blk)
        return block.log_det_from_block_cholesky(lb) + jnp.sum(
            block.takahashi_inverse_block_banded(lb)
        )

    check_grads(f, (blocks,), order=1, modes=["rev"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("W,nb,B", [(1, 4, 2), (2, 5, 3), (0, 3, 4)])
def test_chol_block_adjoint_matches_scan_autodiff(W, nb, B):
    """The registered reverse-recursion VJP of cholesky_block_banded must
    equal JAX scan-transpose autodiff of the raw implementation for an
    arbitrary band-supported cotangent."""
    blocks, _ = random_block_banded_spd(0, nb, B, W)
    lbar = jnp.asarray(np.random.RandomState(7).randn(W + 1, nb, B, B))
    for p in range(1, W + 1):
        lbar = lbar.at[p, nb - p:].set(0.0)
    lbar = lbar.at[0].set(jnp.tril(lbar[0]))

    want = jax.grad(
        lambda blk: jnp.vdot(block._cholesky_block_banded_impl(blk), lbar)
    )(blocks)
    got = jax.grad(
        lambda blk: jnp.vdot(block.cholesky_block_banded(blk), lbar)
    )(blocks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-13)
