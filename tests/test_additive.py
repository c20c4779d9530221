"""GPRAdditive tests vs dense oracles (reference asvgp/gpr.py:139-236)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp import banded
from asvgp.basis import BSplineBasis
from asvgp.features.spline_features import make_kuu
from asvgp.models import Matern12, Matern32, Matern52
from asvgp.models.additive import GPRAdditive


def make_data(n=120, D=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 0.95, (n, D))
    y = sum(np.sin((d + 2) * X[:, d]) for d in range(D)) + 0.1 * rng.randn(n)
    return jnp.asarray(X), jnp.asarray(y.reshape(-1, 1))


def dense_setup(model, params, X):
    kernels, lik = model._build(params)
    Kuus, Kufs = [], []
    for d, b in enumerate(model.bases):
        Kuus.append(
            np.asarray(
                banded.band_to_dense(
                    banded.symmetrise_lower_band(make_kuu(kernels[d], b)),
                    b.order, b.order,
                )
            )
        )
        Kufs.append(np.asarray(b.evaluate_basis_dense(X[:, d])))
    Kuu = np.zeros((sum(k.shape[0] for k in Kuus),) * 2)
    o = 0
    for K in Kuus:
        Kuu[o:o + K.shape[0], o:o + K.shape[0]] = K
        o += K.shape[0]
    Kuf = np.vstack(Kufs)
    return kernels, lik, Kuu, Kuf


def test_additive_stats_and_elbo_match_dense():
    X, y = make_data()
    bases = [
        BSplineBasis(0.0, 1.0, 10, 3),
        BSplineBasis(0.0, 1.0, 12, 3),
        BSplineBasis(0.0, 1.0, 9, 3),
    ]
    model = GPRAdditive(
        (X, y), [Matern32(0.8, 0.5), Matern12(1.1, 0.9), Matern52(0.6, 0.7)],
        bases, noise_variance=0.25,
    )
    params = model.init_params()
    kernels, lik, Kuu, Kuf = dense_setup(model, params, np.asarray(X))
    yv = np.asarray(y)[:, 0]
    n = yv.shape[0]
    s2 = float(lik.variance)

    np.testing.assert_allclose(np.asarray(model.stats.kuf_y), Kuf @ yv, atol=1e-10)
    np.testing.assert_allclose(np.asarray(model.stats.kufkfu), Kuf @ Kuf.T, atol=1e-10)

    # reference-style dense additive ELBO (gpr.py:178-208)
    P = Kuu + Kuf @ Kuf.T / s2
    LP = np.linalg.cholesky(P)
    c = np.linalg.solve(LP, Kuf @ yv) / s2
    total_var = sum(float(k.variance) for k in kernels)
    want = (
        -0.5 * n * math.log(2 * math.pi * s2)
        - np.sum(np.log(np.diag(LP)))
        + 0.5 * np.linalg.slogdet(Kuu)[1]
        - 0.5 * yv @ yv / s2
        + 0.5 * np.sum(c**2)
        - 0.5 * n * total_var / s2
        + 0.5 * np.trace(np.linalg.solve(Kuu, Kuf @ Kuf.T)) / s2
    )
    np.testing.assert_allclose(float(model.elbo(params)), want, rtol=1e-9)


def test_additive_predict_matches_dense():
    X, y = make_data(n=90, D=2, seed=2)
    bases = [BSplineBasis(0.0, 1.0, 9, 2), BSplineBasis(0.0, 1.0, 11, 2)]
    model = GPRAdditive((X, y), [Matern32(0.9, 0.6), Matern32(0.7, 0.8)], bases,
                        noise_variance=0.2)
    params = model.init_params()
    kernels, lik, Kuu, Kuf = dense_setup(model, params, np.asarray(X))
    yv = np.asarray(y)[:, 0]
    s2 = float(lik.variance)

    Xt = np.random.RandomState(7).uniform(0.1, 0.9, (31, 2))
    Kus = np.vstack(
        [np.asarray(b.evaluate_basis_dense(jnp.asarray(Xt[:, d]))) for d, b in enumerate(bases)]
    )
    P = Kuu + Kuf @ Kuf.T / s2
    w = np.linalg.solve(P, Kuf @ yv) / s2
    mean_want = Kus.T @ w
    var_want = (
        sum(float(k.variance) for k in kernels)
        + np.sum(Kus * np.linalg.solve(P, Kus), axis=0)
        - np.sum(Kus * np.linalg.solve(Kuu, Kus), axis=0)
    )
    mean, var = model.predict_f(params, jnp.asarray(Xt))
    np.testing.assert_allclose(np.asarray(mean)[:, 0], mean_want, atol=1e-9)
    np.testing.assert_allclose(np.asarray(var)[:, 0], var_want, atol=1e-9)


def test_additive_trains():
    from asvgp.train import fit_lbfgs

    X, y = make_data(n=200, D=2, seed=4)
    bases = [BSplineBasis(0.0, 1.0, 12, 3)] * 2
    model = GPRAdditive((X, y), [Matern32(), Matern32()], bases)
    p0 = model.init_params()
    e0 = float(model.elbo(p0))
    pf, loss, _ = fit_lbfgs(jax.jit(model.training_loss), p0, max_iters=60)
    assert np.isfinite(float(loss)) and -float(loss) > e0


def test_additive_validation():
    X, y = make_data(D=2)
    with pytest.raises(ValueError):
        GPRAdditive((X, y), [Matern32()], [BSplineBasis(0.0, 1.0, 10, 3)])


def _to_blocks(P, rhs, B=128):
    """Pad SPD (M, M) to a multiple of B (identity on the padded diagonal,
    zero rhs rows) and take full-bandwidth block-lower storage."""
    from asvgp.banded import block as _block

    M = P.shape[0]
    n_pad = (-M) % B
    if n_pad:
        P = jnp.pad(P, ((0, n_pad), (0, n_pad)))
        r = jnp.arange(M, M + n_pad)
        P = P.at[r, r].set(1.0)
        rhs = jnp.pad(rhs, (0, n_pad))
    nb = P.shape[0] // B
    return _block.dense_to_block_band(P, nb - 1, B), rhs, M


def _logdet_halfsolve_block(P, rhs):
    from asvgp.banded import block as _block

    blocks, rhs_p, M = _to_blocks(P, rhs)
    L = _block.cholesky_block_banded(blocks)
    c = _block.solve_lower_block_banded(L, rhs_p)
    return _block.log_det_from_block_cholesky(L), c[:M]


def _solve_and_inverse_block(P, rhs):
    from asvgp.banded import block as _block

    blocks, rhs_p, M = _to_blocks(P, rhs)
    L = _block.cholesky_block_banded(blocks)
    w = _block.cholesky_solve_block_banded(L, rhs_p)
    S = _block.takahashi_inverse_block_banded(L)
    return w[:M], _block.block_band_to_dense(S)[:M, :M]


def test_dense_block_route_matches_f64():
    """A dense SPD matrix is block-banded at full block bandwidth: the
    block-banded ops (with identity padding) must equal the plain dense f64
    path the additive coupling uses — value, half-solve, full inverse, and
    gradients."""

    rng = np.random.RandomState(3)
    M = 300  # pads 300 -> 384 = 3 blocks of 128
    A = rng.randn(M, M) / np.sqrt(M)
    P0 = A @ A.T + np.eye(M)
    rhs0 = rng.randn(M)
    P = jnp.asarray(P0)
    rhs = jnp.asarray(rhs0)

    ld, c = _logdet_halfsolve_block(P, rhs)
    sign, ld_np = np.linalg.slogdet(P0)
    L_np = np.linalg.cholesky(P0)
    c_np = np.linalg.solve(L_np, rhs0)
    assert sign > 0
    np.testing.assert_allclose(float(ld), ld_np, rtol=1e-11)
    np.testing.assert_allclose(np.asarray(c), c_np, rtol=1e-9, atol=1e-11)

    w, Pinv = _solve_and_inverse_block(P, rhs)
    np.testing.assert_allclose(
        np.asarray(w), np.linalg.solve(P0, rhs0), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(Pinv), np.linalg.inv(P0), rtol=1e-7, atol=1e-9
    )

    # gradients of an ELBO-shaped composite through the custom VJPs
    def f_block(p):
        ld, c = _logdet_halfsolve_block(p, rhs)
        return -0.5 * ld + 0.5 * jnp.sum(jnp.square(c))

    def f_ref(p):
        lp = jnp.linalg.cholesky(p)
        cc = jax.scipy.linalg.solve_triangular(lp, rhs, lower=True)
        return (
            -jnp.sum(jnp.log(jnp.diagonal(lp)))
            + 0.5 * jnp.sum(jnp.square(cc))
        )

    # the block route reads only P's lower triangle (dense_to_block_band)
    # so its matrix-level cotangent lives on the lower triangle; jax's
    # cholesky VJP symmetrizes.  Both represent the same functional on
    # symmetric perturbations — P is built symmetric upstream — so compare
    # the symmetrized cotangents.
    g_block = np.asarray(jax.grad(f_block)(P))
    g_ref = np.asarray(jax.grad(f_ref)(P))
    np.testing.assert_allclose(
        g_block + g_block.T, g_ref + g_ref.T, rtol=1e-7, atol=1e-10
    )
