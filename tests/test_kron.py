"""GPRKron tests vs dense oracles (SURVEY.md §3.4).

The dense oracle mirrors the *reference's* Kronecker computation
(asvgp/gpr.py:282-334): dense Kuu = kron(Kuu1, Kuu2), dense Khatri-Rao Kuf,
dense Cholesky ELBO — which our factorized/block-banded path must reproduce.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp import banded
from asvgp.basis import BSplineBasis
from asvgp.models import Matern12, Matern32, Matern52
from asvgp.models.kron import GPRKron
from asvgp.features.spline_features import make_kuu
from asvgp.stats.kron import compute_kron_stats, compute_kron_stats_sharded


def make_data(n=120, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 0.95, (n, 2))
    X[:, 1] = X[:, 1] * 2.0 - 0.9  # different domain in dim 2
    y = np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.1 * rng.randn(n)
    return jnp.asarray(X), jnp.asarray(y.reshape(-1, 1))


def dense_setup(model, params):
    kernels, lik = model._build(params)
    b1, b2 = model.bases
    K1 = np.asarray(
        banded.band_to_dense(
            banded.symmetrise_lower_band(make_kuu(kernels[0], b1)), b1.order, b1.order
        )
    )
    K2 = np.asarray(
        banded.band_to_dense(
            banded.symmetrise_lower_band(make_kuu(kernels[1], b2)), b2.order, b2.order
        )
    )
    Kuu = np.kron(K1, K2)
    X, y = make_data()
    Kuf1 = np.asarray(b1.evaluate_basis_dense(X[:, 0]))  # (m1, n)
    Kuf2 = np.asarray(b2.evaluate_basis_dense(X[:, 1]))  # (m2, n)
    Kuf = np.einsum("ip,jp->ijp", Kuf1, Kuf2).reshape(Kuf1.shape[0] * Kuf2.shape[0], -1)
    return kernels, lik, Kuu, Kuf, np.asarray(X), np.asarray(y)[:, 0]


@pytest.mark.slow
@pytest.mark.parametrize(
    "kfns,orders,ms",
    [
        ((Matern32, Matern32), (3, 3), (10, 9)),
        ((Matern12, Matern52), (2, 3), (8, 11)),
    ],
)
def test_kron_stats_match_dense(kfns, orders, ms):
    X, y = make_data()
    bases = [
        BSplineBasis(0.0, 1.0, ms[0], orders[0]),
        BSplineBasis(-1.0, 1.2, ms[1], orders[1]),
    ]
    kernels = [kfns[0](), kfns[1]()]
    model = GPRKron((X, y), kernels, bases)
    _, _, _, Kuf, _, yv = dense_setup(model, model.init_params())

    np.testing.assert_allclose(
        np.asarray(model.stats.kuf_y), Kuf @ yv, atol=1e-10
    )
    KK = Kuf @ Kuf.T
    m1, m2 = ms
    k1, k2 = orders
    KK4 = KK.reshape(m1, m2, m1, m2)
    tb = np.asarray(model.stats.t_band)
    for p in range(k1 + 1):
        for o2 in range(-k2, k2 + 1):
            for q1 in range(m1 - p):
                for q2 in range(max(0, -o2), m2 - max(0, o2)):
                    want = KK4[q1 + p, q2 + o2, q1, q2]
                    got = tb[p, o2 + k2, q1, q2]
                    assert abs(got - want) < 1e-10, (p, o2, q1, q2)


def test_kron_elbo_matches_dense_oracle():
    X, y = make_data()
    bases = [BSplineBasis(0.0, 1.0, 10, 3), BSplineBasis(-1.0, 1.2, 9, 3)]
    model = GPRKron((X, y), [Matern32(0.7, 0.9), Matern32(1.2, 0.5)], bases,
                    noise_variance=0.2)
    params = model.init_params()
    kernels, lik, Kuu, Kuf, Xn, yv = dense_setup(model, params)
    n = yv.shape[0]
    s2 = float(lik.variance)

    # reference-style dense collapsed ELBO (gpr.py:282-308)
    P = Kuu + (Kuf @ Kuf.T) / s2
    LP = np.linalg.cholesky(P)
    log_det_p = 2 * np.sum(np.log(np.diag(LP)))
    log_det_kuu = np.linalg.slogdet(Kuu)[1]
    c = np.linalg.solve(LP, Kuf @ yv) / s2
    kdiag = float(kernels[0].variance * kernels[1].variance)
    want = (
        -0.5 * n * math.log(2 * math.pi * s2)
        - 0.5 * log_det_p
        + 0.5 * log_det_kuu
        - 0.5 * yv @ yv / s2
        + 0.5 * np.sum(c**2)
        - 0.5 * n * kdiag / s2
        + 0.5 * np.trace(np.linalg.solve(Kuu, Kuf @ Kuf.T)) / s2
    )
    got = float(model.elbo(params))
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.slow
def test_kron_predict_matches_dense_oracle():
    X, y = make_data()
    bases = [BSplineBasis(0.0, 1.0, 9, 2), BSplineBasis(-1.0, 1.2, 8, 2)]
    model = GPRKron((X, y), [Matern32(0.8, 0.7), Matern12(1.1, 0.6)], bases,
                    noise_variance=0.15)
    params = model.init_params()
    kernels, lik, Kuu, Kuf, Xn, yv = dense_setup(model, params)
    s2 = float(lik.variance)

    rng = np.random.RandomState(3)
    Xt = rng.uniform(0.1, 0.9, (40, 2))
    Xt[:, 1] = Xt[:, 1] * 2.0 - 0.9
    b1, b2 = model.bases
    Kus1 = np.asarray(b1.evaluate_basis_dense(jnp.asarray(Xt[:, 0])))
    Kus2 = np.asarray(b2.evaluate_basis_dense(jnp.asarray(Xt[:, 1])))
    Kus = np.einsum("ip,jp->ijp", Kus1, Kus2).reshape(Kuu.shape[0], -1)

    P = Kuu + (Kuf @ Kuf.T) / s2
    w = np.linalg.solve(P, Kuf @ yv) / s2
    mean_want = Kus.T @ w
    kdiag = float(kernels[0].variance * kernels[1].variance)
    var_want = (
        kdiag
        + np.sum(Kus * np.linalg.solve(P, Kus), axis=0)
        - np.sum(Kus * np.linalg.solve(Kuu, Kus), axis=0)
    )
    mean, var = model.predict_f(params, jnp.asarray(Xt))
    np.testing.assert_allclose(np.asarray(mean)[:, 0], mean_want, atol=1e-9)
    np.testing.assert_allclose(np.asarray(var)[:, 0], var_want, atol=1e-9)
    assert np.all(np.asarray(var) > 0)


@pytest.mark.slow
def test_kron_elbo_is_trainable_and_bounded():
    """ELBO improves under L-BFGS and stays a finite scalar."""
    from asvgp.train import fit_lbfgs

    X, y = make_data(n=300, seed=5)
    bases = [BSplineBasis(0.0, 1.0, 10, 3), BSplineBasis(-1.0, 1.2, 10, 3)]
    model = GPRKron((X, y), [Matern32(), Matern32()], bases)
    p0 = model.init_params()
    e0 = float(model.elbo(p0))
    pf, loss, iters = fit_lbfgs(jax.jit(model.training_loss), p0, max_iters=60)
    assert np.isfinite(e0) and np.isfinite(float(loss))
    assert -float(loss) > e0 + 1.0


def test_kron_sharded_stats_match():
    X, y = make_data(n=160)
    bases = [BSplineBasis(0.0, 1.0, 9, 3), BSplineBasis(-1.0, 1.2, 9, 3)]
    single = jax.jit(lambda xx, yy: compute_kron_stats(bases, xx, yy))(X, y[:, 0])
    mesh = jax.make_mesh((8,), ("data",))
    sharded = compute_kron_stats_sharded(bases, X, y[:, 0], mesh)
    np.testing.assert_allclose(np.asarray(single.kuf_y), np.asarray(sharded.kuf_y), atol=1e-12)
    np.testing.assert_allclose(np.asarray(single.t_band), np.asarray(sharded.t_band), atol=1e-12)


def test_kron_validation():
    X, y = make_data()
    bases = [BSplineBasis(0.0, 1.0, 9, 3), BSplineBasis(-1.0, 1.2, 9, 3)]
    with pytest.raises(ValueError):
        GPRKron((jnp.ones((5, 3)), jnp.ones((5, 1))), [Matern32()] * 3, bases + bases[:1])
    with pytest.raises(ValueError):
        GPRKron((X, y), [Matern32(), Matern32()],
                [BSplineBasis(0.4, 1.0, 9, 3), bases[1]])  # dim-0 outside domain
    model = GPRKron((X, y), [Matern32(), Matern32()], bases)
    assert model.bandwidth == 3 * 9 + 3
