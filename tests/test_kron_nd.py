"""GPRKron D=3 tests vs dense oracles.

The dense oracle mirrors what the reference's GPR_kron *would* compute for
D=3 (asvgp/gpr.py:282-334 generalized: dense Kuu = kron(K1, K2, K3), dense
Khatri-Rao Kuf) — the reference densifies to m^D x m^D and is unusable past
D=2; our factorized path must reproduce the same math.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp import banded
from asvgp.basis import BSplineBasis
from asvgp.models import Matern12, Matern32
from asvgp.models.kron import GPRKron
from asvgp.features.spline_features import make_kuu
from asvgp.stats.kron_nd import (
    compute_kron_stats_nd,
    compute_kron_stats_nd_sharded,
)


def make_data(n=150, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.05, 0.95, (n, 3))
    X[:, 1] = X[:, 1] * 2.0 - 0.9
    X[:, 2] = X[:, 2] * 0.5 + 0.2
    y = (
        np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) * (1 + X[:, 2])
        + 0.1 * rng.randn(n)
    )
    return jnp.asarray(X), jnp.asarray(y.reshape(-1, 1))


def make_bases(ms=(7, 6, 6), orders=(2, 2, 2)):
    return [
        BSplineBasis(0.0, 1.0, ms[0], orders[0]),
        BSplineBasis(-1.0, 1.2, ms[1], orders[1]),
        BSplineBasis(0.1, 0.8, ms[2], orders[2]),
    ]


def dense_setup(model, params, X):
    kernels, lik = model._build(params)
    Ks = []
    for k, b in zip(kernels, model.bases):
        Ks.append(
            np.asarray(
                banded.band_to_dense(
                    banded.symmetrise_lower_band(make_kuu(k, b)),
                    b.order,
                    b.order,
                )
            )
        )
    Kuu = np.kron(np.kron(Ks[0], Ks[1]), Ks[2])
    Kufs = [
        np.asarray(b.evaluate_basis_dense(X[:, d]))
        for d, b in enumerate(model.bases)
    ]
    Kuf = np.einsum("ip,jp,lp->ijlp", *Kufs).reshape(Kuu.shape[0], -1)
    return kernels, lik, Kuu, Kuf


def test_kron_nd_stats_match_dense():
    X, y = make_data()
    bases = make_bases()
    model = GPRKron((X, y), [Matern32(), Matern12(), Matern32()], bases)
    _, _, _, Kuf = dense_setup(model, model.init_params(), np.asarray(X))
    yv = np.asarray(y)[:, 0]

    np.testing.assert_allclose(np.asarray(model.stats.kuf_y), Kuf @ yv, atol=1e-10)

    ms = [b.m for b in bases]
    ks = [b.order for b in bases]
    KK = (Kuf @ Kuf.T).reshape(*ms, *ms)
    tb = np.asarray(model.stats.t_band)
    rng = np.random.RandomState(1)
    # spot-check 300 random multiband entries against the dense product
    for _ in range(300):
        p = rng.randint(ks[0] + 1)
        o2 = rng.randint(-ks[1], ks[1] + 1)
        o3 = rng.randint(-ks[2], ks[2] + 1)
        q1 = rng.randint(ms[0] - p)
        q2 = rng.randint(max(0, -o2), ms[1] - max(0, o2))
        q3 = rng.randint(max(0, -o3), ms[2] - max(0, o3))
        want = KK[q1 + p, q2 + o2, q3 + o3, q1, q2, q3]
        got = tb[p, o2 + ks[1], o3 + ks[2], q1, q2, q3]
        assert abs(got - want) < 1e-10, (p, o2, o3, q1, q2, q3)


def test_kron_nd_elbo_matches_dense_oracle():
    X, y = make_data()
    bases = make_bases()
    model = GPRKron(
        (X, y),
        [Matern32(0.7, 0.9), Matern32(1.2, 0.5), Matern12(0.9, 0.4)],
        bases,
        noise_variance=0.2,
    )
    params = model.init_params()
    kernels, lik, Kuu, Kuf = dense_setup(model, params, np.asarray(X))
    yv = np.asarray(y)[:, 0]
    n = yv.shape[0]
    s2 = float(lik.variance)

    P = Kuu + (Kuf @ Kuf.T) / s2
    LP = np.linalg.cholesky(P)
    log_det_p = 2 * np.sum(np.log(np.diag(LP)))
    log_det_kuu = np.linalg.slogdet(Kuu)[1]
    c = np.linalg.solve(LP, Kuf @ yv) / s2
    kdiag = float(math.prod(float(k.variance) for k in kernels))
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

    # gradients flow through the whole factorized path
    g = jax.grad(model.training_loss)(params)
    flat, _ = jax.tree.flatten(g)
    assert all(np.all(np.isfinite(np.asarray(x))) for x in flat)


def test_kron_nd_predict_matches_dense_oracle():
    X, y = make_data()
    bases = make_bases(ms=(6, 6, 6))
    model = GPRKron(
        (X, y),
        [Matern32(0.8, 0.7), Matern12(1.1, 0.6), Matern32(0.9, 0.5)],
        bases,
        noise_variance=0.15,
    )
    params = model.init_params()
    kernels, lik, Kuu, Kuf = dense_setup(model, params, np.asarray(X))
    yv = np.asarray(y)[:, 0]
    s2 = float(lik.variance)

    rng = np.random.RandomState(3)
    Xt = rng.uniform(0.1, 0.9, (30, 3))
    Xt[:, 1] = Xt[:, 1] * 2.0 - 0.9
    Xt[:, 2] = Xt[:, 2] * 0.5 + 0.2
    Kuss = [
        np.asarray(b.evaluate_basis_dense(jnp.asarray(Xt[:, d])))
        for d, b in enumerate(model.bases)
    ]
    Kus = np.einsum("ip,jp,lp->ijlp", *Kuss).reshape(Kuu.shape[0], -1)

    P = Kuu + (Kuf @ Kuf.T) / s2
    w = np.linalg.solve(P, Kuf @ yv) / s2
    mean_want = Kus.T @ w
    kdiag = float(math.prod(float(k.variance) for k in kernels))
    var_want = (
        kdiag
        + np.sum(Kus * np.linalg.solve(P, Kus), axis=0)
        - np.sum(Kus * np.linalg.solve(Kuu, Kus), axis=0)
    )
    mean, var = model.predict_f(params, jnp.asarray(Xt))
    np.testing.assert_allclose(np.asarray(mean)[:, 0], mean_want, atol=1e-9)
    np.testing.assert_allclose(np.asarray(var)[:, 0], var_want, atol=1e-9)
    assert np.all(np.asarray(var) > 0)

    # predict_log_density drives the same path through the likelihood
    yt = mean_want + 0.05 * rng.randn(30)
    ld = model.predict_log_density(params, (jnp.asarray(Xt), jnp.asarray(yt)))
    assert np.all(np.isfinite(np.asarray(ld)))


def test_kron_nd_sharded_stats_match():
    # order-1 bases: same code path, ~25x smaller multiband graph — the
    # 8-device shard_map compile of the order-2 D=3 stats takes over an
    # hour on this 1-core host (the D=2 sharded path has full-order
    # coverage in test_sharding_extras)
    X, y = make_data(n=160)
    bases = make_bases(ms=(5, 4, 4), orders=(1, 1, 1))
    single = jax.jit(lambda xx, yy: compute_kron_stats_nd(bases, xx, yy))(
        X, y[:, 0]
    )
    mesh = jax.make_mesh((8,), ("data",))
    sharded = compute_kron_stats_nd_sharded(bases, X, y[:, 0], mesh)
    np.testing.assert_allclose(
        np.asarray(single.kuf_y), np.asarray(sharded.kuf_y), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(single.t_band), np.asarray(sharded.t_band), atol=1e-12
    )


def test_kron_nd_validation_and_bandwidth():
    X, y = make_data()
    bases = make_bases()
    with pytest.raises(ValueError):
        GPRKron((jnp.ones((5, 1)), jnp.ones((5, 1))), [Matern32()], bases[:1])
    model = GPRKron((X, y), [Matern32(), Matern32(), Matern32()], bases)
    ms = [b.m for b in bases]
    assert model.bandwidth == 2 * ms[1] * ms[2] + 2 * ms[2] + 2
