"""Unit tests for the banded linear-algebra core against dense oracles.

Mirrors the test strategy the reference delegates to the upstream
banded_matrices C++ test suite (SURVEY.md §4): every banded op is checked
against its dense jnp/np twin, including gradients (the reference's C++ ops
carry registered gradients; ours differentiate through lax.scan).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

from asvgp import banded


def random_banded_spd(key, m, k, dtype=jnp.float64):
    """SPD matrix with exact lower bandwidth k, via A = L0 L0^T."""
    kl, kd = jax.random.split(key)
    l0 = jax.random.normal(kl, (k + 1, m), dtype) * 0.3
    diag = 1.0 + jax.random.uniform(kd, (m,), dtype)
    l0 = l0.at[0].set(diag)
    l0 = banded.mask_lower_band(l0)
    L0 = banded.lower_band_to_dense(l0)
    A = L0 @ L0.T
    return banded.dense_to_lower_band(A, k), A


@pytest.mark.parametrize("m,k", [(1, 0), (5, 0), (7, 1), (12, 3), (50, 3), (40, 6), (8, 6)])
def test_layout_roundtrip(m, k):
    key = jax.random.PRNGKey(0)
    a_band, A = random_banded_spd(key, m, k)
    assert np.allclose(banded.lower_band_to_dense(a_band), np.tril(A))
    # general band roundtrip
    full = banded.symmetrise_lower_band(a_band)
    assert np.allclose(banded.band_to_dense(full, k, k), A)
    assert np.allclose(banded.dense_to_band(A, k, k), full)


@pytest.mark.parametrize("m,k", [(1, 0), (5, 0), (7, 1), (12, 3), (50, 3), (40, 6), (8, 6)])
def test_cholesky_band(m, k):
    a_band, A = random_banded_spd(jax.random.PRNGKey(1), m, k)
    l_band = banded.cholesky_band(a_band)
    L_dense = np.linalg.cholesky(np.asarray(A))
    assert np.allclose(np.asarray(banded.lower_band_to_dense(l_band)), L_dense, atol=1e-10)
    # padding slots must be exactly zero
    dense_back = banded.lower_band_to_dense(l_band)
    assert np.allclose(banded.dense_to_lower_band(dense_back, k), l_band)
    # log det
    want = np.linalg.slogdet(np.asarray(A))[1]
    got = banded.log_det_from_cholesky(l_band)
    assert np.allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("m,k,r", [(7, 1, 1), (12, 3, 4), (50, 3, 2), (9, 6, 3)])
def test_triangular_solves(m, k, r):
    a_band, A = random_banded_spd(jax.random.PRNGKey(2), m, k)
    l_band = banded.cholesky_band(a_band)
    L = np.linalg.cholesky(np.asarray(A))
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (m, r), jnp.float64))

    x = banded.solve_lower_band(l_band, jnp.asarray(b))
    assert np.allclose(np.asarray(x), np.linalg.solve(L, b), atol=1e-10)

    y = banded.solve_upper_band_transpose(l_band, jnp.asarray(b))
    assert np.allclose(np.asarray(y), np.linalg.solve(L.T, b), atol=1e-10)

    z = banded.cholesky_solve_band(l_band, jnp.asarray(b))
    assert np.allclose(np.asarray(z), np.linalg.solve(np.asarray(A), b), atol=1e-9)

    # vector (1-D) rhs path
    xv = banded.solve_lower_band(l_band, jnp.asarray(b[:, 0]))
    assert np.allclose(np.asarray(xv), np.linalg.solve(L, b[:, 0]), atol=1e-10)


@pytest.mark.parametrize("m,k", [(5, 0), (12, 3), (40, 6)])
def test_takahashi_inverse_band(m, k):
    a_band, A = random_banded_spd(jax.random.PRNGKey(4), m, k)
    l_band = banded.cholesky_band(a_band)
    s_band = banded.takahashi_inverse_band(l_band)
    S = np.linalg.inv(np.asarray(A))
    want = banded.dense_to_lower_band(jnp.asarray(S), k)
    assert np.allclose(np.asarray(s_band), np.asarray(want), atol=1e-9)


@pytest.mark.parametrize("m,k", [(12, 3), (50, 3), (9, 2)])
def test_band_frobenius(m, k):
    a_band, A = random_banded_spd(jax.random.PRNGKey(5), m, k)
    b_band, B = random_banded_spd(jax.random.PRNGKey(6), m, k)
    got = banded.band_frobenius(a_band, b_band)
    want = np.trace(np.asarray(A) @ np.asarray(B))
    assert np.allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize(
    "m,la,ua,lb,ub,lc,uc",
    [(12, 3, 3, 3, 3, 0, 0), (12, 3, 3, 3, 3, 6, 6), (15, 2, 1, 1, 3, 3, 4), (10, 0, 2, 3, 0, 3, 2)],
)
def test_product_band_band(m, la, ua, lb, ub, lc, uc):
    key = jax.random.PRNGKey(7)
    ka, kb = jax.random.split(key)
    from asvgp.banded.layout import mask_band

    a_band = mask_band(jax.random.normal(ka, (la + ua + 1, m), jnp.float64), la, ua)
    b_band = mask_band(jax.random.normal(kb, (lb + ub + 1, m), jnp.float64), lb, ub)
    A = banded.band_to_dense(a_band, la, ua)
    B = banded.band_to_dense(b_band, lb, ub)
    got = banded.product_band_band(
        a_band, b_band,
        a_lower=la, a_upper=ua, b_lower=lb, b_upper=ub,
        out_lower=lc, out_upper=uc,
    )
    want = banded.dense_to_band(jnp.asarray(np.asarray(A) @ np.asarray(B)), lc, uc)
    assert np.allclose(np.asarray(got), np.asarray(want), atol=1e-12)


@pytest.mark.parametrize("m,k", [(12, 3), (9, 2), (5, 0)])
def test_matvec(m, k):
    a_band, A = random_banded_spd(jax.random.PRNGKey(8), m, k)
    x = jax.random.normal(jax.random.PRNGKey(9), (m,), jnp.float64)
    got = banded.matvec_symmetric_band(a_band, x)
    assert np.allclose(np.asarray(got), np.asarray(A) @ np.asarray(x), atol=1e-12)

    full = banded.symmetrise_lower_band(a_band)
    got2 = banded.matvec_band(full, x, lower=k, upper=k)
    assert np.allclose(np.asarray(got2), np.asarray(A) @ np.asarray(x), atol=1e-12)


@pytest.mark.parametrize("m,k", [(10, 2), (8, 3)])
def test_gradients(m, k):
    """Gradient checks — the reference's C++ ops carry registered gradients
    (SURVEY.md §2.2 N1); ours must differentiate correctly through scan."""
    a_band, _ = random_banded_spd(jax.random.PRNGKey(10), m, k)

    def logdet_fn(ab):
        return banded.log_det_from_cholesky(banded.cholesky_band(ab))

    check_grads(logdet_fn, (a_band,), order=1, modes=["rev"], rtol=1e-6)

    b = jax.random.normal(jax.random.PRNGKey(11), (m,), jnp.float64)

    def solve_fn(ab):
        l = banded.cholesky_band(ab)
        return jnp.sum(jnp.square(banded.cholesky_solve_band(l, b)))

    check_grads(solve_fn, (a_band,), order=1, modes=["rev"], rtol=1e-6)

    def takahashi_fn(ab):
        l = banded.cholesky_band(ab)
        return jnp.sum(banded.takahashi_inverse_band(l))

    check_grads(takahashi_fn, (a_band,), order=1, modes=["rev"], rtol=1e-6)


def test_elbo_style_pipeline_jits():
    """The whole banded pipeline (as used by the ELBO) compiles as one jit."""
    m, k = 64, 3
    a_band, A = random_banded_spd(jax.random.PRNGKey(12), m, k)
    b_band, B = random_banded_spd(jax.random.PRNGKey(13), m, k)
    y = jax.random.normal(jax.random.PRNGKey(14), (m,), jnp.float64)

    @jax.jit
    def pipeline(ab, bb, y):
        l = banded.cholesky_band(ab)
        ld = banded.log_det_from_cholesky(l)
        s = banded.takahashi_inverse_band(l)
        tr = banded.band_frobenius(s, bb)
        c = banded.solve_lower_band(l, y)
        return ld + tr + jnp.sum(jnp.square(c))

    got = pipeline(a_band, b_band, y)
    An, Bn = np.asarray(A), np.asarray(B)
    Ln = np.linalg.cholesky(An)
    want = (
        np.linalg.slogdet(An)[1]
        + np.trace(np.linalg.inv(An) @ Bn)
        + np.sum(np.linalg.solve(Ln, np.asarray(y)) ** 2)
    )
    assert np.allclose(got, want, rtol=1e-10)


def test_impl_scope_threads_backend():
    """GPR1D(backend=...) must control dispatch regardless of ambient
    device context (VERDICT r1 weak #7)."""
    import numpy as np
    from asvgp.banded import ops as bops
    from asvgp.basis import B3Spline
    from asvgp.models import GPR1D, Matern32

    rng = np.random.RandomState(0)
    x = rng.uniform(0.05, 0.95, 500)
    y = np.sin(8 * x) + 0.1 * rng.randn(500)
    basis = B3Spline(0.0, 1.0, 32)

    with pytest.raises(ValueError):
        GPR1D((x, y), Matern32(), basis, backend="nope")

    m_scan = GPR1D((x, y), Matern32(), basis, backend="scan")
    m_auto = GPR1D((x, y), Matern32(), basis)
    p = m_scan.init_params()
    # force the global impl to something else: the explicit backend wins
    bops.set_impl("cr")
    try:
        l_scan = float(m_scan.training_loss(p))
    finally:
        bops.set_impl("auto")
    l_auto = float(m_auto.training_loss(p))
    np.testing.assert_allclose(l_scan, l_auto, rtol=1e-9)
