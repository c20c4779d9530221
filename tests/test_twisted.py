"""Twisted (two-ended) factorization vs the forward-only ops — exactness.

The twisted core (banded/twisted.py) must reproduce, to f64 roundoff, the
same quantities as the single-ended scan ops it re-derives: log|A|, band of
A⁻¹ (Takahashi), A⁻¹b, and bᵀA⁻¹b.  These are the semantics a two-ended
sweep kernel would be built against.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asvgp.banded import ops
from asvgp.banded import twisted
from asvgp.banded.layout import dense_to_band


def _rand_spd_band(m, k, seed=0):
    rng = np.random.default_rng(seed)
    band = rng.normal(size=(k + 1, m))
    band[0] = np.abs(band[0]) + 2.0 * (k + 1)
    # zero out-of-range tail slots like cholesky_band expects
    for r in range(1, k + 1):
        band[r, m - r:] = 0.0
    return jnp.asarray(band)


def _dense_from_band(band):
    k = band.shape[0] - 1
    m = band.shape[1]
    a = np.zeros((m, m))
    for r in range(k + 1):
        for j in range(m - r):
            a[j + r, j] = band[r, j]
            a[j, j + r] = band[r, j]
    return a


@pytest.mark.parametrize("m,k", [(16, 1), (23, 2), (40, 3), (33, 3), (21, 5)])
def test_flip_band_involution(m, k):
    band = _rand_spd_band(m, k, seed=m + k)
    a = _dense_from_band(np.asarray(band))
    fb = twisted.flip_band(band)
    a_flip = _dense_from_band(np.asarray(fb))
    np.testing.assert_allclose(a_flip, a[::-1, ::-1], rtol=0, atol=0)
    np.testing.assert_allclose(
        np.asarray(twisted.flip_band(fb)), np.asarray(band), atol=0
    )


@pytest.mark.parametrize("m,k", [(16, 1), (23, 2), (40, 3), (33, 3), (21, 5)])
@pytest.mark.parametrize("hoff", [-3, 0, 2])
def test_twisted_inverse_band(m, k, hoff):
    band = _rand_spd_band(m, k, seed=7 * m + k)
    h = twisted.split_point(m, k) + hoff
    ld, z = twisted.twisted_inverse_band(band, h)
    l_ref = ops.cholesky_band(band)
    ld_ref = ops.log_det_from_cholesky(l_ref)
    z_ref = ops.takahashi_inverse_band(l_ref)
    np.testing.assert_allclose(float(ld), float(ld_ref), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(z), np.asarray(z_ref), rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("m,k", [(16, 1), (23, 2), (40, 3), (57, 3)])
def test_twisted_solve_core(m, k):
    band = _rand_spd_band(m, k, seed=3 * m + k)
    rng = np.random.default_rng(99)
    b = jnp.asarray(rng.normal(size=(m,)))
    ld, quad, u, z = twisted.twisted_solve_core(band, b)

    l_ref = ops.cholesky_band(band)
    u_ref = ops.cholesky_solve_band(l_ref, b)
    np.testing.assert_allclose(float(ld),
                               float(ops.log_det_from_cholesky(l_ref)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(quad), float(jnp.vdot(b, u_ref)),
                               rtol=1e-11)
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(
        np.asarray(z), np.asarray(ops.takahashi_inverse_band(l_ref)),
        rtol=1e-10, atol=1e-12,
    )


def test_twisted_collapsed_core_matches_ops():
    m, k = 64, 3
    kuu = _rand_spd_band(m, k, seed=1)
    p = _rand_spd_band(m, k, seed=2)
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.normal(size=(m,)))
    big = _rand_spd_band(m, k, seed=3)

    (ld_kuu, ld_p, quad, trace), (s_kuu, s_p, u) = (
        twisted.twisted_collapsed_core(kuu, p, b, big)
    )
    ref = ops.collapsed_core(kuu, p, b, big)
    for got, want in zip((ld_kuu, ld_p, quad, trace), ref):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-11)


def test_twisted_grads_match_autodiff():
    """Value-and-grad through the twisted scalars == through the plain ops
    (both by plain autodiff in f64) — confirms the twisted composition is
    differentiable and consistent, the contract a custom-VJP kernel
    version would assume."""
    m, k = 48, 2
    kuu = _rand_spd_band(m, k, seed=11)
    p = _rand_spd_band(m, k, seed=12)
    rng = np.random.default_rng(13)
    b = jnp.asarray(rng.normal(size=(m,)))
    big = _rand_spd_band(m, k, seed=14)

    def loss_tw(kuu, p, b, big):
        (a, c, d, e), _ = twisted.twisted_collapsed_core(kuu, p, b, big)
        return 0.7 * a - 1.3 * c + 0.3 * d + 0.11 * e

    def loss_ref(kuu, p, b, big):
        a, c, d, e = ops.collapsed_core(kuu, p, b, big)
        return 0.7 * a - 1.3 * c + 0.3 * d + 0.11 * e

    g_tw = jax.grad(loss_tw, argnums=(0, 1, 2))(kuu, p, b, big)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(kuu, p, b, big)
    for a, r in zip(g_tw, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   rtol=1e-8, atol=1e-10)
