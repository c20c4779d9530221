"""The fused sweep kernels (banded/sweep.py) in Pallas interpret mode
(Triton route) against the plain f64 scan recursions: the seven sweep
outputs — both Cholesky bands, both Takahashi bands, L_P⁻¹b, P⁻¹b and the
tangent of band(Kuu⁻¹) — for k = 1…5 over short, medium and odd m."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp.banded import ops, sweep
from asvgp.banded.layout import dense_to_lower_band

NAMES = ("l_kuu", "l_p", "s_kuu", "s_p", "c0", "u", "sdot_kuu")


def _spd_band(rng, m, k, shift):
    A = rng.randn(m, m + 2 * k) * 0.3
    full = A @ A.T
    mask = np.abs(np.arange(m)[:, None] - np.arange(m)[None]) <= k
    full = np.where(mask, full, 0.0) + shift * np.eye(m)
    return dense_to_lower_band(jnp.asarray(full), k)


@pytest.mark.parametrize("m", [7, 64, 129])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_sweeps_match_scan(k, m):
    rng = np.random.RandomState(10 * k + m)
    kuu = _spd_band(rng, m, k, 2.0 * k + 1.0)
    p = kuu + _spd_band(rng, m, k, 0.0)
    tan = 0.1 * _spd_band(rng, m, k, 0.0)
    b = jnp.asarray(rng.randn(m))
    got = sweep.factor_takahashi_solve(kuu, tan, p, b)
    want = sweep.reference_factor_takahashi_solve(kuu, tan, p, b)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        scale = float(jnp.max(jnp.abs(w)))
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=0, atol=1e-12 * scale,
            err_msg=name,
        )
    # right padding of every band is exactly zero
    for band in (got[0], got[2], got[6]):
        for j in range(1, k + 1):
            assert np.all(np.asarray(band[j, m - j:]) == 0.0)


def test_sweep_supports_and_padding():
    assert not sweep.supports(0)
    assert all(sweep.supports(k) for k in range(1, sweep.KP))
    assert not sweep.supports(sweep.KP)
    band = jnp.arange(12.0).reshape(3, 4)
    cols = sweep._to_cols(band)
    assert cols.shape == (4, sweep.KP)
    np.testing.assert_array_equal(np.asarray(cols[:, :3]), np.asarray(band.T))
    assert np.all(np.asarray(cols[:, 3:]) == 0.0)


def test_sweep_route_falls_back_for_k0():
    """Bandwidth 0 is outside the kernels: the "sweep" route composes the
    scan ops instead."""
    kuu = jnp.full((1, 5), 2.0)
    with ops.impl_scope("sweep"):
        assert not ops._use_sweep(kuu)
        s_kuu, s_p, u = ops.banded_posterior(kuu, 2.0 * kuu, jnp.ones(5))
    np.testing.assert_allclose(np.asarray(s_kuu), 0.5)
    np.testing.assert_allclose(np.asarray(u), 0.25)


def test_sweep_posterior_matches_scan():
    rng = np.random.RandomState(3)
    m, k = 50, 3
    kuu = _spd_band(rng, m, k, 7.0)
    p = kuu + _spd_band(rng, m, k, 0.0)
    b = jnp.asarray(rng.randn(m))
    with ops.impl_scope("sweep"):
        got = ops.banded_posterior(kuu, p, b)
    with ops.impl_scope("scan"):
        want = ops.banded_posterior(kuu, p, b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-12, atol=1e-14)


def test_gpr1d_sweep_route_value_and_grad():
    """One jitted value+grad of GPR1D on the sweep route equals the scan
    route's (the kernel inside the fit loop's program)."""
    from asvgp.basis import B3Spline
    from asvgp.models import GPR1D, Matern32

    rng = np.random.RandomState(0)
    x = rng.uniform(0.02, 0.98, 400)
    y = np.sin(9 * x) + 0.1 * rng.randn(400)
    basis = B3Spline(0.0, 1.0, 30)
    m_sw = GPR1D((x, y), Matern32(lengthscales=0.2), basis, backend="sweep")
    m_sc = GPR1D((x, y), Matern32(lengthscales=0.2), basis, backend="scan")
    p = m_sc.init_params()
    l_sw, g_sw = jax.jit(jax.value_and_grad(m_sw.training_loss))(p)
    l_sc, g_sc = jax.jit(jax.value_and_grad(m_sc.training_loss))(p)
    np.testing.assert_allclose(float(l_sw), float(l_sc), rtol=1e-12)
    for a, c in zip(jax.tree.leaves(g_sw), jax.tree.leaves(g_sc)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c), rtol=1e-9)


@pytest.mark.gpu
def test_sweeps_compiled_on_gpu_match_scan(gpu_device):
    """The Triton-compiled kernels (no interpret mode) on the card."""
    import chip_smoke

    for k in (1, 3, 5):
        core_rel, grad_rel, _, _ = chip_smoke.sweep_vs_scan(gpu_device, k, 257)
        assert core_rel <= 1e-10 and grad_rel <= 1e-8, (k, core_rel, grad_rel)
