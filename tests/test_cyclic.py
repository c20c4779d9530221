"""Block-cyclic-reduction banded algebra (banded/cyclic.py) vs the scan
ops: values, the gradient-derived selected inverse, and autodiff."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp import banded
from asvgp.banded import cyclic
from asvgp.banded import ops as bops


def random_band(key, m, k, diag=2.0):
    kl, kd = jax.random.split(jax.random.PRNGKey(key))
    l0 = jax.random.normal(kl, (k + 1, m), jnp.float64) * 0.3
    l0 = l0.at[0].set(diag + jax.random.uniform(kd, (m,), jnp.float64))
    l0 = banded.mask_lower_band(l0)
    L0 = banded.lower_band_to_dense(l0)
    return banded.dense_to_lower_band(L0 @ L0.T, k)


@pytest.mark.parametrize("m,k", [(13, 1), (40, 2), (129, 3), (64, 5)])
def test_cr_matches_scan(m, k):
    a = random_band(m * 7 + k, m, k)
    b = jax.random.normal(jax.random.PRNGKey(m + k), (m,), jnp.float64)
    l = bops.cholesky_band(a)
    np.testing.assert_allclose(
        float(cyclic.cr_logdet(a)),
        float(bops.log_det_from_cholesky(l)), rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(cyclic.cr_solve(a, b)),
        np.asarray(bops.cholesky_solve_band(l, b)), rtol=1e-11, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(cyclic.cr_inverse_band(a)),
        np.asarray(bops.takahashi_inverse_band(l)), rtol=1e-10, atol=1e-12,
    )


def test_cr_collapsed_core_equivalence():
    """The 4 ELBO scalars computed the CR way (trace = <grad logdet, B>)
    match the scan composition, and so does the full input gradient
    (second-order autodiff through CR)."""
    m, k = 120, 3
    kuu = random_band(1, m, k)
    p = random_band(2, m, k, diag=4.0)
    b = jax.random.normal(jax.random.PRNGKey(3), (m,), jnp.float64)
    big = random_band(4, m, k, diag=3.0)
    coef = jnp.asarray([0.7, -1.3, 0.11, 0.37], jnp.float64)

    def cr_loss(kuu_, p_, b_, big_):
        u = cyclic.cr_solve(p_, b_)
        out = (
            cyclic.cr_logdet(kuu_),
            cyclic.cr_logdet(p_),
            jnp.vdot(b_, u),
            cyclic.cr_trace(kuu_, big_),
        )
        return sum(c * o for c, o in zip(coef, out))

    def scan_loss(kuu_, p_, b_, big_):
        bops.set_impl("scan")
        try:
            l_kuu = bops.cholesky_band(kuu_)
            l_p = bops.cholesky_band(p_)
            s_kuu = bops.takahashi_inverse_band(l_kuu)
            u = bops.cholesky_solve_band(l_p, b_)
            w = cyclic.band_weights(k, m, kuu_.dtype)
            out = (
                bops.log_det_from_cholesky(l_kuu),
                bops.log_det_from_cholesky(l_p),
                jnp.vdot(b_, u),
                jnp.sum(w * s_kuu * big_),
            )
            return sum(c * o for c, o in zip(coef, out))
        finally:
            bops.set_impl("auto")

    np.testing.assert_allclose(
        float(cr_loss(kuu, p, b, big)), float(scan_loss(kuu, p, b, big)),
        rtol=1e-11,
    )
    g_cr = jax.grad(cr_loss, argnums=(0, 1, 2, 3))(kuu, p, b, big)
    g_sc = jax.grad(scan_loss, argnums=(0, 1, 2, 3))(kuu, p, b, big)
    for g, w_, name in zip(g_cr, g_sc, ["kuu", "p", "b", "big"]):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w_), rtol=1e-7, atol=1e-9, err_msg=name
        )
