"""End-to-end data-parallel protocol depth test (VERDICT r2 next #8).

The multichip dryrun (__graft_entry__.dryrun_multichip) proves ONE tiny
sharded step compiles and runs; this test runs the FULL protocol — sharded
sufficient-statistic precompute over an 8-device mesh, then the complete
L-BFGS fit and prediction — at a real protocol shape (N=100k, m=1000,
reference electricity.py's model config) and asserts agreement with the
unsharded fit.  The statistics are sums over data points (SURVEY.md §2.4
DP row): the sharded psum reassociates the reduction, so agreement is
to f64 round-off, not bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp.basis import B3Spline
from asvgp.models import GPR1D, Matern52
from asvgp.train import fit_lbfgs, nlpd


@pytest.mark.slow
def test_dp_full_fit_matches_unsharded():
    rng = np.random.RandomState(0)
    n, m = 100_000, 1000
    x = rng.uniform(0.002, 0.998, n)
    y = np.sin(7 * x) + 0.5 * np.sin(23 * x) + 0.3 * rng.randn(n)
    xte = rng.uniform(0.01, 0.99, 2000)
    yte = np.sin(7 * xte) + 0.5 * np.sin(23 * xte) + 0.3 * rng.randn(2000)
    basis = B3Spline(0.0, 1.0, m)
    kern = lambda: Matern52(lengthscales=0.05)

    mesh = jax.make_mesh((8,), ("data",))
    sharded = GPR1D((x, y), kern(), basis, mesh=mesh)
    local = GPR1D((x, y), kern(), basis)

    # sharded sufficient statistics match the single-device ones
    np.testing.assert_allclose(
        np.asarray(sharded.stats.kuf_y), np.asarray(local.stats.kuf_y),
        rtol=1e-12, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.stats.kufkfu_band),
        np.asarray(local.stats.kufkfu_band), rtol=1e-12, atol=1e-9,
    )
    np.testing.assert_allclose(
        float(sharded.stats.yty), float(local.stats.yty), rtol=1e-14
    )
    assert float(sharded.stats.n) == n

    # the full fit agrees (same objective up to reduction round-off)
    ps, ls, _ = fit_lbfgs(
        jax.jit(sharded.training_loss), sharded.init_params(), max_iters=60
    )
    pl, ll, _ = fit_lbfgs(
        jax.jit(local.training_loss), local.init_params(), max_iters=60
    )
    np.testing.assert_allclose(float(ls), float(ll), rtol=1e-10)
    for a, b in zip(jax.tree.leaves(ps), jax.tree.leaves(pl)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)

    # prediction through the cached posterior agrees
    ld_s = sharded.predict_log_density(ps, (xte, yte))
    ld_l = local.predict_log_density(pl, (xte, yte))
    np.testing.assert_allclose(float(nlpd(ld_s)), float(nlpd(ld_l)),
                               rtol=1e-8)
