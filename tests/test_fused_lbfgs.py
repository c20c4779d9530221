"""Fused (single-eval-site) L-BFGS engine vs the optax reference engine.

The fused driver (asvgp/train/fused_lbfgs.py) reimplements
optax.lbfgs + scale_by_zoom_linesearch as one while loop with the
objective inlined at a single site.  The algorithm is intended to be
step-for-step identical, so these tests require trajectory-level
agreement (same iteration counts, final losses equal to float-reduction
noise), not just "both converge".

Reference counterpart: gpflow.optimizers.Scipy (SciPy L-BFGS-B) used by
every reference experiment, e.g. /root/reference/experiments/snelson/
example.py:31-32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp.train.lbfgs import fit_lbfgs


def _both(loss, p0, **kw):
    out = {}
    for eng in ("optax", "fused"):
        info = {}
        p, l, it = fit_lbfgs(loss, p0, engine=eng, info=info, **kw)
        out[eng] = (p, float(l), it, info)
    return out


def test_quadratic_matches_optax():
    A = jnp.array(np.random.RandomState(0).randn(8, 8))
    Q = A @ A.T + 8 * jnp.eye(8)
    b = jnp.array(np.random.RandomState(1).randn(8))
    out = _both(lambda p: 0.5 * p @ Q @ p - b @ p, jnp.zeros(8))
    (_, lo, ito, io), (_, lf, itf, if_) = out["optax"], out["fused"]
    assert ito == itf
    assert abs(lo - lf) < 1e-10
    assert io["converged"] and if_["converged"]
    # fused counts the initial eval, optax's num_linesearch_steps doesn't
    assert if_["ls_evals"] == io["ls_evals"] + 1


def test_rosenbrock_matches_optax():
    def rosen(p):
        return jnp.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2
                       + (1 - p[:-1]) ** 2)

    out = _both(rosen, jnp.full(6, -1.2), max_iters=300)
    (_, lo, ito, _), (_, lf, itf, _) = out["optax"], out["fused"]
    assert ito == itf
    assert abs(lo - lf) < 1e-12


def test_pytree_params_and_info_fields():
    def f(p):
        x, y = p["a"], p["b"]
        return (jnp.sum(1e4 * x ** 2) + jnp.sum((y - 3.0) ** 4)
                + jnp.sum(x) * jnp.sum(jnp.cos(y)))

    out = _both(f, {"a": jnp.ones(3), "b": jnp.zeros(2)}, max_iters=200)
    (_, lo, ito, _), (pf, lf, itf, if_) = out["optax"], out["fused"]
    assert ito == itf
    assert abs(lo - lf) < 1e-10
    assert set(pf) == {"a", "b"}
    assert if_["evals_per_iter"] >= 1.0
    assert "stopping_rule" in if_


def test_iteration_cap_and_grad_norm():
    def rosen(p):
        return jnp.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2
                       + (1 - p[:-1]) ** 2)

    info = {}
    _, _, iters = fit_lbfgs(rosen, jnp.full(6, -1.2), engine="fused",
                            max_iters=10, info=info)
    assert iters == 10
    assert not info["converged"]
    assert info["grad_norm"] > 0


def test_snelson_matches_optax():
    X = np.loadtxt("data/snelson/train_inputs").reshape(-1, 1)
    y = np.loadtxt("data/snelson/train_outputs").reshape(-1, 1)
    from asvgp.basis import B3Spline
    from asvgp.models import GPR1D, Matern32

    model = GPR1D((X, y), Matern32(), B3Spline(-3.5, 10.5, 100))
    out = _both(jax.jit(model.training_loss), model.init_params())
    (_, lo, ito, _), (_, lf, itf, _) = out["optax"], out["fused"]
    assert ito == itf
    assert abs(lo - lf) < 1e-6
    assert abs(lf - 60.836) < 0.5


def test_restarts_accounting_fused():
    # a fit that converges on the first run: restarts must not run/consume
    def quad(p):
        return jnp.sum((p - 2.0) ** 2)

    info = {}
    _, _, iters = fit_lbfgs(quad, jnp.zeros(4), engine="fused",
                            restarts=2, info=info)
    assert info["restarts"] == 0
    assert info["converged"]
    assert "rejected_restart_iters" not in info


def test_engine_in_refit_cache_key():
    # same shapes, different engine: the in-process cache must not reuse
    def quad(p, c):
        return jnp.sum((p - c) ** 2)

    c = jnp.full(4, 2.0)
    cache = {}
    p1, l1, _ = fit_lbfgs(lambda p: quad(p, c), jnp.zeros(4),
                          engine="fused", cache=cache)
    key1 = cache["key"]
    p2, l2, _ = fit_lbfgs(lambda p: quad(p, c), jnp.zeros(4),
                          engine="optax", cache=cache)
    assert cache["key"] != key1
    assert abs(float(l1) - float(l2)) < 1e-10
