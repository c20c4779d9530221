"""Cross-process executable cache (utils/exec_cache.py).

The disk artifact is the compiled PjRt executable itself, so the cached
path must be BIT-IDENTICAL to the uncached path — these tests assert exact
equality, not tolerances.  "New process" is simulated by clearing the
in-process memo so the blob is reloaded from disk.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from asvgp.basis import B3Spline, B4Spline
from asvgp.models import GPR1D, Matern32
from asvgp.models.kron import GPRKron
from asvgp.utils import exec_cache


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    d = str(tmp_path / "exec_cache")
    monkeypatch.setenv("ASVGP_EXEC_CACHE_DIR", d)
    exec_cache._MEMO.clear()
    yield d
    exec_cache._MEMO.clear()


def _blobs(d):
    import os

    return sorted(f for f in os.listdir(d) if f.endswith(".pjrt"))


def test_gpr1d_posterior_predict_cached_exact(cache_env):
    rng = np.random.RandomState(0)
    x = rng.uniform(0.05, 0.95, 400)
    y = np.sin(8 * x) + 0.1 * rng.randn(400)
    xs = rng.uniform(0.1, 0.9, 64)

    model = GPR1D((x, y), Matern32(), B3Spline(0.0, 1.0, 40))
    params = model.init_params()
    n_build = len(_blobs(cache_env))  # stats build (also exec-cached)
    assert n_build >= 1

    post = model.posterior(params)
    m1, v1 = post.predict_f(xs)
    blobs = _blobs(cache_env)
    assert len(blobs) == n_build + 2  # + posterior factorization + predict chunk

    # "new process": memo cleared, fresh model — must load from disk and
    # reproduce exactly
    exec_cache._MEMO.clear()
    model2 = GPR1D((x, y), Matern32(), B3Spline(0.0, 1.0, 40))
    post2 = model2.posterior(params)
    m2, v2 = post2.predict_f(xs)
    assert _blobs(cache_env) == blobs  # reused, not re-written
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))

    # and it must match the completely uncached path
    import os

    os.environ.pop("ASVGP_EXEC_CACHE_DIR")
    exec_cache._MEMO.clear()
    post3 = model.posterior(params)
    m3, v3 = post3.predict_f(xs)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m3), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v3), rtol=1e-13)


def test_kron_posterior_predict_cached_exact(cache_env):
    rng = np.random.RandomState(1)
    n = 500
    X = rng.uniform(0.05, 0.95, (n, 2))
    y = np.sin(5 * X[:, 0]) * np.cos(4 * X[:, 1]) + 0.1 * rng.randn(n)
    Xs = rng.uniform(0.1, 0.9, (32, 2))

    def build():
        return GPRKron(
            (X, y), [Matern32()] * 2,
            [B4Spline(0.0, 1.0, 14), B4Spline(0.0, 1.0, 14)],
            noise_variance=0.1,
        )

    model = build()
    params = model.init_params()
    n_build = len(_blobs(cache_env))  # stats build (also exec-cached)
    assert n_build >= 1
    post = model.posterior(params)
    m1, v1 = post.predict_f(Xs)
    blobs = _blobs(cache_env)
    assert len(blobs) == n_build + 2

    exec_cache._MEMO.clear()
    post2 = build().posterior(params)
    m2, v2 = post2.predict_f(Xs)
    assert _blobs(cache_env) == blobs
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_cache_key_distinguishes_basis_domain(cache_env):
    """Same shapes, different basis domain => different executables (the
    basis tables are baked into the executable as closure constants — a key
    collision here would silently predict with the WRONG mesh)."""
    rng = np.random.RandomState(2)
    x = rng.uniform(0.3, 0.7, 300)
    y = np.sin(8 * x) + 0.1 * rng.randn(300)
    xs = rng.uniform(0.35, 0.65, 32)

    m1 = GPR1D((x, y), Matern32(), B3Spline(0.0, 1.0, 30))
    m2 = GPR1D((x, y), Matern32(), B3Spline(0.25, 0.75, 30))
    n_build = len(_blobs(cache_env))
    assert n_build == 2  # one stats executable per domain, not shared
    p = m1.init_params()
    r1 = m1.posterior(p).predict_f(xs)
    r2 = m2.posterior(p).predict_f(xs)
    # + per-domain posterior factorization and predict chunk, none shared
    assert len(_blobs(cache_env)) == n_build + 4
    assert not np.allclose(np.asarray(r1[1]), np.asarray(r2[1]))
