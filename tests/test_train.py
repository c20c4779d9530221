"""Training-loop, checkpoint, logging and DP-train-step tests."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax

from asvgp.basis import B3Spline
from asvgp.models import GPR1D, Matern32
from asvgp.models.gpr1d import default_params
from asvgp.parallel import make_dp_train_step, shard_data
from asvgp.train import (
    fit_adam_minibatch,
    fit_lbfgs,
    load_pytree,
    save_pytree,
)
from asvgp.train.logging import MetricsLogger, WallClock


def make_data(n=512, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.02, 0.98, n)
    y = np.sin(8 * x) + 0.1 * rng.randn(n)
    return x, y


import pytest


@pytest.mark.slow
def test_adam_minibatch_improves_elbo():
    x, y = make_data(2048)
    basis = B3Spline(0.0, 1.0, 32)
    model = GPR1D((x, y), Matern32(), basis)
    p0 = model.init_params()
    params, losses = fit_adam_minibatch(
        basis, 3, x, y, p0, batch_size=256, steps=300, learning_rate=0.05
    )
    # stochastic losses: compare full-batch ELBO before/after
    assert float(model.elbo(params)) > float(model.elbo(p0))
    assert losses.shape == (300,)
    assert np.all(np.isfinite(np.asarray(losses)))


def test_dp_train_step_matches_full_batch_gradient():
    x, y = make_data(256)
    basis = B3Spline(0.0, 1.0, 24)
    mesh = jax.make_mesh((8,), ("data",))
    step, opt = make_dp_train_step(basis, 3, mesh, optimizer=optax.sgd(0.0))
    params = default_params(Matern32())
    state = opt.init(params)
    xs, ys = shard_data(jnp.asarray(x), jnp.asarray(y), mesh)
    _, _, loss = step(params, state, xs, ys)

    model = GPR1D((x, y), Matern32(), basis)
    np.testing.assert_allclose(
        float(loss), float(model.training_loss(model.init_params())), rtol=1e-10
    )


def test_checkpoint_roundtrip_and_resume():
    x, y = make_data()
    model = GPR1D((x, y), Matern32(), B3Spline(0.0, 1.0, 24))
    params, loss, _ = fit_lbfgs(
        jax.jit(model.training_loss), model.init_params(), max_iters=20
    )
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.pkl")
        save_pytree(path, params)
        restored = load_pytree(path, model.init_params())
    np.testing.assert_allclose(
        float(model.training_loss(restored)), float(loss), rtol=1e-14
    )


def test_metrics_logger_and_wallclock():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "metrics.jsonl")
        logger = MetricsLogger(path)
        logger.log(0, elbo=-1.5, grad_norm=jnp.asarray(0.3))
        logger.log(1, elbo=-1.2)
        logger.close()
        with open(path) as f:
            lines = f.readlines()
    assert len(lines) == 2
    import json

    row = json.loads(lines[0])
    assert row["step"] == 0 and abs(row["elbo"] + 1.5) < 1e-12

    clock = WallClock()
    with clock.section("a"):
        pass
    assert "a" in clock.summary() and "total" in clock.summary()


def test_interop_roundtrips():
    from asvgp.utils import kuf_to_scipy, lower_band_to_scipy, scipy_to_lower_band
    from asvgp.features.spline_features import make_kuu

    basis = B3Spline(0.0, 1.0, 20)
    kuu = make_kuu(Matern32(), basis)
    sp = lower_band_to_scipy(kuu)
    back = scipy_to_lower_band(sp, 3)
    np.testing.assert_allclose(back, np.asarray(kuu), atol=1e-14)

    x, _ = make_data(64)
    K = kuf_to_scipy(basis, x)
    assert K.shape == (20, 64)
    np.testing.assert_allclose(np.asarray(K.sum(axis=0)).ravel(), 1.0, rtol=1e-12)


def test_fit_lbfgs_cache_refits_on_new_data():
    """The in-process refit cache must parameterize by the model data.

    Regression test: jax.closure_convert returns zero hoisted consts in
    this jax version, which silently baked the first fit's sufficient
    statistics into the reused executable — a cached refit on different
    data returned the FIRST model's optimum.  fit_lbfgs now hoists via
    make_jaxpr/eval_jaxpr and refuses a cache when nothing was hoisted.
    """
    rng = np.random.RandomState(0)
    x = rng.uniform(0.05, 0.95, 400)
    y1 = np.sin(8 * x) + 0.1 * rng.randn(400)
    y2 = np.cos(5 * x) - 0.3 + 0.2 * rng.randn(400)
    basis = B3Spline(0.0, 1.0, 50)

    cache = {}
    m1 = GPR1D((x, y1), Matern32(), basis)
    _, l1, _ = fit_lbfgs(
        jax.jit(m1.training_loss), m1.init_params(), max_iters=60,
        cache=cache,
    )
    assert "compiled" in cache

    m2 = GPR1D((x, y2), Matern32(), basis)
    p2c, l2c, _ = fit_lbfgs(
        jax.jit(m2.training_loss), m2.init_params(), max_iters=60,
        cache=cache,
    )
    p2, l2, _ = fit_lbfgs(
        jax.jit(m2.training_loss), m2.init_params(), max_iters=60,
    )
    # the cached refit must equal the uncached fit on the NEW data...
    np.testing.assert_allclose(float(l2c), float(l2), rtol=1e-9)
    for ka, kb in zip(jax.tree.leaves(p2c), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(ka), np.asarray(kb), rtol=1e-6)
    # ...and must NOT reproduce the first fit
    assert abs(float(l2c) - float(l1)) > 1e-3


def _export_roundtrip_case(tmp_path, suffix):
    """The disk cache must (a) write one artifact, (b) reuse it for a
    same-structure fit on NEW data (consts are runtime arguments, not
    baked in), and (c) reproduce the uncached fit exactly."""
    rng = np.random.RandomState(1)
    x = rng.uniform(0.05, 0.95, 300)
    y1 = np.sin(6 * x) + 0.1 * rng.randn(300)
    y2 = np.cos(4 * x) + 0.2 * rng.randn(300)
    basis = B3Spline(0.0, 1.0, 40)
    d = str(tmp_path / "export")

    m1 = GPR1D((x, y1), Matern32(), basis)
    _, l1, _ = fit_lbfgs(
        jax.jit(m1.training_loss), m1.init_params(), max_iters=40,
        export_dir=d,
    )
    import os

    blobs = os.listdir(d)
    assert len(blobs) == 1 and blobs[0].endswith(suffix)

    m2 = GPR1D((x, y2), Matern32(), basis)
    t2 = {}
    p2e, l2e, _ = fit_lbfgs(
        jax.jit(m2.training_loss), m2.init_params(), max_iters=40,
        export_dir=d, timings=t2,
    )
    assert os.listdir(d) == blobs  # reused, not re-written
    p2, l2, _ = fit_lbfgs(
        jax.jit(m2.training_loss), m2.init_params(), max_iters=40,
    )
    np.testing.assert_allclose(float(l2e), float(l2), rtol=1e-9)
    for ka, kb in zip(jax.tree.leaves(p2e), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(ka), np.asarray(kb), rtol=1e-6)
    assert abs(float(l2e) - float(l1)) > 1e-6


def test_fit_lbfgs_pjrt_cache_roundtrip(tmp_path):
    # default mode: the compiled PjRt executable is the disk artifact
    _export_roundtrip_case(tmp_path, ".pjrt")


def test_fit_lbfgs_data_args_matches_closure_path(tmp_path):
    """The data_args fast path (no closure hoist: the warm-process trace
    saver used by the protocol drivers) must produce the same fit as the
    hoisted path, reuse its disk blob across same-structure fits on new
    data, and work with the in-process refit cache."""
    import os

    rng = np.random.RandomState(2)
    x = rng.uniform(0.05, 0.95, 300)
    y1 = np.sin(6 * x) + 0.1 * rng.randn(300)
    y2 = np.cos(4 * x) + 0.2 * rng.randn(300)
    basis = B3Spline(0.0, 1.0, 40)
    d = str(tmp_path / "export")

    m1 = GPR1D((x, y1), Matern32(), basis)
    p1h, l1h, _ = fit_lbfgs(
        jax.jit(m1.training_loss), m1.init_params(), max_iters=40,
    )
    fn1, dargs1, tag1 = m1.loss_args()
    cache = {}
    p1a, l1a, _ = fit_lbfgs(
        fn1, m1.init_params(), max_iters=40,
        data_args=dargs1, key_extra=tag1, export_dir=d, cache=cache,
    )
    np.testing.assert_allclose(float(l1a), float(l1h), rtol=1e-9)
    for ka, kb in zip(jax.tree.leaves(p1a), jax.tree.leaves(p1h)):
        np.testing.assert_allclose(np.asarray(ka), np.asarray(kb), rtol=1e-6)
    blobs = os.listdir(d)
    assert len(blobs) == 1 and blobs[0].endswith(".pjrt")

    # same structure, new data: blob AND refit cache reused, result = fresh
    m2 = GPR1D((x, y2), Matern32(), basis)
    fn2, dargs2, tag2 = m2.loss_args()
    assert tag2 == tag1
    p2a, l2a, _ = fit_lbfgs(
        fn2, m2.init_params(), max_iters=40,
        data_args=dargs2, key_extra=tag2, export_dir=d,
    )
    assert os.listdir(d) == blobs  # reused, not re-written
    p2c, l2c, _ = fit_lbfgs(
        fn2, m2.init_params(), max_iters=40,
        data_args=dargs2, key_extra=tag2, cache=cache,
    )
    p2, l2, _ = fit_lbfgs(
        jax.jit(m2.training_loss), m2.init_params(), max_iters=40,
    )
    np.testing.assert_allclose(float(l2a), float(l2), rtol=1e-9)
    np.testing.assert_allclose(float(l2c), float(l2), rtol=1e-9)
    for ka, kb in zip(jax.tree.leaves(p2a), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(ka), np.asarray(kb), rtol=1e-6)
    assert abs(float(l2a) - float(l1a)) > 1e-6  # not the first fit's data


def test_fit_lbfgs_export_mode_roundtrip(tmp_path, monkeypatch):
    # round-3 jax.export control path, kept for the A/B probe
    monkeypatch.setenv("ASVGP_CACHE_MODE", "export")
    _export_roundtrip_case(tmp_path, ".jaxexport")


def test_exec_cache_key_ignores_unrelated_sources():
    """A comment edit in e.g. models/vff.py must not invalidate cached
    fit-loop executables (round-3 VERDICT weak #7): the source component of
    the cache key covers only the kernel (banded/) and train/ modules whose
    bodies a structural jaxpr digest cannot see."""
    import os

    from asvgp.utils import exec_cache

    paths = exec_cache.digest_paths()
    rel = {os.path.relpath(p, os.path.dirname(os.path.dirname(
        exec_cache.__file__))) for p in paths}
    assert any(p.startswith("banded/") and p.endswith("sweep.py")
               for p in rel)
    assert any(p == "train/lbfgs.py" for p in rel)
    assert not any(p.startswith("models/") for p in rel)
    assert not any(p.startswith("features/") for p in rel)
    # and the digest is deterministic within a process
    assert exec_cache.kernel_source_digest() == exec_cache.kernel_source_digest()


def test_exec_cache_key_survives_model_comment_edit():
    """Dynamic version of the above: actually append a comment to
    models/vff.py (restored afterwards), recompute digests as a fresh
    process would, and check the fit-loop key component is unchanged while
    the package digest (used by the posterior caches, which close over
    model code) correctly changes."""
    import os

    from asvgp.utils import exec_cache

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(exec_cache.__file__)))
    vff = os.path.join(pkg, "models", "vff.py")
    with open(vff, "rb") as f:
        orig = f.read()

    exec_cache._KERNEL_DIGEST = None
    exec_cache._PKG_DIGEST = None
    k0 = exec_cache.kernel_source_digest()
    p0 = exec_cache.package_source_digest()
    try:
        with open(vff, "ab") as f:
            f.write(b"\n# transient comment (test_exec_cache_key...)\n")
        exec_cache._KERNEL_DIGEST = None
        exec_cache._PKG_DIGEST = None
        assert exec_cache.kernel_source_digest() == k0
        assert exec_cache.package_source_digest() != p0
    finally:
        with open(vff, "wb") as f:
            f.write(orig)
        exec_cache._KERNEL_DIGEST = None
        exec_cache._PKG_DIGEST = None
