"""Sharded-statistics edge cases: padding/masking and the additive path."""

import jax
import jax.numpy as jnp
import numpy as np

from asvgp.basis import B3Spline, BSplineBasis
from asvgp.stats.additive import (
    compute_additive_stats,
    compute_additive_stats_sharded,
)
from asvgp.stats.sufficient import (
    compute_stats,
    compute_stats_sharded_masked,
    pad_for_sharding,
)


def test_padded_masked_stats_match_unpadded():
    """N not divisible by the mesh: pad with zero-weight points."""
    rng = np.random.RandomState(0)
    n = 203  # not divisible by 8
    x = rng.uniform(0.02, 0.98, n)
    y = np.sin(6 * x) + 0.1 * rng.randn(n)
    basis = B3Spline(0.0, 1.0, 24)

    want = jax.jit(lambda a, b: compute_stats(basis, a, b))(
        jnp.asarray(x), jnp.asarray(y)
    )
    xp, yp, w = pad_for_sharding(jnp.asarray(x), jnp.asarray(y), 8)
    assert xp.shape[0] % 8 == 0
    mesh = jax.make_mesh((8,), ("data",))
    got = compute_stats_sharded_masked(basis, xp, yp, w, mesh)
    np.testing.assert_allclose(np.asarray(got.kuf_y), np.asarray(want.kuf_y), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(got.kufkfu_band), np.asarray(want.kufkfu_band), atol=1e-12
    )
    np.testing.assert_allclose(float(got.yty), float(want.yty), rtol=1e-14)
    assert float(got.n) == n


def test_additive_sharded_stats_match():
    rng = np.random.RandomState(1)
    n = 160
    X = rng.uniform(0.02, 0.98, (n, 2))
    y = np.sin(5 * X[:, 0]) + np.cos(3 * X[:, 1]) + 0.1 * rng.randn(n)
    bases = [BSplineBasis(0.0, 1.0, 16, 3), BSplineBasis(0.0, 1.0, 20, 3)]

    want = jax.jit(lambda a, b: compute_additive_stats(bases, a, b))(
        jnp.asarray(X), jnp.asarray(y)
    )
    mesh = jax.make_mesh((8,), ("data",))
    got = compute_additive_stats_sharded(bases, jnp.asarray(X), jnp.asarray(y), mesh)
    np.testing.assert_allclose(np.asarray(got.kuf_y), np.asarray(want.kuf_y), atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.kufkfu), np.asarray(want.kufkfu), atol=1e-12)


def test_kron_dp_step_full_batch_matches_elbo():
    """make_dp_train_step_kron on the FULL dataset (scale = 1) must report
    exactly the replicated -elbo at the pre-update params, and its update
    must match a plain value_and_grad + optax step computed without any
    mesh — the DP step is the same math, psum-assembled."""
    import optax

    from asvgp.basis import B4Spline
    from asvgp.models import Matern32
    from asvgp.models.kron import GPRKron, kron_collapsed_elbo
    from asvgp.parallel import make_dp_train_step_kron, shard_data

    rng = np.random.RandomState(3)
    n = 256
    X = rng.uniform(0.05, 0.95, (n, 2))
    y = np.sin(5 * X[:, 0]) * np.cos(4 * X[:, 1]) + 0.1 * rng.randn(n)
    bases = [B4Spline(0.0, 1.0, 12)] * 2
    mesh = jax.make_mesh((8,), ("data",))

    model = GPRKron((X, y), [Matern32()] * 2, bases, noise_variance=0.1,
                    backend="scan")
    params = model.init_params()

    step, opt = make_dp_train_step_kron(
        bases, [3, 3], mesh, optimizer=optax.adam(1e-2), num_data_total=n,
    )
    opt_state = opt.init(params)
    xs, ys = shard_data(jnp.asarray(X), jnp.asarray(y), mesh)
    p1, opt_state, loss = step(params, opt_state, xs, ys)

    np.testing.assert_allclose(
        float(loss), -float(model.elbo(params)), rtol=1e-12
    )

    # reference update without a mesh
    loss_ref, grads = jax.value_and_grad(
        lambda p: -kron_collapsed_elbo(bases, [3, 3], p, model.stats)
    )(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    p_ref = optax.apply_updates(params, updates)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_additive_dp_step_full_batch_matches_elbo():
    """make_dp_train_step_additive on the FULL dataset must report exactly
    the replicated -elbo at the pre-update params, and its update must
    match a plain value_and_grad + optax step without any mesh (VERDICT r4
    stretch #8: additive-family DP parity)."""
    import optax

    from asvgp.basis import B3Spline
    from asvgp.models import Matern32
    from asvgp.models.additive import GPRAdditive, additive_collapsed_elbo
    from asvgp.parallel import make_dp_train_step_additive, shard_data

    rng = np.random.RandomState(5)
    n = 256
    X = rng.uniform(0.05, 0.95, (n, 2))
    y = np.sin(5 * X[:, 0]) + np.cos(4 * X[:, 1]) + 0.1 * rng.randn(n)
    bases = [B3Spline(0.0, 1.0, 10), B3Spline(0.0, 1.0, 14)]
    mesh = jax.make_mesh((8,), ("data",))

    model = GPRAdditive((X, y), [Matern32()] * 2, bases, noise_variance=0.1,
                        backend="scan")
    params = model.init_params()

    step, opt = make_dp_train_step_additive(
        bases, [3, 3], mesh, optimizer=optax.adam(1e-2), num_data_total=n,
    )
    opt_state = opt.init(params)
    xs, ys = shard_data(jnp.asarray(X), jnp.asarray(y), mesh)
    p1, opt_state, loss = step(params, opt_state, xs, ys)

    np.testing.assert_allclose(
        float(loss), -float(model.elbo(params)), rtol=1e-12
    )

    loss_ref, grads = jax.value_and_grad(
        lambda p: -additive_collapsed_elbo(bases, [3, 3], p, model.stats)
    )(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    p_ref = optax.apply_updates(params, updates)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
