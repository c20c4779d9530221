"""Data-parallel training step over a jax.sharding.Mesh.

The parallelism story of the rebuild (SURVEY.md §2.4): ASVGP's sufficient
statistics (Kuf·y, banded Kuf·Kufᵀ, yᵀy) are sums over data points, so the
natural first-class strategy is DP — shard (X, y) along the mesh's data
axis, assemble partial statistics per device, ``psum`` them across devices, and
run the tiny O(m k²) banded ELBO replicated.  TP/PP/EP are N/A for this
model family (no layer stack, no experts); large-m tensor parallelism is
documented as optional future work.

The reference is single-process CPU and has no distributed path at all;
this module is a new capability (BASELINE.md north-star: minibatch ELBO +
data-parallel psum reduction).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from asvgp.models.gpr1d import (
    collapsed_elbo_matern,
    params_to_kernel,
    params_to_likelihood,
)
from asvgp.stats.sufficient import SufficientStats, _stats_local


def shard_data(X, y, mesh, axis: str = "data"):
    """Place (X, y) sharded along ``axis``; N must divide the axis size.
    X may be (n,) / (n, 1) (GPR1D) or (n, D) with D >= 2 (GPRKron) — data
    points are always partitioned along the leading axis."""
    sharding = NamedSharding(mesh, P(axis))
    x = jnp.asarray(X)
    if x.ndim != 2 or x.shape[1] == 1:
        x = jnp.reshape(x, (-1,))
    yf = jnp.reshape(y, (-1,))
    return jax.device_put(x, sharding), jax.device_put(yf, sharding)


def make_dp_train_step(basis, nu2: int, mesh, *, axis: str = "data",
                       optimizer=None, num_data_total=None, backend=None):
    """Build a jitted data-parallel training step.

    Returns ``(step, opt)`` where
    ``step(params, opt_state, X_sharded, y_sharded) -> (params, opt_state,
    loss)`` assembles sharded sufficient statistics (psum across devices), then
    takes one optimizer step on the negative collapsed ELBO.  When
    ``num_data_total`` is given, batch statistics are rescaled by
    N_total / N_batch — the stochastic (minibatch) collapsed bound.
    """
    opt = optimizer if optimizer is not None else optax.adam(1e-2)

    def loss_fn(params, stats: SufficientStats):
        # the same objective as GPR1D.elbo, on the psum'd statistics
        kernel = params_to_kernel(params, nu2)
        lik = params_to_likelihood(params)
        kdiag_sum = stats.n * kernel.variance
        return -collapsed_elbo_matern(
            stats, basis, nu2, kernel.variance, kernel.lengthscales,
            lik.variance, kdiag_sum,
        )

    def stats_shardmap(xs, ys):
        s = _stats_local(basis, xs, ys)
        return jax.tree.map(partial(jax.lax.psum, axis_name=axis), s)

    stats_fn = jax.shard_map(
        stats_shardmap, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P()
    )

    @jax.jit
    def step(params, opt_state, x, y):
        stats = stats_fn(x, y)
        if num_data_total is not None:
            scale = jnp.asarray(num_data_total, x.dtype) / stats.n
            stats = SufficientStats(
                kuf_y=stats.kuf_y * scale,
                kufkfu_band=stats.kufkfu_band * scale,
                yty=stats.yty * scale,
                n=stats.n * scale,
            )
        loss, grads = jax.value_and_grad(loss_fn)(params, stats)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return _wrap_in_mesh(step, mesh, backend), opt


def make_dp_train_step_kron(bases, nu2s, mesh, *, axis: str = "data",
                            optimizer=None, num_data_total=None,
                            backend=None):
    """Data-parallel training step for the Kronecker (D>=2) model family.

    Same DP strategy as :func:`make_dp_train_step`: the Kronecker
    sufficient statistics (Kuf·y, the multiband T tensor, yᵀy) are sums
    over data points, so each device assembles them on its (X, y) shard and
    ``psum``s across devices; the block-banded collapsed ELBO
    (models/kron.py kron_collapsed_elbo) then runs replicated on the tiny
    m-shaped statistics.  ``num_data_total`` enables the stochastic
    (minibatch) bound, as in the 1-D step.
    """
    import optax as _optax

    from asvgp.models.kron import kron_collapsed_elbo
    from asvgp.stats.kron import KronStats, _kron_stats_local
    from asvgp.stats.kron_nd import _kron_stats_local_nd

    opt = optimizer if optimizer is not None else _optax.adam(1e-2)
    local = _kron_stats_local if len(bases) == 2 else _kron_stats_local_nd

    def stats_shardmap(xs, ys):
        s = local(bases, xs, ys)
        return jax.tree.map(partial(jax.lax.psum, axis_name=axis), s)

    stats_fn = jax.shard_map(
        stats_shardmap, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P()
    )

    @jax.jit
    def step(params, opt_state, x, y):
        stats = stats_fn(x, y)
        if num_data_total is not None:
            scale = jnp.asarray(num_data_total, y.dtype) / stats.n
            stats = KronStats(
                kuf_y=stats.kuf_y * scale,
                t_band=stats.t_band * scale,
                yty=stats.yty * scale,
                n=stats.n * scale,
            )
        loss, grads = jax.value_and_grad(
            lambda p: -kron_collapsed_elbo(bases, nu2s, p, stats)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return _wrap_in_mesh(step, mesh, backend), opt


def make_dp_train_step_additive(bases, nu2s, mesh, *, axis: str = "data",
                                optimizer=None, num_data_total=None,
                                backend=None):
    """Data-parallel training step for the additive (sum-of-1D-GPs) family.

    Identical DP strategy to the other factories: the additive sufficient
    statistics (stacked Kuf·y, dense coupling KufKfuᵀ, yᵀy) are sums over
    data points — assemble per shard, ``psum`` across devices, then run the
    stats-parameterized collapsed ELBO
    (models/additive.py additive_collapsed_elbo) replicated.
    Reference counterpart: asvgp/gpr.py:139-236 (single-process only).
    """
    import optax as _optax

    from asvgp.models.additive import additive_collapsed_elbo
    from asvgp.stats.additive import AdditiveStats, _additive_stats_local

    opt = optimizer if optimizer is not None else _optax.adam(1e-2)

    def stats_shardmap(xs, ys):
        s = _additive_stats_local(bases, xs, ys)
        return jax.tree.map(partial(jax.lax.psum, axis_name=axis), s)

    stats_fn = jax.shard_map(
        stats_shardmap, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P()
    )

    @jax.jit
    def step(params, opt_state, x, y):
        stats = stats_fn(x, y)
        if num_data_total is not None:
            scale = jnp.asarray(num_data_total, y.dtype) / stats.n
            stats = AdditiveStats(
                kuf_y=stats.kuf_y * scale,
                kufkfu=stats.kufkfu * scale,
                yty=stats.yty * scale,
                n=stats.n * scale,
            )
        loss, grads = jax.value_and_grad(
            lambda p: -additive_collapsed_elbo(bases, nu2s, p, stats)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return _wrap_in_mesh(step, mesh, backend), opt


def _wrap_in_mesh(step, mesh, backend):
    # the banded route follows the mesh's platform (banded/ops.py
    # _target_platform honors jax.set_mesh) unless ``backend`` forces one
    from asvgp.banded import ops as _bops

    replicated = jax.NamedSharding(mesh, P())

    def _replicate(tree):
        # params/opt_state may arrive committed to a single device (model
        # init_params device_puts onto the stats' device for the
        # single-chip fit path) — a mesh-jitted step rejects such
        # arguments ("Received incompatible devices").  Re-place anything
        # device-committed into the mesh-replicated sharding; host values
        # pass through untouched (jit places them itself).
        def place(leaf):
            if getattr(leaf, "sharding", None) is not None \
                    and leaf.sharding != replicated:
                return jax.device_put(leaf, replicated)
            return leaf

        return jax.tree.map(place, tree)

    def step_in_mesh(params, opt_state, x, y):
        with jax.set_mesh(mesh), _bops.impl_scope(backend):
            return step(_replicate(params), _replicate(opt_state), x, y)

    return step_in_mesh
