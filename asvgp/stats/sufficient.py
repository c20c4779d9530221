"""Sufficient statistics: Kuf·y, banded Kuf·Kufᵀ, yᵀy — on device.

Replacement of the reference's scipy spMV/spSYRK precompute
(reference asvgp/gpr.py:39-44, SURVEY.md §2.2 N3).  Kuf is never
materialized: each data point contributes its (order+1) contiguous basis
weights, so

  * ``Kuf @ y``       is a windowed scatter-add into (m,)
  * ``Kuf @ Kuf^T``   is banded with bandwidth = order; diagonal j collects
                      Σ_i w_{s} w_{s+j} at position start_i + s

Both are sums over data points => data-parallel: shard X, y over the device
mesh, compute partial statistics per device, ``psum`` across devices
(SURVEY.md §2.4).  The sharded entry point is :func:`compute_stats_sharded`.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SufficientStats:
    """The collapsed-ELBO sufficient statistics (reference gpr.py:39-44)."""

    kuf_y: jnp.ndarray        # (m,)
    kufkfu_band: jnp.ndarray  # (order+1, m), lower band of Kuf Kuf^T
    yty: jnp.ndarray          # scalar
    n: jnp.ndarray            # scalar (float) number of points


def kuf_matvec(vals, start, y, m: int) -> jnp.ndarray:
    """Kuf @ y from the structured-sparse Kuf: scatter-add of w_i * y_i."""
    kp1 = vals.shape[1]
    idx = start[:, None] + jnp.arange(kp1, dtype=start.dtype)[None, :]
    out = jnp.zeros((m,), dtype=vals.dtype)
    return out.at[idx].add(vals * y[:, None])


def kufkfu_band(vals, start, m: int) -> jnp.ndarray:
    """Lower band (order+1, m) of Kuf @ Kuf^T via windowed scatter-adds."""
    kp1 = vals.shape[1]
    rows = []
    for j in range(kp1):
        w = vals[:, : kp1 - j] * vals[:, j:]
        idx = start[:, None] + jnp.arange(kp1 - j, dtype=start.dtype)[None, :]
        rows.append(jnp.zeros((m,), dtype=vals.dtype).at[idx].add(w))
    return jnp.stack(rows, axis=0)


def _cell_sums(values, bounds, n_cells: int):
    """Per-cell sums of ``values`` (n,) sorted by cell, from cumsum +
    boundary gathers — no scatter (scatter-adds serialize on duplicate
    indices; this is the fast path for large N)."""
    c = jnp.concatenate([jnp.zeros((1,), values.dtype), jnp.cumsum(values)])
    return c[bounds[1:]] - c[bounds[:-1]]


def _stats_sorted(basis, vals, start, yf) -> tuple:
    """Scatter-free Kuf·y and banded Kuf·Kufᵀ.

    Sorts points by mesh cell once, then every band diagonal is a handful of
    length-N cumsums + (n_cells,) boundary gathers (SURVEY.md §7.3 item 4:
    'bucket points by mesh cell, segment-sum the (k+1)x(k+1) outer products
    per cell, fold cells into band diagonals').
    """
    kp1 = vals.shape[1]
    m = basis.m
    n_cells = basis.n_cells
    order = jnp.argsort(start)
    vals_s = vals[order]
    y_s = yf[order]
    start_s = start[order]
    bounds = jnp.searchsorted(start_s, jnp.arange(n_cells + 1, dtype=start.dtype))

    def fold(per_cell_list):
        """rows[s] holds per-cell sums destined for position cell + s."""
        out = jnp.zeros((m,), vals.dtype)
        for s, pc in enumerate(per_cell_list):
            out = out.at[s:s + n_cells].add(pc)
        return out

    kuf_y = fold([_cell_sums(vals_s[:, s] * y_s, bounds, n_cells) for s in range(kp1)])
    band_rows = []
    for j in range(kp1):
        per_cell = [
            _cell_sums(vals_s[:, s] * vals_s[:, s + j], bounds, n_cells)
            for s in range(kp1 - j)
        ]
        band_rows.append(fold(per_cell))
    return kuf_y, jnp.stack(band_rows, axis=0)


def _stats_local(basis, X, y, w=None) -> SufficientStats:
    """Per-shard statistics.  ``w`` optionally masks padded points (0/1)."""
    yf = jnp.reshape(y, (-1,))
    vals, start = basis.evaluate_basis(X, dx=0)
    if w is not None:
        vals = vals * w[:, None]
        yty = jnp.sum(w * jnp.square(yf))
        n = jnp.sum(w)
    else:
        yty = jnp.sum(jnp.square(yf))
        n = jnp.asarray(yf.shape[0], yf.dtype)
    # vals carry the mask, so kuf_y and the band are already w-weighted
    kuf_y, band = _stats_sorted(basis, vals, start, yf)
    return SufficientStats(kuf_y=kuf_y, kufkfu_band=band, yty=yty, n=n)


def compute_stats(basis, X, y) -> SufficientStats:
    """Single-device sufficient statistics (jittable)."""
    return _stats_local(basis, X, y)


def _unmesh(tree, mesh):
    """Move fully-replicated shard_map outputs off the mesh onto its first
    device as plain single-device arrays.  The psum'd statistics are
    replicated, but under jax's explicit-sharding types they stay tagged
    with the mesh — which then poisons later single-device programs (the
    banded scans' dynamic_update_slice rejects mixed shardings inside the
    fit loop; caught by tests/test_dp_protocol.py)."""
    dev = list(np.asarray(mesh.devices).flat)[0]
    # host round-trip, NOT device_put: under jax's explicit-sharding types a
    # device_put keeps the Explicit('data') tag in the aval, which still
    # fails sharding type checks downstream.  The statistics are m-sized, so
    # the copy is trivial next to the O(N) compute they summarize.
    return jax.tree.map(
        lambda a: jax.device_put(np.asarray(a), dev), tree
    )


def compute_stats_sharded(basis, X, y, mesh, axis: str = "data") -> SufficientStats:
    """Data-parallel sufficient statistics over a device mesh.

    Shards (X, y) along ``axis`` of ``mesh``, computes per-device partial
    statistics, and ``psum``s them across devices — the DP backbone of the rebuild
    (SURVEY.md §2.4).  N must be divisible by the axis size (pad upstream
    with :func:`pad_for_sharding` if not).
    """

    def shard_fn(xs, ys):
        s = _stats_local(basis, xs, ys)
        return jax.tree.map(partial(jax.lax.psum, axis_name=axis), s)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
    )
    with jax.set_mesh(mesh):
        out = fn(jnp.reshape(X, (-1,)), jnp.reshape(y, (-1,)))
    return _unmesh(out, mesh)


def pad_for_sharding(X, y, num_shards: int):
    """Pad (X, y) to a multiple of num_shards; returns (X, y, weights).

    Padded points replicate X[0] with weight 0 so they stay inside the basis
    domain but contribute nothing (used with the masked stats path).
    """
    x = jnp.reshape(X, (-1,))
    yf = jnp.reshape(y, (-1,))
    n = x.shape[0]
    rem = (-n) % num_shards
    if rem == 0:
        return x, yf, jnp.ones((n,), x.dtype)
    xpad = jnp.concatenate([x, jnp.full((rem,), x[0], x.dtype)])
    ypad = jnp.concatenate([yf, jnp.zeros((rem,), yf.dtype)])
    w = jnp.concatenate([jnp.ones((n,), x.dtype), jnp.zeros((rem,), x.dtype)])
    return xpad, ypad, w


def compute_stats_sharded_masked(basis, X, y, w, mesh, axis: str = "data") -> SufficientStats:
    """Sharded stats with a 0/1 weight mask (for padded N)."""

    def shard_fn(xs, ys, ws):
        s = _stats_local(basis, xs, ys, ws)
        return jax.tree.map(partial(jax.lax.psum, axis_name=axis), s)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(),
    )
    with jax.set_mesh(mesh):
        out = fn(jnp.reshape(X, (-1,)), jnp.reshape(y, (-1,)), jnp.reshape(w, (-1,)))
    return _unmesh(out, mesh)
