"""Sufficient statistics for the additive (sum-of-1D-kernels) model.

Reference ``GPR_additive`` stacks per-dimension Kufs and densifies
Kuf·Kufᵀ (asvgp/gpr.py:169-173).  The (d, e) cross blocks genuinely are
dense (points couple arbitrary cell pairs across dimensions), so we store
the full (M, M) matrix with M = Σ m_d — but assemble it scatter-free with
the same sorted-cumsum trick as the Kronecker stats, sorting by the joint
(cell_d, cell_e) pair per block.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AdditiveStats:
    kuf_y: jnp.ndarray    # (M,)
    kufkfu: jnp.ndarray   # (M, M) dense
    yty: jnp.ndarray
    n: jnp.ndarray


def _cell_sums(values, bounds, n_cells: int):
    c = jnp.concatenate([jnp.zeros((1,), values.dtype), jnp.cumsum(values)])
    return c[bounds[1:]] - c[bounds[:-1]]


def _cross_block(v_d, c_d, nc_d, m_d, v_e, c_e, nc_e, m_e):
    """Dense (m_d, m_e) block: Σ_i v_d[i,s] v_e[i,t] at (c_d+s, c_e+t)."""
    kd = v_d.shape[1]
    ke = v_e.shape[1]
    joint = c_d.astype(jnp.int32) * nc_e + c_e.astype(jnp.int32)
    order = jnp.argsort(joint)
    v_d = v_d[order]
    v_e = v_e[order]
    joint_s = joint[order]
    ncells = nc_d * nc_e
    bounds = jnp.searchsorted(joint_s, jnp.arange(ncells + 1, dtype=jnp.int32))
    out = jnp.zeros((m_d, m_e), v_d.dtype)
    for s in range(kd):
        for t in range(ke):
            g = _cell_sums(v_d[:, s] * v_e[:, t], bounds, ncells).reshape(nc_d, nc_e)
            out = out.at[s:s + nc_d, t:t + nc_e].add(g)
    return out


def _additive_stats_local(bases, X, y, w=None) -> AdditiveStats:
    D = len(bases)
    yf = jnp.reshape(y, (-1,))
    evals = [b.evaluate_basis(X[:, d], dx=0) for d, b in enumerate(bases)]
    if w is not None:
        evals = [(v * w[:, None], c) for (v, c) in evals]
        yty = jnp.sum(w * jnp.square(yf))
        n = jnp.sum(w)
    else:
        yty = jnp.sum(jnp.square(yf))
        n = jnp.asarray(yf.shape[0], yf.dtype)

    # Kuf @ y per dim (reuse the 1-D sorted path)
    from asvgp.stats.sufficient import _stats_sorted

    kuf_y = jnp.concatenate(
        [_stats_sorted(bases[d], evals[d][0], evals[d][1], yf)[0] for d in range(D)]
    )

    ms = [b.m for b in bases]
    offs = [0]
    for m in ms:
        offs.append(offs[-1] + m)
    M = offs[-1]
    kk = jnp.zeros((M, M), yf.dtype)
    for d in range(D):
        v_d, c_d = evals[d]
        for e in range(d, D):
            v_e, c_e = evals[e]
            # all evals carry the 0/1 mask; w² = w, so products stay correct
            blk = _cross_block(
                v_d, c_d, bases[d].n_cells, bases[d].m,
                v_e, c_e, bases[e].n_cells, bases[e].m,
            )
            kk = kk.at[offs[d]:offs[d + 1], offs[e]:offs[e + 1]].add(blk)
            if e != d:
                kk = kk.at[offs[e]:offs[e + 1], offs[d]:offs[d + 1]].add(blk.T)
    return AdditiveStats(kuf_y=kuf_y, kufkfu=kk, yty=yty, n=n)


def compute_additive_stats(bases, X, y) -> AdditiveStats:
    return _additive_stats_local(bases, X, y)


def compute_additive_stats_sharded(bases, X, y, mesh, axis: str = "data") -> AdditiveStats:
    def shard_fn(xs, ys):
        s = _additive_stats_local(bases, xs, ys)
        return jax.tree.map(partial(jax.lax.psum, axis_name=axis), s)

    fn = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P()
    )
    from asvgp.stats.sufficient import _unmesh

    with jax.set_mesh(mesh):
        out = fn(X, jnp.reshape(y, (-1,)))
    return _unmesh(out, mesh)
