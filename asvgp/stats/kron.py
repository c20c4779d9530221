"""Kronecker (tensor-product) sufficient statistics for 2-D models.

Replacement for the reference's Khatri-Rao scipy pipeline
(asvgp/kronecker.py:7-33, asvgp/gpr.py:268-273): the joint Kuf column for a
point x is the outer product of its per-dimension spline weight vectors, so

  Kuf·y                       — (k1+1)(k2+1) windowed scatter per point
  KufKfu = Kuf Kufᵀ           — *Kronecker-banded*: entry ((i1,i2),(j1,j2))
                                 nonzero iff |i1-j1|<=k1 AND |i2-j2|<=k2

Instead of the reference's m²xm² densification (gpr.py:272) we store the
multiband tensor

  T[p, o2+k2, q1, q2] = Σ_i w1[s1] w1[s1+p] w2[s2] w2[s2+o2]
      over s1, s2 with q1 = c1+s1, q2 = c2+s2
  (block-lower: p = i1-j1 in 0..k1; o2 = i2-j2 in -k2..k2)

of shape (k1+1, 2k2+1, m1, m2) — O((2k)² m²) instead of O(m⁴).  Assembly
uses the same scatter-free sorted-cumsum trick as the 1-D stats
(stats/sufficient.py), sorting once by joint mesh cell.  All statistics are
sums over data ⇒ shardable over N with psum (see compute_kron_stats_sharded).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KronStats:
    kuf_y: jnp.ndarray       # (m1*m2,)
    t_band: jnp.ndarray      # (k1+1, 2*k2+1, m1, m2) multiband of Kuf Kufᵀ
    yty: jnp.ndarray
    n: jnp.ndarray


def _cell_sums(values, bounds, n_cells: int):
    c = jnp.concatenate([jnp.zeros((1,), values.dtype), jnp.cumsum(values)])
    return c[bounds[1:]] - c[bounds[:-1]]


def _pairs(k: int):
    """Unordered index pairs (a, b), a <= b, over 0..k."""
    return [(a, b) for a in range(k + 1) for b in range(a, k + 1)]


def _kron_stats_local(bases, X, y, w=None) -> KronStats:
    """Batched pair-product build.

    Every T-band series is a 4-product v1[a]·v1[b] · v2[c]·v2[d]; pair
    symmetry (products commute) dedupes the (k+1)²(k+1)² raw series down to
    the outer product of per-dimension unordered pairs — 15×15 = 225 unique
    series at order 4 instead of 525 — and all of them (plus the
    (k1+1)(k2+1) Kuf·y series) reduce to per-cell sums through ONE shared
    sorted-cumsum pipeline, batched in (n, ~128)-column blocks
    rather than one (n,) cumsum per series.
    """
    b1, b2 = bases
    k1, k2 = b1.order, b2.order
    m1, m2 = b1.m, b2.m
    nc1, nc2 = b1.n_cells, b2.n_cells
    yf = jnp.reshape(y, (-1,))

    v1, c1 = b1.evaluate_basis(X[:, 0], dx=0)
    v2, c2 = b2.evaluate_basis(X[:, 1], dx=0)
    if w is not None:
        v1 = v1 * w[:, None]  # weight folded into dim-1 only (w is 0/1)
        yty = jnp.sum(w * jnp.square(yf))
        n = jnp.sum(w)
    else:
        yty = jnp.sum(jnp.square(yf))
        n = jnp.asarray(yf.shape[0], yf.dtype)

    # sort once by joint cell
    joint = c1.astype(jnp.int32) * nc2 + c2.astype(jnp.int32)
    order = jnp.argsort(joint)
    v1 = v1[order]
    v2 = v2[order]
    ys = yf[order]
    joint_s = joint[order]
    ncells = nc1 * nc2
    bounds = jnp.searchsorted(joint_s, jnp.arange(ncells + 1, dtype=jnp.int32))

    pairs1 = _pairs(k1)
    pairs2 = _pairs(k2)
    p1idx = {p: i for i, p in enumerate(pairs1)}
    p2idx = {p: i for i, p in enumerate(pairs2)}
    np1, np2 = len(pairs1), len(pairs2)

    P1 = jnp.stack([v1[:, a] * v1[:, b] for a, b in pairs1], axis=1)
    P2 = jnp.stack([v2[:, a] * v2[:, b] for a, b in pairs2], axis=1)
    Y1 = v1 * ys[:, None]

    def cell_block(cols):
        """(n, c) column block → (nc1, nc2, c) per-cell sums."""
        c = jnp.cumsum(cols, axis=0)
        c = jnp.concatenate([jnp.zeros((1, cols.shape[1]), cols.dtype), c], 0)
        return (c[bounds[1:]] - c[bounds[:-1]]).reshape(nc1, nc2, cols.shape[1])

    # Pair-product cell grids, chunked so a column block is ~128 columns wide
    # and (n, 128) f64 stays a modest HBM footprint at n=2M.
    g = max(1, 128 // np2)
    t_grids = []
    for i0 in range(0, np1, g):
        blk = P1[:, i0:i0 + g, None] * P2[:, None, :]
        blk = blk.reshape(blk.shape[0], -1)
        t_grids.append(cell_block(blk))
    G = jnp.concatenate(t_grids, axis=2)  # (nc1, nc2, np1*np2)
    ky_cols = (Y1[:, :, None] * v2[:, None, :]).reshape(yf.shape[0], -1)
    GY = cell_block(ky_cols)  # (nc1, nc2, (k1+1)(k2+1))

    # ---- Kuf @ y ----------------------------------------------------------
    kuf_y = jnp.zeros((m1, m2), v1.dtype)
    for s1 in range(k1 + 1):
        for s2 in range(k2 + 1):
            g_ = GY[:, :, s1 * (k2 + 1) + s2]
            kuf_y = kuf_y.at[s1:s1 + nc1, s2:s2 + nc2].add(g_)

    # ---- multiband of Kuf Kufᵀ --------------------------------------------
    t_rows = []
    for p in range(k1 + 1):
        o2_rows = []
        for o2 in range(-k2, k2 + 1):
            acc = jnp.zeros((m1, m2), v1.dtype)
            s2_lo = max(0, -o2)
            s2_hi = min(k2, k2 - o2)
            for s1 in range(k1 + 1 - p):
                i = p1idx[(s1, s1 + p)]
                for s2 in range(s2_lo, s2_hi + 1):
                    j = p2idx[(min(s2, s2 + o2), max(s2, s2 + o2))]
                    g_ = G[:, :, i * np2 + j]
                    acc = acc.at[s1:s1 + nc1, s2:s2 + nc2].add(g_)
            o2_rows.append(acc)
        t_rows.append(jnp.stack(o2_rows, axis=0))
    t_band = jnp.stack(t_rows, axis=0)

    return KronStats(kuf_y=kuf_y.reshape(-1), t_band=t_band, yty=yty, n=n)


def compute_kron_stats(bases, X, y) -> KronStats:
    return _kron_stats_local(bases, X, y)


def compute_kron_stats_sharded(bases, X, y, mesh, axis: str = "data") -> KronStats:
    def shard_fn(xs, ys):
        s = _kron_stats_local(bases, xs, ys)
        return jax.tree.map(partial(jax.lax.psum, axis_name=axis), s)

    fn = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P()
    )
    from asvgp.stats.sufficient import _unmesh

    with jax.set_mesh(mesh):
        out = fn(X, jnp.reshape(y, (-1,)))
    return _unmesh(out, mesh)


def t_band_trace_against_kron(t_band, s1_band, s2_band):
    """trace(Kuu⁻¹ · KufKfu) with Kuu⁻¹ = S1 ⊗ S2 given per-factor Takahashi
    bands — fully elementwise, O((2k)² m²) (the reference densifies to m⁴,
    gpr.py:307)."""
    k1 = t_band.shape[0] - 1
    k2 = (t_band.shape[1] - 1) // 2
    m2 = t_band.shape[3]

    def shift2(row, s):
        # row (m2,): out[q] = row[q + s] with zero fill
        if s == 0:
            return row
        if s > 0:
            return jnp.pad(row[s:], (0, s))
        return jnp.pad(row[: m2 + s], (-s, 0))

    total = 0.0
    for p in range(k1 + 1):
        mult = 1.0 if p == 0 else 2.0
        s1_row = s1_band[p]  # (m1,)
        for o2 in range(-k2, k2 + 1):
            # S2 value at [|o2|, q2 + min(o2, 0)]
            s2_row = shift2(s2_band[abs(o2)], min(o2, 0))  # (m2,)
            total = total + mult * jnp.sum(
                t_band[p, o2 + k2] * s1_row[:, None] * s2_row[None, :]
            )
    return total


def t_band_to_blocks(t_band, kuu1_band, kuu2_dense, sigma2):
    """Assemble the block-banded P = Kuu1 ⊗ Kuu2 + KufKfu/σ².

    Returns blocks of shape (k1+1, m1, m2, m2) in banded/block.py storage
    (block row = i1, block bandwidth k1).
    """
    k1 = t_band.shape[0] - 1
    k2 = (t_band.shape[1] - 1) // 2
    m1, m2 = t_band.shape[2], t_band.shape[3]
    dtype = t_band.dtype

    blocks = jnp.einsum("pj,ab->pjab", kuu1_band, kuu2_dense)
    # embed T/σ² into the (j2+o2, j2) diagonals of each block.  Scatter-free:
    # contract against a static 0/1 diagonal-placement mask (a scatter's
    # VJP is a gather XLA struggles to fuse);
    # M[o2+k2, a, b] = 1 iff a-b == o2, so
    # tblocks[p, j1, a, b] = Σ_o M[o, a, b] · t_band[p, o, j1, b].
    a_i = jnp.arange(m2)[:, None]
    b_i = jnp.arange(m2)[None, :]
    diag_mask = (
        (a_i - b_i)[None, :, :] == jnp.arange(-k2, k2 + 1)[:, None, None]
    ).astype(dtype)
    tblocks = jnp.einsum("oab,pojb->pjab", diag_mask, t_band)
    blocks = blocks + tblocks / sigma2
    # zero out-of-range block rows (i1 = J + p >= m1)
    mask = (
        jnp.arange(m1)[None, :] + jnp.arange(k1 + 1)[:, None] < m1
    ).astype(dtype)
    return blocks * mask[:, :, None, None]
