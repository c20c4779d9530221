"""Generic-D Kronecker (tensor-product) sufficient statistics, D >= 2.

Generalizes stats/kron.py (the tuned D=2 path) to any number of input
dimensions.  The reference's GPR_kron (asvgp/gpr.py:239-359) nominally
accepts D factors but densifies Kuu/P to m^D x m^D (asvgp/utils.py:45-51,
gpr.py:272,292) so it is unusable past D=2; here the statistics stay
multibanded and P stays block-banded along dim 1 with the *trailing* D-1
dimensions flattened dense:

  T[p, o2..oD, j1, j2..jD] = Σ_i Π_d w_d[s_d] w_d[s_d + o_d]
      (p = o1 in 0..k1 block-lower; o_d in -k_d..k_d for d >= 2)

  P = Kuu_1 ⊗ (Kuu_2 ⊗ ... ⊗ Kuu_D) + T/σ²
      → block-banded, block bandwidth k1, dense blocks of size
        M2 = Π_{d>=2} m_d  ⇒  Cholesky O(m1 k1² M2³) instead of O(m^{3D}).

Scaling note: the block-Takahashi band used for prediction stores
(k1+1)·m1·M2² entries, so for D=3 this path is practical up to
m_d ≈ 20-30 per dimension (10⁴-ish total features) — the regime where the
reference's dense O(m^{2D}) storage has long since failed.

All statistics are sums over data ⇒ shardable over N with psum
(compute_kron_stats_nd_sharded).
"""

from __future__ import annotations

import string
from functools import partial
from itertools import product

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from asvgp.stats.kron import KronStats, _cell_sums, _pairs


def _kron_stats_local_nd(bases, X, y, w=None) -> KronStats:
    """Batched pair-product build — the generic-D version of the D=2
    pipeline in stats/kron.py: all T-band series dedupe to the outer
    product of per-dimension unordered index pairs and reduce through one
    shared sorted-cumsum pipeline in wide column blocks."""
    D = len(bases)
    ks = [b.order for b in bases]
    ms = [b.m for b in bases]
    ncs = [b.n_cells for b in bases]
    yf = jnp.reshape(y, (-1,))

    vs, cs = [], []
    for d, b in enumerate(bases):
        v, c = b.evaluate_basis(X[:, d], dx=0)
        vs.append(v)
        cs.append(c.astype(jnp.int32))
    if w is not None:
        vs[0] = vs[0] * w[:, None]  # weight folded into dim-1 only (w is 0/1)
        yty = jnp.sum(w * jnp.square(yf))
        n = jnp.sum(w)
    else:
        yty = jnp.sum(jnp.square(yf))
        n = jnp.asarray(yf.shape[0], yf.dtype)

    # sort once by joint cell (row-major over per-dim cells)
    joint = cs[0]
    for d in range(1, D):
        joint = joint * ncs[d] + cs[d]
    order = jnp.argsort(joint)
    vs = [v[order] for v in vs]
    ys = yf[order]
    joint_s = joint[order]
    npts = yf.shape[0]
    ncells = 1
    for nc in ncs:
        ncells *= nc
    bounds = jnp.searchsorted(joint_s, jnp.arange(ncells + 1, dtype=jnp.int32))

    def cell_block(cols):
        """(n, c) column block → (*ncs, c) per-cell sums."""
        c = jnp.cumsum(cols, axis=0)
        c = jnp.concatenate([jnp.zeros((1, cols.shape[1]), cols.dtype), c], 0)
        return (c[bounds[1:]] - c[bounds[:-1]]).reshape(
            tuple(ncs) + (cols.shape[1],)
        )

    pairs_d = [_pairs(k) for k in ks]
    pidx_d = [{p: i for i, p in enumerate(ps)} for ps in pairs_d]
    nps = [len(ps) for ps in pairs_d]
    P_d = [
        jnp.stack([vs[d][:, a] * vs[d][:, b] for a, b in pairs_d[d]], axis=1)
        for d in range(D)
    ]

    # trailing pair-product matrix over dims 2..D, then chunk over dim-1
    # pairs so each column block is a few hundred columns at most
    Q = P_d[1]
    for d in range(2, D):
        Q = (Q[:, :, None] * P_d[d][:, None, :]).reshape(npts, -1)
    trailing = Q.shape[1]
    g = max(1, 256 // trailing)
    t_grids = []
    for i0 in range(0, nps[0], g):
        blk = (P_d[0][:, i0:i0 + g, None] * Q[:, None, :]).reshape(npts, -1)
        t_grids.append(cell_block(blk))
    G = jnp.concatenate(t_grids, axis=-1)  # (*ncs, Π nps)

    KY = vs[0] * ys[:, None]
    for d in range(1, D):
        KY = (KY[:, :, None] * vs[d][:, None, :]).reshape(npts, -1)
    GY = cell_block(KY)  # (*ncs, Π (k_d+1))

    def t_col(pair_idx):  # mixed-radix pair-combination → column in G
        col = 0
        for d in range(D):
            col = col * nps[d] + pair_idx[d]
        return col

    # ---- Kuf @ y ----------------------------------------------------------
    kuf_y = jnp.zeros(tuple(ms), vs[0].dtype)
    for s in product(*[range(k + 1) for k in ks]):
        col = 0
        for d in range(D):
            col = col * (ks[d] + 1) + s[d]
        sl = tuple(slice(s[d], s[d] + ncs[d]) for d in range(D))
        kuf_y = kuf_y.at[sl].add(GY[..., col])

    # ---- multiband of Kuf Kufᵀ --------------------------------------------
    # axes: (p, o2+k2, ..., oD+kD, j1, ..., jD)
    t_shape = (ks[0] + 1,) + tuple(2 * k + 1 for k in ks[1:]) + tuple(ms)
    t_parts = {}
    for p in range(ks[0] + 1):
        for o in product(*[range(-k, k + 1) for k in ks[1:]]):
            acc = jnp.zeros(tuple(ms), vs[0].dtype)
            s_ranges = [range(ks[0] + 1 - p)] + [
                range(max(0, -o[d]), min(ks[d + 1], ks[d + 1] - o[d]) + 1)
                for d in range(D - 1)
            ]
            for s in product(*s_ranges):
                pi = [pidx_d[0][(s[0], s[0] + p)]]
                for d in range(1, D):
                    a, b = s[d], s[d] + o[d - 1]
                    pi.append(pidx_d[d][(min(a, b), max(a, b))])
                sl = tuple(slice(s[d], s[d] + ncs[d]) for d in range(D))
                acc = acc.at[sl].add(G[..., t_col(pi)])
            t_parts[(p,) + o] = acc

    # assemble the multiband tensor (stack along offset axes)
    def stack_level(prefix, axis):
        if axis == len(t_shape) - D:  # all offset axes consumed
            return t_parts[prefix]
        if axis == 0:
            rng = range(ks[0] + 1)
        else:
            k = ks[axis]
            rng = range(-k, k + 1)
        return jnp.stack([stack_level(prefix + (i,), axis + 1) for i in rng], 0)

    t_band = stack_level((), 0)
    return KronStats(kuf_y=kuf_y.reshape(-1), t_band=t_band, yty=yty, n=n)


def compute_kron_stats_nd(bases, X, y) -> KronStats:
    return _kron_stats_local_nd(bases, X, y)


def compute_kron_stats_nd_sharded(bases, X, y, mesh, axis: str = "data") -> KronStats:
    def shard_fn(xs, ys):
        s = _kron_stats_local_nd(bases, xs, ys)
        return jax.tree.map(partial(jax.lax.psum, axis_name=axis), s)

    fn = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P()
    )
    from asvgp.stats.sufficient import _unmesh

    with jax.set_mesh(mesh):
        out = fn(X, jnp.reshape(y, (-1,)))
    return _unmesh(out, mesh)


def _shift_row(row, s, m):
    """out[q] = row[q + s] with zero fill."""
    if s == 0:
        return row
    if s > 0:
        return jnp.pad(row[s:], (0, s))
    return jnp.pad(row[: m + s], (-s, 0))


def t_band_trace_against_kron_nd(t_band, s_bands):
    """trace(Kuu⁻¹ · KufKfu) with Kuu⁻¹ = ⊗_d S_d given per-factor Takahashi
    bands — fully elementwise (reference densifies to m^{2D}, gpr.py:307)."""
    D = len(s_bands)
    k1 = t_band.shape[0] - 1
    t_ks = [(t_band.shape[1 + i] - 1) // 2 for i in range(D - 1)]
    ms = t_band.shape[-D:]

    total = 0.0
    for p in range(k1 + 1):
        mult = 1.0 if p == 0 else 2.0
        for o in product(*[range(-k, k + 1) for k in t_ks]):
            weight = s_bands[0][p]
            for d in range(1, D):
                row = _shift_row(
                    s_bands[d][abs(o[d - 1])], min(o[d - 1], 0), ms[d]
                )
                weight = weight[..., None] * row
            idx = (p,) + tuple(o[i] + t_ks[i] for i in range(D - 1))
            total = total + mult * jnp.sum(t_band[idx] * weight)
    return total


def t_band_to_blocks_nd(t_band, kuu1_band, kuu_trailing_dense, sigma2):
    """Assemble block-banded P = Kuu1 ⊗ (⊗_{d>=2} Kuu_d) + KufKfu/σ².

    ``kuu_trailing_dense`` is the dense (M2, M2) Kronecker product of the
    trailing factors.  Returns blocks of shape (k1+1, m1, M2, M2) in
    banded/block.py storage (block row = i1, block bandwidth k1).
    """
    # t_band has 1 + (D-1) offset axes + D index axes = 2D axes
    D = t_band.ndim // 2
    k1 = t_band.shape[0] - 1
    t_ks = [(t_band.shape[1 + i] - 1) // 2 for i in range(D - 1)]
    ms = list(t_band.shape[-D:])
    m1 = ms[0]
    m2_total = 1
    for m in ms[1:]:
        m2_total *= m
    dtype = t_band.dtype

    blocks = jnp.einsum("pj,ab->pjab", kuu1_band, kuu_trailing_dense)

    # Embed T/σ² into the multiband diagonals of each block.  Scatter-free:
    # contract a static 0/1 diagonal-placement mask per trailing dimension
    # (M_d[o_d, a_d, b_d] = 1 iff a_d - b_d = o_d), generalizing the D=2
    # einsum in stats/kron.py::t_band_to_blocks.
    masks = []
    for d in range(1, D):
        a_i = jnp.arange(ms[d])[:, None]
        b_i = jnp.arange(ms[d])[None, :]
        masks.append(
            (
                (a_i - b_i)[None, :, :]
                == jnp.arange(-t_ks[d - 1], t_ks[d - 1] + 1)[:, None, None]
            ).astype(dtype)
        )
    # einsum: t[p, o2..oD, j, b2..bD] · Π_d M_d[o_d, a_d, b_d]
    #   → tblocks[p, j, a2..aD, b2..bD]
    letters = iter(string.ascii_lowercase)
    o_l = [next(letters) for _ in range(D - 1)]
    a_l = [next(letters) for _ in range(D - 1)]
    b_l = [next(letters) for _ in range(D - 1)]
    t_sub = "P" + "".join(o_l) + "J" + "".join(b_l)
    mask_subs = [o_l[i] + a_l[i] + b_l[i] for i in range(D - 1)]
    out_sub = "PJ" + "".join(a_l) + "".join(b_l)
    tblocks = jnp.einsum(
        f"{t_sub}," + ",".join(mask_subs) + f"->{out_sub}", t_band, *masks
    ).reshape(k1 + 1, m1, m2_total, m2_total)
    blocks = blocks + tblocks / sigma2

    # zero out-of-range block rows (i1 = J + p >= m1)
    mask = (
        jnp.arange(m1)[None, :] + jnp.arange(k1 + 1)[:, None] < m1
    ).astype(dtype)
    return blocks * mask[:, :, None, None]
