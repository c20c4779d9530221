"""Band storage layout utilities (pack/unpack/transpose/symmetrise).

Equivalents of the reference's ``banded.transpose_band``,
``banded.symmetrise_band``, ``banded.{un,}pack_*`` and
``asvgp.utils.{symmetrise_banded, sparse_to_band, band_to_sparse}``
(reference: asvgp/utils.py:7-57).  Everything here is cheap bookkeeping —
static shifts and masks, fully parallel along the m (column) axis.
"""

from __future__ import annotations

import jax.numpy as jnp


def _validity_mask(l: int, u: int, m: int, dtype) -> jnp.ndarray:
    """Mask of in-range band slots for a general (l, u) band of an m x m matrix."""
    r = jnp.arange(l + u + 1)[:, None]
    i = jnp.arange(m)[None, :]
    row = i + r - u
    return ((row >= 0) & (row < m)).astype(dtype)


def mask_lower_band(band: jnp.ndarray) -> jnp.ndarray:
    """Zero the out-of-range (right-padding) slots of a lower band."""
    k = band.shape[0] - 1
    m = band.shape[1]
    return band * _validity_mask(k, 0, m, band.dtype)


def mask_band(band: jnp.ndarray, l: int, u: int) -> jnp.ndarray:
    """Zero the out-of-range slots of a general (l, u) band."""
    m = band.shape[1]
    return band * _validity_mask(l, u, m, band.dtype)


def lower_band_to_dense(band: jnp.ndarray) -> jnp.ndarray:
    """Expand a lower band (k+1, m) to the dense lower-triangular (m, m) matrix."""
    return band_to_dense(band, band.shape[0] - 1, 0)


def dense_to_lower_band(dense: jnp.ndarray, k: int) -> jnp.ndarray:
    """Extract the lower band (k+1, m) of a dense (m, m) matrix."""
    return dense_to_band(dense, k, 0)


def band_to_dense(band: jnp.ndarray, l: int, u: int) -> jnp.ndarray:
    """Expand a general (l, u) band of shape (l+u+1, m) to dense (m, m).

    band[r, i] -> M[i + r - u, i].
    """
    m = band.shape[1]
    rows = jnp.arange(l + u + 1)[:, None] + jnp.arange(m)[None, :] - u
    cols = jnp.broadcast_to(jnp.arange(m)[None, :], rows.shape)
    valid = (rows >= 0) & (rows < m)
    rows_c = jnp.clip(rows, 0, m - 1)
    dense = jnp.zeros((m, m), dtype=band.dtype)
    vals = jnp.where(valid, band, 0)
    return dense.at[rows_c.reshape(-1), cols.reshape(-1)].add(vals.reshape(-1))


def dense_to_band(dense: jnp.ndarray, l: int, u: int) -> jnp.ndarray:
    """Extract a general (l, u) band, shape (l+u+1, m), from dense (m, m)."""
    m = dense.shape[0]
    rows = jnp.arange(l + u + 1)[:, None] + jnp.arange(m)[None, :] - u
    cols = jnp.broadcast_to(jnp.arange(m)[None, :], rows.shape)
    valid = (rows >= 0) & (rows < m)
    rows_c = jnp.clip(rows, 0, m - 1)
    return jnp.where(valid, dense[rows_c, cols], 0).astype(dense.dtype)


def shift_cols(v: jnp.ndarray, s: int) -> jnp.ndarray:
    """out[i] = v[i + s] with zero fill, along the last axis (static s)."""
    if s == 0:
        return v
    m = v.shape[-1]
    if s > 0:
        pad = [(0, 0)] * (v.ndim - 1) + [(0, s)]
        return jnp.pad(v[..., s:], pad)
    s = -s
    pad = [(0, 0)] * (v.ndim - 1) + [(s, 0)]
    return jnp.pad(v[..., :m - s], pad)


def transpose_lower_band(band: jnp.ndarray) -> jnp.ndarray:
    """Transpose a lower band into the general-band storage of its transpose.

    Input: lower band (k+1, m) of M.  Output: general band (k+1, m) of M^T,
    which has l=0, u=k: out[r, i] = M^T[i + r - k, i] = M[i, i + r - k]
    = band[k - r, i + r - k].
    """
    k = band.shape[0] - 1
    rows = [shift_cols(band[k - r], r - k) for r in range(k + 1)]
    return jnp.stack(rows, axis=0)


def symmetrise_lower_band(band: jnp.ndarray) -> jnp.ndarray:
    """Lower band (k+1, m) of symmetric M -> full general band (2k+1, m) of M.

    Equivalent of reference utils.symmetrise_banded (asvgp/utils.py:7-9).
    """
    k = band.shape[0] - 1
    upper = transpose_lower_band(band)  # (k+1, m), row k = main diag
    return jnp.concatenate([upper[:-1], band], axis=0)


def lower_band_of_symmetric(band_full: jnp.ndarray, l: int, u: int) -> jnp.ndarray:
    """Extract the lower band (rows u..u+l) from a general band of a symmetric M."""
    return band_full[u:u + l + 1]
