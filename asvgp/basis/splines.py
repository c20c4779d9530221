"""B-spline basis on a uniform mesh: evaluation + banded Gram tables.

Equivalent of the reference's ``SplineBasis`` /
``B1Spline``..``B6Spline`` (reference asvgp/basis.py:8-800), with two
deliberate design changes:

1.  The per-order hard-coded polynomial formulas and L2 inner-product tables
    are *generated* exactly (rational arithmetic, Cox-de Boor) by
    :mod:`asvgp.basis.bsplines` instead of transcribed — one code path
    for all orders 1..6, all derivative orders 0..3.
2.  ``evaluate_basis`` returns a *structured sparse* pair
    ``(vals (n, k+1), start (n,))`` instead of a scipy CSR matrix
    (reference asvgp/basis.py:51-80): exactly k+1 contiguous nonzeros per
    point, which is the gather-friendly layout consumed by the
    sufficient-statistic kernels (SURVEY.md §2.2 N3).

Boundary-condition matrices replicate the reference's construction
(asvgp/basis.py:82-114) including its cross-boundary quirk: the dx=3/4
"ggrad x none" products evaluate one side at ``a`` and the other at ``b``,
whose supports are disjoint for m >= 2*order + 2, so those bands are
identically zero (documented behavioral parity; SURVEY.md §7.3 item 6).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from asvgp.basis import bsplines


def _banded_from_cells(cells_desc, m: int, scale: float) -> np.ndarray:
    """Assemble a (k+1, m) lower band from per-overlap-cell inner products.

    ``cells_desc[i]`` is the tuple of exact per-cell products for diagonal
    offset i, ordered boundary->interior (descending cell index j).  The
    running cumulative sum gives the truncated inner products of the
    boundary-straddling basis functions; interior entries are the full sum.
    Equivalent of the reference's ``_make_banded_matrix``
    (asvgp/basis.py:31-45), right padding.
    """
    k = len(cells_desc) - 1
    if m < 2 * k + 2:
        raise ValueError(f"BSplineBasis requires m >= 2*order+2 = {2*k+2}, got m={m}")
    rows = []
    for i, cells in enumerate(cells_desc):
        cells = [float(c) * scale for c in cells]
        lhs = np.cumsum(cells)
        mid = np.full(m - 2 * len(cells) - i, lhs[-1])
        rhs = lhs[::-1]
        rows.append(np.concatenate([lhs, mid, rhs, np.zeros(i)]))
    return np.stack(rows, axis=0)


def _bc_band_from_vector(v: np.ndarray, m: int, order: int) -> np.ndarray:
    """Boundary-condition band from the vector v_s = φ_s^{(d)}(a), s=0..k-1.

    Places diag(v v^T, +i) at both corners, replicating the reference's
    ``make_boundary_conditions`` (asvgp/basis.py:101-114).  By the
    (anti)symmetry of cardinal B-splines this is exactly the correct
    bottom-right corner as well.
    """
    k = order
    outer = np.outer(v, v)
    rows = []
    for i in range(k):
        l = np.diagonal(outer, offset=i)
        fill = np.zeros(m - 2 * l.shape[0] - i)
        rows.append(np.concatenate([l, fill, l, np.zeros(i)]))
    rows.append(np.zeros(m))
    return np.stack(rows, axis=0)


def _flatten_basis(basis):
    aux = (basis.a, basis.b, basis.m, basis.order)
    return (), aux


def _unflatten_basis(aux, _children):
    a, b, m, order = aux
    return BSplineBasis(a, b, m, order)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True, eq=True)
class BSplineBasis:
    """B-spline basis of a given order on a uniform mesh over [a, b].

    All inner-product tables are precomputed exactly at construction (host,
    float64) and enter jitted programs as constants; the only traced inputs
    downstream are the kernel hyperparameters and the data.

    Attributes (parity with reference B{1..6}Spline, asvgp/basis.py):
      A, B, C, D      — banded L2 inner products of the 0th..3rd derivatives
                        (C needs order >= 2, D needs order >= 3)
      BC, BC_grad, BC_ggrad — boundary outer-product bands (value/grad/ggrad)
      BC_ggrad_none, BC_none_ggrad — cross-boundary bands (identically zero
                        for m >= 2*order+2; see module docstring)
      mesh, delta, order, m
    """

    a: float
    b: float
    m: int
    order: int

    def __post_init__(self):
        if not (1 <= self.order <= 6):
            raise ValueError(f"order must be in 1..6, got {self.order}")
        if self.m < 2 * self.order + 2:
            raise ValueError(
                f"m must be >= 2*order+2 = {2 * self.order + 2}, got m={self.m}"
            )
        if not self.b > self.a:
            raise ValueError("need b > a")

    # ---- static geometry -------------------------------------------------
    @property
    def n_cells(self) -> int:
        return self.m - self.order

    @property
    def delta(self) -> float:
        return (self.b - self.a) / self.n_cells

    @property
    def mesh(self) -> np.ndarray:
        return np.linspace(self.a, self.b, self.n_cells + 1)

    # ---- banded inner-product tables (cached per instance) ---------------
    def _table(self, dx: int) -> np.ndarray:
        if dx > self.order:
            raise ValueError(
                f"L2 inner product of derivative order {dx} is not defined for "
                f"B{self.order} splines (needs order >= {dx})"
            )
        cells = [
            bsplines.overlap_cell_products(self.order, i, dx)
            for i in range(self.order + 1)
        ]
        return _banded_from_cells(cells, self.m, self.delta ** (1 - 2 * dx))

    @property
    def A(self) -> np.ndarray:
        return self._cached("A", lambda: self._table(0))

    @property
    def B(self) -> np.ndarray:
        return self._cached("B", lambda: self._table(1))

    @property
    def C(self) -> np.ndarray:
        return self._cached("C", lambda: self._table(2))

    @property
    def D(self) -> np.ndarray:
        return self._cached("D", lambda: self._table(3))

    def _bc_vector(self, dx: int) -> np.ndarray:
        """v_s = φ_s^{(dx)}(a) for s = 0..order-1 (the functions alive at a)."""
        vals = bsplines.piece_values_at_zero(self.order, dx)
        scale = self.delta ** (-dx)
        return np.array(
            [float(vals[self.order - s]) * scale for s in range(self.order)]
        )

    @property
    def BC(self) -> np.ndarray:
        return self._cached(
            "BC", lambda: _bc_band_from_vector(self._bc_vector(0), self.m, self.order)
        )

    @property
    def BC_grad(self) -> np.ndarray:
        return self._cached(
            "BC_grad",
            lambda: _bc_band_from_vector(self._bc_vector(1), self.m, self.order),
        )

    @property
    def BC_ggrad(self) -> np.ndarray:
        return self._cached(
            "BC_ggrad",
            lambda: _bc_band_from_vector(self._bc_vector(2), self.m, self.order),
        )

    @property
    def BC_ggrad_none(self) -> np.ndarray:
        # cross-boundary product φ''(a) x φ(b): disjoint supports -> zero
        return np.zeros((self.order + 1, self.m))

    @property
    def BC_none_ggrad(self) -> np.ndarray:
        return np.zeros((self.order + 1, self.m))

    def _cached(self, name, fn):
        cache = self.__dict__.setdefault("_cache", {})
        if name not in cache:
            cache[name] = fn()
        return cache[name]

    # ---- evaluation (device, jittable) ------------------------------------
    def evaluate_basis(self, X, dx: int = 0):
        """Structured-sparse evaluation of the basis (or a derivative) at X.

        Args:
          X: (n,) or (n, 1) points inside [a, b].
          dx: derivative order, 0..3 (reference asvgp/basis.py:61-70).
        Returns:
          (vals, start): ``vals`` is (n, order+1) with
          ``vals[p, s] = φ_{start[p]+s}^{(dx)}(X[p])``; ``start`` is (n,)
          int32, the index of the first active basis function (= cell index).
        """
        if dx > 3 or dx < 0:
            raise NotImplementedError("dx must be in 0..3")
        x = jnp.reshape(X, (-1,))
        delta = self.delta
        c = jnp.clip(
            jnp.floor((x - self.a) / delta).astype(jnp.int32), 0, self.n_cells - 1
        )
        t = (x - (self.a + c.astype(x.dtype) * delta)) / delta
        # coeffs[s, q]: coefficient of t^q for basis function (cell + s)
        coeffs = bsplines.piece_coeff_matrix(self.order, dx) * delta ** (-dx)
        coeffs = jnp.asarray(coeffs, dtype=x.dtype)
        deg = coeffs.shape[1]
        # Horner over the polynomial degree — elementwise VPU ops only
        vals = jnp.broadcast_to(coeffs[None, :, deg - 1], (x.shape[0], self.order + 1))
        for q in range(deg - 2, -1, -1):
            vals = vals * t[:, None] + coeffs[None, :, q]
        return vals, c

    def evaluate_basis_dense(self, X, dx: int = 0):
        """Dense (m, n) evaluation matrix (reference sparse=False path)."""
        vals, start = self.evaluate_basis(X, dx)
        n = vals.shape[0]
        rows = start[:, None] + jnp.arange(self.order + 1)[None, :]
        cols = jnp.broadcast_to(jnp.arange(n)[:, None], rows.shape)
        out = jnp.zeros((self.m, n), dtype=vals.dtype)
        return out.at[rows.reshape(-1), cols.reshape(-1)].add(vals.reshape(-1))

    # ---- pytree (static node: tables are regenerated, cheap + cached) -----
    def tree_flatten(self):
        return _flatten_basis(self)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return _unflatten_basis(aux, children)


def B1Spline(a, b, m):
    return BSplineBasis(a, b, m, 1)


def B2Spline(a, b, m):
    return BSplineBasis(a, b, m, 2)


def B3Spline(a, b, m):
    return BSplineBasis(a, b, m, 3)


def B4Spline(a, b, m):
    return BSplineBasis(a, b, m, 4)


def B5Spline(a, b, m):
    return BSplineBasis(a, b, m, 5)


def B6Spline(a, b, m):
    return BSplineBasis(a, b, m, 6)
