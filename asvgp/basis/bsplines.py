"""Exact cardinal B-spline machinery (rational arithmetic, host-side).

The reference hard-codes per-order polynomial evaluation formulas and L2
inner-product tables (reference asvgp/basis.py:117-800).  We instead derive
everything from the Cox-de Boor recursion with exact ``Fraction``
coefficients:

  * piece polynomials of the cardinal B-spline B_k on [0, k+1]
  * their derivatives
  * exact per-overlap-cell L2 inner products
      c_j^{(i,d)} = ∫_0^1 B_k^{(d)}(t + j) B_k^{(d)}(t + j - i) dt

which are precisely the entries the reference's ``l2_*_inner_product``
tables encode (e.g. asvgp/basis.py:314-318 for B3).  This runs once at
basis construction on the host; the results become static float64 constants
baked into the jitted programs.

Conventions: B_k is the degree-k cardinal B-spline supported on [0, k+1],
B_0 = 1 on [0, 1).  Piece p (p = 0..k) is the polynomial of B_k on
[p, p+1) expressed in the local coordinate t = x - p, coefficients in
ascending powers.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np

Poly = tuple  # tuple[Fraction, ...], ascending powers


def _poly_add(a: Poly, b: Poly) -> Poly:
    n = max(len(a), len(b))
    a = a + (Fraction(0),) * (n - len(a))
    b = b + (Fraction(0),) * (n - len(b))
    return tuple(x + y for x, y in zip(a, b))


def _poly_scale(a: Poly, s: Fraction) -> Poly:
    return tuple(x * s for x in a)


def _poly_mul(a: Poly, b: Poly) -> Poly:
    out = [Fraction(0)] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] += x * y
    return tuple(out)


def _poly_shift_arg(a: Poly, c: Fraction) -> Poly:
    """p(t) -> p(t + c)."""
    out = (Fraction(0),)
    # Horner: p(t+c) = a0 + (t+c)(a1 + (t+c)(a2 + ...))
    for coef in reversed(a):
        out = _poly_add(_poly_mul(out, (c, Fraction(1))), (coef,))
    return out


def _poly_derivative(a: Poly) -> Poly:
    if len(a) <= 1:
        return (Fraction(0),)
    return tuple(Fraction(i) * a[i] for i in range(1, len(a)))


def _poly_integral_01(a: Poly) -> Fraction:
    """∫_0^1 p(t) dt."""
    return sum((c / Fraction(i + 1) for i, c in enumerate(a)), Fraction(0))


def _poly_eval(a: Poly, x: Fraction) -> Fraction:
    out = Fraction(0)
    for coef in reversed(a):
        out = out * x + coef
    return out


@lru_cache(maxsize=None)
def cardinal_pieces(order: int) -> tuple:
    """Piece polynomials of B_order: tuple of order+1 polys (local t in [0,1))."""
    if order == 0:
        return ((Fraction(1),),)
    prev = cardinal_pieces(order - 1)  # pieces 0..order-1
    k = Fraction(order)
    pieces = []
    t = (Fraction(0), Fraction(1))  # the polynomial "t"
    for p in range(order + 1):
        # B_k(p + t) = ((p + t)/k) B_{k-1}(p + t) + ((k + 1 - p - t)/k) B_{k-1}(p - 1 + t)
        term = (Fraction(0),)
        if p < order:
            w = _poly_scale(_poly_add((Fraction(p),), t), Fraction(1) / k)
            term = _poly_add(term, _poly_mul(w, prev[p]))
        if p >= 1:
            w = _poly_scale(_poly_add((k + 1 - p,), _poly_scale(t, Fraction(-1))), Fraction(1) / k)
            term = _poly_add(term, _poly_mul(w, prev[p - 1]))
        pieces.append(term)
    return tuple(pieces)


@lru_cache(maxsize=None)
def cardinal_piece_derivatives(order: int, dx: int) -> tuple:
    """dx-th derivative of each piece polynomial of B_order (w.r.t. x, unit cells)."""
    pieces = cardinal_pieces(order)
    for _ in range(dx):
        pieces = tuple(_poly_derivative(p) for p in pieces)
    return pieces


@lru_cache(maxsize=None)
def overlap_cell_products(order: int, offset: int, dx: int) -> tuple:
    """Exact per-cell products c_j = ∫_0^1 B^{(dx)}(t+j) B^{(dx)}(t+j-offset) dt.

    Returned for j = order, order-1, ..., offset (descending j), which is the
    boundary-to-interior order the reference's table rows use (the running
    ``cumsum`` over these gives the truncated boundary inner products,
    reference asvgp/basis.py:31-45).  Length = order + 1 - offset.
    """
    pieces = cardinal_piece_derivatives(order, dx)
    out = []
    for j in range(order, offset - 1, -1):
        out.append(_poly_integral_01(_poly_mul(pieces[j], pieces[j - offset])))
    return tuple(out)


@lru_cache(maxsize=None)
def piece_values_at_zero(order: int, dx: int) -> tuple:
    """B^{(dx)}(p) evaluated as piece p's polynomial at t=0, p = 0..order."""
    pieces = cardinal_piece_derivatives(order, dx)
    return tuple(_poly_eval(p, Fraction(0)) for p in pieces)


def piece_coeff_matrix(order: int, dx: int) -> np.ndarray:
    """Float64 coefficient matrix for vectorized evaluation on device.

    Returns P of shape (order+1, deg+1) with P[s, q] = coefficient of t^q in
    the dx-th derivative of piece ``order - s``.  Row s corresponds to basis
    function index (cell + s) at a point in that cell: the basis function
    j = c + s sees the point in its piece (order - s) — see
    evaluate_basis layout notes in asvgp/basis/splines.py.
    """
    pieces = cardinal_piece_derivatives(order, dx)
    deg = max(len(p) for p in pieces)
    P = np.zeros((order + 1, deg), dtype=np.float64)
    for s in range(order + 1):
        piece = pieces[order - s]
        for q, c in enumerate(piece):
            P[s, q] = float(c)
    return P
