"""B-spline basis tests (SURVEY.md §4): partition of unity, locality,
exact-table verification against the reference's hard-coded rationals,
independent quadrature cross-checks, derivative consistency.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp import banded
from asvgp.basis import BSplineBasis, bsplines


# ---------------------------------------------------------------------------
# Exact cell-product tables vs the reference's hard-coded rational constants
# (reference asvgp/basis.py: B1 at 143-167, B2 at 206-249, B3 at 303-369).
# These constants are *verification data*, independent of our generation path.
# ---------------------------------------------------------------------------
REFERENCE_CELLS = {
    # (order, offset, dx): tuple of per-cell products, boundary -> interior
    (1, 0, 0): (Fraction(1, 3), Fraction(1, 3)),
    (1, 1, 0): (Fraction(1, 6),),
    (1, 0, 1): (Fraction(1), Fraction(1)),
    (1, 1, 1): (Fraction(-1),),
    (2, 0, 0): (Fraction(1, 20), Fraction(9, 20), Fraction(1, 20)),
    (2, 1, 0): (Fraction(13, 120), Fraction(13, 120)),
    (2, 2, 0): (Fraction(1, 120),),
    (2, 0, 1): (Fraction(1, 3), Fraction(1, 3), Fraction(1, 3)),
    (2, 1, 1): (Fraction(-1, 6), Fraction(-1, 6)),
    (2, 2, 1): (Fraction(-1, 6),),
    (2, 0, 2): (Fraction(1), Fraction(4), Fraction(1)),
    (2, 1, 2): (Fraction(-2), Fraction(-2)),
    (2, 2, 2): (Fraction(1),),
    (3, 0, 0): (Fraction(1, 252), Fraction(33, 140), Fraction(33, 140), Fraction(1, 252)),
    (3, 1, 0): (Fraction(43, 1680), Fraction(311, 1680), Fraction(43, 1680)),
    (3, 2, 0): (Fraction(1, 84), Fraction(1, 84)),
    (3, 3, 0): (Fraction(1, 5040),),
    (3, 0, 1): (Fraction(1, 20), Fraction(17, 60), Fraction(17, 60), Fraction(1, 20)),
    (3, 1, 1): (Fraction(7, 120), Fraction(-29, 120), Fraction(7, 120)),
    (3, 2, 1): (Fraction(-1, 10), Fraction(-1, 10)),
    (3, 3, 1): (Fraction(-1, 120),),
    (3, 0, 2): (Fraction(1, 3), Fraction(1), Fraction(1), Fraction(1, 3)),
    (3, 1, 2): (Fraction(-1, 2), Fraction(-1, 2), Fraction(-1, 2)),
    (3, 2, 2): (Fraction(0), Fraction(0)),
    (3, 3, 2): (Fraction(1, 6),),
    (3, 0, 3): (Fraction(1), Fraction(9), Fraction(9), Fraction(1)),
    (3, 1, 3): (Fraction(-3), Fraction(-9), Fraction(-3)),
    (3, 2, 3): (Fraction(3), Fraction(3)),
    (3, 3, 3): (Fraction(-1),),
}


def test_cell_products_match_reference_tables():
    for (order, offset, dx), want in REFERENCE_CELLS.items():
        got = bsplines.overlap_cell_products(order, offset, dx)
        assert got == want, (order, offset, dx, got, want)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
def test_cardinal_pieces_properties(order):
    pieces = bsplines.cardinal_pieces(order)
    assert len(pieces) == order + 1
    # partition of unity of integer translates: sum_p piece_p(t) == 1
    total = (Fraction(0),)
    from asvgp.basis.bsplines import _poly_add

    for p in pieces:
        total = _poly_add(total, p)
    assert total[0] == 1 and all(c == 0 for c in total[1:])
    # unit integral: sum_p ∫ piece_p = 1
    s = sum(bsplines._poly_integral_01(p) for p in pieces)
    assert s == 1
    # continuity at knots: piece_p(1) == piece_{p+1}(0); endpoint values 0
    assert bsplines._poly_eval(pieces[0], Fraction(0)) == 0
    assert bsplines._poly_eval(pieces[order], Fraction(1)) == 0
    for p in range(order):
        assert bsplines._poly_eval(pieces[p], Fraction(1)) == bsplines._poly_eval(
            pieces[p + 1], Fraction(0)
        )


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
def test_tables_vs_gauss_legendre_quadrature(order):
    """Independent cross-check: exact tables vs numerical quadrature of the
    piece polynomials (different code path than Fraction integration)."""
    nodes, weights = np.polynomial.legendre.leggauss(order + 2)
    t = 0.5 * (nodes + 1.0)
    w = 0.5 * weights
    for dx in range(0, min(order, 3) + 1):
        pieces = bsplines.cardinal_piece_derivatives(order, dx)

        def peval(poly, tt):
            out = np.zeros_like(tt)
            for c in reversed(poly):
                out = out * tt + float(c)
            return out

        for offset in range(order + 1):
            want = bsplines.overlap_cell_products(order, offset, dx)
            got = [
                np.sum(w * peval(pieces[j], t) * peval(pieces[j - offset], t))
                for j in range(order, offset - 1, -1)
            ]
            assert np.allclose(got, [float(x) for x in want], atol=1e-13)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
def test_partition_of_unity_and_locality(order):
    basis = BSplineBasis(-2.0, 3.0, max(20, 2 * order + 2), order)
    x = jnp.linspace(-1.999, 2.999, 101, dtype=jnp.float64)
    vals, start = basis.evaluate_basis(x, dx=0)
    assert vals.shape == (101, order + 1)
    np.testing.assert_allclose(np.asarray(vals.sum(axis=1)), 1.0, rtol=1e-12)
    assert np.all(np.asarray(start) >= 0)
    assert np.all(np.asarray(start) + order < basis.m)
    # values nonnegative for dx=0
    assert np.all(np.asarray(vals) >= -1e-14)


@pytest.mark.parametrize("order,dx", [(1, 1), (2, 1), (3, 1), (3, 2), (4, 2), (5, 3), (6, 3), (3, 3)])
def test_derivatives_vs_finite_differences(order, dx):
    basis = BSplineBasis(0.0, 1.0, 24, order)
    # stay away from knots so FD of a piecewise polynomial is clean
    x = np.linspace(0.013, 0.987, 41)
    h = 1e-6

    def dense(xv, d):
        return np.asarray(basis.evaluate_basis_dense(jnp.asarray(xv), dx=d))

    got = dense(x, dx)
    fd = (dense(x + h, dx - 1) - dense(x - h, dx - 1)) / (2 * h)
    scale = max(1.0, np.abs(got).max())
    np.testing.assert_allclose(got / scale, fd / scale, atol=1e-4)


@pytest.mark.parametrize("order", [1, 3, 4, 6])
def test_gram_matrix_vs_brute_force_quadrature(order):
    """Assembled banded A/B tables (incl. boundary truncation) vs brute-force
    quadrature of the evaluated basis functions over [a, b]."""
    m = 2 * order + 4  # small m exercises the boundary overlaps hard
    a, b = -0.5, 2.0
    basis = BSplineBasis(a, b, m, order)
    # composite Gauss-Legendre per mesh cell (exact for the polynomials)
    nodes, weights = np.polynomial.legendre.leggauss(order + 2)
    mesh = basis.mesh
    xs, ws = [], []
    for c in range(basis.n_cells):
        lo, hi = mesh[c], mesh[c + 1]
        xs.append(0.5 * (hi - lo) * nodes + 0.5 * (hi + lo))
        ws.append(0.5 * (hi - lo) * weights)
    xs = np.concatenate(xs)
    ws = np.concatenate(ws)

    for dx, table in [(0, basis.A), (1, basis.B)]:
        Phi = np.asarray(basis.evaluate_basis_dense(jnp.asarray(xs), dx=dx))  # (m, nq)
        G = (Phi * ws[None, :]) @ Phi.T
        want = np.asarray(banded.dense_to_lower_band(jnp.asarray(G), order))
        np.testing.assert_allclose(table, want, atol=1e-11)


def test_bc_band_matches_outer_product():
    order, m = 3, 14
    basis = BSplineBasis(0.0, 1.0, m, order)
    # dense evaluation at the boundary, reference construction semantics
    phi_a = np.asarray(basis.evaluate_basis_dense(jnp.asarray([0.0]), dx=0))[:, 0]
    v = phi_a[:order]
    M = np.zeros((m, m))
    M[:order, :order] += np.outer(v, v)
    M[m - order:, m - order:] += np.outer(v, v)[::-1, ::-1]
    want = np.asarray(banded.dense_to_lower_band(jnp.asarray(M), order))
    np.testing.assert_allclose(basis.BC, want, atol=1e-13)
    # cross-boundary bands are identically zero (reference quirk, documented)
    assert np.all(basis.BC_ggrad_none == 0) and np.all(basis.BC_none_ggrad == 0)


def test_structured_vs_dense_evaluation():
    basis = BSplineBasis(-1.0, 1.0, 16, 3)
    x = jnp.asarray(np.random.RandomState(0).uniform(-0.999, 0.999, 37))
    vals, start = basis.evaluate_basis(x)
    dense = np.asarray(basis.evaluate_basis_dense(x))
    for p in range(x.shape[0]):
        col = np.zeros(basis.m)
        col[np.asarray(start)[p]: np.asarray(start)[p] + 4] = np.asarray(vals)[p]
        np.testing.assert_allclose(dense[:, p], col, atol=1e-14)


def test_validation_errors():
    with pytest.raises(ValueError):
        BSplineBasis(0.0, 1.0, 7, 3)  # m too small
    with pytest.raises(ValueError):
        BSplineBasis(0.0, 1.0, 20, 7)  # bad order
    basis = BSplineBasis(0.0, 1.0, 20, 1)
    with pytest.raises(ValueError):
        _ = basis.C  # ∫φ''φ'' undefined for B1
