"""Banded linear algebra.

Replacement for the reference's external C++ ``banded_matrices``
package (see reference usage at asvgp/gpr.py:56-75, asvgp/utils.py:7-57).

Storage conventions
-------------------
*Lower band* (the workhorse): an array ``band`` of shape ``(k+1, m)`` holding
a lower-triangular-banded ``(m, m)`` matrix ``M`` with lower bandwidth ``k``::

    band[j, i] = M[i + j, i]      for 0 <= j <= k, i + j < m

Out-of-range slots (``i + j >= m``) are zero ("right padding").  Row 0 is the
main diagonal.  This matches the reference layout (asvgp/basis.py:31-45,
asvgp/utils.py:24-30) so that all Kuu-assembly formulas transfer verbatim.

*General band*: an array of shape ``(l + u + 1, m)`` for a matrix with lower
bandwidth ``l`` and upper bandwidth ``u``::

    band[r, i] = M[i + r - u, i]    for 0 <= r <= l + u, 0 <= i + r - u < m

Row 0 is the uppermost diagonal (+u), row ``u`` the main diagonal, row
``l + u`` the lowest (-l).  A lower band is the special case ``u = 0``.

All ops are pure jittable functions of plain arrays; bandwidths are static
Python ints so XLA sees fixed shapes.
"""

from asvgp.banded.layout import (
    band_to_dense,
    dense_to_band,
    lower_band_to_dense,
    dense_to_lower_band,
    transpose_lower_band,
    symmetrise_lower_band,
    lower_band_of_symmetric,
    mask_lower_band,
)
from asvgp.banded.ops import (
    cholesky_band,
    solve_lower_band,
    solve_upper_band_transpose,
    cholesky_solve_band,
    takahashi_inverse_band,
    collapsed_core,
    collapsed_core_matern,
    banded_posterior,
    log_det_from_cholesky,
    band_frobenius,
    product_band_band,
    matvec_band,
    matvec_symmetric_band,
)

__all__ = [
    "band_to_dense",
    "dense_to_band",
    "lower_band_to_dense",
    "dense_to_lower_band",
    "transpose_lower_band",
    "symmetrise_lower_band",
    "lower_band_of_symmetric",
    "mask_lower_band",
    "cholesky_band",
    "solve_lower_band",
    "solve_upper_band_transpose",
    "cholesky_solve_band",
    "takahashi_inverse_band",
    "collapsed_core",
    "collapsed_core_matern",
    "banded_posterior",
    "log_det_from_cholesky",
    "band_frobenius",
    "product_band_band",
    "matvec_band",
    "matvec_symmetric_band",
]
