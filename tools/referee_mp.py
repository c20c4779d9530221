"""Referee: which f64 path is more accurate at high condition number —
the sequential scan Takahashi or cyclic reduction?  Compares both against a
50-digit mpmath banded Cholesky + Takahashi on the genuinely
ill-conditioned spline Kuu (kappa ~ m^4 for Matern-3/2 x B3 at unit
lengthscale).  CPU only.  Run: python tools/referee_mp.py [m]
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import mpmath as mp
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from asvgp.banded import cyclic, ops as bops  # noqa: E402
from asvgp.basis import B3Spline  # noqa: E402
from asvgp.features.spline_features import make_kuu  # noqa: E402
from asvgp.models import Matern32  # noqa: E402

mp.mp.dps = 50
M = int(sys.argv[1]) if len(sys.argv) > 1 else 512
K = 3


def mp_cholesky_band(band):
    k1, m = len(band), len(band[0])
    k = k1 - 1
    L = [[mp.mpf(0)] * k1 for _ in range(m)]  # L[i] = column i rows 0..k
    for i in range(m):
        s = mp.mpf(0)
        for p in range(1, min(k, i) + 1):
            s += L[i - p][p] ** 2
        d = band[0][i] - s
        l0 = mp.sqrt(d)
        L[i][0] = l0
        for r in range(1, min(k, m - 1 - i) + 1):
            s = mp.mpf(0)
            for p in range(1, min(k, i) + 1):
                if r + p <= k:
                    s += L[i - p][r + p] * L[i - p][p]
            L[i][r] = (band[r][i] - s) / l0
    return L


def mp_takahashi(L, m, k):
    S = [[mp.mpf(0)] * (k + 1) for _ in range(m)]  # S[j] col j rows 0..k
    for j in range(m - 1, -1, -1):
        d = 1 / L[j][0]
        s_off = [mp.mpf(0)] * (k + 1)
        for q in range(1, min(k, m - 1 - j) + 1):
            acc = mp.mpf(0)
            for p in range(1, min(k, m - 1 - j) + 1):
                r, c = abs(q - p), j + min(p, q)
                acc += S[c][r] * L[j][p]
            s_off[q] = -d * acc
        acc = mp.mpf(0)
        for q in range(1, min(k, m - 1 - j) + 1):
            acc += L[j][q] * s_off[q]
        S[j][0] = d * d - d * acc
        for q in range(1, k + 1):
            S[j][q] = s_off[q]
    return S


def main():
    kuu = make_kuu(Matern32(), B3Spline(0.0, 1.0, M))
    band_np = np.asarray(kuu)
    band_mp = [[mp.mpf(repr(float(x))) for x in row] for row in band_np]

    L = mp_cholesky_band(band_mp)
    S = mp_takahashi(L, M, K)
    ld_mp = 2 * sum(mp.log(L[i][0]) for i in range(M))
    s_mp = np.array([[float(S[j][r]) for j in range(M)] for r in range(K + 1)])

    l_scan = bops.cholesky_band(kuu)
    ld_scan = float(bops.log_det_from_cholesky(l_scan))
    s_scan = np.asarray(bops.takahashi_inverse_band(l_scan))
    ld_cr = float(cyclic.cr_logdet(kuu))
    s_cr = np.asarray(cyclic.cr_inverse_band(kuu))

    denom = np.abs(s_mp).max()
    print(f"m={M} (kappa ~ {M**4:.1e})")
    print(f"logdet: mp={float(ld_mp):.9f}")
    print(f"  scan rel {abs(ld_scan-float(ld_mp))/abs(float(ld_mp)):.3g}   "
          f"cr rel {abs(ld_cr-float(ld_mp))/abs(float(ld_mp)):.3g}")
    print(f"S band (rel to max): scan {np.abs(s_scan-s_mp).max()/denom:.3g}  "
          f"cr {np.abs(s_cr-s_mp).max()/denom:.3g}")


if __name__ == "__main__":
    main()
