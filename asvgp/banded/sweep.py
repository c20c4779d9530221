"""The collapsed-ELBO banded core as two fused sweeps (Pallas, Triton route).

Each sweep is one sequential walk over the m columns of a lower band
(k+1, m), k <= 7:

  sweep A (forward):  Cholesky L of A, its JVP L̇ in a tangent direction T,
     the reciprocal pivots 1/L[i,i] with their tangents, and the lower solve
     c = L⁻¹ b.  The solve reuses the pivot just computed, so it adds no
     divide to the chain.
  sweep B (reverse):  the Takahashi band S = band(A⁻¹) from L and the
     reciprocal pivots (no divides at all), its JVP Ṡ, and the upper solve
     u = L⁻ᵀ c.

The two matrices of the collapsed core are independent recursions, so each
sweep runs with ``grid=(2,)``: program 0 walks Kuu (tangent T = ∂Kuu/∂ℓ,
b = 0), program 1 walks P (T = 0, b = Kuf·y), each on its own SM.  Inside
a program every quantity is a scalar: the k-window of the recursion is the
loop carry, held in registers, and the inputs of column i±1 are loaded
while column i is computed.

Everything the ELBO needs is then elementwise in the outputs:

  log|Kuu|, log|P| from the factor diagonals, bᵀP⁻¹b = ‖c‖²,
  tr(Kuu⁻¹B) = ⟨w∘S_Kuu, B⟩,

and so is its gradient.  Kuu is a Matérn RKHS Gram band,
Kuu(σ_f², ℓ) = σ_f⁻²·G(ℓ) (spline_features.make_kuu), so

  ∂log|P|/∂P = w∘S_P,  ∂(bᵀP⁻¹b)/∂P = −w∘band(uuᵀ),  ∂/∂b = 2u,
  ∂log|Kuu|/∂θ = ⟨w∘S_Kuu, ∂Kuu/∂θ⟩,  ∂trace/∂B = w∘S_Kuu,
  ∂trace/∂σ_f² = trace/σ_f²,  ∂trace/∂ℓ = ⟨w∘Ṡ_Kuu, B⟩,

where w = (2 − δ_{row 0}) counts the symmetric band twice.  The backward
pass of ``collapsed_core_matern`` is therefore elementwise.

Tangent recursions (per column, r = A_col − Σ window products, l₀ = √r₀,
d = 1/l₀):

  ṙ = Ṫ_col − Σ (L̇ L + L L̇),  l̇₀ = ½ ṙ₀ d,  ḋ = −d² l̇₀,
  L̇_col = ṙ d + r ḋ (rows ≥ 1);
  Takahashi s_q = −d a_q, a_q = Σ_p S[j+max(p,q), j+min(p,q)] w_p,
  ṡ_q = −(ḋ a_q + d ȧ_q),  ṡ_jj = 2 d ḋ − (ḋ Σ w s + d Σ (ẇ s + w ṡ)).

On a CPU the kernels run in Pallas interpret mode (the tests' route); the
plain-JAX reference is ``reference_factor_takahashi_solve``.

Reference parity: replaces the C++ ``banded_matrices`` ops and their
registered gradients (cholesky_band, inverse_from_cholesky_band,
solve_triang_mat; reference asvgp/gpr.py:49-89) for the 1-D collapsed
core and its posterior.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from asvgp.banded.cyclic import band_weights

# band columns are stored padded to KP entries (k + 1 <= KP)
KP = 8


def supports(k: int) -> bool:
    return 1 <= k <= KP - 1


def _interpret() -> bool:
    from asvgp.banded.ops import _target_platform

    return _target_platform() == "cpu"


def _call(kernel, out_shape, *args, name):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(2,),
        backend="triton",
        interpret=_interpret(),
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        name=name,
    )(*args)


def _tri(k):
    """Index pairs (p, q), 1 <= p <= q <= k, of a triangular window."""
    return [(p, q) for p in range(1, k + 1) for q in range(p, k + 1)]


# ===========================================================================
# sweep A: Cholesky ⊗ tangent ⊗ lower solve
# ===========================================================================


def _sweep_a_kernel(a_ref, t_ref, b_ref, l_ref, ld_ref, iv_ref, ivd_ref,
                    c_ref, *, k, m):
    pr = pl.program_id(0)

    def load(i):
        return (
            [a_ref[pr, i, j] for j in range(k + 1)],
            [t_ref[pr, i, j] for j in range(k + 1)],
            b_ref[pr, i],
        )

    def body(i, carry):
        # C[(p, q)] = L[i-p+q, i-p] (column i-p of L at band row q >= p),
        # Cd the same of L̇; X[p-1] = c[i-p]; (a, t, bi) = column i's inputs
        C, Cd, X, (a, t, bi) = carry
        nxt = load(jnp.minimum(i + 1, m - 1))
        r, rd = [], []
        for j in range(k + 1):
            s, sd = a[j], t[j]
            for p in range(1, k + 1 - j):
                g, gd = C[(p, p)], Cd[(p, p)]
                h, hd = C[(p, p + j)], Cd[(p, p + j)]
                s = s - g * h
                sd = sd - (gd * h + g * hd)
            r.append(s)
            rd.append(sd)
        l0 = jnp.sqrt(r[0])
        iv = 1.0 / l0
        l0d = 0.5 * rd[0] * iv
        ivd = -(iv * iv) * l0d
        col = [l0] + [r[j] * iv for j in range(1, k + 1)]
        cold = [l0d] + [rd[j] * iv + r[j] * ivd for j in range(1, k + 1)]
        zero = jnp.zeros_like(l0)
        for j in range(1, k + 1):
            col[j] = jnp.where(i + j < m, col[j], zero)
            cold[j] = jnp.where(i + j < m, cold[j], zero)
        sx = bi
        for p in range(1, k + 1):
            sx = sx - C[(p, p)] * X[p - 1]
        x = sx * iv
        for j in range(k + 1):
            l_ref[pr, i, j] = col[j]
            ld_ref[pr, i, j] = cold[j]
        iv_ref[pr, i] = iv
        ivd_ref[pr, i] = ivd
        c_ref[pr, i] = x
        C2 = {(p, q): (col[q] if p == 1 else C[(p - 1, q)]) for p, q in _tri(k)}
        Cd2 = {(p, q): (cold[q] if p == 1 else Cd[(p - 1, q)])
               for p, q in _tri(k)}
        return C2, Cd2, [x] + X[:-1], nxt

    zero = jnp.zeros((), a_ref.dtype)
    init = (
        {pq: zero for pq in _tri(k)},
        {pq: zero for pq in _tri(k)},
        [zero] * k,
        load(0),
    )
    lax.fori_loop(0, m, body, init)


# ===========================================================================
# sweep B: Takahashi ⊗ tangent ⊗ upper solve (columns m-1 … 0)
# ===========================================================================


def _sweep_b_kernel(l_ref, ld_ref, iv_ref, ivd_ref, c_ref, s_ref, sd_ref,
                    u_ref, *, k, m):
    pr = pl.program_id(0)

    def load(j):
        return (
            [l_ref[pr, j, q] for q in range(k + 1)],
            [ld_ref[pr, j, q] for q in range(k + 1)],
            iv_ref[pr, j],
            ivd_ref[pr, j],
            c_ref[pr, j],
        )

    def body(t, carry):
        # CS[(c, c+r)] = S[j+c+r, j+c] (column j+c of S at band row r),
        # CSd the same of Ṡ; U[p-1] = u[j+p]
        CS, CSd, U, (lc, lcd, d, dd, cj) = carry
        j = m - 1 - t
        nxt = load(jnp.maximum(j - 1, 0))

        def M(src, q, p):
            c = min(p, q)
            return src[(c, c + abs(q - p))]

        s, sd = [], []
        for q in range(1, k + 1):
            aq = aqd = None
            for p in range(1, k + 1):
                mv, mvd = M(CS, q, p), M(CSd, q, p)
                term = mv * lc[p]
                termd = mvd * lc[p] + mv * lcd[p]
                aq = term if aq is None else aq + term
                aqd = termd if aqd is None else aqd + termd
            s.append(-d * aq)
            sd.append(-(dd * aq + d * aqd))
        ws = wsd = None
        for q in range(1, k + 1):
            term = lc[q] * s[q - 1]
            termd = lcd[q] * s[q - 1] + lc[q] * sd[q - 1]
            ws = term if ws is None else ws + term
            wsd = termd if wsd is None else wsd + termd
        sjj = d * d - d * ws
        sjjd = 2.0 * d * dd - (dd * ws + d * wsd)
        col = [sjj] + s
        cold = [sjjd] + sd
        zero = jnp.zeros_like(d)
        for q in range(1, k + 1):
            col[q] = jnp.where(j + q < m, col[q], zero)
            cold[q] = jnp.where(j + q < m, cold[q], zero)
        su = cj
        for p in range(1, k + 1):
            su = su - lc[p] * U[p - 1]
        u = su * d
        for q in range(k + 1):
            s_ref[pr, j, q] = col[q]
            sd_ref[pr, j, q] = cold[q]
        u_ref[pr, j] = u
        # new window: column j becomes c = 1; older columns shift outward
        CS2 = {(c, q): (col[q - 1] if c == 1 else CS[(c - 1, q - 1)])
               for c, q in _tri(k)}
        CSd2 = {(c, q): (cold[q - 1] if c == 1 else CSd[(c - 1, q - 1)])
                for c, q in _tri(k)}
        return CS2, CSd2, [u] + U[:-1], nxt

    zero = jnp.zeros((), l_ref.dtype)
    init = (
        {pq: zero for pq in _tri(k)},
        {pq: zero for pq in _tri(k)},
        [zero] * k,
        load(m - 1),
    )
    lax.fori_loop(0, m, body, init)


# ===========================================================================
# wrappers
# ===========================================================================


def _to_cols(band):
    """(k+1, m) lower band → (m, KP) column-major storage, zero-padded."""
    return jnp.pad(band.T, ((0, 0), (0, KP - band.shape[0])))


def factor_takahashi_solve(kuu_band, tan_band, p_band, b):
    """Sweeps A and B over (Kuu, P).  Returns
    ``(l_kuu, l_p, s_kuu, s_p, c0, u, sdot_kuu)``: the two Cholesky bands,
    the two Takahashi bands, c0 = L_P⁻¹ b, u = P⁻¹ b and the JVP of S_Kuu in
    the direction ``tan_band`` of Kuu."""
    k1, m = kuu_band.shape
    k = k1 - 1
    dt = kuu_band.dtype
    zero_band = jnp.zeros_like(kuu_band)
    a = jnp.stack([_to_cols(kuu_band), _to_cols(p_band)])
    t = jnp.stack([_to_cols(tan_band), _to_cols(zero_band)])
    bb = jnp.stack([jnp.zeros_like(b), b])
    cols = jax.ShapeDtypeStruct((2, m, KP), dt)
    vec = jax.ShapeDtypeStruct((2, m), dt)
    l, ld, iv, ivd, c = _call(
        partial(_sweep_a_kernel, k=k, m=m), (cols, cols, vec, vec, vec),
        a, t, bb, name="asvgp_sweep_a",
    )
    s, sd, u = _call(
        partial(_sweep_b_kernel, k=k, m=m), (cols, cols, vec),
        l, ld, iv, ivd, c, name="asvgp_sweep_b",
    )

    def band(x, i):
        return x[i, :, :k1].T

    return (band(l, 0), band(l, 1), band(s, 0), band(s, 1), c[1], u[1],
            band(sd, 0))


def reference_factor_takahashi_solve(kuu_band, tan_band, p_band, b):
    """Plain-JAX (lax.scan) counterpart of :func:`factor_takahashi_solve`."""
    from asvgp.banded import ops

    def chol_tak(band):
        l = ops.cholesky_band(band)
        return l, ops.takahashi_inverse_band(l)

    (l_kuu, s_kuu), (_, sdot) = jax.jvp(chol_tak, (kuu_band,), (tan_band,))
    l_p, s_p = chol_tak(p_band)
    c0 = ops.solve_lower_band(l_p, b)
    u = ops.solve_upper_band_transpose(l_p, c0)
    return l_kuu, l_p, s_kuu, s_p, c0, u, sdot


def posterior(kuu_band, p_band, b):
    """(band of Kuu⁻¹, band of P⁻¹, P⁻¹ b) from one pair of sweeps."""
    _, _, s_kuu, s_p, _, u, _ = factor_takahashi_solve(
        kuu_band, jnp.zeros_like(kuu_band), p_band, b
    )
    return s_kuu, s_p, u


def _outer_band(u, k):
    """O[j, i] = u_{i+j} u_i (lower band of u uᵀ), right-padded."""
    m = u.shape[0]
    rows = [jnp.pad(u[j:] * u[: m - j], (0, j)) for j in range(k + 1)]
    return jnp.stack(rows, axis=0)


def _core(kuu_fn, var, ell, p_band, b, big_band):
    kuu, tan = jax.jvp(
        lambda l: kuu_fn(var, l), (ell,), (jnp.ones_like(ell),)
    )
    l_kuu, l_p, s_kuu, s_p, c0, u, sdot = factor_takahashi_solve(
        kuu, tan, p_band, b
    )
    w = band_weights(kuu.shape[0] - 1, kuu.shape[1], kuu.dtype)
    out = (
        2.0 * jnp.sum(jnp.log(l_kuu[0])),
        2.0 * jnp.sum(jnp.log(l_p[0])),
        jnp.sum(jnp.square(c0)),
        jnp.sum(w * s_kuu * big_band),
    )
    trace_dot = jnp.sum(w * sdot * big_band)
    return out, (var, ell, s_kuu, s_p, u, big_band, out[3], trace_dot)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def collapsed_core_matern(kuu_fn, var, ell, p_band, b, big_band):
    """(log|Kuu|, log|P|, bᵀP⁻¹b, tr(Kuu⁻¹B)) with Kuu = kuu_fn(var, ell).

    CONTRACT: ``kuu_fn`` must scale as kuu_fn(var, ell) = var⁻¹·G(ell)
    (true for every Matérn RKHS Gram band, spline_features.make_kuu), and
    ``ell`` is one lengthscale — the trace gradient is closed-form in var
    and one fused JVP direction in ell.
    """
    return _core(kuu_fn, var, ell, p_band, b, big_band)[0]


def _ccm_fwd(kuu_fn, var, ell, p_band, b, big_band):
    return _core(kuu_fn, var, ell, p_band, b, big_band)


def _ccm_bwd(kuu_fn, res, cots):
    var, ell, s_kuu, s_p, u, big_band, trace, trace_dot = res
    g_ldk, g_ldp, g_quad, g_tr = cots
    k = s_kuu.shape[0] - 1
    w = band_weights(k, s_kuu.shape[1], s_kuu.dtype)

    p_bar = g_ldp * (w * s_p) - g_quad * (w * _outer_band(u, k))
    b_bar = (2.0 * g_quad) * u
    big_bar = g_tr * (w * s_kuu)
    # log|Kuu| leg through the (elementwise) band assembly by plain AD
    _, kuu_vjp = jax.vjp(kuu_fn, var, ell)
    var_bar, ell_bar = kuu_vjp(g_ldk * (w * s_kuu))
    # trace leg: closed form in var (Kuu ∝ 1/var), fused JVP in ell
    var_bar = var_bar + g_tr * trace / var
    ell_bar = ell_bar + g_tr * trace_dot
    return var_bar, ell_bar, p_bar, b_bar, big_bar


collapsed_core_matern.defvjp(_ccm_fwd, _ccm_bwd)
