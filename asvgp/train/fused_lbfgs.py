"""Single-eval-site L-BFGS + zoom line search.

Algorithmically this is optax.lbfgs with optax.scale_by_zoom_linesearch
(strong-Wolfe zoom, Algorithms 3.5/3.6 of Nocedal & Wright 1999, with the
Hager-Zhang approximate-decrease relaxation) — the optimizer the reference
effectively runs through ``gpflow.optimizers.Scipy`` (SciPy L-BFGS-B,
reference experiments/snelson/example.py:31-32).  The difference is purely
STRUCTURAL: optax's formulation inlines the objective's value+grad program
at three call sites (the recompute branch of ``value_and_grad_from_state``
plus the two cond branches of the line-search inner while loop), so the
compiled fit loop contains three copies of the ELBO+gradient XLA program.
Three copies triple the compile time and the size of a serialized
executable.

Here the whole optimizer is ONE ``lax.while_loop`` whose body evaluates
value+grad at exactly ONE site.  Each body iteration evaluates the pending
query point q = x + t*d, then a scalar controller (the zoom state machine,
rotated from "choose-eval-classify" to "classify-choose") decides the next
query: continue bracketing, zoom into the interval, or accept the step and
compute a new L-BFGS direction.  The objective appears once, the executable
shrinks ~3x, and the eval count equals the loop trip count, which makes
evals/iter a first-class, freely instrumented quantity.

Parameters are flattened to a single f64 vector (hyperparameter pytrees
here are a handful of scalars), so the L-BFGS memory is a dense (mem, n)
pair of buffers and the two-loop recursion is two length-``mem`` scans —
the same structure optax uses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


def make_fused_run(closed_fn, *, max_iters: int, tol: float,
                   memory_size: int, max_linesearch_steps: int = 30,
                   curv_rtol: float = 0.9, ls_guess: str = "keep",
                   slope_rtol: float = 1e-4, approx_dec_rtol: float = 1e-6,
                   increase_factor: float = 2.0,
                   interval_threshold: float = 1e-5):
    """Build ``run(params, consts) -> (params, iters, value, grad_norm,
    evals)`` — drop-in for the optax-based loop in fit_lbfgs, with the
    objective ``closed_fn(params, *consts)`` inlined at a single site."""
    if ls_guess not in ("keep", "one"):
        raise ValueError(f"ls_guess must be 'keep' or 'one', got {ls_guess!r}")

    def run(params, consts):
        flat0, unravel = ravel_pytree(params)
        n = flat0.shape[0]
        fdt = flat0.dtype

        def vag_flat(q):
            value, grad = jax.value_and_grad(
                lambda p: closed_fn(p, *consts)
            )(unravel(q))
            return value, ravel_pytree(grad)[0]

        mem = memory_size
        inf = jnp.asarray(jnp.inf, fdt)
        zero = jnp.asarray(0.0, fdt)

        def dot(a, b):
            return jnp.vdot(a, b)

        def _dec_err(t, f_t, s_t, f0, s0):
            # sufficient decrease (3.7a) with the Hager-Zhang approximate
            # decrease alternative (eq. 23), exactly as optax
            armijo = f_t - f0 - slope_rtol * t * s0
            approx = jnp.maximum(
                s_t - (2.0 * slope_rtol - 1.0) * s0,
                f_t - f0 - approx_dec_rtol * jnp.abs(f0),
            )
            err = jnp.maximum(jnp.minimum(armijo, approx), 0.0)
            return jnp.where(jnp.isnan(err), inf, err)

        def _curv_err(s_t, s0):
            # strong-Wolfe curvature (3.7b)
            err = jnp.maximum(jnp.abs(s_t) - curv_rtol * jnp.abs(s0), 0.0)
            return jnp.where(jnp.isnan(err), inf, err)

        def _cubicmin(a, fa, fpa, b, fb, c, fc):
            C = fpa
            db, dc = b - a, c - a
            denom = (db * dc) ** 2 * (db - dc)
            d1 = jnp.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]],
                           dtype=fdt)
            AB = jnp.dot(
                d1, jnp.array([fb - fa - C * db, fc - fa - C * dc], dtype=fdt),
                precision=jax.lax.Precision.HIGHEST,
            ) / denom
            A, B = AB[0], AB[1]
            radical = B * B - 3.0 * A * C
            return a + (-B + jnp.sqrt(radical)) / (3.0 * A)

        def _quadmin(a, fa, fpa, b, fb):
            D, C = fa, fpa
            db = b - a
            B = (fb - D - C * db) / (db ** 2)
            return a - C / (2.0 * B)

        def _middle(low, f_low, s_low, high, f_high, cref, f_cref):
            """Next zoom trial point from the current interval (start of
            optax's _zoom_into_interval): cubic if well inside, else
            quadratic, else bisection."""
            delta = jnp.abs(high - low)
            left = jnp.minimum(high, low)
            right = jnp.maximum(high, low)
            cubic_chk = 0.2 * delta
            quad_chk = 0.1 * delta
            mc = _cubicmin(low, f_low, s_low, high, f_high, cref, f_cref)
            use_cubic = (mc > left + cubic_chk) & (mc < right - cubic_chk)
            mq = _quadmin(low, f_low, s_low, high, f_high)
            use_quad = (~use_cubic) & (mq > left + quad_chk) & (
                mq < right - quad_chk)
            mb = (low + high) / 2.0
            middle = jnp.where(use_cubic, mc, cref)
            middle = jnp.where(use_quad, mq, middle)
            middle = jnp.where(~use_cubic & ~use_quad, mb, middle)
            too_small = delta <= interval_threshold
            return middle, too_small

        def _direction(c, S, Y, rho, g, gamma):
            """Two-loop recursion (Nocedal & Wright alg. 7.4), optax's exact
            index order: slots visited oldest->newest via
            (c % mem + arange(mem)) % mem."""
            idx = (c % mem + jnp.arange(mem)) % mem

            def right(vec, i):
                alpha = rho[i] * dot(S[i], vec)
                return vec - alpha * Y[i], alpha

            r, alphas = jax.lax.scan(right, g, idx, reverse=True)
            r = gamma * r

            def left(vec, ia):
                i, alpha = ia
                beta = rho[i] * dot(Y[i], vec)
                return vec + (alpha - beta) * S[i], beta

            r, _ = jax.lax.scan(left, r, (idx, alphas))
            return -r

        # ---- carry ----
        # (x, f_x, g_x): accepted point; (d, slope0): current direction;
        # t: pending trial stepsize; LS controller state; (S, Y, rho, k):
        # L-BFGS memory and accepted-iteration count; evals; done.
        carry0 = dict(
            x=flat0, f_x=inf, g_x=jnp.zeros((n,), fdt),
            d=jnp.zeros((n,), fdt), slope0=zero,
            t=zero, ls_iter=jnp.int32(0), guess=jnp.asarray(1.0, fdt),
            interval_found=jnp.asarray(False),
            prev_t=zero, prev_f=inf, prev_s=zero,
            low=zero, f_low=inf, s_low=zero,
            high=zero, f_high=inf, s_high=zero,
            cref=zero, f_cref=inf,
            safe_t=zero, safe_f=inf, safe_g=jnp.zeros((n,), fdt),
            too_small=jnp.asarray(False),
            first=jnp.asarray(True),
            S=jnp.zeros((mem, n), fdt), Y=jnp.zeros((mem, n), fdt),
            rho=jnp.zeros((mem,), fdt),
            k=jnp.int32(0), evals=jnp.int32(0),
            done=jnp.asarray(False),
        )

        def body(st):
            # ---- the single evaluation site ----
            q = st["x"] + st["t"] * st["d"]
            f_t, g_t = vag_flat(q)
            evals = st["evals"] + 1
            s_t = dot(g_t, st["d"])
            t = st["t"]

            f0, s0 = st["f_x"], st["slope0"]
            dec_err = _dec_err(t, f_t, s_t, f0, s0)
            curv_err = _curv_err(s_t, s0)
            err = jnp.maximum(dec_err, curv_err)
            done_ls = err <= 0.0
            in_zoom = st["interval_found"]

            # safe-step bookkeeping: any point with sufficient decrease, in
            # the zoom phase only if it improves on the stored one
            safe_upd = (dec_err <= 0.0) & jnp.where(
                in_zoom, f_t < st["safe_f"], True)
            safe_t = jnp.where(safe_upd, t, st["safe_t"])
            safe_f = jnp.where(safe_upd, f_t, st["safe_f"])
            safe_g = jnp.where(safe_upd, g_t, st["safe_g"])

            failed = (~done_ls) & (
                (st["ls_iter"] + 1 >= max_linesearch_steps)
                | (in_zoom & st["too_small"] & (safe_t > 0.0))
            )
            accept = st["first"] | done_ls | failed

            # ---- accept path: take the step, update memory, new direction
            outside = jnp.isinf(dec_err)
            use_safe = failed & ((safe_t > 0.0) | outside)
            step_t = jnp.where(st["first"], zero,
                               jnp.where(use_safe, safe_t, t))
            f_new = jnp.where(st["first"], f_t,
                              jnp.where(use_safe, safe_f, f_t))
            g_new = jnp.where(st["first"], g_t,
                              jnp.where(use_safe, safe_g, g_t))
            x_new = st["x"] + step_t * st["d"]

            c = jnp.where(st["first"], 0, st["k"] + 1)
            dx = x_new - st["x"]
            dg = g_new - st["g_x"]
            # first update stores zeros (no previous point), like optax
            dx = jnp.where(c > 0, dx, jnp.zeros_like(dx))
            dg = jnp.where(c > 0, dg, jnp.zeros_like(dg))
            vdd = dot(dg, dx)
            w = jnp.where(vdd == 0.0, zero, 1.0 / vdd)
            slot = (c - 1) % mem
            S2 = st["S"].at[slot].set(dx)
            Y2 = st["Y"].at[slot].set(dg)
            rho2 = st["rho"].at[slot].set(w)
            denom = dot(dg, dg)
            gamma = jnp.where(denom > 0.0, vdd / denom, jnp.asarray(1.0, fdt))
            gnorm_new = jnp.sqrt(dot(g_new, g_new))
            capped = jnp.minimum(jnp.asarray(1.0, fdt), 1.0 / gnorm_new)
            gamma = jnp.where(c > 0, gamma, capped)
            d_new = _direction(c, S2, Y2, rho2, g_new, gamma)
            slope0_new = dot(d_new, g_new)
            guess_new = (
                jnp.where(st["first"], st["guess"],
                          step_t.astype(fdt))
                if ls_guess == "keep" else jnp.asarray(1.0, fdt)
            )
            done_outer = ~((c == 0) | ((c < max_iters) & (gnorm_new >= tol)))

            # ---- continue-linesearch path: bracket or zoom bookkeeping and
            # the next trial point
            # bracketing (optax _search_interval, rotated):
            set_high_new = (dec_err > 0.0) | (
                (f_t >= st["prev_f"]) & (st["ls_iter"] > 0))
            set_low_new = (s_t >= 0.0) & (~set_high_new)
            found = set_high_new | set_low_new
            b_low = jnp.where(set_low_new, t, st["prev_t"])
            b_f_low = jnp.where(set_low_new, f_t, st["prev_f"])
            b_s_low = jnp.where(set_low_new, s_t, st["prev_s"])
            b_high = jnp.where(set_low_new, st["prev_t"], t)
            b_f_high = jnp.where(set_low_new, st["prev_f"], f_t)
            b_s_high = jnp.where(set_low_new, st["prev_s"], s_t)
            # zoom (optax _zoom_into_interval, rotated): t was the middle
            z_set_high_mid = (dec_err > 0.0) | (f_t >= st["f_low"])
            secant = s_t * (st["high"] - st["low"])
            z_set_high_low = (secant >= 0.0) & (~z_set_high_mid)
            z_high = jnp.where(z_set_high_mid, t,
                               jnp.where(z_set_high_low, st["low"],
                                         st["high"]))
            z_f_high = jnp.where(z_set_high_mid, f_t,
                                 jnp.where(z_set_high_low, st["f_low"],
                                           st["f_high"]))
            z_s_high = jnp.where(z_set_high_mid, s_t,
                                 jnp.where(z_set_high_low, st["s_low"],
                                           st["s_high"]))
            z_low = jnp.where(z_set_high_mid, st["low"], t)
            z_f_low = jnp.where(z_set_high_mid, st["f_low"], f_t)
            z_s_low = jnp.where(z_set_high_mid, st["s_low"], s_t)
            z_cref = jnp.where(z_set_high_mid | z_set_high_low,
                               st["high"], st["low"])
            z_f_cref = jnp.where(z_set_high_mid | z_set_high_low,
                                 st["f_high"], st["f_low"])

            # merged interval state for the next trial
            n_found = jnp.where(in_zoom, True, found)
            n_low = jnp.where(in_zoom, z_low, b_low)
            n_f_low = jnp.where(in_zoom, z_f_low, b_f_low)
            n_s_low = jnp.where(in_zoom, z_s_low, b_s_low)
            n_high = jnp.where(in_zoom, z_high, b_high)
            n_f_high = jnp.where(in_zoom, z_f_high, b_f_high)
            n_s_high = jnp.where(in_zoom, z_s_high, b_s_high)
            n_cref = jnp.where(in_zoom, z_cref, b_low)
            n_f_cref = jnp.where(in_zoom, z_f_cref, b_f_low)

            mid, too_small = _middle(n_low, n_f_low, n_s_low, n_high,
                                     n_f_high, n_cref, n_f_cref)
            # next trial: zoom middle once an interval exists, else keep
            # enlarging the bracket
            t_cont = jnp.where(n_found, mid, increase_factor * t)

            def sel(a, b):
                # accept ? a : b, for mixed scalar/array leaves
                return jnp.where(accept, a, b)

            return dict(
                x=jnp.where(accept, x_new, st["x"]),
                f_x=sel(f_new, st["f_x"]),
                g_x=jnp.where(accept, g_new, st["g_x"]),
                d=jnp.where(accept, d_new, st["d"]),
                slope0=sel(slope0_new, st["slope0"]),
                t=sel(guess_new, t_cont),
                ls_iter=sel(jnp.int32(0), st["ls_iter"] + 1),
                guess=sel(guess_new, st["guess"]),
                interval_found=sel(jnp.asarray(False), n_found),
                prev_t=sel(zero, t),
                prev_f=sel(f_new, f_t),
                prev_s=sel(slope0_new, s_t),
                low=sel(zero, n_low), f_low=sel(f_new, n_f_low),
                s_low=sel(slope0_new, n_s_low),
                high=sel(zero, n_high), f_high=sel(f_new, n_f_high),
                s_high=sel(slope0_new, n_s_high),
                cref=sel(zero, n_cref), f_cref=sel(f_new, n_f_cref),
                safe_t=sel(zero, safe_t),
                safe_f=sel(f_new, safe_f),
                safe_g=jnp.where(accept, g_new, safe_g),
                too_small=sel(jnp.asarray(False), too_small),
                first=jnp.asarray(False),
                S=jnp.where(accept, S2, st["S"]),
                Y=jnp.where(accept, Y2, st["Y"]),
                rho=jnp.where(accept, rho2, st["rho"]),
                k=sel(c, st["k"]),
                evals=evals,
                done=sel(done_outer, st["done"]),
            )

        def cond(st):
            return ~st["done"]

        out = jax.lax.while_loop(cond, body, carry0)
        gnorm = jnp.sqrt(dot(out["g_x"], out["g_x"]))
        return (unravel(out["x"]), out["k"], out["f_x"], gnorm,
                out["evals"])

    return run
