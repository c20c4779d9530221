"""Smoke test of the fit-and-predict path on the GPU, in native float64.

    python chip_smoke.py               # one card: phases (a)-(e)
    python chip_smoke.py --phases be   # one card: a subset of (b)-(e)
    python chip_smoke.py --devices 4   # four cards: the data-parallel path only

One process.  Each phase drives the public entry points (model
constructors, ``fit_lbfgs``, ``predict_f``) at a real width on the card and
compares with the CPU float64 scan route of the same process:

  (a) devices, the card's name and power limit (fails without a GPU);
  (b) GPR1D, N=10⁶, m=10⁴, B3 × Matérn-3/2: stats, 5 L-BFGS iterations,
      predict on 10⁴ points;
  (c) GPRKron at the eNATL widths (m=100 per dimension, B4, 2 × Matérn-3/2),
      N=2·10⁵ on both sides, 5 iterations, predict on 10⁵ points;
  (d) GPRAdditive, n=5·10⁵, D=4, 250 B3 features per dimension;
  (e) the fused sweep kernels (banded/sweep.py) against the scan route on
      the card at m=10⁴, k=1…5;
  (f) with ``--devices 4``: the GPR1D and GPRKron data-parallel train steps
      over four cards, each against the same step on one card.

Any comparison outside its tolerance is printed and the script exits
non-zero.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)
# the CPU reference runs in the same process: keep its backend available
# when JAX_PLATFORMS names only the GPU
if jax.config.jax_platforms and "cpu" not in jax.config.jax_platforms:
    jax.config.update("jax_platforms", jax.config.jax_platforms + ",cpu")

import jax.numpy as jnp  # noqa: E402

# on-card result vs CPU f64 scan route (sums run in another order)
TOL = {
    "loss_rel": 1e-8,
    "grad_max_rel": 1e-6,
    "mean_max_abs": 1e-8,
    "var_max_rel": 1e-6,
}
# sweep kernels vs the scan route, both on the card
SWEEP_TOL = {"core_rel": 1e-9, "grad_rel": 1e-7}


class Failures(list):
    def check(self, phase, name, value, tol):
        ok = bool(np.isfinite(value)) and value <= tol
        print(f"  [{phase}] {name} = {value:.3e} (tol {tol:.0e})"
              f"{'' if ok else '  FAILED'}", flush=True)
        if not ok:
            self.append(f"{phase}: {name} = {value:.3e} > {tol:.0e}")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _grad_rel(ga, gb):
    return max(_rel(a, b) for a, b in
               zip(jax.tree.leaves(ga), jax.tree.leaves(gb)))


def _to(tree, dev):
    return jax.tree.map(lambda a: jax.device_put(a, dev), tree)


def _timed(fn, *args):
    t0 = time.time()
    out = jax.block_until_ready(fn(*args))
    return out, time.time() - t0


def _loss_grad(model, params, dev):
    with jax.default_device(dev):
        vg = jax.jit(jax.value_and_grad(model.training_loss))
        (_, t_first) = _timed(vg, params)
        (loss, grad), t = _timed(vg, params)
    return float(loss), grad, t_first, t


def _fit(model, params, dev, iters):
    from asvgp.train import fit_lbfgs

    with jax.default_device(dev):
        if hasattr(model, "loss_args"):
            loss_fn, dargs, tag = model.loss_args()
        else:  # the closure hoist finds the statistics
            loss_fn, dargs, tag = jax.jit(model.training_loss), None, ""
        t0 = time.time()
        p, loss, n_it = fit_lbfgs(loss_fn, params, max_iters=iters,
                                  data_args=dargs, key_extra=tag)
        loss = float(loss)
    return p, loss, int(n_it), time.time() - t0


def _predict(model, params, x, dev):
    with jax.default_device(dev):
        (mean, var), t = _timed(model.predict_f, params, x)
    return np.asarray(mean), np.asarray(var), t


def _compare_fit_predict(phase, make_model, x_test, dev, ref, iters, fails):
    """Build on both devices, compare loss and gradient at init, fit on
    ``dev``, compare predictions at the fitted parameters."""
    t0 = time.time()
    model = make_model(dev, None)
    jax.block_until_ready(jax.tree.leaves(model.stats))
    t_stats = time.time() - t0
    ref_model = make_model(ref, "scan")
    p0 = model.init_params()
    loss, grad, t_vg_first, t_vg = _loss_grad(model, p0, dev)
    ref_loss, ref_grad, _, t_ref_vg = _loss_grad(
        ref_model, _to(p0, ref), ref
    )
    fails.check(phase, "loss_rel_err_at_init", abs(loss - ref_loss)
                / abs(ref_loss), TOL["loss_rel"])
    fails.check(phase, "grad_max_rel_err_at_init", _grad_rel(grad, ref_grad),
                TOL["grad_max_rel"])
    p_fit, fit_loss, n_it, t_fit = _fit(model, p0, dev, iters)
    if not (np.isfinite(fit_loss) and fit_loss <= loss):
        fails.append(f"{phase}: fit did not decrease the loss "
                     f"({loss} -> {fit_loss})")
    mean, var, t_pred = _predict(model, p_fit, x_test, dev)
    rmean, rvar, t_ref_pred = _predict(ref_model, _to(p_fit, ref), x_test,
                                       ref)
    fails.check(phase, "predict_mean_max_abs_err",
                float(np.max(np.abs(mean - rmean))), TOL["mean_max_abs"])
    fails.check(phase, "predict_var_max_rel_err", _rel(var, rvar),
                TOL["var_max_rel"])
    print(f"  [{phase}] on {dev.device_kind}: stats {t_stats:.3f} s, "
          f"value+grad {t_vg * 1e3:.3f} ms (first call {t_vg_first:.2f} s), "
          f"fit {n_it} iters {t_fit:.2f} s (loss {loss:.10g} -> "
          f"{fit_loss:.10g}), predict {len(x_test)} pts {t_pred:.3f} s | "
          f"CPU f64 scan: value+grad {t_ref_vg * 1e3:.3f} ms, predict "
          f"{t_ref_pred:.3f} s", flush=True)


# ---------------------------------------------------------------------------
# (b)-(d): the three model families
# ---------------------------------------------------------------------------


def data_1d(n, seed=0):
    """bench.py's data: ~700 effective periods on (0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.005, 0.995, n)
    y = np.sin(4400.0 * x) + 0.5 * np.sin(1100.0 * x) + 0.3 * rng.randn(n)
    return x, y


def phase_gpr1d(dev, ref, fails, *, n=1_000_000, m=10_000, n_test=10_000,
                iters=5):
    from asvgp.basis import B3Spline
    from asvgp.models import GPR1D, Matern32

    x, y = data_1d(n + n_test)

    def make(d, backend):
        with jax.default_device(d):
            return GPR1D((x[n_test:], y[n_test:]),
                         Matern32(variance=1.0, lengthscales=1e-3),
                         B3Spline(0.0, 1.0, m), noise_variance=0.1,
                         backend=backend)

    print(f"(b) GPR1D N={n} m={m} B3 x Matern-3/2", flush=True)
    _compare_fit_predict("b", make, x[:n_test], dev, ref, iters, fails)


def data_2d(n, seed=1997):
    """A synthetic sea-surface-height-like field (ocean_ssh.py)."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 2))
    u, v = X[:, 0], X[:, 1]
    f = (np.sin(9 * u + 3 * v) + 0.6 * np.cos(14 * v) * np.sin(5 * u)
         + 0.3 * np.sin(31 * u * v + 2))
    return X, f + 0.15 * rng.randn(n)


def phase_kron(dev, ref, fails, *, n=200_000, m=100, n_test=100_000,
               iters=5):
    from asvgp.basis import B4Spline
    from asvgp.models import Matern32
    from asvgp.models.kron import GPRKron

    X, y = data_2d(n + n_test)

    def make(d, backend):
        with jax.default_device(d):
            return GPRKron((X[n_test:], y[n_test:]),
                           [Matern32(lengthscales=0.1)] * 2,
                           [B4Spline(0.0, 1.0, m)] * 2, noise_variance=0.1,
                           backend=backend)

    print(f"(c) GPRKron N={n} (cut from 2e6 on both sides) m={m}x{m} B4 x "
          f"2 Matern-3/2", flush=True)
    _compare_fit_predict("c", make, X[:n_test], dev, ref, iters, fails)


def data_additive(n, D, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, D))
    y = sum(np.sin((3 + 2 * d) * X[:, d]) for d in range(D))
    return X, y + 0.2 * rng.randn(n)


def phase_additive(dev, ref, fails, *, n=500_000, D=4, m=250,
                   n_test=10_000, iters=5):
    from asvgp.basis import B3Spline
    from asvgp.models import Matern32
    from asvgp.models.additive import GPRAdditive

    X, y = data_additive(n + n_test, D)

    def make(d, backend):
        with jax.default_device(d):
            return GPRAdditive((X[n_test:], y[n_test:]),
                               [Matern32(lengthscales=0.2)] * D,
                               [B3Spline(0.0, 1.0, m)] * D,
                               noise_variance=0.1, backend=backend)

    print(f"(d) GPRAdditive n={n} D={D} m={m} per dim (M={D * m})",
          flush=True)
    _compare_fit_predict("d", make, X[:n_test], dev, ref, iters, fails)


# ---------------------------------------------------------------------------
# (e): the sweep kernels against the scan route
# ---------------------------------------------------------------------------


def sweep_problem(k, m, seed=0):
    """A Matérn-shaped collapsed-core problem at bandwidth k: kuu_fn(var,
    ell) = G(ell)/var with G(ell) SPD and banded, P = B/σ² + Kuu."""
    from asvgp.banded import dense_to_lower_band

    rng = np.random.RandomState(seed)

    def spd_band(scale, shift):
        A = rng.randn(m, m + 2 * k) * scale
        full = A @ A.T
        mask = np.abs(np.arange(m)[:, None] - np.arange(m)[None]) <= k
        full = np.where(mask, full, 0.0) + shift * np.eye(m)
        return np.asarray(dense_to_lower_band(jnp.asarray(full), k))

    g0 = spd_band(0.3, 2.0 * k + 1.0)
    g1 = spd_band(0.1, 0.0)
    big = spd_band(0.5, 0.0)

    def kuu_fn(var, ell):
        return (jnp.asarray(g0) + ell * jnp.asarray(g1)) / var

    b = rng.randn(m)
    return kuu_fn, 1.3, 0.7, big, b, 0.25


def sweep_vs_scan(dev, k, m, seed=0, time_it=False):
    """Value and gradient of the Matérn collapsed core on the "sweep" and
    "scan" routes (both on ``dev``).  Returns (core_rel, grad_rel, t_sweep,
    t_scan) with t_* the value+grad time of each route (None unless
    ``time_it``)."""
    from asvgp.banded import ops

    kuu_fn, var, ell, big, b, sigma2 = sweep_problem(k, m, seed)
    w = jnp.asarray([1.0, -0.5, 0.3, 0.2])

    def loss(route):
        def f(var, ell, big, b):
            p = big / sigma2 + kuu_fn(var, ell)
            with ops.impl_scope(route):
                out = ops.collapsed_core_matern(kuu_fn, var, ell, p, b, big)
            return jnp.vdot(w, jnp.stack(out)), jnp.stack(out)
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                          has_aux=True))

    args = _to((jnp.asarray(var), jnp.asarray(ell), jnp.asarray(big),
                jnp.asarray(b)), dev)
    res, times = {}, {}
    with jax.default_device(dev):
        for route in ("sweep", "scan"):
            fn = loss(route)
            res[route] = jax.block_until_ready(fn(*args))
            if time_it:
                reps = 3
                t0 = time.time()
                for _ in range(reps):
                    jax.block_until_ready(fn(*args))
                times[route] = (time.time() - t0) / reps
    (_, core_s), g_s = res["sweep"]
    (_, core_r), g_r = res["scan"]
    core_rel = _rel(core_s, core_r)
    grad_rel = max(
        float(np.max(np.abs(np.asarray(a) - np.asarray(c)))
              / max(float(np.max(np.abs(np.asarray(c)))), 1e-300))
        for a, c in zip(g_s, g_r)
    )
    return core_rel, grad_rel, times.get("sweep"), times.get("scan")


def phase_sweep(dev, fails, *, m=10_000, ks=(1, 2, 3, 4, 5)):
    print(f"(e) sweep kernels vs scan route, m={m}", flush=True)
    for k in ks:
        core_rel, grad_rel, t_sw, t_sc = sweep_vs_scan(dev, k, m,
                                                       time_it=True)
        fails.check("e", f"k={k} core_rel_err", core_rel,
                    SWEEP_TOL["core_rel"])
        fails.check("e", f"k={k} grad_rel_err", grad_rel,
                    SWEEP_TOL["grad_rel"])
        print(f"  [e] k={k} value+grad on {dev.device_kind}: sweep "
              f"{t_sw * 1e3:.3f} ms, XLA scan {t_sc * 1e3:.3f} ms",
              flush=True)


# ---------------------------------------------------------------------------
# (f): data-parallel train steps over several cards
# ---------------------------------------------------------------------------


def _dp_steps(make_step, params, X, y, devices, steps=2):
    import optax

    from asvgp.parallel import shard_data

    mesh = jax.sharding.Mesh(np.array(devices), ("data",))
    step = make_step(mesh, optax.adam(1e-2))
    opt_state = optax.adam(1e-2).init(params)
    xs, ys = shard_data(jnp.asarray(X), jnp.asarray(y), mesh)
    losses = []
    t0 = time.time()
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, xs, ys)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params), time.time() - t0


def phase_dp(devices, fails, *, n1=1_000_000, m1=10_000, n2=200_000,
             m2=100):
    from asvgp.basis import B3Spline, B4Spline
    from asvgp.models import Matern32
    from asvgp.models.gpr1d import default_params
    from asvgp.parallel import make_dp_train_step, make_dp_train_step_kron

    nd = len(devices)
    x, y = data_1d(n1)
    basis = B3Spline(0.0, 1.0, m1)
    p1 = default_params(Matern32(lengthscales=1e-3), 0.1)

    def step1(mesh, opt):
        return make_dp_train_step(basis, 3, mesh, optimizer=opt)[0]

    X2, y2 = data_2d(n2)
    bases2 = [B4Spline(0.0, 1.0, m2)] * 2
    p2 = {
        "kernels": [default_params(Matern32(lengthscales=0.1))["kernel"]] * 2,
        "likelihood": default_params(Matern32(), 0.1)["likelihood"],
    }

    def step2(mesh, opt):
        return make_dp_train_step_kron(bases2, [3, 3], mesh,
                                       optimizer=opt)[0]

    for name, step, p, X, Y in (("GPR1D", step1, p1, x, y),
                                ("GPRKron", step2, p2, X2, y2)):
        print(f"(f) {name} data-parallel step, {nd} cards vs 1", flush=True)
        l_n, p_n, t_n = _dp_steps(step, p, X, Y, devices)
        l_1, p_1, t_1 = _dp_steps(step, p, X, Y, devices[:1])
        fails.check("f", f"{name} loss_rel_err", _rel(l_n, l_1),
                    TOL["loss_rel"])
        fails.check("f", f"{name} params_max_rel_err", _grad_rel(p_n, p_1),
                    TOL["grad_max_rel"])
        print(f"  [f] {name}: 2 steps on {nd} cards {t_n:.2f} s, on 1 card "
              f"{t_1:.2f} s (both include compilation)", flush=True)


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the data-parallel path on 4 cards")
    ap.add_argument("--phases", default="bcde",
                    help="one-card phases to run, a subset of 'bcde'")
    args = ap.parse_args(argv)
    if not args.phases or set(args.phases) - set("bcde"):
        ap.error(f"--phases takes letters of 'bcde', got {args.phases!r}")

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"no GPU: the first JAX device is {dev.platform!r}; "
              "this smoke test runs on the card only", file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"--devices {args.devices} needs {args.devices} GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 1
    from asvgp.banded import ops
    from asvgp.utils.compile_cache import enable_compile_cache
    from asvgp.utils.profiling import card_line

    print(f"(a) devices: {devices}", flush=True)
    print(f"    device_kind: {dev.device_kind}", flush=True)
    print(f"    card: {card_line()}", flush=True)

    enable_compile_cache()
    print(f"    GPU banded route: {ops.GPU_IMPL}", flush=True)
    ref = jax.devices("cpu")[0]
    fails = Failures()
    t0 = time.time()
    if args.devices == 4:
        phase_dp(devices[:4], fails)
    else:
        phases = {"b": lambda: phase_gpr1d(dev, ref, fails),
                  "c": lambda: phase_kron(dev, ref, fails),
                  "d": lambda: phase_additive(dev, ref, fails),
                  "e": lambda: phase_sweep(dev, fails)}
        for name in "bcde":
            if name in args.phases:
                phases[name]()
    print(f"total {time.time() - t0:.1f} s", flush=True)
    if fails:
        print("FAILED: " + "; ".join(fails), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": args.devices}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
