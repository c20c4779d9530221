"""North-star benchmark: ELBO+grad step at N=1e6 points, m=10k B3 features.

Runs on the GPU and fails without one.  Prints the card's name and power
limit, then ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"extras"}.  ``value`` is the median ELBO value-and-grad step time (ms) on
the GPU, f64 — the training hot loop of BASELINE.md's "1e6-point 1-D
Matérn-3/2 regression with 10k B-spline features"; ``loss_rel_err_vs_f64``
checks the value against the host CPU float64 scan route, and
``vs_baseline`` is the speedup over that CPU step.

``python bench.py --routes`` instead times the value+grad step of every
banded route ("scan", "cr", "sweep") at m = 10³ and 10⁴ with B3 ×
Matérn-3/2 and B5 × Matérn-5/2, one JSON line per (shape, route) — the
measurement behind banded/ops.py GPU_IMPL.

The synthetic data carries ~700 effective periods so the m=10⁴ basis is
genuinely exercised and the lengthscale init matches the data scale — the
regime the method is designed for (with smooth data + m=10⁴ the ELBO's
trace term is mathematically ill-conditioned, κ(Kuu) ≳ 1e16, and *no*
implementation, the reference's f64 CPU included, computes it to any
precision).
"""

import argparse
import json
import sys
import time

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)
# the CPU f64 leg runs in the same process: keep its backend available when
# JAX_PLATFORMS names only the GPU
if jax.config.jax_platforms and "cpu" not in jax.config.jax_platforms:
    jax.config.update("jax_platforms", jax.config.jax_platforms + ",cpu")

import jax.numpy as jnp  # noqa: E402

N = 1_000_000
M = 10_000
SEED = 0


def make_data(n=N):
    rng = np.random.RandomState(SEED)
    x = rng.uniform(0.005, 0.995, n)
    y = np.sin(4400.0 * x) + 0.5 * np.sin(1100.0 * x) + 0.3 * rng.randn(n)
    return x, y


def require_gpu():
    """The first device, which must be a GPU: no CPU fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found (first JAX device is {dev.platform!r}); "
            "this measurement runs on the card only"
        )
    return dev


def build(device, m=M, order=3, nu2=3, lengthscale=1e-3, backend=None,
          n=N):
    from asvgp.basis import BSplineBasis
    from asvgp.models import GPR1D, Matern

    x, y = make_data(n)
    with jax.default_device(device):
        t0 = time.time()
        model = GPR1D(
            (jnp.asarray(x), jnp.asarray(y)),
            Matern(variance=1.0, lengthscales=lengthscale, nu2=nu2),
            BSplineBasis(0.0, 1.0, m, order),
            noise_variance=0.1, backend=backend,
        )
        jax.block_until_ready(model.stats.kuf_y)
        t_pre = time.time() - t0
        params = model.init_params()
    return model, params, t_pre


def time_step(model, params, device, reps=5, k_steps=10):
    """Median per-step ELBO+grad time with ``k_steps`` steps inside one jit
    — how training actually runs (fit_lbfgs is a single on-device
    while_loop), so per-dispatch latency is amortized as in production."""
    with jax.default_device(device):
        vg = jax.value_and_grad(model.training_loss)

        @jax.jit
        def steps(p):
            def body(carry, i):
                # perturb a hyperparameter so no step can be CSE'd away
                q = dict(p)
                q["kernel"] = dict(p["kernel"])
                q["kernel"]["raw_lengthscales"] = (
                    p["kernel"]["raw_lengthscales"] + 1e-12 * (i + carry * 0.0)
                )
                loss, grads = vg(q)
                gsum = sum(jax.tree.leaves(jax.tree.map(jnp.sum, grads)))
                return carry + loss + 1e-20 * gsum, loss

            dt = p["likelihood"]["raw_variance"].dtype
            return jax.lax.scan(
                body, jnp.zeros((), dt), jnp.arange(k_steps, dtype=dt)
            )

        t0 = time.time()
        _, losses = steps(params)
        val = float(losses[0])
        t_compile = time.time() - t0
        ts = []
        for i in range(reps):
            p = dict(params)
            p["kernel"] = dict(params["kernel"])
            p["kernel"]["raw_lengthscales"] = (
                params["kernel"]["raw_lengthscales"] + 1e-10 * (i + 1)
            )
            t0 = time.time()
            float(steps(p)[1][0])
            ts.append(time.time() - t0)
    return float(np.median(ts)) / k_steps, t_compile, val


# (label, order, nu2, lengthscale init) of the route comparison
ROUTE_SHAPES = [("B3xMatern32", 3, 3, 1e-3), ("B5xMatern52", 5, 5, 1e-3)]


def bench_routes(dev):
    cpu = jax.devices("cpu")[0]
    for m in (1_000, 10_000):
        for label, order, nu2, ell in ROUTE_SHAPES:
            ref_model, ref_params, _ = build(cpu, m, order, nu2, ell, "scan")
            with jax.default_device(cpu):
                ref = float(jax.jit(ref_model.training_loss)(ref_params))
            for route in ("scan", "cr", "sweep"):
                row = {"shape": f"{label}-m{m}", "route": route,
                       "device": dev.device_kind}
                try:
                    model, params, _ = build(dev, m, order, nu2, ell, route)
                    step_s, t_compile, val = time_step(
                        model, params, dev, reps=2, k_steps=3
                    )
                    row.update(
                        step_ms=step_s * 1e3, compile_s=t_compile,
                        loss_rel_err_vs_cpu_f64=abs(val - ref) / abs(ref),
                    )
                except Exception as e:  # noqa: BLE001 — reported per route
                    row["error"] = f"{type(e).__name__}: {e}"[:400]
                print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", action="store_true",
                    help="time value+grad of each banded route instead")
    args = ap.parse_args(argv)

    from asvgp.utils.compile_cache import enable_compile_cache
    from asvgp.utils.profiling import card_line

    dev = require_gpu()
    enable_compile_cache()
    print(f"card: {card_line()}", flush=True)
    if args.routes:
        bench_routes(dev)
        return

    model, params, t_pre = build(dev)
    step_s, t_compile, val = time_step(model, params, dev)

    cpu = jax.devices("cpu")[0]
    model_cpu, params_cpu, _ = build(cpu, backend="scan")
    cpu_s, _, cpu_val = time_step(model_cpu, params_cpu, cpu, reps=2)

    print(
        json.dumps(
            {
                "metric": "elbo_grad_step_1m_points_10k_features",
                "value": step_s * 1000,
                "unit": "ms",
                "vs_baseline": cpu_s / step_s,
                "extras": {
                    "device": {"platform": dev.platform,
                               "kind": dev.device_kind,
                               "count": len(jax.devices())},
                    "precompute_s": t_pre,
                    "compile_s": t_compile,
                    "loss": val,
                    "cpu_f64_step_ms": cpu_s * 1000,
                    "loss_rel_err_vs_f64": abs(val - cpu_val) / abs(cpu_val),
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
