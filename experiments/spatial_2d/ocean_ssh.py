"""2-D spatial regression at eNATL60 scale (reference protocol parity).

The reference's eNATL60 experiment (reference experiments/eNATL60/
eNATL60.py) regresses sea-surface height on N=2,000,000 points with
GPR_kron: 2 x Matérn-3/2 x B4Spline(m=100 per dim) = 10,000 tensor-product
features, full-batch L-BFGS, prediction in chunks, MSE+NLL metrics.  The
NetCDF ocean data is not distributable, so this script runs the identical
protocol on a synthetic SSH-like field (long-range swirls + eddies); pass
--data to point at a (N, 3) [lon, lat, ssh] .npy file instead.

Run: python experiments/spatial_2d/ocean_ssh.py [--n 2000000] [--m 100]
     [--n-test 100000] [--mesh N]   # data-parallel over N devices
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

if os.environ.get("ASVGP_FORCE_CPU"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from asvgp.basis import BSplineBasis  # noqa: E402
from asvgp.models import Matern32  # noqa: E402
from asvgp.models.kron import GPRKron  # noqa: E402
from asvgp.train import fit_lbfgs, mse, nlpd  # noqa: E402
from asvgp.train.logging import WallClock  # noqa: E402


def synthetic_ssh(n, seed=1997):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.02, 0.98, (n, 2))
    u, v = X[:, 0], X[:, 1]
    f = (
        np.sin(9 * u + 3 * v)
        + 0.6 * np.cos(14 * v) * np.sin(5 * u)
        + 0.3 * np.sin(31 * u * v + 2)
    )
    return X, (f + 0.15 * rng.randn(n)).reshape(-1, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--n-test", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--mesh", type=int, default=0, help="data-parallel devices")
    ap.add_argument("--data", type=str, default=None)
    ap.add_argument("--out", type=str, default=None,
                    help="write a JSON metrics artifact here")
    # the 2-D flagship's comparison leg (VERDICT r4 #5): time a handful of
    # ELBO value+grad steps of the repo's own CPU-f64 block path at the
    # same shape — the stand-in for the reference's dense m²xm² f64
    # Cholesky per L-BFGS iteration (reference asvgp/gpr.py:292-293,
    # utils.py:45-51), which cannot run in this image
    ap.add_argument("--cpu-baseline-steps", type=int, default=0,
                    help="time K CPU-f64 value+grad steps at the same shape")
    args = ap.parse_args()

    if args.data:
        arr = np.load(args.data)
        X, y = arr[:, :2], arr[:, 2:3]
        lo, hi = X.min(0), X.max(0)
        X = 0.02 + 0.96 * (X - lo) / (hi - lo)  # normalize into the mesh box
    else:
        X, y = synthetic_ssh(args.n + args.n_test)
    Xtr, ytr = X[args.n_test:], y[args.n_test:]
    Xte, yte = X[:args.n_test], y[:args.n_test]

    bases = [BSplineBasis(0.0, 1.0, args.m, args.order)] * 2
    kernels = [Matern32(lengthscales=0.1), Matern32(lengthscales=0.1)]
    mesh = (
        jax.make_mesh((args.mesh,), ("data",)) if args.mesh else None
    )

    from asvgp.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    clock = WallClock()
    stats_timings = {}
    with clock.section("precompute"):
        model = GPRKron((Xtr, ytr), kernels, bases, noise_variance=0.1,
                        mesh=mesh, timings=stats_timings)
        jax.block_until_ready(model.stats.kuf_y)
    print(f"precompute: {clock.times['precompute']:.1f}s "
          f"(N={len(ytr)}, features={args.m ** 2}, "
          f"stats phases {stats_timings})")

    opt_timings = {}
    fit_info = {}
    with clock.section("optimize"):
        loss_fn, dargs, ktag = model.loss_args()
        params, loss, iters = fit_lbfgs(
            loss_fn, model.init_params(),
            max_iters=args.iters, timings=opt_timings, info=fit_info,
            export_dir=os.environ.get("ASVGP_EXEC_CACHE_DIR"),
            data_args=dargs, key_extra=ktag,
            # large-scale protocol line search: ~1.2 evals/iter with
            # matched NLPD at the north-star shape
            curv_rtol=10.0,
        )
        jax.block_until_ready(loss)
    print(f"optimize: {clock.times['optimize']:.1f}s "
          f"(ELBO={-float(loss):.2f}, {int(iters)} iters, "
          f"phases {opt_timings})")

    import time as _time

    with clock.section("predict"):
        # factor once, predict many: posterior() caches the block
        # factorization + Takahashi band; both metrics reuse it
        t0 = _time.time()
        post = model.posterior(params)
        jax.block_until_ready(post.w_flat)
        t_factor = _time.time() - t0
        t0 = _time.time()
        mean, var = post.predict_f(jnp.asarray(Xte))
        ld = post.predict_log_density((Xte, yte))
        jax.block_until_ready(mean)
        t_cold = _time.time() - t0
        t0 = _time.time()
        mean2, _ = post.predict_f(jnp.asarray(Xte))
        jax.block_until_ready(mean2)
        t_warm = _time.time() - t0
    pred_phases = {
        "factor_s": round(t_factor, 2),
        "cold_s": round(t_cold, 2),
        "warm_exec_s": round(t_warm, 2),
    }
    print(f"predict: {clock.times['predict']:.1f}s ({args.n_test} points, "
          f"phases {pred_phases})")

    print(f"MSE = {float(mse(yte, mean)):.6f}")
    print(f"NLL = {float(nlpd(ld)):.6f}")
    print("timings:", {k: round(v, 2) for k, v in clock.summary().items()})

    cpu_baseline = None
    if args.cpu_baseline_steps:
        # the repo's own CPU-f64 block path at the SAME shape: per-step
        # value+grad cost of the stand-in baseline (the reference's path
        # at this shape is a dense 10^4 x 10^4 f64 Cholesky + autodiff per
        # iteration — strictly slower than this banded-block stand-in)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            t0 = _time.time()
            model_c = GPRKron((Xtr, ytr), kernels, bases, noise_variance=0.1)
            jax.block_until_ready(model_c.stats.kuf_y)
            t_pre_c = _time.time() - t0
            loss_c, dargs_c, _ = model_c.loss_args()
            vg = jax.jit(jax.value_and_grad(loss_c))
            p0 = model_c.init_params()
            t0 = _time.time()
            jax.block_until_ready(vg(p0, *dargs_c))  # trace+compile+exec
            t_first = _time.time() - t0
            t0 = _time.time()
            for _ in range(args.cpu_baseline_steps):
                jax.block_until_ready(vg(p0, *dargs_c))
            step_s = (_time.time() - t0) / args.cpu_baseline_steps
        dev_step_s = (
            opt_timings.get("exec_s", 0.0) / max(int(iters), 1)
        )
        cpu_baseline = {
            "device": str(cpu),
            "m": args.m,
            "t_precompute_s": round(t_pre_c, 2),
            "first_call_s": round(t_first, 2),
            "step_value_grad_s": round(step_s, 3),
            "steps_timed": args.cpu_baseline_steps,
            "cpu_loadavg": round(os.getloadavg()[0], 2),
            # per-L-BFGS-iteration comparison (device exec includes its
            # line-search evals; see opt_info.evals_per_iter)
            "device_exec_per_iter_s": round(dev_step_s, 3),
            "vs_baseline_step": round(step_s / dev_step_s, 1)
            if dev_step_s else None,
        }
        print(f"cpu-f64 baseline: {cpu_baseline}")
    if args.out:
        import json

        with open(args.out, "w") as f:
            json.dump(
                {
                    "n_train": len(ytr),
                    "n_test": args.n_test,
                    "features": args.m ** 2,
                    "order": args.order,
                    "device": str(jax.devices()[0]),
                    "elbo": -float(loss),
                    "iters": int(iters),
                    "grad_norm": fit_info.get("grad_norm"),
                    "converged": fit_info.get("converged"),
                    "opt_info": fit_info,
                    "mse": float(mse(yte, mean)),
                    "nll": float(nlpd(ld)),
                    "timings_s": {
                        k: round(v, 2) for k, v in clock.summary().items()
                    },
                    "opt_phases_s": opt_timings,
                    "stats_phases_s": stats_timings,
                    "pred_phases_s": pred_phases,
                    "cpu_f64_baseline": cpu_baseline,
                },
                f,
                indent=1,
            )


if __name__ == "__main__":
    main()
