"""Large-scale 1-D regression: N=1e6 points, m up to 10k features.

The reference's analogous experiment is household electricity (~2M rows,
reference experiments/large_regression/electricity.py) whose data file is
not distributable; this script reproduces the same protocol (5 random
splits, NLPD/MSE/opt-time/pred-time table, ASVGP vs minibatch baseline) on
a synthetic dataset matching the BASELINE.md north-star config.

Run:  python experiments/large_regression/synthetic_1m.py \
          [--n 1000000] [--m 10000] [--splits 5] [--adam-baseline]
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
from asvgp.models import GPR1D, Matern52  # noqa: E402
from asvgp.models.parameters import positive  # noqa: E402
from asvgp.train import fit_adam_minibatch, fit_lbfgs, mse, nlpd  # noqa: E402


def make_data(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.002, 0.998, n)
    f = np.sin(7 * x) + 0.5 * np.sin(23 * x) * np.exp(-x)
    return x, f + 0.3 * rng.randn(n)


def load_data(path):
    """``--data`` hook for a real dataset (the reference's electricity
    pickle — electricity.py:30 — is not distributable).

    Accepts ``.npy`` (an (n, 2) array), ``.npz`` (arrays named ``x`` and
    ``y``), a two-column ``.csv``, or a pickle of anything with two columns
    (e.g. a pandas DataFrame).  Inputs are min-max scaled strictly inside
    (0, 1) and targets standardized, matching the synthetic protocol's
    domain.
    """
    if path.endswith(".npz"):
        z = np.load(path)
        if "x" not in z or "y" not in z:
            # archive order says nothing about which array is the input
            raise ValueError(
                f"{path}: an .npz needs arrays named 'x' and 'y', "
                f"found {sorted(z.files)}"
            )
        x, y = z["x"], z["y"]
    elif path.endswith(".npy"):
        arr = np.load(path)
        x, y = arr[:, 0], arr[:, 1]
    elif path.endswith(".csv"):
        arr = np.loadtxt(path, delimiter=",")
        x, y = arr[:, 0], arr[:, 1]
    else:
        import pickle

        with open(path, "rb") as f:
            obj = pickle.load(f)
        arr = np.asarray(obj)
        x, y = arr[:, 0], arr[:, 1]
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    lo, hi = x.min(), x.max()
    if not hi > lo:
        raise ValueError(f"{path}: x is constant ({lo}); cannot scale it")
    if not y.std() > 0:
        raise ValueError(f"{path}: y is constant; cannot standardize it")
    x = 0.002 + 0.996 * (x - lo) / (hi - lo)
    y = (y - y.mean()) / y.std()
    return x, y


def run_split(args, seed, fit_cache=None, data=None):
    if data is not None:
        # 5 random 95/5 splits of the SAME dataset (reference protocol,
        # electricity.py:128-142)
        xall, yall = data
        perm = np.random.RandomState(seed).permutation(xall.shape[0])
        x, y = xall[perm], yall[perm]
    else:
        x, y = make_data(args.n, seed)
    n_test = max(1, x.shape[0] // 20)  # 95/5 split (reference protocol)
    xtr, ytr = x[n_test:], y[n_test:]
    xte, yte = x[:n_test], y[:n_test]

    basis = BSplineBasis(0.0, 1.0, args.m, args.order)
    # data-scale lengthscale init: with a smooth default init (l=1) the
    # spline Gram's condition number (l/delta)^{2nu+1} reaches ~1e18 at
    # m=1000 and the ELBO trace term is ill-posed for ANY implementation
    # (reference f64 CPU included) — see CLAUDE.md numerics notes
    kern = lambda: Matern52(lengthscales=args.lengthscale_init)
    t0 = time.time()
    model = GPR1D((xtr, ytr), kern(), basis)
    jax.block_until_ready(model.stats.kuf_y)
    t_pre = time.time() - t0

    t0 = time.time()
    fit_info = {}
    loss_fn, dargs, ktag = model.loss_args()
    params, loss, iters = fit_lbfgs(
        loss_fn, model.init_params(),
        max_iters=args.iters, cache=fit_cache, info=fit_info,
        export_dir=os.environ.get("ASVGP_EXEC_CACHE_DIR"),
        data_args=dargs, key_extra=ktag, restarts=args.restarts,
        # large-scale protocol line search: Armijo + HZ approximate
        # decrease, ~1.2 evals/iter; wedges are covered by the
        # accept-only-if-better restarts
        curv_rtol=10.0,
    )
    jax.block_until_ready(loss)
    t_opt = time.time() - t0

    t0 = time.time()
    ld = model.predict_log_density(params, (xte, yte))
    mean, _ = model.predict_f(params, xte)
    jax.block_until_ready(mean)
    t_pred = time.time() - t0

    row = {
        "elbo": -float(loss),
        "nlpd": float(nlpd(ld)),
        "mse": float(mse(yte, mean)),
        "t_precompute": t_pre,
        "t_opt": t_opt,
        "t_pred": t_pred,
        "iters": int(iters),
        # convergence evidence: distinguishes tol-converged folds from
        # iteration-cap-truncated ones (a fold whose ELBO diverges from its
        # siblings with converged=False needs more iterations, not debugging)
        "grad_norm": fit_info.get("grad_norm"),
        "converged": fit_info.get("converged"),
        "restarts": fit_info.get("restarts"),
        "ls_evals": fit_info.get("ls_evals"),
        "evals_per_iter": fit_info.get("evals_per_iter"),
        "stopping_rule": fit_info.get("stopping_rule"),
        "noise_variance": float(positive(params["likelihood"]["raw_variance"])),
    }

    if args.adam_baseline:
        t0 = time.time()
        p_adam, losses = fit_adam_minibatch(
            basis, 5, xtr, ytr, model.init_params(),
            batch_size=args.batch, steps=args.adam_steps,
        )
        jax.block_until_ready(losses)
        row["t_adam"] = time.time() - t0
        ld_a = model.predict_log_density(p_adam, (xte, yte))
        row["nlpd_adam"] = float(nlpd(ld_a))

    if args.svgp_baseline:
        # true SVGP with minibatch Adam — the reference's baseline model
        # and protocol (reference electricity.py:115-116: gpflow.models.SVGP
        # + run_adam with batch 100, 10k iterations).  A baseline failure
        # must not abort the protocol run: record it and continue.
        from asvgp.models.svgp import SVGP1D, fit_svgp

        try:
            svgp = SVGP1D(kern(), basis, num_data=len(xtr))
            t0 = time.time()
            p_svgp, losses = fit_svgp(
                svgp, xtr, ytr, svgp.init_params(),
                batch_size=args.svgp_batch, steps=args.svgp_steps,
            )
            jax.block_until_ready(losses)
            row["t_svgp"] = time.time() - t0
            t0 = time.time()
            ld_s = svgp.predict_log_density(p_svgp, (xte, yte))
            mean_s, _ = svgp.predict_f(p_svgp, xte)
            jax.block_until_ready(mean_s)
            row["t_svgp_pred"] = time.time() - t0
            row["nlpd_svgp"] = float(nlpd(ld_s))
            row["mse_svgp"] = float(mse(yte, mean_s))
            # convergence evidence for the baseline: learned noise (should
            # match the generative 0.09) and the ELBO tail slope (flat=done)
            row["noise_svgp"] = float(
                positive(p_svgp["likelihood"]["raw_variance"])
            )
            tail = np.asarray(losses[-args.svgp_steps // 10:], dtype=float)
            head = np.asarray(
                losses[-args.svgp_steps // 5: -args.svgp_steps // 10],
                dtype=float,
            )
            row["svgp_elbo_tail_drop"] = float(head.mean() - tail.mean())
        except Exception as e:  # noqa: BLE001 — recorded, run continues
            row["svgp_error"] = f"{type(e).__name__}: {e}"[:300]
            print(f"SVGP baseline failed on this fold: {row['svgp_error']}",
                  flush=True)

    if args.vff_baseline:
        # VFF baseline (reference electricity.py:12-13,76-79 imports the
        # external VFF package; here models/vff.py)
        from asvgp.features.fourier import FourierBasis1D
        from asvgp.models.vff import GPRVFF

        fb = FourierBasis1D(0.0, 1.0, args.vff_frequencies)
        t0 = time.time()
        vff = GPRVFF((xtr, ytr), kern(), fb)
        jax.block_until_ready(vff.kuf_y)
        row["t_vff_precompute"] = time.time() - t0
        t0 = time.time()
        p_vff, loss_vff, _ = fit_lbfgs(
            jax.jit(vff.training_loss), vff.init_params(), max_iters=args.iters
        )
        jax.block_until_ready(loss_vff)
        row["t_vff_opt"] = time.time() - t0
        t0 = time.time()
        ld_v = vff.predict_log_density(p_vff, (xte, yte))
        mean_v, _ = vff.predict_f(p_vff, xte)
        jax.block_until_ready(mean_v)
        row["t_vff_pred"] = time.time() - t0
        row["elbo_vff"] = -float(loss_vff)
        row["nlpd_vff"] = float(nlpd(ld_v))
        row["mse_vff"] = float(mse(yte, mean_v))
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=1000)  # reference protocol
    ap.add_argument("--lengthscale-init", type=float, default=0.05)
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--splits", type=int, default=5)
    ap.add_argument("--iters", type=int, default=200)
    # stall-escape reruns (fresh L-BFGS memory from the reached point);
    # the reference's scipy L-BFGS default cap is 1000 iterations, so up
    # to 3x200 stays well inside its budget
    ap.add_argument("--restarts", type=int, default=2)
    ap.add_argument("--adam-baseline", action="store_true")
    ap.add_argument("--svgp-baseline", action="store_true")
    ap.add_argument("--vff-baseline", action="store_true")
    ap.add_argument("--vff-frequencies", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--adam-steps", type=int, default=2000)
    # SVGP baseline protocol = the reference's (electricity.py:115-116)
    ap.add_argument("--svgp-batch", type=int, default=100)
    ap.add_argument("--svgp-steps", type=int, default=10000)
    ap.add_argument("--out", type=str, default=None,
                    help="write a JSON metrics artifact here")
    ap.add_argument("--data", type=str, default=None,
                    help="real dataset (.npy/.npz/.csv/pickle of x,y) run "
                         "through the same 5-split protocol; default is "
                         "the synthetic stand-in")
    args = ap.parse_args()
    data = load_data(args.data) if args.data else None

    from asvgp.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # one compiled-loop cache across splits (the reference's 5-fold protocol
    # refits per split in one process; electricity.py)
    fit_cache = {}
    rows = []
    for seed in range(args.splits):
        rows.append(run_split(args, seed, fit_cache=fit_cache, data=data))
        print(f"split {seed}: " + ", ".join(
            f"{k}={v:.6g}" if isinstance(v, (int, float)) else f"{k}={v}"
            for k, v in rows[-1].items()), flush=True)
    keys = sorted({k for r in rows for k in r})
    table = {}
    print(f"{'metric':14s}  mean ± std over {args.splits} splits")
    for key in keys:
        try:
            vals = np.array(
                [r[key] for r in rows if key in r], dtype=float
            )
        except (TypeError, ValueError):  # non-numeric (e.g. *_error strings)
            continue
        table[key] = {"mean": float(vals.mean()), "std": float(vals.std())}
        print(f"{key:14s}  {vals.mean():.6g} ± {vals.std():.3g}")
    if args.out:
        import json

        with open(args.out, "w") as f:
            json.dump(
                {
                    "config": vars(args),
                    "device": str(jax.devices()[0]),
                    "rows": rows,
                    "table": table,
                },
                f,
                indent=1,
            )


if __name__ == "__main__":
    main()
