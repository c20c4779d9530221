"""Snelson 1-D toy regression (reference protocol parity).

Mirrors the reference experiment (reference experiments/snelson/example.py):
train an exact GP, then ASVGP with B3 splines (m=100, Matérn-3/2) on
[-3.5, 10.5], and print both objectives side by side — the ELBO must
lower-bound and approach the exact log marginal likelihood.

Run:  python experiments/snelson/example.py [--m 100] [--order 3]
      [--plot out.png]   # predictive mean ±2σ plot (reference example.ipynb)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

if os.environ.get("ASVGP_FORCE_CPU"):  # some images ignore JAX_PLATFORMS
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from asvgp.basis import BSplineBasis  # noqa: E402
from asvgp.models import ExactGPR, GPR1D, Matern32  # noqa: E402
from asvgp.train import fit_lbfgs  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data", "snelson")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--a", type=float, default=-3.5)
    ap.add_argument("--b", type=float, default=10.5)
    ap.add_argument(
        "--plot",
        default=None,
        metavar="PATH",
        help="write the predictive plot (mean, ±2σ band, training points) "
        "to PATH — the artifact the reference produces in example.ipynb",
    )
    args = ap.parse_args()

    X = np.loadtxt(os.path.join(DATA, "train_inputs")).reshape(-1, 1)
    y = np.loadtxt(os.path.join(DATA, "train_outputs")).reshape(-1, 1)

    gp = ExactGPR((X, y), Matern32())
    p, loss, it = fit_lbfgs(jax.jit(gp.training_loss), gp.init_params())
    print(f"GP: ELBO = {-float(loss):.6f}  ({int(it)} iters)")

    t0 = time.time()
    model = GPR1D((X, y), Matern32(), BSplineBasis(args.a, args.b, args.m, args.order))
    pf, lossf, itf = fit_lbfgs(jax.jit(model.training_loss), model.init_params())
    print(
        f"ASVGP: ELBO = {-float(lossf):.6f}  "
        f"({int(itf)} iters, {time.time() - t0:.2f}s total)"
    )

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xs = np.linspace(args.a, args.b, 600).reshape(-1, 1)
        mean, var = model.predict_f(pf, xs)
        mean = np.asarray(mean)[:, 0]
        sd = np.sqrt(np.asarray(var)[:, 0])
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.fill_between(
            xs[:, 0], mean - 2 * sd, mean + 2 * sd,
            alpha=0.25, lw=0, label="±2σ",
        )
        ax.plot(xs[:, 0], mean, lw=1.5, label="predictive mean")
        ax.plot(X[:, 0], y[:, 0], "kx", ms=4, alpha=0.7, label="train")
        ax.set_xlim(args.a, args.b)
        ax.set_title(
            f"ASVGP on Snelson (m={args.m}, order {args.order}); "
            f"ELBO {-float(lossf):.3f} vs exact logZ {-float(loss):.3f}"
        )
        ax.legend(loc="upper right", fontsize=8)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
