"""Adam / minibatch training loop.

Equivalent of the reference's SVGP-baseline Adam loop
(experiments/large_regression/electricity.py:47-69) and the north-star
minibatch-ELBO capability (BASELINE.md): each step re-assembles sufficient
statistics from a minibatch (rescaled by N/B — the stochastic collapsed
bound) and updates hyperparameters.  The loop runs as one jitted
``lax.scan`` over steps with on-device minibatch gathers, so there is no
host round-trip per iteration.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from asvgp.features.spline_features import make_kuu
from asvgp.models.gpr1d import (
    collapsed_elbo_banded,
    params_to_kernel,
    params_to_likelihood,
)
from asvgp.stats.sufficient import SufficientStats, _stats_local


def fit_adam_minibatch(basis, nu2, X, y, params, *, batch_size=1024,
                       steps=1000, learning_rate=1e-2, seed=0,
                       log_every=0):
    """Minibatch Adam on the stochastic collapsed ELBO for the 1-D model.

    Returns (params, loss_history (steps,)).
    """
    x = jnp.reshape(jnp.asarray(X), (-1,))
    yf = jnp.reshape(jnp.asarray(y), (-1,))
    n_total = x.shape[0]
    opt = optax.adam(learning_rate)

    def loss_fn(p, xb, yb):
        stats = _stats_local(basis, xb, yb)
        scale = jnp.asarray(n_total, x.dtype) / stats.n
        stats = SufficientStats(
            kuf_y=stats.kuf_y * scale,
            kufkfu_band=stats.kufkfu_band * scale,
            yty=stats.yty * scale,
            n=stats.n * scale,
        )
        kernel = params_to_kernel(p, nu2)
        lik = params_to_likelihood(p)
        kuu = make_kuu(kernel, basis)
        return -collapsed_elbo_banded(stats, kuu, lik.variance,
                                      stats.n * kernel.variance)

    @jax.jit
    def run(params, key):
        opt_state = opt.init(params)

        def step(carry, _):
            params, opt_state, key = carry
            key, sub = jax.random.split(key)
            idx = jax.random.randint(sub, (batch_size,), 0, n_total)
            xb = x[idx]
            yb = yf[idx]
            loss, grads = jax.value_and_grad(loss_fn)(params, xb, yb)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state, key), loss

        (params, _, _), losses = jax.lax.scan(
            step, (params, opt_state, key), None, length=steps
        )
        return params, losses

    params, losses = run(params, jax.random.PRNGKey(seed))
    return params, losses
