"""Parameter transforms: positive-constrained hyperparameters.

Equivalent of gpflow's Parameter/positive-bijector machinery consumed by the
reference (SURVEY.md §2.3): hyperparameters are stored unconstrained and
mapped through softplus, so optimizers (L-BFGS/Adam) work in R^d.
"""

from __future__ import annotations

import jax.numpy as jnp


def positive(raw):
    """softplus: raw (unconstrained) -> positive."""
    return jnp.logaddexp(raw, 0.0)


def positive_inverse(value):
    """Inverse softplus: positive -> unconstrained (stable for small/large)."""
    value = jnp.asarray(value, dtype=jnp.result_type(float))
    return value + jnp.log(-jnp.expm1(-value))


def positive_inverse_host(value):
    """Inverse softplus computed HOST-SIDE (numpy).

    Model ``init_params`` runs this instead of the jnp version, so the
    chain of tiny softplus-inverse ops is not one eager device dispatch
    each.  The caller device_puts the finished pytree in one batch."""
    import numpy as np

    # follow jax's ambient default float (f32 unless x64), matching the
    # jnp version's jnp.result_type(float) coercion
    value = np.asarray(value, dtype=np.dtype(jnp.result_type(float)))
    return value + np.log(-np.expm1(-value))
