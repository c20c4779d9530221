"""The sweep route's custom VJP (closed-form band gradients plus the fused
lengthscale tangent, banded/sweep.py) against autodiff through the f64
scan route, in Pallas interpret mode, for k = 1…5 over short, medium and
odd m.  The comparison is chip_smoke.sweep_vs_scan, which runs the same
check on the card at m = 10⁴."""

import jax
import pytest

import chip_smoke


@pytest.mark.parametrize("m", [7, 64, 129])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_sweep_vjp_matches_scan(k, m):
    cpu = jax.devices("cpu")[0]
    core_rel, grad_rel, _, _ = chip_smoke.sweep_vs_scan(cpu, k, m, seed=k + m)
    assert core_rel <= 1e-12, core_rel
    assert grad_rel <= 1e-10, grad_rel
