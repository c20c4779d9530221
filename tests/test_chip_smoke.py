"""chip_smoke.py's phases at tiny shapes on an explicit CPU device (the
card is not here: the same functions run at full width there), and its
refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

import bench
import chip_smoke as cs


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def _ok(fails):
    assert not fails, list(fails)


def test_phase_gpr1d_tiny(cpu):
    fails = cs.Failures()
    cs.phase_gpr1d(cpu, cpu, fails, n=3000, m=48, n_test=200, iters=3)
    _ok(fails)


def test_phase_kron_tiny(cpu):
    fails = cs.Failures()
    cs.phase_kron(cpu, cpu, fails, n=1500, m=10, n_test=100, iters=3)
    _ok(fails)


def test_phase_additive_tiny(cpu):
    fails = cs.Failures()
    cs.phase_additive(cpu, cpu, fails, n=1500, D=2, m=10, n_test=100,
                      iters=3)
    _ok(fails)


def test_phase_sweep_tiny(cpu):
    fails = cs.Failures()
    cs.phase_sweep(cpu, fails, m=33, ks=(2, 4))
    _ok(fails)


def test_phase_dp_four_devices_tiny():
    fails = cs.Failures()
    cs.phase_dp(jax.devices("cpu")[:4], fails, n1=2000, m1=32, n2=800,
                m2=10)
    _ok(fails)


def test_failures_flag_out_of_tolerance():
    fails = cs.Failures()
    fails.check("x", "fine", 1e-12, 1e-8)
    fails.check("x", "nan", float("nan"), 1e-8)
    fails.check("x", "big", 1e-3, 1e-8)
    assert len(fails) == 2


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_without_gpu(script):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=root,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_main_returns_nonzero_on_cpu():
    assert cs.main([]) == 1
    with pytest.raises(SystemExit):
        bench.require_gpu()
