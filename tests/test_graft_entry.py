"""The entry points must work hermetically (no accelerator required).

dryrun_multichip must not dispatch its first eager op to the default
accelerator.  These tests run the actual entry points in a fresh subprocess
with NO JAX_PLATFORMS override in the environment, so a regression to
accelerator dependence fails here first.
"""

import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run_snippet(code, timeout=600, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    if env_extra:
        env.update(env_extra)
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_dryrun_multichip_8_devices_no_tpu():
    _run_snippet(
        "import __graft_entry__ as g; g.dryrun_multichip(8); print('DRYRUN_OK')"
    )


def test_dryrun_multichip_2_devices_no_tpu():
    _run_snippet(
        "import __graft_entry__ as g; g.dryrun_multichip(2); print('DRYRUN_OK')"
    )
