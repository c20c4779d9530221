"""Profiling helpers (SURVEY.md §5: tracing/profiling row).

The reference has only time.time() brackets; here we add
block_until_ready-accurate timers and a jax.profiler trace context for
per-kernel inspection on the device.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax


def timed(fn, *args, reps: int = 5, warmup: int = 1, **kwargs):
    """Median wall time of a jitted callable with device sync.

    Returns (median_seconds, last_result).
    """
    import numpy as np

    result = None
    for _ in range(warmup):
        result = jax.block_until_ready(fn(*args, **kwargs))
    ts = []
    for _ in range(reps):
        t0 = time.time()
        result = jax.block_until_ready(fn(*args, **kwargs))
        ts.append(time.time() - t0)
    return float(np.median(ts)), result


def card_line() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them (a card
    may be set below its maximum power and then runs slower under load, so
    every device number is reported beside it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


@contextlib.contextmanager
def trace_to(logdir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
