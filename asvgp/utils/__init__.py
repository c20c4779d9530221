"""Utility helpers: profiling and scipy interop."""

from asvgp.utils.profiling import timed, trace_to
from asvgp.utils.interop import (
    lower_band_to_scipy,
    scipy_to_lower_band,
    kuf_to_scipy,
)

__all__ = [
    "timed",
    "trace_to",
    "lower_band_to_scipy",
    "scipy_to_lower_band",
    "kuf_to_scipy",
]
