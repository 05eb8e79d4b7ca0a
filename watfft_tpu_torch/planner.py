"""Kernel dispatch for the port.

Counterpart of `watfft_tpu/planner.py`. The port has one kernel so far,
the Stockham engine of `ops/stockham.py`, for f32 and power-of-two n up to
4096 (one transform per thread block). Sizes and dtypes it does not cover
raise: the planner never hands a call to `torch.fft`, which would hide the
kernel. Its TPU decision table (crossovers, overrides) does not carry over.
"""

from __future__ import annotations

from .plan import is_power_of_two

__all__ = ["STOCKHAM_MAX_N", "c2c_kernel"]

STOCKHAM_MAX_N = 4096


def c2c_kernel(n: int, dtype: str) -> str:
    """'stockham' for float32 and power-of-two 2 <= n <= STOCKHAM_MAX_N."""
    if not is_power_of_two(n) or n < 2:
        raise ValueError(f"size must be a power of two >= 2, got {n!r}")
    if dtype != "float32":
        raise NotImplementedError(
            f"dtype {dtype}: the port runs float32 only; the f64 tier is "
            f"ROADMAP item A10")
    if n > STOCKHAM_MAX_N:
        raise NotImplementedError(
            f"n={n}: the port covers n <= {STOCKHAM_MAX_N}; large N is "
            f"ROADMAP item A7")
    return "stockham"
