"""Kernel dispatch for the port.

Counterpart of `watfft_tpu/planner.py`. The port has the Stockham engine
of `ops/stockham.py` (complex, f32, power-of-two n up to 4096: one
transform per thread block) and the real FFT of `ops/rfft.py` on it (n up
to 8192, its core being n/2 points). Sizes and dtypes it does not cover
raise: the planner never hands a call to `torch.fft`, which would hide the
kernels. Its TPU decision tables (crossovers, overrides, the per-size
fused/hybrid sets `config.RFFT_FUSED_*`) were measured on a TPU and do not
carry over.
"""

from __future__ import annotations

from .plan import is_power_of_two

__all__ = ["STOCKHAM_MAX_N", "RFFT_MAX_N", "c2c_kernel", "r2c_kernel"]

STOCKHAM_MAX_N = 4096
RFFT_MAX_N = 2 * STOCKHAM_MAX_N


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


def r2c_kernel(n: int, dtype: str, direction: str = "forward") -> str:
    """'rfft-fused' (the one-pass r2c / c2r kernel of ops/csrc/rfft.cu) for
    float32 and power-of-two 4 <= n <= RFFT_MAX_N, in both directions. The
    rule: one read and one write of device memory beat the hybrid's extra
    write and read of the core planes Z, so the fused kernel takes every
    size; chip_smoke.py times both on the card to check it."""
    if direction not in ("forward", "inverse"):
        raise ValueError(f"direction must be 'forward' or 'inverse', got {direction!r}")
    if not is_power_of_two(n) or n < 4:
        raise ValueError(f"size must be a power of two >= 4, got {n!r}")
    if dtype != "float32":
        raise NotImplementedError(
            f"dtype {dtype}: the port runs float32 only; the f64 tier is "
            f"ROADMAP item A10")
    if n > RFFT_MAX_N:
        raise NotImplementedError(
            f"n={n}: the port's real FFT covers n <= {RFFT_MAX_N}; large N is "
            f"ROADMAP item A7")
    return "rfft-fused"
