"""Kernel dispatch for the port.

Counterpart of `watfft_tpu/planner.py`. The port has the Stockham engine
of `ops/stockham.py` (complex, f32, power-of-two n up to 4096: one
transform per thread block), the real FFT of `ops/rfft.py` on it (n up to
8192, its core being n/2 points), the four-step large-N kernels of
`ops/large.py` (n = 8192 .. 2^24, both factors run by the engine) and the
matmul surface of `ops/fourstep.py` past them. Sizes and dtypes it does not
cover raise: the planner never hands a call to `torch.fft`, which would
hide the kernels. Its TPU decision tables (crossovers, overrides, the
per-size fused/hybrid sets `config.RFFT_FUSED_*`, the VMEM-derived
`CUBE_MAX_N` and `LARGE_NB_MAX_N`) were measured on a TPU and do not carry
over; the limits here come from the H100's thread blocks and shared memory.
"""

from __future__ import annotations

from .plan import is_power_of_two

__all__ = ["STOCKHAM_MAX_N", "RFFT_MAX_N", "LARGE_MIN_N", "CUBE_MAX_N", "CUBE_MIN_BATCH",
           "LARGE_MAX_N", "RFFT_LARGE_MAX_N", "c2c_kernel", "large_mode", "r2c_kernel"]

# One transform per thread block: n/16 threads of at most 256.
STOCKHAM_MAX_N = 4096
RFFT_MAX_N = 2 * STOCKHAM_MAX_N
LARGE_MIN_N = 2 * STOCKHAM_MAX_N
# The cube kernel holds one whole transform in shared memory, n + n/16
# float2: 136 KB at 2^14 and 272 KB at 2^15, against 227 KB a block can use.
CUBE_MAX_N = 1 << 14
# The least batch at which the cube beats the two-pass pipeline, per n. A
# cube block holds one transform, so a small batch leaves SMs idle; measured
# on the H100 (chip_smoke.py's large_crossover phase, complex64 layout): at
# 2^13 (68 KB, 3 blocks per SM) the cube won at every batch from 16 up
# (21 us against 31 at 16); at 2^14 (136 KB, one block per SM) pipe2 won
# at 16 and 64 (30 and 40 us against 41 and 42) and the cube from 132 up.
CUBE_MIN_BATCH = {1 << 13: 1, 1 << 14: 128}
# Each four-step factor is one thread block of the engine: n1, n2 <= 4096.
LARGE_MAX_N = STOCKHAM_MAX_N * STOCKHAM_MAX_N
RFFT_LARGE_MAX_N = 2 * LARGE_MAX_N


def _check(n: int, dtype: str, minimum: int) -> None:
    if not is_power_of_two(n) or n < minimum:
        raise ValueError(f"size must be a power of two >= {minimum}, got {n!r}")
    if dtype != "float32":
        raise NotImplementedError(
            f"dtype {dtype}: the port runs float32 only; the f64 tier is "
            f"ROADMAP item A10")


def large_mode(n: int, batch: int | None = None, time_major: bool = False) -> str:
    """The four-step mode for n = LARGE_MIN_N .. LARGE_MAX_N: "cube" for
    n <= CUBE_MAX_N at a batch of at least CUBE_MIN_BATCH[n] (or an unknown
    batch), else "pipe2". Time-major planes [n, b] with b > 1 take pipe2:
    a cube block reads one sequence, b floats apart, and measured 1.9-2.1x
    slower than pipe2 there (chip_smoke.py's large_times phase, cube_nb).
    Under LARGE_MIN_N (a four-step asked for by hand) pipe2: the cube
    kernel takes n >= 8192."""
    if not LARGE_MIN_N <= n <= CUBE_MAX_N or (time_major and batch not in (None, 1)):
        return "pipe2"
    if batch is None or batch >= CUBE_MIN_BATCH.get(n, 1):
        return "cube"
    return "pipe2"


def c2c_kernel(n: int, dtype: str, batch: int | None = None, time_major: bool = False) -> str:
    """For float32 and power-of-two n: 'stockham' for 2 <= n <=
    STOCKHAM_MAX_N; 'large-cube' or 'large-pipe2' (`large_mode`, by batch
    and layout) up to LARGE_MAX_N; 'fourstep' (the matmul surface, as the
    JAX planner routes past its kernels) beyond."""
    _check(n, dtype, 2)
    if n <= STOCKHAM_MAX_N:
        return "stockham"
    if n <= LARGE_MAX_N:
        return "large-" + large_mode(n, batch, time_major)
    return "fourstep"


def r2c_kernel(n: int, dtype: str, direction: str = "forward") -> str:
    """'rfft-fused' (the one-pass r2c / c2r kernel of ops/csrc/rfft.cu) for
    float32 and power-of-two 4 <= n <= RFFT_MAX_N, in both directions: one
    read and one write of device memory beat the hybrid's extra write and
    read of the core planes Z (chip_smoke.py times both on the card).
    'rfft-large' (the m = n/2-point core on the four-step kernels, the
    Hermitian post/pre in torch) for RFFT_MAX_N < n <= RFFT_LARGE_MAX_N.
    Past that the real four-step surface is not ported: it raises."""
    if direction not in ("forward", "inverse"):
        raise ValueError(f"direction must be 'forward' or 'inverse', got {direction!r}")
    _check(n, dtype, 4)
    if n <= RFFT_MAX_N:
        return "rfft-fused"
    if n <= RFFT_LARGE_MAX_N:
        return "rfft-large"
    raise NotImplementedError(
        f"n={n}: the port's real FFT covers n <= {RFFT_LARGE_MAX_N}; the real "
        f"matmul surface past it is not ported")
