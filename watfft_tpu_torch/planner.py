"""Kernel dispatch for the port.

Counterpart of `watfft_tpu/planner.py`. The port has the Stockham engine
of `ops/stockham.py` (complex, power-of-two n up to 4096: one transform
per thread block), the real FFT of `ops/rfft.py` on it (n up to 8192, its
core being n/2 points), the four-step large-N kernels of `ops/large.py`
(n = 8192 .. 2^24, both factors run by the engine), the matmul surface of
`ops/fourstep.py` past them, and the Bluestein transform of
`ops/bluestein.py` for any other n, on these. Sizes and dtypes it does not
cover raise: the planner never hands a call to `torch.fft`, which would
hide the kernels.

The f64 rule: float64 runs the FP64 instances of the Stockham kernel
(n <= STOCKHAM_MAX_N) and of the fused real kernels (n <= RFFT_MAX_N), the
port of the JAX f64 tier (`doublefloat.py`'s `_df_kernel`), and the matmul
surface in float64 past them, where the JAX planner sends every f64 call
(`watfft_tpu/planner.py:30-34`). The large-N, Bluestein and 2D kernels are
float32 only, as the JAX package's are. Its TPU decision tables (crossovers, overrides, the
per-size fused/hybrid sets `config.RFFT_FUSED_*`, the VMEM-derived
`CUBE_MAX_N` and `LARGE_NB_MAX_N`) were measured on a TPU and do not carry
over; the limits here come from the H100's thread blocks and shared memory.
"""

from __future__ import annotations

from .plan import is_power_of_two

__all__ = ["STOCKHAM_MAX_N", "RFFT_MAX_N", "LARGE_MIN_N", "CUBE_MAX_N", "CUBE_NB_MAX_BATCH",
           "LARGE_MAX_N", "RFFT_LARGE_MAX_N", "c2c_kernel", "large_mode", "r2c_kernel",
           "bluestein_m", "bluestein_kernel",
           "FFT2_CUBE_MIN_BATCH", "FFT2_NATIVE_MAX_AXIS", "FFT2_NATIVE_MIN_BATCH", "fft2_kernel"]

# One transform per thread block: n/16 threads of at most 256.
STOCKHAM_MAX_N = 4096
RFFT_MAX_N = 2 * STOCKHAM_MAX_N
LARGE_MIN_N = 2 * STOCKHAM_MAX_N
# The cube kernel holds one whole transform in shared memory, n + n/16
# float2: 136 KB at 2^14 and 272 KB at 2^15, against 227 KB a block can use.
CUBE_MAX_N = 1 << 14
# The cube beat the two-pass pipeline at every batch on complex64 and
# batch-major planes, and on time-major planes [n, b] (where a cube block
# reads its sequence b floats apart) up to CUBE_NB_MAX_BATCH[n] sequences.
# Measured on an H100 80GB HBM3 at a 700 W limit (chip_smoke.py's
# large_crossover phase, batches 1..1024; PERF.md): on complex64 at 2^13
# 16.8 us against 28.6 at batch 1 and 91.5 against 196.8 at 1024, at 2^14
# 25.3 against 29.0 at 1 and 203.9 against 383.4 at 1024 (the cube before
# it lost at 2^14 below a batch of 128). Time-major, the cube won at 2^13
# up to a batch of 8 (28.5 against 30.4) and lost from 16 (32.9 against
# 30.7), at 2^14 up to 2 (30.6 against 31.0; 35.5 against 30.8 at 4).
CUBE_NB_MAX_BATCH = {1 << 13: 8, 1 << 14: 2}
# Each four-step factor is one thread block of the engine: n1, n2 <= 4096.
LARGE_MAX_N = STOCKHAM_MAX_N * STOCKHAM_MAX_N
RFFT_LARGE_MAX_N = 2 * LARGE_MAX_N


def _check(n: int, dtype: str, minimum: int) -> None:
    if not is_power_of_two(n) or n < minimum:
        raise ValueError(f"size must be a power of two >= {minimum}, got {n!r}")
    if dtype not in ("float32", "float64"):
        raise NotImplementedError(
            f"dtype {dtype}: the contexts run float32 and float64; the bf16 tiers are "
            f"stockham_fft_nb / stockham_fft_bm on bfloat16 planes")


def large_mode(n: int, batch: int | None = None, time_major: bool = False) -> str:
    """The four-step mode for n = LARGE_MIN_N .. LARGE_MAX_N: "cube" for
    n <= CUBE_MAX_N at any batch, on time-major planes [n, b] only up to
    CUBE_NB_MAX_BATCH[n] sequences (or an unknown batch); else "pipe2".
    Under LARGE_MIN_N (a four-step asked for by hand) pipe2: the cube kernel
    takes n >= 8192."""
    if not LARGE_MIN_N <= n <= CUBE_MAX_N:
        return "pipe2"
    if time_major and batch is not None and batch > CUBE_NB_MAX_BATCH[n]:
        return "pipe2"
    return "cube"


def c2c_kernel(n: int, dtype: str, batch: int | None = None, time_major: bool = False) -> str:
    """For power-of-two n: 'stockham' for 2 <= n <= STOCKHAM_MAX_N (the f32
    kernel or its FP64 instance); in float32 'large-cube' or 'large-pipe2'
    (`large_mode`, by batch and layout) up to LARGE_MAX_N; 'fourstep' (the
    matmul surface, as the JAX planner routes past its kernels) beyond, and
    for float64 past STOCKHAM_MAX_N."""
    _check(n, dtype, 2)
    if n <= STOCKHAM_MAX_N:
        return "stockham"
    if dtype == "float64":
        return "fourstep"
    if n <= LARGE_MAX_N:
        return "large-" + large_mode(n, batch, time_major)
    return "fourstep"


def r2c_kernel(n: int, dtype: str, direction: str = "forward") -> str:
    """'rfft-fused' (the one-pass r2c / c2r kernel of ops/csrc/rfft.cu, f32
    or its FP64 instance) for power-of-two 4 <= n <= RFFT_MAX_N, in both
    directions: one read and one write of device memory beat the hybrid's
    extra write and read of the core planes Z (chip_smoke.py times both on
    the card). In float32 'rfft-large' (the m = n/2-point core on the
    four-step kernels, the Hermitian post/pre in torch) for RFFT_MAX_N < n
    <= RFFT_LARGE_MAX_N. 'fourstep' (the real matmul surface,
    `fourstep.rfft_planes`) past that, and for float64 past RFFT_MAX_N."""
    if direction not in ("forward", "inverse"):
        raise ValueError(f"direction must be 'forward' or 'inverse', got {direction!r}")
    _check(n, dtype, 4)
    if n <= RFFT_MAX_N:
        return "rfft-fused"
    if dtype == "float32" and n <= RFFT_LARGE_MAX_N:
        return "rfft-large"
    return "fourstep"


def bluestein_m(n: int) -> int:
    """Power-of-two circular-convolution length m >= 2n - 1."""
    m = 1
    while m < 2 * n - 1:
        m <<= 1
    return m


def bluestein_kernel(n: int, batch: int | None = None) -> str:
    """The route of the Bluestein transform of n >= 1 points (ops/bluestein.py),
    fused or not by its convolution length m = bluestein_m(n) alone:
    "bluestein-fused" (the one-pass kernel of csrc/bluestein.cu, #17 then
    #18 in one launch) for m <= STOCKHAM_MAX_N, i.e. n <= 2048; otherwise
    "bluestein-" + the m-point route of `c2c_kernel` at this batch
    ("bluestein-large-cube", "bluestein-large-pipe2", "bluestein-fourstep"),
    with the chirp multiplies as torch ops. The threshold is one thread
    block of the stage engine: the kernel holds whole m-point transforms in
    shared memory, m/16 threads a transform and at most 256 a block, as the
    c2c kernel does. It beat the pair #17 + #18 at every fused n timed on
    an H100 (chip_smoke.py's bluestein_times, PERF.md), so no n keeps the
    pair. The JAX package's threshold is its Stockham kernel's
    range on the TPU (`_fused_available`), VMEM-derived, which does not
    carry over. `batch` only names the m-point route; the choice between
    the two routes is m's alone."""
    if n < 1:
        raise ValueError(f"the FFT takes n >= 1 points, got n={n!r}")
    m = bluestein_m(n)
    if m <= STOCKHAM_MAX_N:
        return "bluestein-fused"
    return "bluestein-" + c2c_kernel(m, "float32", batch)


# The least batch at which the 2D cube beats the 2-pass route, per h*w, in
# the batch-major and complex layouts. Measured on an H100 80GB HBM3 at a
# 700 W limit (chip_smoke.py's fft2_crossover phase, complex64; PERF.md):
# at 2^12 (64x64) the cube won at every batch from 1 to 1024 (11.4 us
# against 22.8 at 1); at 2^14 (128x128, 16x1024, 1024x16, 64x256, 32x512:
# one 139 KB block of 512 threads per SM), once both routes were
# redesigned, the 2-pass route won at batch 1..64 (21.6-24.4 us against
# 24.1-30.3) and the cube from 96 up (25.4-30.4 against 35.0-38.0 at 96;
# 1024x16 alone lost by 3-4% at 160 and 192: 58.8 / 60.0 against 56.5 /
# 58.1).
FFT2_CUBE_MIN_BATCH = {1 << 14: 96}
# Native [h, w, B] planes: a cube block that holds one image (h*w >= 4096)
# reads it B floats apart, uncoalesced; measured at 2^24 points (the same
# card, chip_smoke.py's fft2_times phase; PERF.md), the cube took 818.7 us
# at 64x64 and 912.5 at 128x128 against 455.9 and 474.1 for the 2-pass
# route, whose passes coalesce along B. Past 1024 points on an axis the
# 2-pass route's own passes slow down (one or two transforms per block:
# 1027.3 us against the cube's 833.2 at 2x4096), so it takes the native
# layout only up to there, and above a batch of 16.
FFT2_NATIVE_MAX_AXIS, FFT2_NATIVE_MIN_BATCH = 1024, 17


def fft2_kernel(h: int, w: int, batch: int | None = None, layout: str = "bm") -> str:
    """The 2D route for power-of-two h, w >= 2 (ops/fft2.py): "fft2-cube"
    (one kernel, whole images in shared memory) for h*w <= CUBE_MAX_N at a
    batch of at least FFT2_CUBE_MIN_BATCH[h*w] (or an unknown batch), except
    the native layout ("nb") with one image per cube block, a batch over 16
    and axes of at most FFT2_NATIVE_MAX_AXIS; "fft2-2pass" (the column pass,
    then the row pass) otherwise for h, w <= 4096; "fft2-axes" (an axis over
    4096 on the large route) beyond. An axis of 8192 (8192 x 2) takes the
    cube at any batch: the 2-pass route has no such axis."""
    for n in (h, w):
        if not is_power_of_two(n) or n < 2:
            raise ValueError(f"fft2 axes must be powers of two >= 2, got {h}x{w}")
    hw = h * w
    if hw <= CUBE_MAX_N:
        if max(h, w) > STOCKHAM_MAX_N or batch is None:
            return "fft2-cube"
        native_2pass = (layout == "nb" and hw >= 4096 and batch >= FFT2_NATIVE_MIN_BATCH
                        and max(h, w) <= FFT2_NATIVE_MAX_AXIS)
        if batch >= FFT2_CUBE_MIN_BATCH.get(hw, 1) and not native_2pass:
            return "fft2-cube"
        return "fft2-2pass"
    if max(h, w) <= STOCKHAM_MAX_N:
        return "fft2-2pass"
    return "fft2-axes"
