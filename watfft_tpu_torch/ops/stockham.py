"""Batched mixed-radix Stockham FFT: host tables, plain version, kernel wrapper.

Counterpart of `watfft_tpu/ops/pallas_stockham.py`. The transform is the
same: `stage_plan` splits n into radix-16 stages plus one {2,4,8}
remainder, `make_twiddle_pack` builds per-stage twiddle columns in f64 on
the host (1/n folded into the last inverse stage), and every stage is a
radix-R butterfly over R contiguous row blocks followed by the Stockham
interleave. Forward and inverse differ only by a sign flip.

Two implementations of one function:

* `run_stages` — the plain version, written in torch ops on `[n, ...]`
  planes of any float dtype and any power-of-two radix plan (including the
  JAX package's radix-32/64 plans); `plain_fft` applies it to complex
  tensors. The wrappers use it for CPU tensors.
* `csrc/stockham.cu` — the Hopper kernel, built at first use by `_build`.
  The wrappers launch it for every CUDA tensor; a kernel that fails to
  build or launch raises, there is no fallback.

Both run in float32, in float64 and in the two bf16 tiers. The float64
tier ports `watfft_tpu/ops/doublefloat.py` (`_df_kernel`, `df_fft_nb`): the JAX
package computes it on hi/lo f32 pairs because the TPU has no f64 units;
here the tables are f64 (`make_twiddle_pack(..., dtype=np.float64)`) and
the kernel's FP64 instance runs the same plan on double2. Tables and
planes must share their dtype: f32 tables on f64 planes would give f32
accuracy under an f64 promise, so a mismatch raises.

bfloat16 planes take #1's bf16 tiers (`pallas_stockham.py:260-289`), on
the rule of the JAX package, since another tier is another result: the
compute tier (bf16 stages, a bf16 twiddle pack cast from the f32 one) for
2-D time-major `[n, b]` planes when `config.BF16_COMPUTE` is set
(`pallas_stockham.py:576`), the interop tier (f32 stages and tables
between bf16 loads and stores) for every other layout: the folded
`[n, 8, W]` view, batch-major planes, and `[n, b]` without the switch.
Given tables choose the tier: f32 tables interop, bf16 tables compute.
The outputs are bf16. Each tier has its own instance of the kernel, which
moves 8 bytes a point; the plain versions are `run_stages` in f32 between
a widening and a rounding (interop) and `run_stages` on bf16 tensors, the
codelet constants rounded to bf16 as JAX rounds its weak-typed scalars
(compute).

The wrappers (`stockham_fft_nb` time-major planes, `stockham_fft_bm`
batch-major planes, `stockham_fft` complex tensors) are differentiable: the
gradient of the DFT is the conjugate transform, VJP(fft) = n * ifft and
VJP(ifft) = fft / n, run through the same wrapper
(pallas_stockham.py:590-600). The backward uses the port's own tables for
the conjugate direction, of the forward tables' dtype: bf16 planes get
their gradient in the tier of their output.

The kernel takes separate re and im pointers with an element stride along
n and one along the batch, so one launch serves interleaved complex64
(stride 2, im at base + 4 bytes), split planes, batch-major `[B, n]` and
time-major `[n, B]` — the `[n, 8, W]` view of `_kernel_dma3d` included.

Where the rows lie further apart than the transforms (time-major planes,
and the four-step and 2D passes down columns, `ops/large.py`), a block of
the engine's T = 256 * P / n transforms reads only T adjacent columns of
each row: at n >= 1024 (T <= 4) a fraction of each 32-byte sector. There
(and at every n >= 16, where it measured faster too) the wrappers ask the
kernels for a column tile of C > T adjacent transforms in a block of 256
or 512 threads, as `tile_shape` gives it; `config.COLUMN_TILE` sets the
tile by hand. The transforms' arithmetic is the same at every tile.

Where both sides walk along their rows (batch-major planes, interleaved
complex, the real core's views, the 2D row pass) and no tile is taken, the
f32 and float64 launches take the redesigned batch-major walk of
`stockham_c2c_resident_kernel`: tiles copied in by cp.async, one copy and
one store a point where re and im are adjacent, resident blocks or a
block a tile by the rule `c2c_launch` states. The host decides the walk
and passes it; the arithmetic, and so every output, is the engine's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import profiler

from .. import config, trace

__all__ = ["stage_plan", "make_twiddle_pack", "run_stages", "plain_fft",
           "Tables", "make_tables", "device_tables", "fft_views", "stockham_fft_nb",
           "plain_fft_nb", "plain_fft_bm",
           "stockham_fft_bm", "stockham_fft", "stockham_fft_nb_postmul", "plain_postmul",
           "engine_transforms", "tile_shape", "check_tile", "column_tile", "c2c_walk",
           "c2c_launch", "complex_pairs",
           "launches", "launches_f64", "launches_bf16", "launches_bf16c"]

# Kernel launches made by the CUDA wrapper since the counts were last reset:
# the float32 kernel, its FP64 instance and its bf16 interop and compute
# instances.
launches = 0
launches_f64 = 0
launches_bf16 = 0
launches_bf16c = 0

_REAL = {torch.float32: torch.float32, torch.float64: torch.float64,
         torch.complex64: torch.float32, torch.complex128: torch.float64}

# Largest radix of the default plan; the kernel takes 2, 4, 8 and 16.
MAX_RADIX = 16


def stage_plan(n: int) -> list[tuple[int, int]]:
    """Stage sequence as (R, l) pairs: radix-16 stages plus one {2,4,8}
    remainder — radix-8 leads, radix-2/4 sit at position 1. This is the JAX
    package's default rule (pallas_stockham.py:87-105) without its measured
    TPU overrides."""
    m = n.bit_length() - 1
    radices = []
    while m >= 4:
        radices.append(MAX_RADIX)
        m -= 4
    if m:
        rem = 1 << m
        if not radices:
            radices.append(rem)          # tiny n: single stage
        elif rem == 8:
            radices.insert(0, rem)
        else:
            radices.insert(1, rem)
    stages = []
    l = 1
    for r in radices:
        stages.append((r, l))
        l *= r
    return stages


def make_twiddle_pack(n: int, inverse: bool, dtype=np.float32, stages=None
                      ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Pack per-stage twiddle columns w_{R*l}^{p*(row mod l)}, p=1..R-1, into
    [total, 1] planes of `dtype` (f64 host math, phases reduced mod R*l).
    offsets[i] = row offset of stage i's block ((R-1)*(n/R) rows); -1 for
    the twiddle-free l==1 stage. The final stage carries the folded 1/n for
    the inverse. Same numpy code as pallas_stockham.py:114-142 (and, in
    float64, as doublefloat.py:_df_twiddle_pack before its hi/lo split).
    `stages`: the (R, l) plan, `stage_plan(n)` by default."""
    sign = +1.0 if inverse else -1.0
    res, ims, offsets = [], [], []
    off = 0
    stages = stage_plan(n) if stages is None else stages
    for idx, (r, l) in enumerate(stages):
        if l == 1:
            offsets.append(-1)
            continue
        rows = n // r
        k = np.arange(rows, dtype=np.int64) % l
        scale = (1.0 / n) if (inverse and idx == len(stages) - 1) else 1.0
        for p in range(1, r):
            ang = sign * 2.0 * np.pi * ((p * k) % (r * l)) / (r * l)
            res.append((scale * np.cos(ang)).astype(dtype))
            ims.append((scale * np.sin(ang)).astype(dtype))
        offsets.append(off)
        off += (r - 1) * rows
    if not res:  # single twiddle-free stage; keep a dummy row
        res, ims = [np.ones(1, dtype)], [np.zeros(1, dtype)]
    re = np.concatenate(res).reshape(-1, 1)
    im = np.concatenate(ims).reshape(-1, 1)
    return re, im, offsets


# -- plain version -------------------------------------------------------------

def _small_dft(res, ims, inverse: bool):
    """R-point DFT across R part-tensors via a recursive radix-2 network with
    scalar constant twiddles. X_q = sum_p part_p * w_R^{p*q},
    w_R = exp(-+2i pi / R). Python-float constants follow the tensor dtype;
    on bf16 tensors they are rounded to bf16 first, as JAX rounds its
    weak-typed scalars (torch would multiply by the unrounded value)."""
    r = len(res)
    if r == 1:
        return res, ims
    bf16 = res[0].dtype == torch.bfloat16
    ere, eim = _small_dft(res[0::2], ims[0::2], inverse)
    ore, oim = _small_dft(res[1::2], ims[1::2], inverse)
    half = r // 2
    sign = +1.0 if inverse else -1.0
    out_re = [None] * r
    out_im = [None] * r
    for q in range(half):
        ang = sign * 2.0 * math.pi * q / r
        wr, wi = math.cos(ang), math.sin(ang)
        if bf16:
            wr, wi = (torch.tensor(w, dtype=torch.bfloat16) for w in (wr, wi))
        orq, oiq = ore[q], oim[q]
        if q == 0:  # w = 1
            tre, tim = orq, oiq
        elif 4 * q == r:  # w = -+i: (re,im) -> (+-im, -+re)
            if inverse:
                tre, tim = -oiq, orq
            else:
                tre, tim = oiq, -orq
        else:
            tre = orq * wr - oiq * wi
            tim = orq * wi + oiq * wr
        out_re[q] = ere[q] + tre
        out_im[q] = eim[q] + tim
        out_re[q + half] = ere[q] - tre
        out_im[q + half] = eim[q] - tim
    return out_re, out_im


def _stage(cre, cim, n, r, l, tw, inverse, scale0):
    """One Stockham stage on [n, ...] planes: twiddle, R-point DFT across
    the R row blocks, then interleave rows j*R*l + q*l + k."""
    q = n // r
    rest = tuple(cre.shape[1:])
    bs_re = [cre[p * q:(p + 1) * q] for p in range(r)]
    bs_im = [cim[p * q:(p + 1) * q] for p in range(r)]
    if tw is not None:
        twre, twim = tw
        col = (q,) + (1,) * len(rest)
        for p in range(1, r):
            wr = twre[(p - 1) * q:p * q].reshape(col)
            wi = twim[(p - 1) * q:p * q].reshape(col)
            br, bi = bs_re[p], bs_im[p]
            bs_re[p] = br * wr - bi * wi
            bs_im[p] = br * wi + bi * wr
    if scale0 is not None:  # inverse final stage: fold 1/n into the p=0 term
        bs_re[0] = bs_re[0] * scale0
        bs_im[0] = bs_im[0] * scale0
        if tw is None:  # twiddle-free final stage: scale every term
            for p in range(1, r):
                bs_re[p] = bs_re[p] * scale0
                bs_im[p] = bs_im[p] * scale0
    xs_re, xs_im = _small_dft(bs_re, bs_im, inverse)
    g = n // (r * l)
    return _interleave(xs_re, g, l, rest), _interleave(xs_im, g, l, rest)


def _interleave(parts, g, l, rest):
    """Stockham output permute: R parts of [g*l, ...] -> [n, ...] with rows
    j*R*l + q*l + k."""
    n = len(parts) * g * l
    return torch.stack([p.reshape(g, l, *rest) for p in parts], dim=1).reshape(n, *rest)


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The precision of data of `dtype`: float32 for float32 and complex64,
    float64 for float64 and complex128; any other dtype raises."""
    if dtype not in _REAL:
        raise TypeError(f"the FFT takes float32/float64 planes or complex64/complex128 "
                        f"tensors, got {dtype}")
    return _REAL[dtype]


def check_dtype(tables_dtype: torch.dtype, data_dtype: torch.dtype) -> None:
    """Raise unless tables of `tables_dtype` serve data of `data_dtype`
    (real planes, or the complex dtype of the same precision; bf16 planes
    take f32 tables, the interop tier, or bf16 ones, the compute tier)."""
    if data_dtype == torch.bfloat16:
        if tables_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"tables are {tables_dtype}: bf16 planes take float32 tables "
                            f"(the interop tier) or bfloat16 ones (the compute tier)")
        return
    if real_dtype(data_dtype) != tables_dtype:
        raise TypeError(f"tables are {tables_dtype}, data {data_dtype}: the tables and "
                        f"the data must share their precision (f32 tables would give f64 "
                        f"data f32 accuracy)")


def run_stages(cre, cim, n, inverse, offsets, stages, twre, twim):
    """Run the full Stockham stage chain on [n, ...] planes (the transform
    runs along axis 0; any strides). twre/twim: the packed twiddle columns
    (any shape with `total` elements) of the planes' dtype."""
    if twre.dtype != cre.dtype:
        raise TypeError(f"tables are {twre.dtype}, planes {cre.dtype}: the stages run in "
                        f"one dtype, so the tables and the planes must share their precision")
    twre = twre.reshape(-1)
    twim = twim.reshape(-1)
    for idx, (r, l) in enumerate(stages):
        is_final = idx == len(stages) - 1
        tw = None
        if offsets[idx] >= 0:
            o = offsets[idx]
            rows = (r - 1) * (n // r)
            tw = (twre[o:o + rows], twim[o:o + rows])
        scale0 = 1.0 / n if (inverse and is_final) else None
        cre, cim = _stage(cre, cim, n, r, l, tw, inverse, scale0)
    return cre, cim


# -- the column tile -------------------------------------------------------------
# What csrc/stockham.cuh calls T, C and the tile's shared memory, on the host.

BLOCK_THREADS = 256          # the engine's threads a block (kBlockThreads)
SECTOR_BYTES = 32            # the unit device memory is read and written in
# Shared memory a block may opt in to on the H100 (227 KB; the hopper-kernels
# table). The kernels ask the card itself and refuse past its own limit.
SMEM_OPTIN_BYTES = 232_448
# SMs of the card (H100 and H200: 132). A tile's block runs its groups in
# turn, so where few columns give fewer blocks than SMs a wider tile only
# lengthens each block's pass: C stays at most 2 * batch / SMS, a block for
# every two SMs (6 columns of 4096 points took 24.4 us at C = 4 against
# 17.5 at T = 1; 300 columns 35.5 at C = 4 against 69.7; PERF.md).
SMS = 132


def engine_transforms(n: int, radix: int = MAX_RADIX) -> int:
    """T, the transforms a block of the engine holds: 256 threads of
    n / radix threads each (csrc/stockham.cuh `make_plan`)."""
    return max(1, BLOCK_THREADS * radix // n)


def smem_stride(n: int) -> int:
    """Complex slots a transform takes in shared memory (`smem_stride`)."""
    return (n + (n >> 4)) | 1


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1) if x >= 1 else 0


@functools.cache
def tile_shape(n: int, run_bytes: int | None, point_bytes: int, inner: int | None = None,
               radix: int = MAX_RADIX, batch: int | None = None) -> tuple[int, int]:
    """(C, threads): the transforms (columns) a block of the c2c or strided
    c2c kernel stages on a walk down columns, and the block's threads. The
    rule the H100 measured fastest at every n = 16..4096 in the four tiers
    (PERF.md): the widest C whose tile leaves room for three blocks an SM
    (C * smem_stride(n) * point_bytes <= SMEM_OPTIN_BYTES / 3), in 256
    threads, where that is more than T and its rows fill a 32-byte sector;
    else the widest the opt-in shared memory holds, one block an SM, in
    512 threads. At most `inner` for a batch over two axes (the columns of
    the inner axis; a tile past it is right but not contiguous) and
    2 * batch / SMS. (T, 256), no tile, where there is no column walk
    (`run_bytes` None: batch-major on both sides) and on plans whose
    largest radix is not 16.

    run_bytes: bytes from one column to the next in device memory (the
    batch stride times the element size: 4 on f32 planes, 2 on bf16, 8 on
    f64 planes and interleaved complex64, 16 on complex128); point_bytes:
    a point in shared memory (8 for f32 stages, 16 for f64, 4 for bf16)."""
    T = engine_transforms(n, radix)
    if run_bytes is None or radix != MAX_RADIX:
        return T, BLOCK_THREADS
    column = smem_stride(n) * point_bytes
    c, threads = min(_pow2_floor(SMEM_OPTIN_BYTES // 3 // column), BLOCK_THREADS), BLOCK_THREADS
    if c <= T or c * run_bytes < SECTOR_BYTES:
        c, threads = min(_pow2_floor(SMEM_OPTIN_BYTES // column), 2 * BLOCK_THREADS), 512
    if inner is not None:
        c = min(c, _pow2_floor(inner))
    if batch is not None:
        c = min(c, _pow2_floor(2 * batch // SMS))
    if c <= T:
        return T, BLOCK_THREADS
    return c, threads if c >= threads * radix // n else BLOCK_THREADS


def check_tile(cols: int, n: int, point_bytes: int, radix: int = MAX_RADIX,
               threads: int = 256) -> None:
    """Raise ValueError for a tile the kernels refuse (kErrTile): C not a
    power of two, below T, over the opt-in shared memory, or above T on a
    plan whose largest radix is not 16; a block of other than 256 or 512
    threads, of more transforms (threads * 16 / n) than C, or of fewer
    threads than C."""
    T = engine_transforms(n, radix)
    if cols == T:
        return
    if threads not in (256, 512) or not threads * radix // n <= cols <= threads:
        raise ValueError(f"column tile C={cols} at n={n}: a block of {threads} threads "
                         f"must be 256 or 512, hold at most C transforms and at least C "
                         f"threads")
    if cols < T or cols & (cols - 1):
        raise ValueError(f"column tile C={cols} at n={n}: C must be a power of two and at "
                         f"least the engine's T={T} transforms a block")
    if radix != MAX_RADIX:
        raise ValueError(f"column tile C={cols} at n={n}: above T={T} the kernels take plans "
                         f"whose largest radix is {MAX_RADIX}, got {radix}")
    need = cols * smem_stride(n) * point_bytes
    if need > SMEM_OPTIN_BYTES:
        raise ValueError(f"column tile C={cols} at n={n}: {need} bytes of shared memory, over "
                         f"the {SMEM_OPTIN_BYTES} a block may take")


def column_tile(n: int, walks, elem_bytes: int, point_bytes: int, radix: int, batch: int,
                inner: int | None = None) -> tuple[int, int]:
    """The `cols, threads` arguments of a launch ((0, 0): the engine's T).
    walks: the (row stride, batch stride) of the load and of the store, in
    elements; a side walks down columns where its row stride is the
    larger, and its run is its batch stride times `elem_bytes`; the
    narrower run sets C (interleaved complex64 in, f32 planes out: 4
    bytes). The wrappers call it on every device, so a tile the kernels
    refuse raises on the CPU too. `config.COLUMN_TILE`, where set, takes
    the helper's place (0: no tile; C or (C, threads): every column walk
    at that tile)."""
    runs = [sb * elem_bytes for sn, sb in walks if sn > sb]
    run = min(runs) if runs else None
    forced = config.COLUMN_TILE
    if forced == 0 or (forced is not None and run is None):
        return 0, 0
    if forced is None:
        cols, threads = tile_shape(n, run, point_bytes, inner, radix, batch)
    else:
        cols, threads = forced if isinstance(forced, tuple) else (forced, 256)
        check_tile(cols, n, point_bytes, radix, threads)
    return (0, 0) if cols == engine_transforms(n, radix) else (cols, threads)


# -- device tables -------------------------------------------------------------

@dataclass(eq=False)
class Tables:
    """One transform length and direction on one device: the stage plan as
    (R, l) pairs, each stage's offset into the twiddle pack (-1 for the
    twiddle-free l=1 stage) and the pack itself as 1-D tensors of one dtype
    (float32, float64 for the f64 tier, bfloat16 for the bf16 compute
    tier), the dtype the stages run in. The plan's ctypes arrays for the
    kernel are built once, here."""
    stages: tuple[tuple[int, int], ...]
    offsets: tuple[int, ...]
    twre: torch.Tensor
    twim: torch.Tensor
    n: int = field(init=False)

    def __post_init__(self):
        self.n = math.prod(r for r, _ in self.stages)
        if self.twre.dtype not in (torch.float32, torch.float64, torch.bfloat16) or (
                self.twim.dtype != self.twre.dtype):
            raise TypeError(f"twiddle packs are float32, float64 or bfloat16 pairs, got "
                            f"{self.twre.dtype} and {self.twim.dtype}")
        nst = len(self.stages)
        self.c_radices = (ctypes.c_int * nst)(*(r for r, _ in self.stages))
        self.c_offsets = (ctypes.c_int * nst)(*self.offsets)
        self.radix = max((r for r, _ in self.stages), default=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.twre.dtype


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the Stockham FFT runs on CPU or CUDA tensors, got device {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} asked for, but CUDA is not available "
                f"(torch.cuda.is_available() is false); pass device='cpu' to "
                f"run the kernels' plain torch versions")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_tables(stages, offsets, twre, twim, device, dtype=torch.float32) -> Tables:
    """Tables of `dtype` on `device` from a host plan and twiddle pack
    (numpy)."""
    device = check_device(device)
    stages = tuple((int(r), int(l)) for r, l in stages)
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) != len(stages):
        raise ValueError(f"{len(stages)} stages but {len(offsets)} offsets")

    def put(a):
        return trace.h2d(np.asarray(a, np.float64).reshape(-1), device, dtype)
    return Tables(stages, offsets, put(twre), put(twim))


def np_dtype(dtype: torch.dtype):
    """The numpy dtype of a real torch dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


@functools.cache
def _cached_tables(n: int, inverse: bool, device: torch.device, dtype: torch.dtype) -> Tables:
    trace.counts["tables_built"] += 1
    # the bf16 pack is the f32 one rounded, as pallas_stockham.py:409-411 casts it
    pack = np.float32 if dtype == torch.bfloat16 else np_dtype(dtype)
    re, im, offsets = make_twiddle_pack(n, inverse, pack)
    return make_tables(stage_plan(n), offsets, re, im, device, dtype)


def device_tables(n: int, inverse: bool, device, dtype=torch.float32) -> Tables:
    """The port's own tables for (n, direction) in `dtype` (float32,
    float64 or bfloat16), built once per device."""
    return _cached_tables(int(n), bool(inverse), check_device(device), dtype)


# -- dispatch ------------------------------------------------------------------
# CPU tensors take the plain version on [n, B] views; CUDA tensors launch the
# kernel on raw addresses and strides, which costs the host no view objects
# (four strided views per call took the H100 host's time per call from
# ~27 us to ~99 us at 8 x 1024, where the kernel runs 14 us). `fft_views`
# serves callers that hold views already: the hybrid real FFT's core.

def _plain_into(xre, xim, yre, yim, inverse: bool, tables: Tables) -> None:
    """y = DFT along axis 0 of the [n, B] views x, written into the views y
    (bf16 planes with f32 tables: f32 stages, rounded to nearest on the
    copy into y)."""
    if xre.dtype != tables.dtype:
        xre, xim = xre.float(), xim.float()
    ore, oim = run_stages(xre, xim, xre.shape[0], inverse, tables.offsets,
                          tables.stages, tables.twre, tables.twim)
    yre.copy_(ore)
    yim.copy_(oim)


_ITEMSIZE = {torch.float32: 4, torch.float64: 8, torch.bfloat16: 2}

# The kernel instance for (data dtype, tables dtype) and its counter.
_ENTRIES = {(torch.float32, torch.float32): ("watfft_stockham_c2c", "launches"),
            (torch.float64, torch.float64): ("watfft_stockham_c2c_f64", "launches_f64"),
            (torch.bfloat16, torch.float32): ("watfft_stockham_c2c_bf16", "launches_bf16"),
            (torch.bfloat16, torch.bfloat16): ("watfft_stockham_c2c_bf16c", "launches_bf16c")}
# The launch span of each counter, named as `registry.launch_counts()` names it.
_SPANS = {"launches": "launch.stockham_c2c", "launches_f64": "launch.stockham_c2c_f64",
          "launches_bf16": "launch.stockham_c2c_bf16",
          "launches_bf16c": "launch.stockham_c2c_bf16c"}


def _cols(dtype, x_sn, x_sb, y_sn, y_sb, n, batch, tables) -> tuple[int, int]:
    """The column tile of a launch on planes of `dtype` (`column_tile`)."""
    return column_tile(n, ((x_sn, x_sb), (y_sn, y_sb)), _ITEMSIZE[dtype],
                       2 * _ITEMSIZE[tables.dtype], tables.radix, batch)


# -- the batch-major walk ----------------------------------------------------------
# The walks of the c2c and r2c kernels (csrc/stockham.cuh kWalk*): the
# engine's (a block a tile; the kernels before the redesign), resident
# blocks with two buffers, or a block a tile copied in by cp.async.
WALK_ENGINE, WALK_RESIDENT, WALK_BLOCK = 1, 2, 3
# The n up to which the f32 c2c takes a block a tile rather than resident
# blocks: one or two radix-2/4 stages on 4 or 8 KB tiles, too little work a
# tile for the resident loop's syncs, where a block a tile ran 3-9% faster
# than the engine's walk and 10-15% faster than resident blocks (PERF.md).
C2C_BLOCK_MAX_N = 4


def c2c_walk(n: int, dtype: torch.dtype) -> int:
    """The redesigned walk of a batch-major c2c launch: resident blocks on
    f32 past C2C_BLOCK_MAX_N; a block a tile on f32 up to it and on FP64
    at every n, whose two buffers at P = 16 (139 KB) leave one block an SM
    (PERF.md has the times that chose the rule)."""
    return WALK_RESIDENT if dtype == torch.float32 and n > C2C_BLOCK_MAX_N else WALK_BLOCK


def complex_pairs(re: int, im: int, sn: int, sb: int, size: int = 4) -> bool:
    """Whether a complex operand of `size`-byte scalars moves one point at a
    time: im one scalar after re (addresses) in points aligned to their
    2 * size bytes (the point and batch strides, in scalars, even). The
    kernels refuse pairs asked for otherwise."""
    return im == re + size and sn % 2 == 0 and sb % 2 == 0 and re % (2 * size) == 0


def c2c_launch(n: int, dtype: torch.dtype, cols: tuple[int, int], x, y) -> tuple[int, ...]:
    """The walk arguments of a c2c launch at n points on planes of `dtype`
    that takes the column tile `cols`: none for bf16 planes (their entries
    run the engine's walk); else (walk, pairs_x, pairs_y). The engine's walk
    without pairs where the launch takes a column tile or a side walks down
    columns (row stride over batch stride); else `c2c_walk`, with one copy
    and one store a point where re and im are adjacent (`complex_pairs`).
    x, y: (re address, im address, point stride, batch stride), strides in
    elements."""
    if dtype not in (torch.float32, torch.float64):
        return ()
    if cols != (0, 0) or x[2] > x[3] or y[2] > y[3]:
        return WALK_ENGINE, 0, 0
    size = _ITEMSIZE[dtype]
    return c2c_walk(n, dtype), int(complex_pairs(*x, size)), int(complex_pairs(*y, size))


def _use_kernel(t: torch.Tensor, plain: bool = False) -> bool:
    """CUDA tensors launch the kernel; CPU tensors (or plain=True) take the
    plain version."""
    return t.device.type == "cuda" and not plain


def _launch(device, dtype, xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch,
            inverse, tables) -> None:
    """Kernel on the [n, batch] planes of `dtype` (their real dtype) whose
    element (k, b) sits k*x_sn + b*x_sb elements past the addresses xre,
    xim (input) and k*y_sn + b*y_sb elements past yre, yim (output); the
    instance of the data's dtype and the tables' (the caller has checked
    the pair), with the column tile `_cols` gives and the walk `c2c_launch`
    gives."""
    from ._build import library

    if tables.twre.device != device:
        raise ValueError(f"tables on {tables.twre.device}, data on {device}")
    cols = _cols(dtype, x_sn, x_sb, y_sn, y_sb, n, batch, tables)
    walk = c2c_launch(n, dtype, cols, (xre, xim, x_sn, x_sb), (yre, yim, y_sn, y_sb))
    lib = library()
    name, counter = _ENTRIES[(dtype, tables.dtype)]
    entry = getattr(lib, name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        span = trace.begin(_SPANS[counter]) if profiler._is_profiler_enabled else None
        err = entry(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch,
                    tables.twre.data_ptr(), tables.twim.data_ptr(), tables.c_radices,
                    tables.c_offsets, len(tables.stages), int(inverse), stream, *cols, *walk)
        if span is not None:
            trace.end(span)
    if err:
        raise RuntimeError(
            f"Stockham kernel launch failed (n={n}, batch={batch}, {dtype} data, "
            f"{tables.dtype} tables, column tile {cols}, walk {walk}): "
            f"{lib.watfft_error_string(err).decode()}")
    globals()[counter] += 1


def fft_views(xre, xim, yre, yim, inverse: bool, tables: Tables) -> None:
    """y = DFT along axis 0 of the [n, B] real views x, written into the
    [n, B] views y, all of the tables' dtype. The re and im views of a side
    share their strides (they may interleave, as x[0::2] and x[1::2] do); y
    must not overlap x. CUDA views: one kernel launch on their addresses and
    strides; CPU views: the plain version."""
    if xre.stride() != xim.stride() or yre.stride() != yim.stride():
        raise ValueError("the re and im views of a side must share their strides")
    check_dtype(tables.dtype, xre.dtype)
    n, batch = xre.shape
    if _use_kernel(xre):
        _launch(xre.device, xre.dtype, xre.data_ptr(), xim.data_ptr(), yre.data_ptr(),
                yim.data_ptr(), *xre.stride(), *yre.stride(), n, batch, inverse, tables)
    else:
        _cols(xre.dtype, *xre.stride(), *yre.stride(), n, batch, tables)
        _plain_into(xre, xim, yre, yim, inverse, tables)


def _kernel_dtype(t: torch.Tensor, want: torch.dtype) -> None:
    if t.dtype != want:
        raise TypeError(f"the CUDA kernel takes {want}, got {t.dtype}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t with its lazy conj and neg bits applied, in contiguous memory. The
    kernel reads raw storage, where `x.conj()` or `x.conj().imag` still hold
    the unconjugated values; autograd hands backward such views too."""
    return t.resolve_conj().resolve_neg().contiguous()


def _resolve(tables, n: int, inverse: bool, device, dtype: torch.dtype,
             bf16_compute: bool = False) -> Tables:
    """The tables for n points of data of `dtype` (real or complex):
    given ones checked, or the port's own of that precision (for bf16
    planes, f32 ones, or bf16 ones where `bf16_compute`)."""
    if tables is None:
        if dtype == torch.bfloat16:
            tdtype = torch.bfloat16 if bf16_compute else torch.float32
        else:
            tdtype = real_dtype(dtype)
        return device_tables(n, inverse, device, tdtype)  # checks the device
    check_device(device)
    if tables.n != n:
        raise ValueError(f"tables are for n={tables.n}, got n={n}")
    check_dtype(tables.dtype, dtype)
    return tables


def _planes_tables(re, inverse, time_major, tables) -> Tables:
    """The tables of a plane call: given ones checked, or the port's own
    in the tier the planes take (the bf16 compute tier serves 2-D
    time-major planes alone, as in JAX)."""
    n = re.shape[0] if time_major else re.shape[-1]
    compute = config.BF16_COMPUTE and time_major and re.dim() == 2
    return _resolve(tables, n, inverse, re.device, re.dtype, compute)


def _planes(re, im, inverse, time_major, tables, plain=False):
    if re.shape != im.shape or re.dtype != im.dtype or re.device != im.device:
        raise ValueError(f"re and im planes differ: {re.shape} {re.dtype} "
                         f"{re.device} vs {im.shape} {im.dtype} {im.device}")
    tables = _planes_tables(re, inverse, time_major, tables)
    n = tables.n
    if re.is_complex():
        raise TypeError(f"the plane entry points take real planes, got {re.dtype}")
    re, im = _dense(re), _dense(im)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    batch = re.numel() // n
    if batch == 0:
        return ore, oim
    sn, sb = (batch, 1) if time_major else (1, n)
    if _use_kernel(re, plain):
        _launch(re.device, re.dtype, re.data_ptr(), im.data_ptr(), ore.data_ptr(),
                oim.data_ptr(), sn, sb, sn, sb, n, batch, inverse, tables)
        return ore, oim
    _cols(re.dtype, sn, sb, sn, sb, n, batch, tables)
    if time_major:
        _plain_into(*(t.view(n, batch) for t in (re, im, ore, oim)), inverse, tables)
    else:
        _plain_into(*(t.view(batch, n).T for t in (re, im, ore, oim)), inverse, tables)
    return ore, oim


def plain_fft(x, inverse: bool = False, tables: Tables | None = None):
    """The plain version of `stockham_fft`: the same plan in torch ops, on
    any device. The wrappers use it for CPU tensors; on CUDA it is the
    reference the kernel is held against."""
    n = x.shape[-1]
    tables = _resolve(tables, n, inverse, x.device, x.dtype)
    xr = torch.view_as_real(_dense(x)).reshape(x.numel() // n, n, 2)
    ore, oim = run_stages(xr[..., 0].T, xr[..., 1].T, n, inverse, tables.offsets,
                          tables.stages, tables.twre, tables.twim)
    return torch.complex(ore, oim).T.reshape(x.shape)


def plain_fft_nb(re, im, inverse: bool = False, tables: Tables | None = None):
    """The plain version of `stockham_fft_nb` on any device (the same tier
    for bf16 planes); on CUDA the reference the kernel is held against."""
    return _planes(re, im, bool(inverse), True, tables, plain=True)


def plain_fft_bm(re, im, inverse: bool = False, tables: Tables | None = None):
    """The plain version of `stockham_fft_bm` on any device."""
    return _planes(re, im, bool(inverse), False, tables, plain=True)


def _complex(x, inverse, tables):
    n = x.shape[-1]
    tables = _resolve(tables, n, inverse, x.device, x.dtype)
    if not x.is_complex():
        raise TypeError(f"the complex entry point takes a complex tensor, got {x.dtype}")
    if not _use_kernel(x):
        return plain_fft(x, inverse, tables)
    x = _dense(x)
    out = torch.empty_like(x)
    batch = x.numel() // n
    if batch:
        # interleaved complex: re at the base, im one real on, stride 2
        xp, yp, step = x.data_ptr(), out.data_ptr(), x.element_size() // 2
        _launch(x.device, real_dtype(x.dtype), xp, xp + step, yp, yp + step, 2, 2 * n, 2,
                2 * n, n, batch, inverse, tables)
    return out


class _PlanesFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, inverse, time_major, tables):
        tables = _planes_tables(re, inverse, time_major, tables)
        # the backward runs in the forward's tier: for bf16 planes, the
        # tables' dtype (f32 interop, bf16 compute)
        ctx.inverse, ctx.time_major, ctx.tables_dtype = inverse, time_major, tables.dtype
        return _planes(re, im, inverse, time_major, tables)

    @staticmethod
    def backward(ctx, gre, gim):
        n = gre.shape[0] if ctx.time_major else gre.shape[-1]
        tables = device_tables(n, not ctx.inverse, gre.device, ctx.tables_dtype)
        ore, oim = _PlanesFFT.apply(gre, gim, not ctx.inverse, ctx.time_major, tables)
        s = 1.0 / n if ctx.inverse else float(n)
        return ore * s, oim * s, None, None, None


class _ComplexFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, inverse, tables):
        ctx.inverse = inverse
        return _complex(x, inverse, tables)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1]
        s = 1.0 / n if ctx.inverse else float(n)
        return _ComplexFFT.apply(g, not ctx.inverse, None) * s, None, None


def _wants_grad(*ts) -> bool:
    # autograd's bookkeeping added ~6 us to a ~21 us call on the H100's
    # host (PERF.md); skip it unless a gradient can flow
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def stockham_fft_nb(xre, xim, inverse: bool = False, tables: Tables | None = None):
    """Batched FFT on time-major planes [n, ...] (the transform runs along
    axis 0; `[n, b]` and the `[n, 8, W]` view alike). Returns new planes of
    the same shape and dtype: float32, float64, or bfloat16 (the bf16
    tiers; the compute tier on 2-D planes under `config.BF16_COMPUTE`).
    Any batch size; no padding."""
    if _wants_grad(xre, xim):
        return _PlanesFFT.apply(xre, xim, bool(inverse), True, tables)
    return _planes(xre, xim, bool(inverse), True, tables)


def stockham_fft_bm(xre, xim, inverse: bool = False, tables: Tables | None = None):
    """Batched FFT on batch-major planes [..., n] (bfloat16 planes: the
    interop tier)."""
    if _wants_grad(xre, xim):
        return _PlanesFFT.apply(xre, xim, bool(inverse), False, tables)
    return _planes(xre, xim, bool(inverse), False, tables)


def stockham_fft(x, inverse: bool = False, tables: Tables | None = None):
    """Batched FFT over the last axis of a complex tensor [..., n]. On CUDA
    the kernel reads and writes the interleaved complex64 (or complex128)
    storage itself: no split or assemble pass."""
    if _wants_grad(x):
        return _ComplexFFT.apply(x, bool(inverse), tables)
    return _complex(x, bool(inverse), tables)


# -- #3: the stages with a complex multiply in the store --------------------------

def _postmul(xre, xim, pmre, pmim, inverse, tables, plain):
    from .large import MUL_STORE, strided_c2c

    if not (xre.shape == xim.shape == pmre.shape == pmim.shape) or xre.dim() != 2:
        raise ValueError(f"x and pm must be [n, b] planes of one shape, got "
                         f"{tuple(xre.shape)}, {tuple(xim.shape)}, {tuple(pmre.shape)}, "
                         f"{tuple(pmim.shape)}")
    n, b = xre.shape
    tables = _resolve(tables, n, bool(inverse), xre.device, xre.dtype)
    x = (_dense(xre), _dense(xim))
    pm = (_dense(pmre), _dense(pmim))
    out = (torch.empty_like(x[0]), torch.empty_like(x[1]))
    # [n, b] time-major planes: one batch axis, the other of count 1
    strided_c2c(x, out, n, (b, b, b), [(b, 1, 1, 1), (1, 0, 0, 0)], bool(inverse), tables,
                "postmul", pm=pm, mul=MUL_STORE, plain=plain)
    return out


def stockham_fft_nb_postmul(xre, xim, pmre, pmim, inverse: bool = False,
                            tables: Tables | None = None):
    """Batched FFT on time-major planes [n, b] followed by the elementwise
    complex multiply with (pmre, pmim) [n, b], fused into the kernel's store
    (#3 `_kernel_postmul`; the CUDA kernel is csrc/large.cu's strided c2c
    kernel, counted in `large.launches["postmul"]`). Any batch."""
    return _postmul(xre, xim, pmre, pmim, inverse, tables, plain=False)


def plain_postmul(xre, xim, pmre, pmim, inverse: bool = False, tables: Tables | None = None):
    """The plain version of `stockham_fft_nb_postmul` on any device:
    `run_stages`, then the complex multiply."""
    return _postmul(xre, xim, pmre, pmim, inverse, tables, plain=True)
