"""Large-N FFT (N = 2^13 .. 2^24) by the four-step decomposition.

Counterpart of `watfft_tpu/ops/large.py`. With N = n1 * n2 and the point
x[j1 + n1*j2]:

  1. the n2-point FFTs down the columns of the [n2, n1] view of each
     sequence, batched over (j1, sequence) -> C[k2, j1];
  2. the four-step twiddle C[k2, j1] *= T[k2, j1] = w_N^{j1*k2};
  3. the n1-point FFTs along the rows -> D[k1, k2], stored at row
     k1*n2 + k2, which is the natural order X[k1*n2 + k2].

The inverse runs the inverse kernels (1/n1 and 1/n2 folded into their last
stages) with the conjugate twiddle. Three modes compute this:

* "pipe2": stage 1 (#11 `_stage1_kernel`, steps 1) and stage 2 (#13
  `_stage2_kernel`, steps 2-3 with the twiddle in the load): two passes
  through device memory;
* "2d": the c2c stages with the twiddle in the store (#3 `_kernel_postmul`,
  steps 1-2), then the c2c kernel over j1 with transposed output strides
  (the "outer" pass, step 3): two passes;
* "cube": one block holds a whole sequence (#12 `_cube_kernel`): one pass,
  for N <= planner.CUBE_MAX_N; `cube_launch` picks its block and its
  8-byte copies and stores.

Stage 1, stage 2, the post-multiplying pass and the outer pass are one CUDA
kernel (`csrc/large.cu`, `strided_c2c_kernel`) driven through strides: a
batch over two axes and an optional complex multiply by a table with its
own strides (0 over the sequences, so the [n2, n1] twiddle is never tiled
across the batch). The cube is a kernel of its own in the same file. Each
keeps its own launch count in `launches`.

The wrappers take any strides, so one code path serves time-major planes
[N, ...] (`fft_large_nb`), batch-major planes [..., N] (`fft_large_bm`),
interleaved complex64 (`fft_large_complex`), one flat sequence
(`fft_large`) and views (`fft_large_views`, which the real path uses on the
even and odd rows of its signal). Any batch runs, with no padding. CPU
tensors run each kernel's plain torch version on the same strided views
(`stockham.run_stages` and the complex multiply), CUDA tensors launch the
kernels or raise. Every form is differentiable: the gradient of the DFT is
the conjugate transform, VJP(fft) = N * ifft and VJP(ifft) = fft / N.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd import profiler

from .. import planner, trace
from . import stockham
from .stockham import Tables, check_device, complex_pairs, run_stages

__all__ = ["large_split", "pm_grid", "LargeTables", "make_large_tables",
           "device_large_tables", "strided_c2c", "stage1", "stage2", "cube",
           "plain_stage1", "plain_stage2", "fft_large_views", "fft_large_nb",
           "fft_large_bm", "fft_large_complex", "fft_large", "plain_fft_large",
           "rfft_large", "irfft_large", "rfft_large_bm", "irfft_large_bm",
           "rfft_large_nb", "irfft_large_nb", "cube_threads", "complex_pairs", "cube_launch",
           "launches", "MODES"]

# Kernel launches made by the CUDA wrappers since the counts were last set
# to 0: stage 1 (#11), stage 2 (#13), the cube (#12), the post-multiplying
# c2c pass (#3) and the "2d" mode's outer c2c pass.
launches = {"stage1": 0, "stage2": 0, "cube": 0, "postmul": 0, "outer": 0}

MODES = ("cube", "pipe2", "2d")
MUL_NONE, MUL_LOAD, MUL_STORE = 0, 1, 2


def large_split(n: int) -> tuple[int, int]:
    """Power-of-two split (n1, n2) of n, each factor at most 4096: the
    balanced split, with n1 >= 128 and the smaller factor outer when log2 n
    is odd. The formula of watfft_tpu/ops/large.py:41-49, kept so the port
    and the JAX package split alike."""
    log = n.bit_length() - 1
    l1 = min(max(log // 2, 7, log - 12), 12)
    n1 = 1 << l1
    return n1, n // n1


def pm_grid(n: int, n1: int, n2: int, inverse: bool,
            cols: slice = slice(None)) -> tuple[np.ndarray, np.ndarray]:
    """The four-step twiddle T[k2, j1] = w_N^{j1*k2} as [n2, n1] f32 planes,
    f64 host math (the code of watfft_tpu/ops/large.py:52-66); `cols`
    keeps the columns j1 of one slice (a rank's block of the sharded
    four-step, `parallel/large_sharded.py`)."""
    sign = +1.0 if inverse else -1.0
    ang = sign * 2.0 * np.pi * np.outer(np.arange(n2), np.arange(n1)[cols]) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# -- tables --------------------------------------------------------------------

@dataclass(eq=False)
class LargeTables:
    """One four-step split and direction on one device: the twiddle T
    (`pmre`, `pmim`, flat [n2*n1] f32, T[k2, j1] at k2*n1 + j1) and the
    Stockham tables of the n2-point (`t1`) and n1-point (`t2`) passes."""
    n1: int
    n2: int
    inverse: bool
    pmre: torch.Tensor
    pmim: torch.Tensor
    t1: Tables
    t2: Tables

    def __post_init__(self):
        if self.t1.n != self.n2 or self.t2.n != self.n1:
            raise ValueError(f"stage tables for n={self.t1.n}, {self.t2.n}; the split "
                             f"{self.n1}x{self.n2} needs n2={self.n2}, n1={self.n1}")
        if self.pmre.numel() != self.n1 * self.n2 or self.pmim.numel() != self.n1 * self.n2:
            raise ValueError(f"twiddle grid of {self.pmre.numel()} values for the split "
                             f"{self.n1}x{self.n2}")

    @property
    def n(self) -> int:
        return self.n1 * self.n2


def make_large_tables(n1, n2, pmre, pmim, t1: Tables, t2: Tables, inverse: bool) -> LargeTables:
    """LargeTables from a host twiddle grid (numpy, [n2, n1]) and the two
    passes' Stockham tables, on the tables' device."""
    def put(a):
        return trace.h2d(np.asarray(a, np.float32).reshape(-1), t1.twre.device)
    return LargeTables(int(n1), int(n2), bool(inverse), put(pmre), put(pmim), t1, t2)


@functools.cache
def _cached_large(n1: int, n2: int, inverse: bool, device: torch.device) -> LargeTables:
    trace.counts["tables_built"] += 1
    return make_large_tables(n1, n2, *pm_grid(n1 * n2, n1, n2, inverse),
                             stockham.device_tables(n2, inverse, device),
                             stockham.device_tables(n1, inverse, device), inverse)


def device_large_tables(n: int, inverse: bool, device, split=None) -> LargeTables:
    """The port's own four-step tables for (n, direction, split), built
    once per device. split defaults to `large_split(n)`."""
    n1, n2 = _check_split(int(n), split)
    return _cached_large(n1, n2, bool(inverse), check_device(device))


def _check_split(n: int, split) -> tuple[int, int]:
    if n < 4 or n & (n - 1):
        raise ValueError(f"the four-step takes a power-of-two n >= 4, got n={n}")
    n1, n2 = (int(f) for f in (split if split is not None else large_split(n)))
    if n1 * n2 != n or min(n1, n2) < 2 or max(n1, n2) > planner.STOCKHAM_MAX_N:
        raise ValueError(
            f"split {n1}x{n2} of n={n}: the factors must multiply to n and lie in "
            f"2..{planner.STOCKHAM_MAX_N} (one thread block of the stage engine each)")
    return n1, n2


def _resolve(tables, n: int, inverse: bool, device, split) -> LargeTables:
    if tables is None:
        return device_large_tables(n, inverse, device, split)
    check_device(device)
    if tables.n != n or tables.inverse != inverse:
        raise ValueError(f"tables are for n={tables.n} "
                         f"{'inverse' if tables.inverse else 'forward'}, got n={n} "
                         f"{'inverse' if inverse else 'forward'}")
    if split is not None and tuple(split) != (tables.n1, tables.n2):
        raise ValueError(f"tables are for the split {tables.n1}x{tables.n2}, got {split}")
    return tables


# -- the strided c2c kernel and its plain version --------------------------------
# An operand is a pair of float tensors (re, im) whose first elements mark
# where the operand starts in their storage, plus strides in floats. CUDA:
# their addresses go to the kernel; CPU (or plain=True): views of their
# storage go to the plain version.

def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return t.device.type == "cuda" and not plain


def _as(t: torch.Tensor, size, stride) -> torch.Tensor:
    return t.as_strided(size, stride, t.storage_offset())


def _cmul(are, aim, bre, bim):
    return are * bre - aim * bim, are * bim + aim * bre


def strided_c2c(x, y, n: int, sn, axes, inverse: bool, tables: Tables, key: str,
                pm=None, mul: int = MUL_NONE, plain: bool = False, counts=None) -> None:
    """y = DFT_n(x) (times pm in the store for mul=MUL_STORE; of x times pm
    for mul=MUL_LOAD) over a batch of two axes. sn: the element strides
    (x, y, pm); axes: two (count, x stride, y stride, pm stride) tuples.
    The axis whose x or y stride is smallest becomes the kernel's inner
    batch axis, so its tiles coalesce. A launch adds one to counts[key]
    (default: this module's `launches`)."""
    (na, xa, ya, ma), (nb, xb, yb, mb) = sorted(
        axes, key=lambda a: (a[0] == 1, min(abs(a[1]), abs(a[2]))))
    if na * nb == 0:
        return
    x_sn, y_sn, m_sn = sn
    # the kernel's walks: the row stride against the inner axis's. A column
    # tile stays within the inner axis unless the outer one continues it in
    # x and y (one run of na * nb columns). On every device, so a tile the
    # kernel would refuse raises on the CPU too.
    runs_on = nb == 1 or (xb == na * xa and yb == na * ya)
    cols = stockham.column_tile(n, ((x_sn, xa), (y_sn, ya)), 4, 8, tables.radix, na * nb,
                                None if runs_on else na)
    if _use_kernel(x[0], plain):
        _launch(x, y, n, (x_sn, xa, xb), (y_sn, ya, yb), pm, (m_sn, ma, mb), mul,
                na, na * nb, inverse, tables, key, launches if counts is None else counts, cols)
        return
    size = (n, na, nb)
    xre, xim = (_as(t, size, (x_sn, xa, xb)) for t in x)
    if mul == MUL_LOAD:
        xre, xim = _cmul(xre, xim, *(_as(t, size, (m_sn, ma, mb)) for t in pm))
    ore, oim = run_stages(xre, xim, n, inverse, tables.offsets, tables.stages,
                          tables.twre, tables.twim)
    if mul == MUL_STORE:
        ore, oim = _cmul(ore, oim, *(_as(t, size, (m_sn, ma, mb)) for t in pm))
    _as(y[0], size, (y_sn, ya, yb)).copy_(ore)
    _as(y[1], size, (y_sn, ya, yb)).copy_(oim)


def _library(x: torch.Tensor, tables_dev: torch.device):
    from ._build import library

    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes torch.float32, got {x.dtype}")
    if tables_dev != x.device:
        raise ValueError(f"tables on {tables_dev}, data on {x.device}")
    return library()


def _check(lib, err: int, key: str, n: int, batch: int, counts=launches) -> None:
    if err:
        raise RuntimeError(f"{key} kernel launch failed (n={n}, batch={batch}): "
                           f"{lib.watfft_error_string(err).decode()}")
    counts[key] += 1


def _launch(x, y, n, xs, ys, pm, ms, mul, inner, batch, inverse, tables, key, counts,
            cols) -> None:
    lib = _library(x[0], tables.twre.device)
    pmp = (pm[0].data_ptr(), pm[1].data_ptr()) if mul else (None, None)
    with torch.cuda.device(x[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        span = trace.begin(_span(key, counts)) if profiler._is_profiler_enabled else None
        err = lib.watfft_strided_c2c(
            x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(), *xs, *ys,
            *pmp, *ms, mul, n, inner, batch, tables.twre.data_ptr(), tables.twim.data_ptr(),
            tables.c_radices, tables.c_offsets, len(tables.stages), int(inverse), stream, *cols)
        if span is not None:
            trace.end(span)
    _check(lib, err, key, n, batch, counts)


def _span(key: str, counts: dict) -> str:
    """The launch span of the counter counts[key], named as
    `registry.launch_counts()` names it (this module's with `large_`)."""
    return ("launch.large_" if counts is launches else "launch.") + key


def _launch_cube(x, y, xs, ys, batch, lt: LargeTables) -> None:
    lib = _library(x[0], lt.pmre.device)
    t1, t2 = lt.t1, lt.t2
    ptrs = [t.data_ptr() for t in (*x, *y)]
    launch = cube_launch(lt.n, (*ptrs[:2], *xs), (*ptrs[2:], *ys))
    with torch.cuda.device(x[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        span = trace.begin("launch.large_cube") if profiler._is_profiler_enabled else None
        err = lib.watfft_large_cube(
            *ptrs, *xs, *ys,
            lt.n1, lt.n2, batch, lt.pmre.data_ptr(), lt.pmim.data_ptr(),
            t1.twre.data_ptr(), t1.twim.data_ptr(), t1.c_radices, t1.c_offsets, len(t1.stages),
            t2.twre.data_ptr(), t2.twim.data_ptr(), t2.c_radices, t2.c_offsets, len(t2.stages),
            int(lt.inverse), stream, *launch)
        if span is not None:
            trace.end(span)
    _check(lib, err, "cube", lt.n, batch)


# -- the cube's launch ---------------------------------------------------------------

# Shared memory of one SM of the H100 (228 KB); each block also takes 1 KB
# of it for itself.
SMEM_SM_BYTES = 233_472
SMEM_BLOCK_RESERVED = 1024


def cube_threads(n: int) -> int:
    """The cube's block at n points: 256 threads where two blocks'
    sequences (n + n/16 complex64 slots each) fit an SM's shared memory
    (n = 8192), else 512 (16384). The kernel's register bound gives 128 a
    thread either way. On the H100 two blocks of 256 at n = 8192 ran faster
    than one of 512, with or without a second buffer for the next sequence
    (PERF.md)."""
    two = 2 * ((n + n // 16) * 8 + SMEM_BLOCK_RESERVED) <= SMEM_SM_BYTES
    return 256 if two else 512


def cube_launch(n: int, x, y) -> tuple[int, int, int]:
    """The last arguments of a cube launch at n points: its threads
    (`cube_threads`) and whether it copies the input and stores the output
    8 bytes a point (`complex_pairs`). x, y: (re address, im address, point
    stride, batch stride), strides in floats."""
    return cube_threads(n), int(complex_pairs(*x)), int(complex_pairs(*y))


# -- the modes on [N, B] operands ------------------------------------------------

def _pass1(x, xs, c, cs, batch, lt: LargeTables, plain: bool, postmul: bool) -> None:
    """x -> C[k2, j1]: the n2-point FFTs over j2, batched over (j1, s);
    with the twiddle in the store when postmul (#3), without it (#11)."""
    n1, n2 = lt.n1, lt.n2
    (sn, sb), (csn, csb) = xs, cs
    strided_c2c(x, c, n2, (n1 * sn, n1 * csn, n1), [(n1, sn, csn, 1), (batch, sb, csb, 0)],
                lt.inverse, lt.t1, "postmul" if postmul else "stage1",
                pm=(lt.pmre, lt.pmim), mul=MUL_STORE if postmul else MUL_NONE, plain=plain)


def _pass2(c, cs, y, ys, batch, lt: LargeTables, plain: bool, premul: bool) -> None:
    """C[k2, j1] -> D[k1, k2] at row k1*n2 + k2: the n1-point FFTs over j1,
    batched over (k2, s); with the twiddle in the load when premul (#13),
    without it (the "2d" mode's outer pass)."""
    n1, n2 = lt.n1, lt.n2
    (csn, csb), (ysn, ysb) = cs, ys
    strided_c2c(c, y, n1, (csn, n2 * ysn, 1), [(n2, n1 * csn, ysn, n1), (batch, csb, ysb, 0)],
                lt.inverse, lt.t2, "stage2" if premul else "outer",
                pm=(lt.pmre, lt.pmim), mul=MUL_LOAD if premul else MUL_NONE, plain=plain)


def _run(x, xs, y, ys, batch: int, lt: LargeTables, mode: str, plain: bool = False) -> None:
    """y = DFT_N(x) for `batch` sequences; point j of sequence s at
    j*xs[0] + s*xs[1] floats past x's first elements (y likewise)."""
    if batch == 0:
        return
    if mode == "cube" and _use_kernel(x[0], plain):
        _launch_cube(x, y, xs, ys, batch, lt)
        return
    n = lt.n
    # C takes the layout of x's coalesced axis, so both passes can walk it
    if xs[0] <= xs[1]:
        c = tuple(x[0].new_empty(batch, n) for _ in range(2))
        cs = (1, n)
    else:
        c = tuple(x[0].new_empty(n, batch) for _ in range(2))
        cs = (batch, 1)
    two_d = mode == "2d"
    _pass1(x, xs, c, cs, batch, lt, plain, postmul=two_d)
    _pass2(c, cs, y, ys, batch, lt, plain, premul=not two_d)


def _mode(n: int, batch: int, mode, strides) -> str:
    if mode is None:
        return planner.large_mode(n, batch, time_major=strides[0] > strides[1])
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return mode


def fft_large_views(xre, xim, yre, yim, inverse: bool = False, split=None, mode=None,
                    tables: LargeTables | None = None) -> None:
    """y = DFT_N along axis 0 of the [N, B] float views x, written into the
    [N, B] views y (the large counterpart of `stockham.fft_views`). The re
    and im views of a side share their strides; y must not overlap x."""
    if xre.stride() != xim.stride() or yre.stride() != yim.stride():
        raise ValueError("the re and im views of a side must share their strides")
    n, batch = xre.shape
    lt = _resolve(tables, n, bool(inverse), xre.device, split)
    _run((xre, xim), xre.stride(), (yre, yim), yre.stride(), batch, lt,
         _mode(n, batch, mode, xre.stride()))


# -- forms, autograd -------------------------------------------------------------
# layout "nb": planes [N, ...]; "bm": planes [..., N]; "complex": complex
# [..., N] (interleaved storage: re and im 4 bytes apart, stride 2).

def _forms(a, b, inverse: bool, layout: str, split, mode, tables, plain: bool = False):
    if layout == "complex":
        if _use_kernel(a, plain):
            stockham._kernel_dtype(a, torch.complex64)
        n = a.shape[-1]
        x = stockham._dense(a)
        out = torch.empty_like(x)
        fx, fo = torch.view_as_real(x).view(-1), torch.view_as_real(out).view(-1)
        xo, yo = (fx, fx[1:]), (fo, fo[1:])  # re at the base, im 4 bytes on
    else:
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            raise ValueError(f"re and im planes differ: {a.shape} {a.dtype} "
                             f"{a.device} vs {b.shape} {b.dtype} {b.device}")
        n = a.shape[0] if layout == "nb" else a.shape[-1]
        x = a
        xo = (stockham._dense(a), stockham._dense(b))
        out = yo = (torch.empty_like(xo[0]), torch.empty_like(xo[1]))
    batch = x.numel() // n
    strides = {"nb": (batch, 1), "bm": (1, n), "complex": (2, 2 * n)}[layout]
    lt = _resolve(tables, n, bool(inverse), x.device, split)
    _run(xo, strides, yo, strides, batch, lt, _mode(n, batch, mode, strides), plain)
    return out


class _LargeFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, inverse, layout, split, mode, tables):
        ctx.inverse, ctx.layout, ctx.split, ctx.mode = inverse, layout, split, mode
        out = _forms(a, b, inverse, layout, split, mode, tables)
        return out if layout == "complex" else tuple(out)

    @staticmethod
    def backward(ctx, *g):
        layout = ctx.layout
        n = g[0].shape[0] if layout == "nb" else g[0].shape[-1]
        s = 1.0 / n if ctx.inverse else float(n)
        if layout == "complex":
            return (_LargeFFT.apply(g[0], None, not ctx.inverse, layout, ctx.split, ctx.mode,
                                    None) * s, None, None, None, None, None, None)
        ore, oim = _LargeFFT.apply(g[0], g[1], not ctx.inverse, layout, ctx.split, ctx.mode,
                                   None)
        return ore * s, oim * s, None, None, None, None, None


def _transform(a, b, inverse, layout, split, mode, tables):
    if stockham._wants_grad(*(t for t in (a, b) if t is not None)):
        return _LargeFFT.apply(a, b, bool(inverse), layout, split, mode, tables)
    out = _forms(a, b, bool(inverse), layout, split, mode, tables)
    return out if layout == "complex" else tuple(out)


def fft_large_nb(xre, xim, inverse: bool = False, split=None, mode=None,
                 tables: LargeTables | None = None):
    """Batched large-N FFT on time-major planes [N, ...] (f32). Any batch,
    no padding. split: (n1, n2), default `large_split(N)`; mode: "cube",
    "pipe2" or "2d", default the planner's rule (`planner.large_mode`)."""
    return _transform(xre, xim, inverse, "nb", split, mode, tables)


def fft_large_bm(re, im, inverse: bool = False, split=None, mode=None,
                 tables: LargeTables | None = None):
    """Batched large-N FFT on batch-major planes [..., N]."""
    return _transform(re, im, inverse, "bm", split, mode, tables)


def fft_large_complex(x, inverse: bool = False, split=None, mode=None,
                      tables: LargeTables | None = None):
    """Batched large-N FFT over the last axis of a complex tensor [..., N];
    on CUDA the kernels read and write the interleaved complex64 storage."""
    return _transform(x, None, inverse, "complex", split, mode, tables)


def fft_large(xre, xim, inverse: bool = False):
    """FFT of one large sequence on flat planes [N] (f32): the "2d" mode, as
    the JAX package's fft_large runs the post-multiplying kernel and then
    the c2c kernel."""
    if xre.dim() != 1:
        raise ValueError(f"fft_large takes flat planes [N], got shape {tuple(xre.shape)}")
    return _transform(xre, xim, inverse, "nb", None, "2d", None)


def plain_fft_large(x, inverse: bool = False, split=None, mode: str = "pipe2",
                    tables: LargeTables | None = None):
    """The plain version of `fft_large_complex` on any device: each kernel
    of the mode ("pipe2" or "2d"; the cube's plain version is pipe2's) in
    torch ops on the same strided views. On CUDA it is the reference the
    kernels are held against."""
    return _forms(x, None, bool(inverse), "complex", split,
                  "pipe2" if mode == "cube" else mode, tables, plain=True)


# -- each kernel on the JAX package's [n2, n1, b] blocks -------------------------

def _blocks(xre, xim, inverse, tables):
    """Checks [n2, n1, b] planes; their [N, b] view is time-major (point
    j1 + n1*j2 of sequence s at j*b + s)."""
    if xre.dim() != 3 or xre.shape != xim.shape:
        raise ValueError(f"expected [n2, n1, b] planes, got {tuple(xre.shape)} "
                         f"and {tuple(xim.shape)}")
    n2, n1, b = xre.shape
    lt = _resolve(tables, n1 * n2, bool(inverse), xre.device, (n1, n2))
    return lt, n1, n2, b, stockham._dense(xre), stockham._dense(xim)


def _stage1(xre, xim, inverse, tables, plain):
    lt, n1, n2, b, xre, xim = _blocks(xre, xim, inverse, tables)
    out = (torch.empty_like(xre), torch.empty_like(xim))
    _pass1((xre, xim), (b, 1), out, (b, 1), b, lt, plain, postmul=False)
    return out


def stage1(xre, xim, inverse: bool = False, tables: LargeTables | None = None):
    """Stage 1 (#11) on [n2, n1, b] planes: the n2-point FFTs over axis 0,
    no twiddle. Returns [n2, n1, b] planes."""
    return _stage1(xre, xim, inverse, tables, plain=False)


def plain_stage1(xre, xim, inverse: bool = False, tables: LargeTables | None = None):
    """The plain version of `stage1`, on any device."""
    return _stage1(xre, xim, inverse, tables, plain=True)


def _stage2(cre, cim, inverse, tables, plain):
    lt, n1, n2, b, cre, cim = _blocks(cre, cim, inverse, tables)
    out = (cre.new_empty(n1, n2, b), cim.new_empty(n1, n2, b))
    _pass2((cre, cim), (b, 1), out, (b, 1), b, lt, plain, premul=True)
    return out


def stage2(cre, cim, inverse: bool = False, tables: LargeTables | None = None):
    """Stage 2 (#13) on C [n2, n1, b] planes: the twiddle T[k2, j1] in the
    load, the n1-point FFTs over j1, the store transposed. Returns
    [n1, n2, b] planes."""
    return _stage2(cre, cim, inverse, tables, plain=False)


def plain_stage2(cre, cim, inverse: bool = False, tables: LargeTables | None = None):
    """The plain version of `stage2`, on any device."""
    return _stage2(cre, cim, inverse, tables, plain=True)


def cube(xre, xim, inverse: bool = False, tables: LargeTables | None = None):
    """The cube (#12) on [n2, n1, b] planes: the whole four-step of each of
    the b sequences in one block. Returns [n1, n2, b] planes. Its plain
    version is `plain_stage2(*plain_stage1(...))`."""
    lt, n1, n2, b, xre, xim = _blocks(xre, xim, inverse, tables)
    out = (xre.new_empty(n1, n2, b), xim.new_empty(n1, n2, b))
    _run((xre, xim), (b, 1), out, (b, 1), b, lt, "cube")
    return out


# -- the large real FFT ----------------------------------------------------------
# The m = n/2-point core on the even and odd rows of the signal, through
# `fft_large_views`, with the Hermitian post / pre of ops/rfft.py beside it
# (as the JAX package runs them in XLA); the forms and the autograd (the
# JAX adjoint identities) are ops/rfft.py's, on the route "large".

def rfft_large_nb(x):
    """Large real FFT on time-major real [n, ...] -> planes [n//2+1, ...],
    n = 2^14 .. 2^25."""
    from . import rfft as rf
    return rf._forward(x, "large", "nb", None)


def irfft_large_nb(xre, xim):
    """Normalized inverse, time-major planes [m+1, ...] -> real [2m, ...]."""
    from . import rfft as rf
    return rf._inverse(xre, xim, "large", "nb", None)


def rfft_large_bm(x):
    """Large real FFT on batch-major real [..., n] -> planes [..., n//2+1]."""
    from . import rfft as rf
    return rf._forward(x, "large", "bm", None)


def irfft_large_bm(xre, xim):
    """Normalized inverse on batch-major planes [..., m+1] -> real [..., 2m]."""
    from . import rfft as rf
    return rf._inverse(xre, xim, "large", "bm", None)


def rfft_large(x):
    """Large real FFT over the last axis: real [..., n] -> complex [..., n//2+1]."""
    from . import rfft as rf
    return rf._forward(x, "large", "complex", None)


def irfft_large(x):
    """Normalized inverse over the last axis: complex [..., m+1] -> real [..., 2m]."""
    from . import rfft as rf
    return rf._inverse(x, None, "large", "complex", None)
