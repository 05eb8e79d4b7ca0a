"""Batched small-n FFT as one real matrix product: host matrix and its
tensor-core fragments, plain version, kernel wrapper.

Counterpart of `watfft_tpu/ops/mxu_dft.py` (kernel #20, `_kernel`). For
n <= `config.DIRECT_MAX` (128) the whole transform of each sequence is one
product with the real form of the DFT matrix,

    [Yre]   [ Wre  -Wim ] [xre]
    [Yim] = [ Wim   Wre ] [xim],    Wre + i Wim = exp(-+2 pi i k j / n),

the inverse conjugated with 1/n folded into W. On the TPU that product
runs on the matrix unit (MXU) at HIGHEST precision, a multi-pass split of
bf16 passes. On Hopper `csrc/mxu_dft.cu` runs it on the tensor cores in
3xTF32 (past n = SIMT_MAX_N; below, on the FP32 cores): each operand v is
split into hi = tf32_rna(v) and lo = tf32_rna(v - hi), and each product
is lo*hi + hi*lo + hi*hi (`tf32_rna` rounds to 10 mantissa bits, ties
away from zero, as `cvt.rna.tf32.f32` does). W is split here, on the
host, once per (n, direction, device): `mma_fragments` gives the hi and lo
planes of Wre and Wim, zero-padded to whole 16 x 8 tiles and laid out in
the order of the mma's A fragments, so that each lane loads its four values
of a plane with one 16-byte load. The matrix is the JAX package's, bit for
bit (`dft_matrix_real`).

Two implementations of one function:

* `plain_dft_matmul` (and the wrappers on CPU tensors) — one torch.matmul
  in full f32 (`fourstep.full_f32`);
* the kernel — every CUDA tensor launches it, or the call raises.

Forms: time-major planes [n, ...] (`dft_matmul_nb`, the JAX signature,
without its TPU-only `b % 128` rule), batch-major planes [..., n]
(`dft_matmul_bm`) and complex64 tensors [..., n] (`dft_matmul`, whose
interleaved storage the kernel reads and writes itself, one 8-byte copy
and store a point). n is any of 1..DIRECT_MAX, as in the JAX function; f32
only. Like the JAX function (`pallas_call` has no autodiff rule and the
module defines no VJP), it has no gradient: planes that require one raise
instead of dropping it. The planner never routes a call here, as the JAX
planner never does (`watfft_tpu/planner.py:86-91`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import config, trace
from . import _build, stockham
from .fourstep import full_f32
from .stockham import check_device

__all__ = ["dft_matrix_real", "device_matrix", "tf32_rna", "fragment_index", "mma_fragments",
           "device_fragments", "dft_launch", "plain_dft_matmul", "dft_matmul_nb",
           "dft_matmul_bm", "dft_matmul"]

# The C entry's kernels (its `kernel` argument): the register-tiled product
# on the FP32 cores, and the 3xTF32 product on the tensor cores. The FP32
# cores take n <= SIMT_MAX_N, where they measured faster (an mma's 16 x 8
# tile is 1/8 or less of work there); the tensor cores every larger n.
KERNEL_SIMT, KERNEL_MMA = 1, 2
SIMT_MAX_N = 2


def dft_matrix_real(n: int, inverse: bool) -> np.ndarray:
    """[2n, 2n] f32 real form of the DFT matrix W[k, j] = exp(-+2i pi k j / n)
    (/n for the inverse): f64 host trig with the phases reduced mod n, the
    code of watfft_tpu/ops/mxu_dft.py:43-56."""
    k = np.arange(n, dtype=np.int64).reshape(-1, 1)
    j = np.arange(n, dtype=np.int64).reshape(1, -1)
    sign = +1.0 if inverse else -1.0
    ang = sign * 2.0 * np.pi * ((k * j) % n) / n
    scale = (1.0 / n) if inverse else 1.0
    wre = (scale * np.cos(ang))
    wim = (scale * np.sin(ang))
    top = np.concatenate([wre, -wim], axis=1)
    bot = np.concatenate([wim, wre], axis=1)
    return np.concatenate([top, bot], axis=0).astype(np.float32)


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, the low 13 bits cleared: as `cvt.rna.tf32.f32` rounds
    and as the kernel splits x (csrc/mxu_dft.cu `tf32_split`). Finite
    inputs only."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def fragment_index(n: int) -> np.ndarray:
    """[MT, KT, 32, 4] int64: the flat index, into a plane zero-padded to
    [16 MT, 8 KT] (MT = ceil(n / 16), KT = ceil(n / 8)), of the value lane
    l holds in register r of the A fragment of m-tile mt and k-tile kt of
    mma.m16n8k8.tf32: with g = l / 4 and t = l % 4, a0..a3 sit at rows
    (g, g + 8, g, g + 8) and columns (t, t, t + 4, t + 4) of the tile."""
    mt, kt = -(-n // 16), -(-n // 8)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rows = np.stack([g, g + 8, g, g + 8], axis=-1)       # [32, 4]
    cols = np.stack([t, t, t + 4, t + 4], axis=-1)
    r = np.arange(mt).reshape(-1, 1, 1, 1) * 16 + rows
    c = np.arange(kt).reshape(1, -1, 1, 1) * 8 + cols
    return r * (8 * kt) + c


def mma_fragments(n: int, inverse: bool) -> np.ndarray:
    """[MT, KT, 4, 32, 4] f32: for each 16 x 8 tile of Wre and Wim (the
    quadrants of `dft_matrix_real`; the kernel negates Wim in registers for
    the -Wim quadrant), the planes Wre hi, Wre lo, Wim hi, Wim lo (hi =
    tf32_rna(w), lo = tf32_rna(w - hi)), each in A-fragment order
    (`fragment_index`): lane l's four values of a plane are 16 contiguous
    bytes. Zero past n."""
    w = dft_matrix_real(n, inverse)
    idx = fragment_index(n)
    mt, kt = idx.shape[:2]
    parts = []
    for quad in (w[:n, :n], w[n:, :n]):
        plane = np.zeros((16 * mt, 8 * kt), np.float32)
        plane[:n, :n] = quad
        hi = tf32_rna(plane)
        lo = tf32_rna(plane - hi)
        parts += [hi.reshape(-1)[idx], lo.reshape(-1)[idx]]
    return np.ascontiguousarray(np.stack(parts, axis=2))


@functools.cache
def _cached(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    trace.counts["tables_built"] += 1
    return trace.h2d(np.ascontiguousarray(dft_matrix_real(n, inverse).T), device)


@functools.cache
def _cached_fragments(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    trace.counts["tables_built"] += 1
    return trace.h2d(mma_fragments(n, inverse), device)


def device_matrix(n: int, inverse: bool, device) -> torch.Tensor:
    """W^T for (n, direction) on `device`, [2n, 2n] f32 contiguous (the
    layout the FP32-core kernel reads: row k holds W[:, k]), built once per
    device."""
    return _cached(int(n), bool(inverse), check_device(device))


def device_fragments(n: int, inverse: bool, device) -> torch.Tensor:
    """`mma_fragments` for (n, direction) on `device` (what the tensor-core
    kernel reads), built once per device."""
    return _cached_fragments(int(n), bool(inverse), check_device(device))


def dft_launch(n: int, x, y) -> tuple[int, int, int]:
    """The last arguments of a launch at n points: (kernel, pairs_x,
    pairs_y). The FP32-core kernel at n <= SIMT_MAX_N (no pairs); else the
    tensor-core kernel, with one 8-byte copy and store a point where re and
    im are adjacent (`complex_pairs`). Either kernel sizes its own grid.
    x, y: (re address, im address, point stride, batch stride), strides in
    floats."""
    if n <= SIMT_MAX_N:
        return KERNEL_SIMT, 0, 0
    return KERNEL_MMA, int(stockham.complex_pairs(*x)), int(stockham.complex_pairs(*y))


def _check(a, b, n: int) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"re and im planes differ: {a.shape} {a.dtype} {a.device} vs "
                         f"{b.shape} {b.dtype} {b.device}")
    if not 1 <= n <= config.DIRECT_MAX:
        raise ValueError(f"the DFT matmul takes 1 <= n <= DIRECT_MAX = {config.DIRECT_MAX}, "
                         f"got n={n}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError("dft_matmul has no gradient (neither has the JAX function): "
                           "call it on tensors that do not require grad, or under "
                           "torch.no_grad()")


def _launch(x, xs, y, ys, n: int, batch: int, inverse: bool) -> None:
    device = x[0].device
    wt = device_matrix(n, inverse, device)
    frag = device_fragments(n, inverse, device)
    addr = [t.data_ptr() for t in (*x, *y)]
    last = dft_launch(n, (addr[0], addr[1], *xs), (addr[2], addr[3], *ys))
    # W^T stays in its old place (a build without the tensor-core kernel
    # reads it and ignores the arguments after the stream)
    _build.launch("mxu_dft", device, "watfft_dft_matmul",
                  (*addr, *xs, *ys, n, batch, wt.data_ptr()),
                  (ctypes.c_void_p(frag.data_ptr()), *last), lambda: f"n={n}, batch={batch}")


def _plain(x, xs, y, ys, n: int, batch: int, inverse: bool) -> None:
    """Y = W @ concat(xre, xim) on the [n, batch] views of x's storage, into
    y's: one matmul in full f32."""
    wt = device_matrix(n, inverse, x[0].device)
    view = [t.as_strided((n, batch), s, t.storage_offset())
            for t, s in ((x[0], xs), (x[1], xs), (y[0], ys), (y[1], ys))]
    with full_f32():
        out = wt.T @ torch.cat([view[0], view[1]])
    view[2].copy_(out[:n])
    view[3].copy_(out[n:])


# layout "nb": planes [n, ...]; "bm": planes [..., n]; "complex": complex64
# [..., n] (interleaved storage: re and im 4 bytes apart, stride 2).

def _forms(a, b, inverse: bool, layout: str, plain: bool = False):
    n = a.shape[0] if layout == "nb" else a.shape[-1]
    if layout == "complex":
        if a.dtype != torch.complex64:
            raise TypeError(f"the DFT matmul takes complex64 tensors, got {a.dtype}")
        _check(a, a, n)
        x = stockham._dense(a)
        out = torch.empty_like(x)
        fx, fo = torch.view_as_real(x).view(-1), torch.view_as_real(out).view(-1)
        xo, yo = (fx, fx[1:]), (fo, fo[1:])  # re at the base, im 4 bytes on
    else:
        _check(a, b, n)
        if a.dtype != torch.float32:
            raise TypeError(f"the DFT matmul takes float32 planes, got {a.dtype}")
        xo = (stockham._dense(a), stockham._dense(b))
        out = yo = (torch.empty_like(xo[0]), torch.empty_like(xo[1]))
    batch = a.numel() // n
    if batch:
        strides = {"nb": (batch, 1), "bm": (1, n), "complex": (2, 2 * n)}[layout]
        run = _launch if _build.use_kernel(a, plain) else _plain
        run(xo, strides, yo, strides, n, batch, bool(inverse))
    return out


def dft_matmul_nb(xre, xim, inverse: bool = False):
    """Batched small-n FFT on time-major f32 planes [n, ...] (n <=
    DIRECT_MAX; any batch). Returns new planes of the same shape; the
    inverse is normalized (1/n)."""
    return _forms(xre, xim, inverse, "nb")


def dft_matmul_bm(xre, xim, inverse: bool = False):
    """Batched small-n FFT on batch-major f32 planes [..., n]."""
    return _forms(xre, xim, inverse, "bm")


def dft_matmul(x, inverse: bool = False):
    """Batched small-n FFT over the last axis of a complex64 tensor [..., n];
    on CUDA the kernel reads and writes its interleaved storage."""
    return _forms(x, None, inverse, "complex")


def plain_dft_matmul(xre, xim, inverse: bool = False, layout: str = "nb"):
    """The plain version of the three forms on any device (layout "nb",
    "bm" or "complex"; xim is None for "complex"): one torch.matmul in
    full f32. On CUDA it is the reference the kernel is held against."""
    return _forms(xre, xim, inverse, layout, plain=True)
