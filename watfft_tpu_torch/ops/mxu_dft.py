"""Batched small-n FFT as one real matrix product: host matrix, plain
version, kernel wrapper.

Counterpart of `watfft_tpu/ops/mxu_dft.py` (kernel #20, `_kernel`). For
n <= `config.DIRECT_MAX` (128) the whole transform of each sequence is one
product with the real form of the DFT matrix,

    [Yre]   [ Wre  -Wim ] [xre]
    [Yim] = [ Wim   Wre ] [xim],    Wre + i Wim = exp(-+2 pi i k j / n),

the inverse conjugated with 1/n folded into W. On the TPU that product
runs on the matrix unit (MXU) at HIGHEST precision. Hopper has no MXU:
`csrc/mxu_dft.cu` runs it on the FP32 cores, a register-tiled product that
sums the 2n terms of each output in a fixed order (its tensor cores reach
f32 accuracy only through a 3xTF32 split, queued as later work). The
matrix is the JAX package's, bit for bit (`dft_matrix_real`), kept on each
device once per (n, direction).

Two implementations of one function:

* `plain_dft_matmul` (and the wrappers on CPU tensors) — one torch.matmul
  in full f32 (`fourstep.full_f32`);
* the kernel — every CUDA tensor launches it, or the call raises.

Forms: time-major planes [n, ...] (`dft_matmul_nb`, the JAX signature,
without its TPU-only `b % 128` rule), batch-major planes [..., n]
(`dft_matmul_bm`) and complex64 tensors [..., n] (`dft_matmul`, whose
interleaved storage the kernel reads and writes itself). n is any of
1..DIRECT_MAX, as in the JAX function; f32 only. Like the JAX function
(`pallas_call` has no autodiff rule and the module defines no VJP), it has
no gradient: planes that require one raise instead of dropping it. The
planner never routes a call here, as the JAX planner never does
(`watfft_tpu/planner.py:86-91`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import config
from . import stockham
from .fourstep import full_f32
from .stockham import check_device

__all__ = ["dft_matrix_real", "device_matrix", "plain_dft_matmul", "dft_matmul_nb",
           "dft_matmul_bm", "dft_matmul", "launches"]

# Kernel launches made by the CUDA wrapper since the count was last set to 0.
launches = 0


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


@functools.cache
def _cached(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(dft_matrix_real(n, inverse).T)).to(device)


def device_matrix(n: int, inverse: bool, device) -> torch.Tensor:
    """W^T for (n, direction) on `device`, [2n, 2n] f32 contiguous (the
    layout the kernel reads: row k holds W[:, k]), built once per device."""
    return _cached(int(n), bool(inverse), check_device(device))


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


def _launch(x, xs, y, ys, n: int, batch: int, wt: torch.Tensor) -> None:
    global launches
    from ._build import library

    lib = library()
    with torch.cuda.device(x[0].device):
        err = lib.watfft_dft_matmul(x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(),
                                    y[1].data_ptr(), *xs, *ys, n, batch, wt.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"DFT matmul kernel launch failed (n={n}, batch={batch}): "
                           f"{lib.watfft_error_string(err).decode()}")
    launches += 1


def _plain(x, xs, y, ys, n: int, batch: int, wt: torch.Tensor) -> None:
    """Y = W @ concat(xre, xim) on the [n, batch] views of x's storage, into
    y's: one matmul in full f32."""
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
    wt = device_matrix(n, bool(inverse), a.device)
    batch = a.numel() // n
    if batch:
        strides = {"nb": (batch, 1), "bm": (1, n), "complex": (2, 2 * n)}[layout]
        run = _launch if a.device.type == "cuda" and not plain else _plain
        run(xo, strides, yo, strides, n, batch, wt)
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
