"""The spectrometer's power detection: the power |X|^2 of a chunk's spectra
x, complex64 [chans, pols, per, nfft], summed over the polarisations and
the spectra, added in place into one integration's row of the accumulator,
float32 [chans, nfft] (`acc[:, j]`: bins contiguous, its own channel
stride).

Two implementations of one function:

* the plain version (`plain_detect`): torch ops, `square` of the real
  parts, `addcmul_` of the imaginary parts, the sum over the streams and
  the add into the row. `detect` takes it for CPU spectra.
* the kernel (`power_add`, `csrc/detect.cu`): one streaming pass that reads
  the spectra once and the row once and writes the row once, no atomics
  and no temporaries. It takes every CUDA spectra tensor; the input is
  integer voltages, so nothing here is differentiable.

The JAX package has no spectrometer; no TPU kernel is replaced.
"""

from __future__ import annotations

import torch

from . import _build
from .stockham import check_device

__all__ = ["detect_launch", "detect", "plain_detect", "power_add"]


def detect_launch(shape, row_stride: int, x_addr: int, row_addr: int) -> tuple:
    """The C entry's sizes for spectra of `shape` [chans, pols, per, nfft] at
    address x_addr into a row at row_addr whose channels lie row_stride
    floats apart: (chans, streams, nfft, row_stride, vec), streams = pols *
    per. vec = 4 (16-byte accesses of 4 bins) where nfft and the stride are
    multiples of 4 and both addresses 16-byte aligned, else 1."""
    chans, pols, per, nfft = shape
    aligned = x_addr % 16 == 0 and row_addr % 16 == 0
    vec = 4 if nfft % 4 == 0 and row_stride % 4 == 0 and aligned else 1
    return chans, pols * per, nfft, row_stride, vec


def detect(x: torch.Tensor, row: torch.Tensor) -> None:
    """Adds the power of the spectra x [chans, pols, per, nfft], summed over
    the polarisations and the spectra, into the row [chans, nfft]: the
    kernel on CUDA spectra, the plain version on CPU spectra."""
    if _build.use_kernel(x):
        power_add(x, row)
    else:
        plain_detect(x, row)


def plain_detect(x: torch.Tensor, row: torch.Tensor) -> None:
    """The plain version: four torch passes."""
    power = x.real.square().addcmul_(x.imag, x.imag)  # [chans, pols, per, nfft]
    # a sum over the outer axes, along contiguous bins (over the (re, im)
    # pairs' axis, torch's reduction ran 5x slower on the card)
    row.add_(power.sum(dim=(1, 2)))


def power_add(x: torch.Tensor, row: torch.Tensor) -> None:
    """The kernel on CUDA spectra x, complex64 [chans, pols, per, nfft], into
    the row, float32 [chans, nfft] with contiguous bins, on one device; the
    row is read and written in place."""
    if x.dtype != torch.complex64 or row.dtype != torch.float32:
        raise TypeError(f"the detection kernel takes complex64 spectra and a float32 row, "
                        f"got {x.dtype}, {row.dtype}")
    if x.dim() != 4:
        raise ValueError(f"spectra must be [chans, pols, per, nfft], got shape "
                         f"{tuple(x.shape)}")
    chans, nfft = x.shape[0], x.shape[-1]
    if row.shape != (chans, nfft) or (nfft > 1 and row.stride(1) != 1):
        raise ValueError(f"row {tuple(row.shape)} with strides {row.stride()} for spectra "
                         f"{tuple(x.shape)}: want [{chans}, {nfft}], bins contiguous")
    if row.device != x.device:
        raise ValueError(f"row on {row.device}, spectra on {x.device}")
    check_device(x.device)
    if x.numel() == 0:
        return
    x = x.contiguous()
    args = detect_launch(x.shape, row.stride(0), x.data_ptr(), row.data_ptr())
    _build.launch("spec_detect", x.device, "watfft_spec_detect",
                  (x.data_ptr(), row.data_ptr(), *args), (),
                  lambda: f"spectra={tuple(x.shape)}, row stride={row.stride(0)}")
