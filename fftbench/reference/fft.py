"""The plain complex FFT: `torch.fft` in complex128, and the error of a
transform against it.

Imports torch alone: nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import torch


def c2c(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The DFT of each row of x in complex128; the inverse normalized by 1/n."""
    x = x.to(torch.complex128)
    return torch.fft.ifft(x, dim=-1) if inverse else torch.fft.fft(x, dim=-1)


def max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst over the rows (the last axis is one transform) of the row's
    largest error, as a share of the row's largest reference value."""
    err = (got.to(ref.dtype) - ref).abs().amax(dim=-1)
    return float((err / ref.abs().amax(dim=-1)).max())
