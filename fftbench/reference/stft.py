"""The plain STFT and its inverse, in float64: the periodic Hann window, the
frames, `torch.fft.rfft` / `irfft`, and the overlap-add divided by the
overlap-added squared window (COLA normalization, the sum clamped at 1e-8 as
the STFT's definition states), each worked out here. With `dtype` below
float64 the transforms are DFT matrix products in that dtype instead (the
control: the reference computed in a lower precision).

Imports torch alone: nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
CLAMP = 1e-8


def hann(n: int, device) -> torch.Tensor:
    """The periodic (DFT-even) Hann window of n points."""
    k = torch.arange(n, dtype=F64, device=device)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * k / n)


def num_frames(t: int, n_fft: int, hop: int) -> int:
    return 1 + (t - n_fft) // hop


def _angles(n: int, device) -> torch.Tensor:
    """2 pi j k / n for the samples j (rows) and the bins k (columns)."""
    j = torch.arange(n, dtype=F64, device=device)
    k = torch.arange(n // 2 + 1, dtype=F64, device=device)
    return 2 * math.pi * torch.outer(j, k).remainder(n) / n


def rdft(frames: torch.Tensor, dtype=F64) -> torch.Tensor:
    """The real DFT of each row; in float64 by `torch.fft.rfft`, else as a
    product with the DFT matrix in `dtype`."""
    n = frames.shape[-1]
    if dtype == F64:
        return torch.fft.rfft(frames.to(F64), dim=-1)
    a = _angles(n, frames.device)
    f = frames.to(dtype)
    return torch.complex((f @ torch.cos(a).to(dtype)).to(F64),
                         (f @ -torch.sin(a).to(dtype)).to(F64))


def irdft(re: torch.Tensor, im: torch.Tensor, n: int, dtype=F64) -> torch.Tensor:
    """The normalized inverse real DFT of each row of bins (the imaginary
    parts of the DC and Nyquist bins ignored); in float64 by
    `torch.fft.irfft`, else as a product with the matrix in `dtype`."""
    if dtype == F64:
        return torch.fft.irfft(torch.complex(re.to(F64), im.to(F64)), n=n, dim=-1)
    a = _angles(n, re.device).T  # [bins, n]
    c = torch.full((n // 2 + 1, 1), 2.0, dtype=F64, device=re.device)
    c[0] = c[-1] = 1.0
    return ((re.to(dtype) @ (c * torch.cos(a) / n).to(dtype)).to(F64)
            - (im.to(dtype) @ (c * torch.sin(a) / n).to(dtype)).to(F64))


def stft(x: torch.Tensor, n_fft: int, hop: int, dtype=F64) -> tuple[torch.Tensor, torch.Tensor]:
    """Real [..., t] -> (re, im) [..., frames, n_fft//2 + 1], float64."""
    x = x.to(F64)
    m = num_frames(x.shape[-1], n_fft, hop)
    starts = torch.arange(m, device=x.device) * hop
    idx = starts[:, None] + torch.arange(n_fft, device=x.device)[None, :]
    spec = rdft(x[..., idx] * hann(n_fft, x.device), dtype)
    return spec.real, spec.imag


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
          length: int | None = None, dtype=F64) -> torch.Tensor:
    """(re, im) [..., frames, bins] -> real [..., (frames-1)*hop + n_fft],
    cut to `length` if given; float64."""
    w = hann(n_fft, re.device)
    frames = irdft(re, im, n_fft, dtype) * w
    m = frames.shape[-2]
    t = (m - 1) * hop + n_fft
    out = torch.zeros(frames.shape[:-2] + (t,), dtype=F64, device=re.device)
    for f in range(m):
        out[..., f * hop:f * hop + n_fft] += frames[..., f, :]
    out = out / overlap(m, n_fft, hop, re.device).clamp_min(CLAMP)
    return out if length is None else out[..., :length]


def overlap(m: int, n_fft: int, hop: int, device) -> torch.Tensor:
    """The overlap-added squared window over the frames' span (the divisor
    of `istft` before its clamp)."""
    w2 = hann(n_fft, device) ** 2
    norm = torch.zeros((m - 1) * hop + n_fft, dtype=F64, device=device)
    for f in range(m):
        norm[f * hop:f * hop + n_fft] += w2
    return norm
