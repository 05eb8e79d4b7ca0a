"""The plain w-stacking inversion (WSClean's, Offringa et al. 2014, MNRAS
444:606, section 2) in float64, and the error of an imager's output
against it:

    image[y, x] = n(l, m) / (taper[y] taper[x])
                  * sum_k Re( e^{2 pi i w_k (n(l, m) - 1)}
                              * fftshift(ifft2(ifftshift(grids[k])))[y, x] )

with l = (x - N/2) pixel_scale, m = (y - N/2) pixel_scale, n = sqrt(1 - l^2 -
m^2), and 0 where l^2 + m^2 >= 1; ifft2 is numpy's (e^{+2 pi i (ux + vy) /
N}, 1/N^2). The screen e^{+2 pi i w (n - 1)} is the inverse of the w-term of
the paper's eq. 1, V = integral A I / n e^{-2 pi i (ul + vm + w (n - 1))};
the factor n turns its I / n into I. Departures from the paper: no primary
beam (A = 1), no gridding (the grids come gridded), no crop of the padding
(padding 1), one pass of the layers (a caller sums the passes' images), l
growing with x; and the division by the gridding kernel's image-domain
correction, `taper`, which the paper leaves to the gridder.

Imports torch alone: nothing of the port and nothing of JAX. One plane at
a time in complex128 (256 MiB at 4096^2), so it runs on the card beside a
request of 16 GiB. The screen is computed here as cos and sin of 2 pi w (n
- 1) in float64, with n - 1 as sqrt(1 - r^2) - 1 written the stable way.
"""

from __future__ import annotations

import math

import torch


def _lm2(n: int, pixel_scale: float, device) -> torch.Tensor:
    lm = (torch.arange(n, dtype=torch.float64, device=device) - n // 2) * pixel_scale
    return lm[:, None] ** 2 + lm[None, :] ** 2


def invert(grids: torch.Tensor, w: torch.Tensor, pixel_scale: float, taper: torch.Tensor,
           plane_dtype: torch.dtype | None = None) -> torch.Tensor:
    """float64 [N, N]: the image of grids [L, N, N] under w [L] and taper
    [N]. With `plane_dtype`, each layer's inverse transform has its real
    and imaginary parts rounded to it before the screen (the control:
    bfloat16)."""
    n = grids.shape[-1]
    r2 = _lm2(n, pixel_scale, grids.device)
    inside = r2 < 1.0
    root = torch.sqrt(torch.where(inside, 1.0 - r2, 0.0))
    nm1 = -r2 / (1.0 + root)
    acc = torch.zeros((n, n), dtype=torch.float64, device=grids.device)
    w = w.to(device=grids.device, dtype=torch.float64)
    for k in range(grids.shape[0]):
        g = torch.fft.ifftshift(grids[k].to(torch.complex128))
        plane = torch.fft.fftshift(torch.fft.ifft2(g))
        if plane_dtype is not None:
            plane = torch.view_as_complex(
                torch.view_as_real(plane).to(plane_dtype).to(torch.float64).contiguous())
        phase = 2.0 * math.pi * w[k] * nm1
        acc += plane.real * torch.cos(phase) - plane.imag * torch.sin(phase)
    t = taper.to(device=grids.device, dtype=torch.float64)
    return torch.where(inside, acc * root / (t[:, None] * t[None, :]), 0.0)


def image_err(got: torch.Tensor, grids: torch.Tensor, w: torch.Tensor, pixel_scale: float,
              taper: torch.Tensor) -> float:
    """max |got - reference| / max |reference|; NaN anywhere reads NaN."""
    want = invert(grids, w, pixel_scale, taper)
    return float((got.to(torch.float64) - want).abs().max() / want.abs().max())
