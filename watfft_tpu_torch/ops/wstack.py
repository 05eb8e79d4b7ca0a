"""The w-stacking inversion's accumulation: a chunk of inverse-transformed
w-planes, complex64 [layers, N, N] as the port's `ifft2` leaves them (no
centring shift), summed under their w-screens into the float32 image
[N, N] in place:

    acc[y, x]   = sum_k Re(e^{2 pi i w_k (n - 1)} P_k[(y + N/2) % N, (x + N/2) % N])
    image[y, x] = (0 if first else image[y, x]) + (-1)^(x + y) acc[y, x]
    and, where last, image[y, x] *= n / (taper[y] taper[x])

with l = (x - N/2) pixel_scale, m = (y - N/2) pixel_scale, n = sqrt(1 - l^2 -
m^2); pixels with l^2 + m^2 >= 1 are 0. For even N, fftshift(ifft2(
ifftshift(G))) = (-1)^(x + y) ifft2(G) shifted by N/2 on both axes
(`fold`), so the kernel reads the planes where the transform left them.

Two implementations of one function:

* the plain version (`plain_accum`): torch ops, the fold a roll, the screen
  a plane at a time (`screen`). `accumulate` takes it for CPU planes.
* the kernel (`accum_kernel`, `csrc/wstack.cu`): one streaming pass that
  reads the chunk's planes once and the image once and writes it once, no
  atomics and no temporaries. It takes every CUDA chunk.

The phase is w_k (n - 1) turns: n - 1 in float64 as -r^2 / (1 + sqrt(1 -
r^2)) (`n_minus_1`, no cancellation near the centre), the product in
float64, reduced mod 1 before the float32 sine and cosine. Nothing here is
differentiable. The JAX package has no imager; no TPU kernel is replaced.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .stockham import check_device

__all__ = ["accum_launch", "accumulate", "plain_accum", "accum_kernel", "fold", "n_minus_1",
           "screen"]


def accum_launch(n: int, planes_addr: int, image_addr: int) -> int:
    """The C entry's vec: 4 (16-byte accesses of 4 pixels) where N is a
    multiple of 8 and both addresses are 16-byte aligned, else 1."""
    return 4 if n % 8 == 0 and planes_addr % 16 == 0 and image_addr % 16 == 0 else 1


def accumulate(planes, image, w, pixel_scale: float, taper, first: bool, last: bool) -> None:
    """Sums the planes [layers, N, N] (complex64) under their w-screens into
    the image [N, N] (float32) in place: the kernel on CUDA planes, the
    plain version on CPU planes. w: float64 [layers]; taper: float32 [N];
    first: the image is not read; last: the n / taper^2 scale follows."""
    if _build.use_kernel(planes):
        accum_kernel(planes, image, w, pixel_scale, taper, first, last)
    else:
        plain_accum(planes, image, w, pixel_scale, taper, first, last)


def _r2(n: int, pixel_scale: float, device) -> torch.Tensor:
    """l^2 + m^2, float64 [N, N], the centre at index N/2."""
    lm = (torch.arange(n, dtype=torch.float64, device=device) - n // 2) * pixel_scale
    return lm[:, None] * lm[:, None] + lm[None, :] * lm[None, :]


def n_minus_1(n: int, pixel_scale: float, device="cpu") -> torch.Tensor:
    """n - 1 = sqrt(1 - r^2) - 1 of every pixel as -r^2 / (1 + sqrt(1 - r^2)),
    float64 [N, N] (0 where r^2 >= 1)."""
    r2 = _r2(n, pixel_scale, device)
    inside = r2 < 1.0
    return torch.where(inside, -r2 / (1.0 + torch.sqrt(torch.where(inside, 1.0 - r2, 0.0))),
                       0.0)


def screen(w, nm1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of 2 pi w (n - 1), float32: the product in nm1's dtype
    (float64 here), reduced mod 1 (half to even), the turns doubled and
    rounded to float32 (the kernel's `sincospif` argument), their cosine and
    sine in float64 rounded to float32."""
    p = nm1 * w
    a = (2.0 * (p - torch.round(p))).float().double() * math.pi
    return torch.cos(a).float(), torch.sin(a).float()


def fold(planes: torch.Tensor) -> torch.Tensor:
    """(-1)^(x + y) P[(y + N/2) % N, (x + N/2) % N] of each plane: equal, for
    even N, to fftshift of the inverse transform of the ifftshifted grid."""
    n = planes.shape[-1]
    idx = torch.arange(n, device=planes.device)
    sign = 1 - 2 * ((idx[:, None] + idx[None, :]) % 2)
    return torch.roll(planes, (n // 2, n // 2), (-2, -1)) * sign


def plain_accum(planes, image, w, pixel_scale: float, taper, first: bool, last: bool) -> None:
    """The plain version: a plane at a time, in the kernel's order (the
    kernel flips the sum's sign where this flips each folded plane's: the
    same bits, as rounding to nearest is symmetric)."""
    n = planes.shape[-1]
    r2 = _r2(n, pixel_scale, planes.device)
    nm1 = n_minus_1(n, pixel_scale, planes.device)
    acc = torch.zeros((n, n), dtype=torch.float32, device=planes.device)
    for k in range(planes.shape[0]):
        folded = fold(planes[k])
        c, s = screen(w[k], nm1)
        acc = acc + (folded.real * c - folded.imag * s)
    out = acc if first else image + acc
    if last:
        t = taper.double()
        scale = torch.sqrt(torch.clamp(1.0 - r2, min=0.0)) / (t[:, None] * t[None, :])
        out = out * scale.float()
    image.copy_(torch.where(r2 < 1.0, out, 0.0))


def accum_kernel(planes, image, w, pixel_scale: float, taper, first: bool, last: bool) -> None:
    """The kernel on CUDA planes, complex64 [layers, N, N], into the image,
    float32 [N, N] contiguous, with w float64 [layers] and taper float32 [N]
    on the planes' device."""
    if (planes.dtype != torch.complex64 or image.dtype != torch.float32
            or w.dtype != torch.float64 or taper.dtype != torch.float32):
        raise TypeError(f"the accumulation kernel takes complex64 planes, a float32 image, "
                        f"float64 w and a float32 taper, got {planes.dtype}, {image.dtype}, "
                        f"{w.dtype}, {taper.dtype}")
    if planes.dim() != 3 or planes.shape[-1] != planes.shape[-2]:
        raise ValueError(f"planes must be [layers, N, N], got shape {tuple(planes.shape)}")
    layers, n = planes.shape[0], planes.shape[-1]
    if image.shape != (n, n) or w.shape != (layers,) or taper.shape != (n,):
        raise ValueError(f"image {tuple(image.shape)}, w {tuple(w.shape)} and taper "
                         f"{tuple(taper.shape)} for planes {tuple(planes.shape)}: want "
                         f"[{n}, {n}], [{layers}] and [{n}]")
    if not image.is_contiguous():
        raise ValueError("the image must be contiguous")
    if any(t.device != planes.device for t in (image, w, taper)):
        raise ValueError(f"image on {image.device}, w on {w.device}, taper on {taper.device}, "
                         f"planes on {planes.device}")
    check_device(planes.device)
    if layers == 0:
        return
    planes, w, taper = planes.contiguous(), w.contiguous(), taper.contiguous()
    vec = accum_launch(n, planes.data_ptr(), image.data_ptr())
    _build.launch("wstack_accum", planes.device, "watfft_wstack_accum",
                  (planes.data_ptr(), image.data_ptr(), w.data_ptr(), taper.data_ptr(), layers,
                   n, float(pixel_scale), int(first), int(last), vec), (),
                  lambda: f"planes={tuple(planes.shape)}, pixel_scale={pixel_scale}")
