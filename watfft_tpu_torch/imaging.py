"""Wide-field radio imaging: the w-stacking inversion of WSClean (Offringa
et al. 2014, "WSClean: an implementation of a fast, generic wide-field
imager for radio astronomy", MNRAS 444:606, section 2).

An interferometer's visibilities are gridded onto L planes by their w
coordinate; `wstack_invert(grids, w, pixel_scale, taper)` turns the planes
into the dirty image:

    image[y, x] = n(l, m) / (taper[y] taper[x])
                  * sum_k Re( e^{2 pi i w_k (n(l, m) - 1)}
                              * fftshift(ifft2(ifftshift(grids[k])))[y, x] )

with l = (x - N/2) pixel_scale, m = (y - N/2) pixel_scale (radians) and
n(l, m) = sqrt(1 - l^2 - m^2); pixels with l^2 + m^2 >= 1 are 0. ifft2 is
numpy's: e^{+2 pi i (ux + vy) / N} and 1/N^2.

What follows Offringa et al. 2014 eq. 1, V(u, v, w) = integral A I / n
e^{-2 pi i (ul + vm + w (n - 1))} dl dm: the inverse's e^{+2 pi i (ul + vm)}
and, for each layer, the screen e^{+2 pi i w_k (n - 1)}, the conjugate of
the equation's w-term; the factor n, which turns the equation's I / n into
I. What departs from it: the primary beam A is 1; the image is divided by
the gridding kernel's image-domain correction, the separable `taper`; the
grids come gridded (no gridding here) and the image is not cropped (padding
1); one call is one pass of layers, whose images the caller sums; l grows
with x, as numpy's ifft2 gives it, where sky images put l (east) on the
left: that flip moves no w-term, which depends on l^2 + m^2 alone.

Arguments: `grids` complex64 [L, N, N] with u = v = 0 at index N/2 (numpy's
`fftshift` order), N a power of two, L >= 1; `w` float64 [L], in
wavelengths; `pixel_scale` radians a pixel; `taper` float32 [N]. Returns
float32 [N, N] with l = m = 0 at index N/2. Nothing here is differentiable.

The planes go through the port's public 2D inverse (`api.ifft2`: the
planner's route, "fft2-2pass" at 4096^2) in chunks of at most the
spectrometer's `CHUNK_POINTS` points (at least one plane), then one
launch of the accumulation kernel a chunk (`ops/wstack.py`), which folds
both centring shifts into its indexing and sums the chunk's planes under
their w-screens into the image. The last chunk's launch also applies
n / taper^2 in its epilogue, so no other pass touches the image.
`device` is "cuda" by default; `device="cpu"` runs the plain versions.
Grids on the host move to the device a chunk at a time.

While a profiler runs, the call is the root span `imaging.wstack`, each
chunk's transform its `api.ifft2` span, each chunk's launch but the last
in a `wstack.accum` span and the last in `wstack.finalise`;
`trace.counts["wstack.layers"]` counts the planes summed.
"""

from __future__ import annotations

import math
import numbers

import torch
from torch.autograd import profiler

from . import trace
from .api import ifft2
from .ops.stockham import check_device
from .ops.wstack import accumulate
from .plan import is_power_of_two
from .spectrometer import CHUNK_POINTS

__all__ = ["planes_per_chunk", "wstack_invert"]


def planes_per_chunk(layers: int, n: int) -> int:
    """Planes a chunk holds: as many N x N planes as CHUNK_POINTS holds, at
    least 1, at most `layers`."""
    return max(1, min(layers, CHUNK_POINTS // (n * n)))


def _check(grids, w, pixel_scale, taper):
    grids, w, taper = (torch.as_tensor(t).detach() for t in (grids, w, taper))
    if grids.dtype != torch.complex64:
        raise TypeError(f"grids must be complex64, got {grids.dtype}")
    if w.dtype != torch.float64:
        raise TypeError(f"w must be float64 (wavelengths), got {w.dtype}")
    if taper.dtype != torch.float32:
        raise TypeError(f"taper must be float32, got {taper.dtype}")
    if grids.dim() != 3 or grids.shape[0] < 1 or grids.shape[1] != grids.shape[2]:
        raise ValueError(f"grids must be [L, N, N] with L >= 1, got shape {tuple(grids.shape)}")
    layers, n = grids.shape[0], grids.shape[-1]
    if not is_power_of_two(n) or n < 2:
        raise ValueError(f"the grid's side must be a power of two >= 2, got {n}")
    if w.shape != (layers,):
        raise ValueError(f"w must be [L] = [{layers}], got shape {tuple(w.shape)}")
    if taper.shape != (n,):
        raise ValueError(f"taper must be [N] = [{n}], got shape {tuple(taper.shape)}")
    if not (isinstance(pixel_scale, numbers.Real) and math.isfinite(pixel_scale)
            and pixel_scale > 0):
        raise ValueError(f"pixel_scale must be a positive number of radians, "
                         f"got {pixel_scale!r}")
    return grids, w, taper


def wstack_invert(grids, w, pixel_scale: float, taper, device="cuda"):
    """The dirty image: complex64 [L, N, N] w-planes -> float32 [N, N]."""
    if profiler._is_profiler_enabled:
        return trace.call("imaging.wstack", _invert, grids, w, pixel_scale, taper, device, True)
    return _invert(grids, w, pixel_scale, taper, device, False)


def _invert(grids, w, pixel_scale, taper, device, on: bool):
    grids, w, taper = _check(grids, w, pixel_scale, taper)
    device = check_device(device)
    w, taper = trace.to(w, device), trace.to(taper, device)
    layers, n = grids.shape[0], grids.shape[-1]
    image = torch.empty((n, n), dtype=torch.float32, device=device)
    per = planes_per_chunk(layers, n)
    for k0 in range(0, layers, per):  # a chunk's planes go before the next's come
        k1 = min(layers, k0 + per)
        planes = ifft2(grids[k0:k1], device)
        args = (planes, image, w[k0:k1], float(pixel_scale), taper, k0 == 0, k1 == layers)
        if on:
            trace.call("wstack.finalise" if k1 == layers else "wstack.accum", accumulate, *args)
        else:
            accumulate(*args)
        del planes, args
        trace.counts["wstack.layers"] += k1 - k0
    return image
