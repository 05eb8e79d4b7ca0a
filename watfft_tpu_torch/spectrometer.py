"""Fine-channel spectrometer: integrated total-power spectra of 8-bit
complex voltages, as radio telescopes' GPU spectrometers make them
(Breakthrough Listen's rawspec; Lebofsky et al. 2019, PASP 131:124505).

`integrate(volts, nfft, nint)` takes int8 voltages [chans, t, pols, 2] in
GUPPI RAW order (each coarse channel's samples in time order, each sample's
polarisations, each a (re, im) pair) and returns float32 [chans,
t // (nfft * nint), nfft]: for each coarse channel and each run of `nint`
consecutive `nfft`-sample spectra, the power |X|^2 summed over the
polarisations and over the `nint` spectra, the fine channels in ascending
frequency (`numpy.fft.fftshift`'s order: the DC bin at nfft / 2).

Every transform goes through the cached f32 `FFTContext` of `nfft`, so the
planner picks the route (the four-step pipe2 kernels at nfft = 2^20). The
power is detected and summed into a float32 accumulator by one kernel a
chunk (`spec.detect`, `ops/detect.py`); the other steps around the
transform are torch ops: unpacking the int8 pairs into complex64
(`spec.unpack`), the accumulator's zeroing and the shift (`spec.shift`).
`device` is "cuda" by default; `device="cpu"` runs the kernels' plain
versions. Input on the host moves to the device a chunk at a time. The
input is integer, so nothing here is differentiable.

Chunks: the spectra run in chunks of consecutive spectra of every channel
and polarisation (`spectra_per_chunk`): the largest divisor of `nint` whose
spectra of every stream fit in `CHUNK_POINTS` complex points, and at least
one spectrum of each stream. A chunk so lies inside one integration and
adds into one row of the accumulator. The workspace is a few chunks of
complex64: at 64 channels, 2 polarisations and nfft = 2^20 one chunk is
one spectrum of all 128 streams, 1 GiB.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import profiler

from . import trace
from .api import FFTContext, _ctx as _api_ctx
from .ops.detect import detect
from .plan import is_power_of_two

__all__ = ["CHUNK_POINTS", "spectra_per_chunk", "integrate"]

CHUNK_POINTS = 1 << 27


def spectra_per_chunk(streams: int, nfft: int, nint: int) -> int:
    """Consecutive spectra a chunk holds, of `streams` channels times
    polarisations: the largest divisor of nint whose spectra CHUNK_POINTS
    holds, at least 1."""
    budget = max(1, CHUNK_POINTS // (streams * nfft))
    return max(d for d in range(1, min(budget, nint) + 1) if nint % d == 0)


def _check(volts: torch.Tensor, nfft, nint) -> None:
    if volts.dtype != torch.int8:
        raise TypeError(f"volts must be int8 samples, got {volts.dtype}")
    if volts.dim() != 4 or volts.shape[-1] != 2:
        raise ValueError(f"volts must be [chans, t, pols, 2] (GUPPI RAW order), "
                         f"got shape {tuple(volts.shape)}")
    if not isinstance(nfft, (int, np.integer)) or not is_power_of_two(int(nfft)) or nfft < 2:
        raise ValueError(f"nfft must be a power of two >= 2, got {nfft!r}")
    if not isinstance(nint, (int, np.integer)) or nint < 1:
        raise ValueError(f"nint must be a positive integer, got {nint!r}")
    t = volts.shape[1]
    if t == 0 or t % (nfft * nint):
        raise ValueError(f"t = {t} samples is not a positive multiple of "
                         f"nfft * nint = {nfft * nint}")


def integrate(volts, nfft: int, nint: int, device="cuda"):
    """Integrated total power: int8 [chans, t, pols, 2] -> float32 [chans,
    t // (nfft * nint), nfft], fftshifted."""
    if profiler._is_profiler_enabled:
        return trace.call("spectrometer.integrate", _integrate, volts, nfft, nint, device,
                          True)
    return _integrate(volts, nfft, nint, device, False)


# integrate runs inside its root span while tracing (`trace`), each step
# inside a span of its own where `on`; the transforms' spans nest in the root.

def _step(on: bool, name: str, fn, *args):
    return trace.call(name, fn, *args) if on else fn(*args)


def _integrate(volts, nfft: int, nint: int, device, on: bool):
    volts = torch.as_tensor(volts)
    _check(volts, nfft, nint)
    nfft, nint = int(nfft), int(nint)
    chans, t, pols, _ = volts.shape
    ctx = _api_ctx(FFTContext, nfft, device)
    nout = t // (nfft * nint)
    per = spectra_per_chunk(chans * pols, nfft, nint)
    acc = _step(on, "spec.detect", _zeros, (chans, nout, nfft), ctx.device)
    for j0 in range(0, nout * nint, per):  # a chunk's buffers go before the next's come
        z = _step(on, "spec.unpack", _unpack, volts, j0, per, nfft, ctx.device)
        x = ctx.forward(z)
        del z
        _step(on, "spec.detect", detect, x, acc[:, j0 // nint])
        del x
        trace.counts["spec.spectra"] += chans * pols * per
    return _step(on, "spec.shift", torch.roll, acc, nfft // 2, -1)


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _unpack(volts, j0: int, per: int, nfft: int, device) -> torch.Tensor:
    """Spectra j0 .. j0+per-1 of every stream as complex64 [chans, pols,
    per, nfft]."""
    chans, _, pols, _ = volts.shape
    v = trace.to(volts[:, j0 * nfft:(j0 + per) * nfft], device)
    z = torch.empty((chans, pols, per, nfft, 2), dtype=torch.float32, device=device)
    z.copy_(v.view(chans, per, nfft, pols, 2).permute(0, 3, 1, 2, 4))
    return torch.view_as_complex(z)

