"""STFT / spectrogram pipeline on the port's real FFT.

Counterpart of `watfft_tpu/stft.py`, with the same signatures and outputs
as the JAX package off the TPU (watfft_tpu/stft.py:69-82): `stft` returns
re and im planes [..., frames, n_fft//2+1]. Every transform goes through
`RFFTContext` and so through the port's real-FFT kernels. Framing
(`Tensor.unfold`), windowing and the overlap-add of `istft` (`index_add_`)
are plain torch, as the JAX package leaves them to XLA. `device` is "cuda"
by default; the kernels' plain versions run only for `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import profiler

from . import trace
from .api import RFFTContext, _ctx as _api_ctx
from .plan import is_power_of_two

__all__ = ["get_window", "frame", "stft", "istft", "spectrogram",
           "mel_filterbank", "fftconvolve"]


def _check_stft_args(n_fft: int, hop: int, t: int | None = None) -> None:
    if not isinstance(n_fft, (int, np.integer)) or not is_power_of_two(int(n_fft)) or n_fft < 4:
        raise ValueError(f"n_fft must be a power of two >= 4, got {n_fft!r}")
    if not isinstance(hop, (int, np.integer)) or hop < 1:
        raise ValueError(f"hop must be a positive integer, got {hop!r}")
    if t is not None and t < n_fft:
        raise ValueError(
            f"signal length {t} is shorter than n_fft={n_fft}: no full frame")


def get_window(name: str, n: int, dtype=np.float32) -> np.ndarray:
    """Analysis windows, periodic (DFT-even), f64 host math: the code of
    watfft_tpu/stft.py:34-53."""
    t = np.arange(n) / n
    if name in ("rect", "rectangular", "boxcar"):
        w = np.ones(n)
    elif name == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * t)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * t)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * t)
             + 0.08 * np.cos(4 * np.pi * t))
    elif name == "blackman-harris":
        w = (0.35875 - 0.48829 * np.cos(2 * np.pi * t)
             + 0.14128 * np.cos(4 * np.pi * t)
             - 0.01168 * np.cos(6 * np.pi * t))
    else:
        raise ValueError(f"unknown window {name!r}")
    return w.astype(dtype)


def frame(x, frame_length: int, hop: int) -> torch.Tensor:
    """[..., t] -> [..., num_frames, frame_length] sliding frames, a view
    of x (no copy); no frame when t < frame_length."""
    x = torch.as_tensor(x)
    if x.shape[-1] < frame_length:
        return x.new_empty(x.shape[:-1] + (0, frame_length))
    return x.unfold(-1, frame_length, hop)


def _window(window: str, n_fft: int, device) -> torch.Tensor:
    trace.counts["tables_built"] += 1
    return trace.h2d(get_window(window, n_fft), device)


# stft and istft run inside their root spans while tracing (`trace`), each
# step inside a span of its own where `on`.

def stft(x, n_fft: int = 1024, hop: int = 256, window: str = "hann", device="cuda"):
    """Batched STFT: real [..., t] -> (re, im) planes [..., frames, n_fft//2+1]."""
    if profiler._is_profiler_enabled:
        return trace.call("stft.stft", _stft, x, n_fft, hop, window, device, True)
    return _stft(x, n_fft, hop, window, device, False)


def _stft(x, n_fft: int, hop: int, window: str, device, on: bool):
    x = torch.as_tensor(x)
    _check_stft_args(n_fft, hop, x.shape[-1])
    ctx = _ctx(n_fft, device)
    x = trace.to(x, ctx.device, torch.float32)
    if on:
        span = trace.begin("stft.window")
    w = _window(window, n_fft, ctx.device)
    if on:
        trace.end(span)
        span = trace.begin("stft.frame")
    frames = frame(x, n_fft, hop) * w
    if on:
        trace.end(span)
    return ctx.forward_planes(frames)


def istft(sre, sim, n_fft: int = 1024, hop: int = 256, window: str = "hann",
          length: int | None = None, device="cuda"):
    """Inverse STFT with windowed overlap-add (COLA normalization): planes
    [..., frames, n_fft//2+1] -> real [..., (frames-1)*hop + n_fft], cut to
    `length` if given."""
    if profiler._is_profiler_enabled:
        return trace.call("stft.istft", _istft, sre, sim, n_fft, hop, window, length, device,
                          True)
    return _istft(sre, sim, n_fft, hop, window, length, device, False)


def _istft(sre, sim, n_fft: int, hop: int, window: str, length, device, on: bool):
    _check_stft_args(n_fft, hop)
    ctx = _ctx(n_fft, device)
    if on:
        span = trace.begin("istft.window")
    w = _window(window, n_fft, ctx.device)
    if on:
        trace.end(span)
    frames = ctx.inverse_planes(sre, sim)
    if on:
        span = trace.begin("istft.frame_window")
    frames = frames * w  # [..., num, n_fft]
    if on:
        trace.end(span)
        span = trace.begin("istft.overlap_add")
    num = frames.shape[-2]
    t = (num - 1) * hop + n_fft
    batch = frames.shape[:-2]
    idx = (torch.arange(num, device=ctx.device)[:, None] * hop
           + torch.arange(n_fft, device=ctx.device)[None, :]).reshape(-1)
    out = frames.new_zeros(batch + (t,)).index_add_(
        -1, idx, frames.reshape(batch + (num * n_fft,)))
    if on:
        trace.end(span)
        span = trace.begin("istft.norm")
    norm = frames.new_zeros(t).index_add_(0, idx, (w * w).repeat(num))
    if on:
        trace.end(span)
        span = trace.begin("istft.divide")
    out = out / torch.clamp_min(norm, 1e-8)
    if length is not None:
        out = out[..., :length]
    if on:
        trace.end(span)
    return out


def spectrogram(x, n_fft: int = 1024, hop: int = 256, window: str = "hann",
                log: bool = True, eps: float = 1e-10, device="cuda"):
    """Power spectrogram [..., frames, bins]; log-magnitude by default."""
    re, im = stft(x, n_fft=n_fft, hop=hop, window=window, device=device)
    p = re * re + im * im
    return torch.log(p + eps) if log else p


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: float,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular mel filters, host-built in f64: the
    code of watfft_tpu/stft.py:175-194."""
    fmax = fmax or sample_rate / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        a, b, c = bins[i], bins[i + 1], bins[i + 2]
        if b > a:
            fb[i, a:b] = (np.arange(a, b) - a) / (b - a)
        if c > b:
            fb[i, b:c] = (c - np.arange(b, c)) / (c - b)
    return fb.astype(np.float32)


def fftconvolve(x, h, mode: str = "full", device="cuda"):
    """FFT-based linear convolution of real signals along the last axis.

    Both inputs are zero-padded to the next power of two >= t + k - 1 (at
    least 4), so the product runs one real FFT each, a spectrum multiply and
    one inverse. Leading axes broadcast. mode: 'full' (t + k - 1 samples),
    'same' (t, centered like np.convolve), 'valid' (t - k + 1, t >= k)."""
    x, h = torch.as_tensor(x), torch.as_tensor(h)
    t, k = x.shape[-1], h.shape[-1]
    if t < 1 or k < 1:
        raise ValueError(f"empty operand: x[-1]={t}, h[-1]={k}")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "valid" and t < k:
        raise ValueError(f"mode 'valid' requires len(x) >= len(h), "
                         f"got {t} < {k}")
    ln = t + k - 1
    m = max(4, 1 << (ln - 1).bit_length())
    ctx = _ctx(m, device)
    xp = torch.nn.functional.pad(x.to(ctx.device, torch.float32), (0, m - t))
    hp = torch.nn.functional.pad(h.to(ctx.device, torch.float32), (0, m - k))
    xre, xim = ctx.forward_planes(xp)
    hre, him = ctx.forward_planes(hp)
    yre = xre * hre - xim * him
    yim = xre * him + xim * hre
    y = ctx.inverse_planes(yre, yim)[..., :ln]
    if mode == "full":
        return y
    if mode == "same":
        start = (k - 1) // 2
        return y[..., start:start + t]
    return y[..., k - 1:t]


def _ctx(n_fft: int, device) -> RFFTContext:
    return _api_ctx(RFFTContext, n_fft, device)
