"""The inverse STFT's overlap-add: the synthesis window, the overlap-add of
the frames and the division by the overlap-added squared window (COLA
normalization), after the c2r of `stft.istft`.

Two implementations of one function on frames [..., num, n_fft] (float32)
and the window w [n_fft], giving [..., L] with L = min(length, t) and
t = (num - 1) * hop + n_fft:

* the plain version (`plain_ola`): torch ops, `frames * w`, an `index_add_`
  of the frames and one of the squared window, and the division by the sum
  clamped at 1e-8. `overlap_add` takes it for CPU frames.
* the kernel (`istft_ola`, `csrc/ola.cu`): one gather pass that reads the
  frames once and writes the signal once, no atomics and no index. It takes
  every CUDA frame tensor; frames that require grad run it inside `_OLA`,
  whose backward is the overlap-add's adjoint (the window is a constant).

The JAX package leaves this step to XLA (watfft_tpu/stft.py, `istft`); no
TPU kernel is replaced.
"""

from __future__ import annotations

import torch

from .. import trace
from . import _build
from .stockham import _wants_grad, check_device

__all__ = ["ola_launch", "overlap_add", "plain_ola", "istft_ola"]


def ola_launch(length: int, hop: int) -> tuple[int, int]:
    """(vec, row) of the kernel's launch for `length` output samples a clip:
    vec = 4 (16-byte loads and stores of 4 samples that share their
    covering frames) where hop % 4 == 0, else 1; row, the samples the
    kernel computes a clip, is `length` rounded up to vec (n_fft is a
    multiple of 4, so with vec = 4 the frames' span is too, and row never
    passes it). The kernel's grid is the C entry's."""
    vec = 4 if hop % 4 == 0 else 1
    return vec, -(-length // vec) * vec


def overlap_add(frames: torch.Tensor, w: torch.Tensor, hop: int, length=None,
                on: bool = False) -> torch.Tensor:
    """`stft.istft`'s tail: the kernel on CUDA frames, the plain version
    (each step in its span where `on`) on CPU frames."""
    if _build.use_kernel(frames):
        return istft_ola(frames, w, hop, length)
    return plain_ola(frames, w, hop, length, on)


def _length(t: int, length) -> int:
    """The samples of `out[..., :length]` for out of t samples."""
    return t if length is None else len(range(t)[:length])


def _index(num: int, n_fft: int, hop: int, device) -> torch.Tensor:
    """The output sample of each frame value, [num * n_fft]."""
    return (torch.arange(num, device=device)[:, None] * hop
            + torch.arange(n_fft, device=device)[None, :]).reshape(-1)


def _norm(w: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """The overlap-added squared window [t]."""
    return w.new_zeros(t).index_add_(0, idx, (w * w).repeat(idx.numel() // w.numel()))


def plain_ola(frames: torch.Tensor, w: torch.Tensor, hop: int, length=None,
              on: bool = False) -> torch.Tensor:
    """The plain version, each step in its span where `on`."""
    if on:
        span = trace.begin("istft.frame_window")
    frames = frames * w  # [..., num, n_fft]
    if on:
        trace.end(span)
        span = trace.begin("istft.overlap_add")
    num, n_fft = frames.shape[-2:]
    t = (num - 1) * hop + n_fft
    batch = frames.shape[:-2]
    idx = _index(num, n_fft, hop, frames.device)
    out = frames.new_zeros(batch + (t,)).index_add_(
        -1, idx, frames.reshape(batch + (num * n_fft,)))
    if on:
        trace.end(span)
        span = trace.begin("istft.norm")
    norm = _norm(w, idx, t)
    if on:
        trace.end(span)
        span = trace.begin("istft.divide")
    out = out / torch.clamp_min(norm, 1e-8)
    if length is not None:
        out = out[..., :length]
    if on:
        trace.end(span)
    return out


class _OLA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, frames, w, hop, length):
        if ctx.needs_input_grad[1]:
            raise ValueError("the overlap-add kernel takes the window as a constant; "
                             "it carries no gradient")
        ctx.save_for_backward(w)
        ctx.hop, ctx.num = hop, frames.shape[-2]
        return _ola(frames, w, hop, length)

    @staticmethod
    def backward(ctx, g):
        # the adjoint of the overlap-add: each frame value takes its
        # sample's g / max(norm, 1e-8), times the window
        w, = ctx.saved_tensors
        n_fft, hop = w.numel(), ctx.hop
        t = (ctx.num - 1) * hop + n_fft
        norm = _norm(w, _index(ctx.num, n_fft, hop, w.device), t)
        g = torch.nn.functional.pad(g, (0, t - g.shape[-1])) / torch.clamp_min(norm, 1e-8)
        return g.unfold(-1, n_fft, hop) * w, None, None, None


def istft_ola(frames: torch.Tensor, w: torch.Tensor, hop: int, length=None) -> torch.Tensor:
    """The kernel on CUDA frames [..., num, n_fft] and the window w [n_fft],
    float32, on one device: [..., L], a view of [..., row] where L is not a
    multiple of 4 and hop is (`ola_launch`). Differentiable in the frames."""
    if _wants_grad(frames, w):
        return _OLA.apply(frames, w, hop, length)
    return _ola(frames, w, hop, length)


def _ola(frames: torch.Tensor, w: torch.Tensor, hop: int, length) -> torch.Tensor:
    if frames.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"the overlap-add kernel takes float32, got {frames.dtype}, {w.dtype}")
    num, n_fft = frames.shape[-2:]
    if w.shape != (n_fft,) or w.device != frames.device:
        raise ValueError(f"window {tuple(w.shape)} on {w.device} for frames "
                         f"{tuple(frames.shape)} on {frames.device}")
    check_device(frames.device)
    t = (num - 1) * hop + n_fft
    batch = frames.shape[:-2]
    length = _length(t, length)
    vec, row = ola_launch(length, hop)
    out = frames.new_empty(batch + (row,))
    if length == 0 or frames.numel() == 0:  # no frame covers a sample: 0, as plain_ola
        return out.zero_()[..., :length]
    clips = frames.numel() // (num * n_fft)
    frames, w = frames.contiguous(), w.contiguous()
    _build.launch("istft_ola", frames.device, "watfft_istft_ola",
                  (frames.data_ptr(), w.data_ptr(), out.data_ptr(), clips, num, n_fft, hop, row,
                   vec), (),
                  lambda: f"n_fft={n_fft}, hop={hop}, frames={num}, clips={clips}, row={row}")
    return out if row == length else out[..., :length]
