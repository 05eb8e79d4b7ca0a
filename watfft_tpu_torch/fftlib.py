"""numpy.fft-style namespace on the port's kernels: the counterpart of
`watfft_tpu/fftlib.py`.

    from watfft_tpu_torch import fftlib as fft
    X = fft.fft(x, axis=-1, norm=None)      # on the CUDA device

The JAX namespace's names, signatures and numpy semantics: fft/ifft/rfft/
irfft/hfft/ihfft with `n` (pad or truncate), `axis` and `norm` (None or
"backward", "ortho", "forward"); fft2/ifft2 with `axes`; fftn/ifftn and
rfft2/irfft2 with `s` and `axes`; fftfreq, rfftfreq, fftshift, ifftshift.
Each takes one more keyword, `device`, "cuda" by default: the input (a
tensor, a numpy array or a list) moves there and the result is a torch
tensor on it, complex64 or float32; with device="cpu" the kernels' plain
versions run. Power-of-two axes run the port's API (`fft`, `ifft`, `rfft`,
`irfft`, `fft2`, `ifft2`, `rfft2`, `irfft2`); every other length runs the
Bluestein transform of ops/bluestein.py, its one-pass kernel up to
n = 2048 and the four-step kernels past that. The real transforms of other
lengths are the complex transform of the real signal (rfft keeps the
n//2+1 non-negative bins) and, for irfft, of the Hermitian extension of
the spectrum, with numpy's rules: the imaginary part of bin 0 is dropped,
and for even n that of the Nyquist bin, while odd n uses its last bin's.
No path calls torch.fft and none falls back to the CPU.

Differences from the JAX namespace, by design:

* A size-1 axis is the identity, as in numpy; the JAX namespace sends it
  to its power-of-two kernels, which raise (ROADMAP C).
* Real transforms of 2 points (rfft / ihfft at n = 2, irfft / hfft to
  n = 2, rfft2 / irfft2 with a last axis of 2) follow numpy: a
  power-of-two n under the real contexts' least n (4) takes the complex
  transform of the real signal, the Stockham kernel at n = 2. The JAX
  namespace raises there (ROADMAP C).
* No host-numpy plumbing and no routing to a library FFT off the TPU
  (`planner.native_backend_fft` there): complex tensors live on the
  device, and any length runs the port's own kernels.

Where the JAX namespace raises for another reason (an invalid `norm`, `s`
and `axes` of different lengths), this one raises the same exception
class.
"""

from __future__ import annotations

import numpy as np
import torch

from . import api
from .ops import bluestein
from .ops.stockham import check_device

__all__ = ["fft", "ifft", "rfft", "irfft", "fft2", "ifft2",
           "fftn", "ifftn", "rfft2", "irfft2", "hfft", "ihfft",
           "fftfreq", "rfftfreq", "fftshift", "ifftshift"]


def _norm_scale(norm, n, direction):
    """Scale to apply on top of our convention (unnormalized fwd, 1/n inv)."""
    if norm in (None, "backward"):
        return 1.0
    if norm == "ortho":
        return (1.0 / np.sqrt(n)) if direction == "fwd" else np.sqrt(n)
    if norm == "forward":
        return (1.0 / n) if direction == "fwd" else float(n)
    raise ValueError(f"invalid norm {norm!r}")


def _scaled(x: torch.Tensor, s) -> torch.Tensor:
    return x * float(s) if s != 1.0 else x


def _tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    """a as a `dtype` tensor on `device` (checked: "cuda" raises without CUDA)."""
    device = check_device(device)
    t = torch.as_tensor(a)
    if t.is_complex() and not dtype.is_complex:
        raise TypeError(f"expected a real input, got {t.dtype}")
    return t.to(device=device, dtype=dtype)


def _fix_len(x: torch.Tensor, n, axis: int):
    """x padded with zeros or truncated to n entries along `axis`."""
    if n is None:
        return x, x.shape[axis]
    if n < 1:
        raise ValueError(f"invalid number of data points ({n}) specified")
    cur = x.shape[axis]
    if n > cur:
        shape = list(x.shape)
        shape[axis] = n - cur
        return torch.cat([x, x.new_zeros(shape)], dim=axis), n
    return x.narrow(axis, 0, n), n


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _real_kernel(n: int) -> bool:
    """n runs the port's real FFT (a power of two its contexts take, >= 4);
    other lengths run the complex transform of the real signal."""
    return n >= 4 and _is_pow2(n)


def _c2c(moved: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The complex transform over the last axis: the port's API for
    power-of-two n >= 2, Bluestein for any other n (n = 1: the identity)."""
    n = moved.shape[-1]
    if n >= 2 and _is_pow2(n):
        return (api.ifft if inverse else api.fft)(moved, device=moved.device)
    return bluestein.bluestein_fft(moved, inverse)


def fft(a, n=None, axis=-1, norm=None, device="cuda"):
    a, n = _fix_len(_tensor(a, device, torch.complex64), n, axis)
    s = _norm_scale(norm, n, "fwd")
    return _scaled(_c2c(a.movedim(axis, -1), False), s).movedim(-1, axis)


def ifft(a, n=None, axis=-1, norm=None, device="cuda"):
    a, n = _fix_len(_tensor(a, device, torch.complex64), n, axis)
    s = _norm_scale(norm, n, "inv")
    return _scaled(_c2c(a.movedim(axis, -1), True), s).movedim(-1, axis)


def rfft(a, n=None, axis=-1, norm=None, device="cuda"):
    a, n = _fix_len(_tensor(a, device, torch.float32), n, axis)
    s = _norm_scale(norm, n, "fwd")
    moved = a.movedim(axis, -1)
    if _real_kernel(n):
        out = api.rfft(moved, device=moved.device)
    else:
        # any other length: the complex transform of the real signal, its
        # non-negative half (numpy's rfft bins)
        out = _c2c(moved.to(torch.complex64), False)[..., :n // 2 + 1]
    return _scaled(out, s).movedim(-1, axis)


def _hermitian_bins(spec: torch.Tensor, n: int) -> torch.Tensor:
    """A copy of the n//2+1 bins of an n-point irfft with numpy's rules
    applied (watfft_tpu/fftlib.py:205-216): the imaginary part of bin 0 is dropped,
    and for even n that of the Nyquist bin; odd n keeps its last bin's."""
    spec = spec.clone()
    spec[..., 0].imag.zero_()
    if n % 2 == 0:
        spec[..., -1].imag.zero_()
    return spec


def _hermitian_full(spec: torch.Tensor, n: int) -> torch.Tensor:
    """The full n-point Hermitian spectrum of the n//2+1 bins: the bins
    (numpy's rules applied), then bins (n-1)//2 .. 1 conjugated."""
    spec = _hermitian_bins(spec, n)
    return torch.cat([spec, spec[..., 1:(n + 1) // 2].flip(-1).conj()], dim=-1)


def irfft(a, n=None, axis=-1, norm=None, device="cuda"):
    a = _tensor(a, device, torch.complex64)
    if n is None:
        n = 2 * (a.shape[axis] - 1)
    if n < 1:
        raise ValueError(f"invalid number of data points ({n}) specified")
    a, _ = _fix_len(a, n // 2 + 1, axis)
    s = _norm_scale(norm, n, "inv")
    moved = a.movedim(axis, -1)
    if _real_kernel(n):
        # the port's kernels read the imaginary parts numpy ignores (the JAX
        # package's composed map), so they are zeroed first
        out = api.irfft(_hermitian_bins(moved, n), device=moved.device)
    else:
        # any other length: the complex inverse of the full spectrum
        out = _c2c(_hermitian_full(moved, n), True).real.contiguous()
    return _scaled(out, s).movedim(-1, axis)


def _fft2(a, axes, norm, device, inverse: bool):
    a = _tensor(a, device, torch.complex64)
    moved = tuple(axes) != (-2, -1)
    if moved:
        a = a.movedim(tuple(axes), (-2, -1))
    if a.dim() >= 2 and all(k >= 2 and _is_pow2(k) for k in a.shape[-2:]):
        out = (api.ifft2 if inverse else api.fft2)(a, device=a.device)
    else:
        # numpy parity for any size: axis by axis through the 1D dispatch
        f = ifft if inverse else fft
        out = f(f(a, axis=-1, device=a.device), axis=-2, device=a.device)
    out = _scaled(out, _norm_scale(norm, out.shape[-1] * out.shape[-2],
                                   "inv" if inverse else "fwd"))
    return out.movedim((-2, -1), tuple(axes)) if moved else out


def fft2(a, axes=(-2, -1), norm=None, device="cuda"):
    return _fft2(a, axes, norm, device, False)


def ifft2(a, axes=(-2, -1), norm=None, device="cuda"):
    return _fft2(a, axes, norm, device, True)


def _resolve_axes(a, s, axes):
    if axes is None:
        axes = (tuple(range(a.dim())) if s is None
                else tuple(range(-len(s), 0)))
    axes = tuple(int(ax) for ax in axes)
    if s is None:
        s = tuple(a.shape[ax] for ax in axes)
    if len(s) != len(axes):
        raise ValueError(f"s and axes length mismatch: {s} vs {axes}")
    return s, axes


def _fftn(a, s, axes, norm, device, inverse: bool):
    """N-D FFT over `axes` (default: all), axis by axis through the 1D
    dispatch (numpy's `s`/`axes` semantics exactly)."""
    a = _tensor(a, device, torch.complex64)
    s, axes = _resolve_axes(a, s, axes)
    f = ifft if inverse else fft
    ntot = 1
    for ax, n in zip(axes, s):
        a = f(a, n=n, axis=ax, device=a.device)
        ntot *= n
    return _scaled(a, _norm_scale(norm, ntot, "inv" if inverse else "fwd"))


def fftn(a, s=None, axes=None, norm=None, device="cuda"):
    return _fftn(a, s, axes, norm, device, False)


def ifftn(a, s=None, axes=None, norm=None, device="cuda"):
    return _fftn(a, s, axes, norm, device, True)


def _is_trailing_pair(axes, ndim):
    ax = tuple(a % ndim for a in axes)
    return ndim >= 2 and ax == (ndim - 2, ndim - 1)


def _fused_2d(s, h: int, w: int) -> bool:
    """The fused half-width 2D path applies: s is the input's own trailing
    power-of-two shape, h >= 2 and w >= 4 (the real contexts' least n)."""
    return tuple(s) == (h, w) and h >= 2 and _is_pow2(h) and w >= 4 and _is_pow2(w)


def rfft2(a, s=None, axes=(-2, -1), norm=None, device="cuda"):
    """2D real FFT: trailing power-of-two axes take the fused half-width
    path (api.rfft2); anything else composes rfft rows and fft columns."""
    a = _tensor(a, device, torch.float32)
    if s is None:
        s = (a.shape[axes[0]], a.shape[axes[1]])
    sc = _norm_scale(norm, s[0] * s[1], "fwd")
    if _is_trailing_pair(axes, a.dim()) and _fused_2d(s, *a.shape[-2:]):
        return _scaled(api.rfft2(a, device=a.device), sc)
    out = rfft(a, n=s[1], axis=axes[1], device=a.device)
    return _scaled(fft(out, n=s[0], axis=axes[0], device=a.device), sc)


def _hermitian_columns(spec: torch.Tensor) -> torch.Tensor:
    """A copy of the half spectrum [..., h, w/2+1] with columns 0 and w/2
    projected onto their Hermitian part along h, (X[k] + conj X[-k]) / 2:
    all numpy's irfft2 keeps of them (the imaginary parts its last-axis
    irfft drops), as `_hermitian_bins` is for 1D. The port's 2D kernels
    read the rest, as the JAX package's do."""
    spec = spec.clone()
    for c in (0, spec.shape[-1] - 1):
        col = spec[..., c]
        mirror = col.flip(-1).roll(1, -1).conj()  # X[(h - k) mod h]
        spec[..., c] = 0.5 * (col + mirror)
    return spec


def irfft2(a, s=None, axes=(-2, -1), norm=None, device="cuda"):
    a = _tensor(a, device, torch.complex64)
    if s is None:
        s = (a.shape[axes[0]], 2 * (a.shape[axes[1]] - 1))
    sc = _norm_scale(norm, s[0] * s[1], "inv")
    if _is_trailing_pair(axes, a.dim()) and _fused_2d(s, a.shape[-2], 2 * (a.shape[-1] - 1)):
        return _scaled(api.irfft2(_hermitian_columns(a), device=a.device), sc)
    out = ifft(a, n=s[0], axis=axes[0], device=a.device)
    return _scaled(irfft(out, n=s[1], axis=axes[1], device=a.device), sc)


def hfft(a, n=None, axis=-1, norm=None, device="cuda"):
    """FFT of a Hermitian-symmetric input -> real output:
    hfft(x, n) = n * irfft(conj(x), n) (numpy's identity)."""
    a = _tensor(a, device, torch.complex64)
    out = irfft(torch.conj_physical(a), n=n, axis=axis, device=a.device)
    nn = out.shape[axis]
    return _scaled(out, float(nn) * _norm_scale(norm, nn, "fwd"))


def ihfft(a, n=None, axis=-1, norm=None, device="cuda"):
    """Inverse of hfft: ihfft(x, n) = conj(rfft(x, n)) / n."""
    a = _tensor(a, device, torch.float32)
    out = rfft(a, n=n, axis=axis, device=a.device)
    nn = a.shape[axis] if n is None else n
    return torch.conj_physical(out) * float((1.0 / nn) * _norm_scale(norm, nn, "inv"))


def _freqs(k: torch.Tensor, n: int, d, device) -> torch.Tensor:
    """numpy's k * (1 / (n d)) in float64, as float32 on `device`."""
    return (k.to(torch.float64) * (1.0 / (n * d))).to(device=check_device(device),
                                                       dtype=torch.float32)


def fftfreq(n, d=1.0, device="cuda"):
    """Sample frequencies of an n-point FFT, numpy's order: 0, 1, ...,
    (n-1)//2, -(n//2), ..., -1, over n*d."""
    return _freqs(torch.cat([torch.arange((n - 1) // 2 + 1), torch.arange(-(n // 2), 0)]),
                  n, d, device)


def rfftfreq(n, d=1.0, device="cuda"):
    """Sample frequencies of an n-point rfft: 0 .. n//2, over n*d."""
    return _freqs(torch.arange(n // 2 + 1), n, d, device)


def _shift(x, axes, device, sign: int) -> torch.Tensor:
    x = torch.as_tensor(x, device=check_device(device))
    if axes is None:
        axes = tuple(range(x.dim()))
    elif isinstance(axes, (int, np.integer)):
        axes = (int(axes),)
    if not axes:
        return x.clone()
    return torch.roll(x, tuple(sign * (x.shape[ax] // 2) for ax in axes), tuple(axes))


def fftshift(x, axes=None, device="cuda"):
    """The zero-frequency term moved to the middle: a roll by n//2 along
    each of `axes` (default: all)."""
    return _shift(x, axes, device, 1)


def ifftshift(x, axes=None, device="cuda"):
    """The inverse of fftshift: a roll by -(n//2) along each of `axes`."""
    return _shift(x, axes, device, -1)
