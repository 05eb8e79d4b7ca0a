"""The difference map's four passes over diffraction frames (`ptycho.py`
runs them): for frames j at integer offsets (r_j, c_j) into the object O
[H, W], the probe P [M, M] and the view O_j[y, x] = O[r_j + y, c_j + x],

    exit     t_j = 2 phi_j - psi_j, phi_j = P O_j
    fourier  F_j <- a_j F_j / |F_j| (a_j where |F_j| = 0), in place;
             err_j = mean over pixels of (|F_j| - a_j)^2
    update   out_j = (psi_j + b_j) - phi_j, b_j the inverse transform of
             the projected F_j; and at each view pixel conj(P) out_j and
             |P|^2 added into the object's sums
    probe    conj(O_j) psi_j and |O_j|^2 summed over the frames into the
             probe's sums

Complex arrays are complex64; the magnitudes a and err float32; the
positions int32 [frames, 2] (row, column); the sums float32 [H, W, 4] and
[M, M, 4]: the numerator's real and imaginary parts, the denominator, and
a lane left 0 (the kernel adds a pixel's three sums with one 16-byte
atomic).

A view that does not lie inside the object is never read or written by a
kernel: exit, update and probe check each position against the object's
height and width on the device, skip such a frame and set a flag; with
`check=True` (the default) the wrapper reads the flag after the launch
(one synchronize) and raises. `ptycho.dm_iterate` checks its positions on
the host first and passes `check=False`. The plain versions index the
object as the positions say.

Two implementations of each pass:

* the plain version (`plain_exit`, ...): torch ops on the frames, the
  views gathered by index, the sums by `index_add_`; each complex product
  written out in real ops in the kernel's order, so exit, the projection
  and out_j are the kernel's bits. The dispatchers (`exit_waves`,
  `fourier_project`, `update`, `probe_sums`) take it for CPU frames.
* the kernels (`exit_kernel`, ..., `csrc/ptycho.cu`): one streaming pass
  each, every load in flight before the arithmetic; the object's and the
  probe's sums by atomics (their order, and so their last bits, vary from
  run to run); err by a block a frame in a fixed order.

Nothing here is differentiable. The JAX package has no ptychography; no
TPU kernel is replaced.
"""

from __future__ import annotations

import torch

from . import _build
from .stockham import check_device

__all__ = ["exit_waves", "fourier_project", "update", "probe_sums", "plain_exit",
           "plain_fourier", "plain_update", "plain_probe", "exit_kernel", "fourier_kernel",
           "update_kernel", "probe_kernel", "views"]


def exit_waves(psi, obj, probe, pos, check=True) -> torch.Tensor:
    """t = 2 P O_j - psi for the frames psi [F, M, M]: the kernel on CUDA
    frames, the plain version on CPU frames."""
    if _build.use_kernel(psi):
        return exit_kernel(psi, obj, probe, pos, check)
    return plain_exit(psi, obj, probe, pos)


def fourier_project(f, amp, err) -> None:
    """Projects the transformed frames f [F, M, M] onto the magnitudes amp
    in place and writes err [F]."""
    if _build.use_kernel(f):
        fourier_kernel(f, amp, err)
    else:
        plain_fourier(f, amp, err)


def update(psi, back, obj, probe, pos, out, sums, check=True) -> None:
    """out = (psi + back) - P O_j (out may be psi) and the object's sums
    [H, W, 4] += (conj(P) out, |P|^2) at each view pixel."""
    if _build.use_kernel(psi):
        update_kernel(psi, back, obj, probe, pos, out, sums, check)
    else:
        plain_update(psi, back, obj, probe, pos, out, sums)


def probe_sums(psi, obj, pos, sums, check=True) -> None:
    """The probe's sums [M, M, 4] += (sum_j conj(O_j) psi_j, sum_j |O_j|^2)
    over the frames psi [J, M, M]."""
    if _build.use_kernel(psi):
        probe_kernel(psi, obj, pos, sums, check)
    else:
        plain_probe(psi, obj, pos, sums)


# -- the plain versions ------------------------------------------------------------------

def _index(pos, m: int, width: int) -> torch.Tensor:
    """The object's flat index of every view pixel, int64 [F, M, M]."""
    k = torch.arange(m, device=pos.device)
    rows = (pos[:, 0].long()[:, None] + k)[:, :, None]
    cols = (pos[:, 1].long()[:, None] + k)[:, None, :]
    return rows * width + cols


def views(obj, pos, m: int) -> torch.Tensor:
    """O_j for each position, complex [F, M, M] (a copy)."""
    return obj.reshape(-1)[_index(pos, m, obj.shape[-1])]


def _mul(ar, ai, br, bi):
    """(ar + i ai)(br + i bi) as (re, im), each product rounded."""
    return ar * br - ai * bi, ar * bi + ai * br


def _mulc(ar, ai, br, bi):
    """conj(ar + i ai)(br + i bi) as (re, im), each product rounded."""
    return ar * br + ai * bi, ar * bi - ai * br


def _phi(obj, probe, pos):
    o = views(obj, pos, probe.shape[-1])
    return _mul(probe.real, probe.imag, o.real, o.imag)


def plain_exit(psi, obj, probe, pos) -> torch.Tensor:
    pr, pi = _phi(obj, probe, pos)
    return torch.complex(2 * pr - psi.real, 2 * pi - psi.imag)


def plain_fourier(f, amp, err) -> None:
    re, im = f.real, f.imag
    # the square root in float64, rounded: the correctly rounded float32
    # root the kernel takes (torch's float32 sqrt on the host may be 1 ulp off)
    mag = torch.sqrt((re * re + im * im).double()).float()
    err.copy_(((mag - amp) ** 2).sum((-2, -1)) / (amp.shape[-1] * amp.shape[-2]))
    s = amp / mag
    f.copy_(torch.where(mag > 0, torch.complex(re * s, im * s), torch.complex(amp, 0 * amp)))


def plain_update(psi, back, obj, probe, pos, out, sums) -> None:
    pr, pi = _phi(obj, probe, pos)
    nr = (psi.real + back.real) - pr
    ni = (psi.imag + back.imag) - pi
    out.copy_(torch.complex(nr, ni))
    cr, ci = _mulc(probe.real, probe.imag, nr, ni)
    d = (probe.real * probe.real + probe.imag * probe.imag).expand_as(nr)
    flat = sums.view(-1, 4)
    flat.index_add_(0, _index(pos, probe.shape[-1], obj.shape[-1]).reshape(-1),
                    torch.stack((cr, ci, d, torch.zeros_like(d)), -1).reshape(-1, 4))


def plain_probe(psi, obj, pos, sums) -> None:
    o = views(obj, pos, psi.shape[-1])
    cr, ci = _mulc(o.real, o.imag, psi.real, psi.imag)
    d = o.real * o.real + o.imag * o.imag
    sums += torch.stack((cr.sum(0), ci.sum(0), d.sum(0), torch.zeros_like(d[0])), -1)


# -- the kernels ----------------------------------------------------------------------------

def _frames(name, t, dtype, frames=None):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 3 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"{name} must be [frames, M, M], got shape {tuple(t.shape)}")
    if frames is not None and t.shape != frames:
        raise ValueError(f"{name} {tuple(t.shape)} for frames {tuple(frames)}")


def _common(psi, obj, probe, pos, *more):
    """The kernels' checks of what every pass shares; returns (frames, M)."""
    _frames("the frames", psi, torch.complex64)
    frames, m = psi.shape[0], psi.shape[-1]
    if obj.dtype != torch.complex64 or obj.dim() != 2 or min(obj.shape) < m:
        raise ValueError(f"the object must be complex64 [H, W] with H, W >= {m}, got "
                         f"{obj.dtype} {tuple(obj.shape)}")
    if not obj.is_contiguous():
        raise ValueError("the object must be contiguous")
    if probe is not None and (probe.dtype != torch.complex64 or probe.shape != (m, m)):
        raise ValueError(f"the probe must be complex64 [{m}, {m}], got {probe.dtype} "
                         f"{tuple(probe.shape)}")
    if pos.dtype != torch.int32 or pos.shape != (frames, 2):
        raise ValueError(f"the positions must be int32 [{frames}, 2], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if not pos.is_contiguous() or pos.data_ptr() % 8:
        raise ValueError("the positions must be contiguous and 8-byte aligned")
    tensors = [t for t in (obj, probe, pos, *more) if t is not None]  # no probe: its sums
    if any(t.device != psi.device for t in tensors):
        raise ValueError(f"every array on the frames' device {psi.device}, got "
                         f"{[str(t.device) for t in tensors]}")
    check_device(psi.device)
    return frames, m


def _sums(sums, shape):
    if sums.dtype != torch.float32 or sums.shape != shape or not sums.is_contiguous():
        raise ValueError(f"the sums must be contiguous float32 {list(shape)}, got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    if sums.data_ptr() % 16:
        raise ValueError("the sums must be 16-byte aligned")


def _flag(check: bool, device):
    """The kernel's flag for a view outside the object: an int32 [1] of 0
    with `check`, else none (a null pointer: the kernel skips such a frame
    all the same)."""
    return torch.zeros(1, dtype=torch.int32, device=device) if check else None


def _address(bad) -> int:
    return 0 if bad is None else bad.data_ptr()


def _raise_if_flagged(bad, obj, m: int) -> None:
    if bad is not None and bad.item():
        raise ValueError(f"every M x M view must lie inside the object {list(obj.shape)} at "
                         f"M = {m}: a position puts one outside it (its frame was skipped)")


def exit_kernel(psi, obj, probe, pos, check=True) -> torch.Tensor:
    frames, m = _common(psi, obj, probe, pos)
    psi, probe = psi.contiguous(), probe.contiguous()
    t = torch.empty_like(psi)
    bad = _flag(check, psi.device)
    _build.launch("ptycho_exit", psi.device, "watfft_ptycho_exit",
                  (psi.data_ptr(), obj.data_ptr(), probe.data_ptr(), pos.data_ptr(),
                   t.data_ptr(), _address(bad), frames, m, *obj.shape), (),
                  lambda: f"frames={frames}, m={m}, object={tuple(obj.shape)}")
    _raise_if_flagged(bad, obj, m)
    return t


def fourier_kernel(f, amp, err) -> None:
    _frames("the transformed frames", f, torch.complex64)
    _frames("the magnitudes", amp, torch.float32, f.shape)
    frames, m = f.shape[0], f.shape[-1]
    if err.dtype != torch.float32 or err.shape != (frames,) or not err.is_contiguous():
        raise ValueError(f"err must be contiguous float32 [{frames}], got {err.dtype} "
                         f"{tuple(err.shape)}")
    if not f.is_contiguous():
        raise ValueError("the transformed frames must be contiguous (projected in place)")
    if amp.device != f.device or err.device != f.device:
        raise ValueError(f"magnitudes on {amp.device}, err on {err.device}, frames on {f.device}")
    check_device(f.device)
    amp = amp.contiguous()
    _build.launch("ptycho_fourier", f.device, "watfft_ptycho_fourier",
                  (f.data_ptr(), amp.data_ptr(), err.data_ptr(), frames, m), (),
                  lambda: f"frames={frames}, m={m}")


def update_kernel(psi, back, obj, probe, pos, out, sums, check=True) -> None:
    frames, m = _common(psi, obj, probe, pos, back, out, sums)
    _frames("the inverse transforms", back, torch.complex64, psi.shape)
    _frames("out", out, torch.complex64, psi.shape)
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    _sums(sums, (*obj.shape, 4))
    psi, back, probe = psi.contiguous(), back.contiguous(), probe.contiguous()
    bad = _flag(check, psi.device)
    _build.launch("ptycho_update", psi.device, "watfft_ptycho_update",
                  (psi.data_ptr(), back.data_ptr(), obj.data_ptr(), probe.data_ptr(),
                   pos.data_ptr(), out.data_ptr(), sums.data_ptr(), _address(bad), frames, m,
                   *obj.shape),
                  (), lambda: f"frames={frames}, m={m}, object={tuple(obj.shape)}")
    _raise_if_flagged(bad, obj, m)


def probe_kernel(psi, obj, pos, sums, check=True) -> None:
    frames, m = _common(psi, obj, None, pos, sums)
    _sums(sums, (m, m, 4))
    psi = psi.contiguous()
    bad = _flag(check, psi.device)
    _build.launch("ptycho_probe", psi.device, "watfft_ptycho_probe",
                  (psi.data_ptr(), obj.data_ptr(), pos.data_ptr(), sums.data_ptr(),
                   _address(bad), frames, m, *obj.shape), (),
                  lambda: f"frames={frames}, m={m}, object={tuple(obj.shape)}")
    _raise_if_flagged(bad, obj, m)
