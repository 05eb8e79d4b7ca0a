"""Ptychographic reconstruction: one iteration of the difference map
(Thibault, Dierolf, Bunk, Menzel and Pfeiffer 2009, "Probe retrieval in
ptychographic coherent diffractive imaging", Ultramicroscopy 109:338; the
`DM` engine of PtyPy, Enders and Thibault 2016, Proc. R. Soc. A
472:20160640) at beta = 1.

For frames j = 0..J-1 at integer pixel offsets (r_j, c_j) into the object
O, complex64 [H, W], the probe P, complex64 [M, M], the exit waves psi_j,
complex64 [M, M], and the measured magnitudes a_j = sqrt(I_j), float32
[M, M] in the transform's own order (zero frequency at index 0), with the
view O_j[y, x] = O[r_j + y, c_j + x], F numpy's fft2 and F^-1 its ifft2:

1. for every j, with the old O and P: phi_j = P O_j; Psi_j = F(2 phi_j -
   psi_j); Psi'_j = a_j Psi_j / |Psi_j| (a_j where |Psi_j| = 0); err_j =
   mean over pixels of (|Psi_j| - a_j)^2; psi_j <- psi_j + F^-1(Psi'_j) -
   phi_j;
2. the object, from the new psi and the old P, with S_j placing an M x M
   array at (r_j, c_j): D_O = sum_j S_j |P|^2, O <- (c_O O + sum_j S_j
   conj(P) psi_j) / (c_O + D_O), c_O = OBJECT_INERTIA mean(D_O) over the
   scanned field (the rectangle the views span);
3. the probe, from the new O: D_P = sum_j |O_j|^2, P <- (c_P P + sum_j
   conj(O_j) psi_j) / (c_P + D_P), c_P = PROBE_INERTIA mean(D_P).

Where this departs from PtyPy's DM: one object and one probe update an
iteration (PtyPy alternates them up to `overlap_max_iterations` times), no
Fourier power bound (`fourier_relax_factor` 0), one probe mode,
integer-pixel views.

`dm_iterate(exits, obj, probe, fmag, positions, out=None, device="cuda")`
returns (exits_new, obj_new, probe_new, err), err float32 [J]. `out`,
complex64 [J, M, M] on the device, receives the new exit waves: `out=exits`
is the in-place form; with any other `out` (or none) `exits`, `obj` and
`probe` are left as they were. M is a power of two with M^2 <= the cube's
`planner.CUBE_MAX_N`; positions are int32 [J, 2] (row, column), any
pattern, each view inside the object. Each call checks the positions on
the host (on a card, one synchronize) before anything is written; the
kernels also skip a view outside the object on their own
(`ops/ptycho.py`).

The frames go in chunks of CHUNK_POINTS points (1024 frames of 128^2):
each chunk's exit waves (one kernel), their forward transform through the
public `api.fft2` (the planner's route: at 1024 x 128^2 the cube, #15),
the projection (one kernel), the inverse through `api.ifft2` and the
update with the object's sums (one kernel), all before the next chunk
begins, so the temporaries are a few chunks' size. Then the object's
division (torch ops), the probe's sums over every frame (one kernel) and
its division. Nothing calls `torch.fft`. `device="cpu"` runs the plain
versions; frames and magnitudes on the host move to the device a chunk at
a time. Nothing here is differentiable.

While a profiler runs, the call is the root span `ptycho.dm`, each chunk's
passes its `ptycho.exit`, `api.fft2`, `ptycho.fourier`, `api.ifft2` and
`ptycho.update` spans, then `ptycho.object` and `ptycho.probe`;
`trace.counts["ptycho.frames"]` counts the frames projected.
"""

from __future__ import annotations

import torch
from torch.autograd import profiler

from . import planner, trace
from .api import fft2, ifft2
from .ops import ptycho as ops
from .ops.stockham import check_device
from .plan import is_power_of_two

__all__ = ["CHUNK_POINTS", "OBJECT_INERTIA", "PROBE_INERTIA", "frames_per_chunk",
           "dm_iterate"]

CHUNK_POINTS = 1 << 24  # [1024, 128, 128]: 128 MiB of complex64 a temporary
OBJECT_INERTIA = 1e-4   # PtyPy's object_inertia
PROBE_INERTIA = 1e-9    # PtyPy's probe_inertia


def frames_per_chunk(frames: int, m: int) -> int:
    """Frames a chunk holds: as many M x M frames as CHUNK_POINTS holds, at
    least 1, at most `frames`."""
    return max(1, min(frames, CHUNK_POINTS // (m * m)))


def dm_iterate(exits, obj, probe, fmag, positions, out=None, device="cuda"):
    """One difference-map iteration: (exits_new, obj_new, probe_new, err)."""
    if profiler._is_profiler_enabled:
        return trace.call("ptycho.dm", _iterate, exits, obj, probe, fmag, positions, out,
                          device, True)
    return _iterate(exits, obj, probe, fmag, positions, out, device, False)


def _check(exits, obj, probe, fmag, positions):
    exits, obj, probe, fmag, positions = (torch.as_tensor(t).detach()
                                          for t in (exits, obj, probe, fmag, positions))
    for name, t, dtype in (("exits", exits, torch.complex64), ("obj", obj, torch.complex64),
                           ("probe", probe, torch.complex64), ("fmag", fmag, torch.float32),
                           ("positions", positions, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if exits.dim() != 3 or exits.shape[0] < 1 or exits.shape[1] != exits.shape[2]:
        raise ValueError(f"exits must be [J, M, M] with J >= 1, got shape {tuple(exits.shape)}")
    frames, m = exits.shape[0], exits.shape[-1]
    if not is_power_of_two(m) or m < 2 or m * m > planner.CUBE_MAX_N:
        raise ValueError(f"the frame's side M must be a power of two >= 2 with M^2 <= "
                         f"{planner.CUBE_MAX_N}, got {m}")
    if probe.shape != (m, m):
        raise ValueError(f"probe must be [M, M] = [{m}, {m}], got shape {tuple(probe.shape)}")
    if fmag.shape != exits.shape:
        raise ValueError(f"fmag must be [J, M, M] = {list(exits.shape)}, got shape "
                         f"{tuple(fmag.shape)}")
    if obj.dim() != 2 or min(obj.shape) < m:
        raise ValueError(f"obj must be [H, W] with H, W >= M = {m}, got shape "
                         f"{tuple(obj.shape)}")
    if positions.shape != (frames, 2):
        raise ValueError(f"positions must be [J, 2] = [{frames}, 2], got shape "
                         f"{tuple(positions.shape)}")
    return exits, obj, probe, fmag, positions


def _positions(positions, shape, m: int, device) -> tuple[torch.Tensor, int]:
    """The positions, contiguous on `device`, and the area of the scanned
    field, the rectangle the views span; raises unless every view lies
    inside the object."""
    span = torch.cat((positions.min(0).values, positions.max(0).values)).tolist()
    lo, hi = span[:2], span[2:]
    if min(lo) < 0 or hi[0] + m > shape[0] or hi[1] + m > shape[1]:
        raise ValueError(f"every M x M view must lie inside the object {list(shape)}: the "
                         f"positions span rows {lo[0]}..{hi[0]} and columns {lo[1]}..{hi[1]} "
                         f"at M = {m}")
    pos = trace.to(positions, device).contiguous()
    if pos.data_ptr() % 8:
        pos = pos.clone()
    return pos, (hi[0] - lo[0] + m) * (hi[1] - lo[1] + m)


def _step(on: bool, name: str, fn, *args):
    return trace.call(name, fn, *args) if on else fn(*args)


def _divide(x, sums, inertia):
    """(c x + numerator) / (c + denominator), c = inertia: the division that
    ends the object's and the probe's update."""
    num = torch.view_as_complex(sums[..., :2])
    return (x * inertia + num) / (sums[..., 2] + inertia)


def _probe(psi, obj, pos, probe):
    sums = torch.zeros((*probe.shape, 4), dtype=torch.float32, device=probe.device)
    ops.probe_sums(psi, obj, pos, sums, False)
    return _divide(probe, sums, PROBE_INERTIA * sums[..., 2].mean())


def _iterate(exits, obj, probe, fmag, positions, out, device, on: bool):
    exits, obj, probe, fmag, positions = _check(exits, obj, probe, fmag, positions)
    device = check_device(device)
    frames, m = exits.shape[0], exits.shape[-1]
    pos, area = _positions(positions, obj.shape, m, device)
    obj = trace.to(obj, device).contiguous()
    probe = trace.to(probe, device).contiguous()
    if out is None:
        out = torch.empty(exits.shape, dtype=torch.complex64, device=device)
    elif (not isinstance(out, torch.Tensor) or out.dtype != torch.complex64
          or out.shape != exits.shape or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous complex64 {list(exits.shape)} tensor on "
                         f"{device}")
    err = torch.empty(frames, dtype=torch.float32, device=device)
    sums = torch.zeros((*obj.shape, 4), dtype=torch.float32, device=device)
    per = frames_per_chunk(frames, m)
    for j0 in range(0, frames, per):  # a chunk's passes run before the next chunk's
        j1 = min(frames, j0 + per)
        psi = trace.to(exits[j0:j1], device)
        p = pos[j0:j1]
        t = _step(on, "ptycho.exit", ops.exit_waves, psi, obj, probe, p, False)
        f = fft2(t, device)
        del t
        _step(on, "ptycho.fourier", ops.fourier_project, f, trace.to(fmag[j0:j1], device),
              err[j0:j1])
        back = ifft2(f, device)
        del f
        _step(on, "ptycho.update", ops.update, psi, back, obj, probe, p, out[j0:j1], sums,
              False)
        del back, psi
    # mean(D_O) over the field: each view adds sum |P|^2 inside it
    c_obj = (probe.real.square() + probe.imag.square()).sum() * (OBJECT_INERTIA * frames / area)
    obj_new = _step(on, "ptycho.object", _divide, obj, sums, c_obj)
    del sums
    probe_new = _step(on, "ptycho.probe", _probe, out, obj_new, pos, probe)
    trace.counts["ptycho.frames"] += frames
    return out, obj_new, probe_new, err
