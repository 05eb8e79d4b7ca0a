"""The plain difference-map iteration (Thibault et al. 2009, Ultramicroscopy
109:338; PtyPy's DM engine) in float64, and the errors of a program's
outputs against it.

For frames j at integer offsets (r_j, c_j) into the object O [H, W], the
probe P [M, M], the exit waves psi_j and the magnitudes a_j (zero frequency
at index 0), O_j[y, x] = O[r_j + y, c_j + x], F numpy's fft2, F^-1 its
ifft2 (1/M^2):

1. with the old O and P: phi_j = P O_j; Psi_j = F(2 phi_j - psi_j);
   Psi'_j = a_j Psi_j / |Psi_j| (a_j where |Psi_j| = 0); err_j = mean of
   (|Psi_j| - a_j)^2; psi_j <- psi_j + F^-1(Psi'_j) - phi_j;
2. D_O = sum_j S_j |P|^2; O <- (c_O O + sum_j S_j conj(P) psi_j) / (c_O +
   D_O), c_O = 1e-4 mean(D_O) over the scanned field (the rectangle the
   views span);
3. D_P = sum_j |O_j|^2 (the new O); P <- (c_P P + sum_j conj(O_j) psi_j) /
   (c_P + D_P), c_P = 1e-9 mean(D_P).

Imports torch alone: nothing of the program and nothing of JAX. Frames go
`BLOCK` at a time in complex128; the sums over frames by `index_add_`
into float64 arrays. The new exit waves are kept whole (complex128, 4 GiB
at 16,384 frames of 128^2) for step 3.
"""

from __future__ import annotations

import torch

BLOCK = 256
OBJECT_INERTIA, PROBE_INERTIA = 1e-4, 1e-9


def _index(pos: torch.Tensor, m: int, width: int) -> torch.Tensor:
    k = torch.arange(m, device=pos.device)
    rows = pos[:, 0].long()[:, None, None] + k[None, :, None]
    cols = pos[:, 1].long()[:, None, None] + k[None, None, :]
    return (rows * width + cols).reshape(-1)


def views(obj: torch.Tensor, pos: torch.Tensor, m: int) -> torch.Tensor:
    """O_j of each position, [F, M, M] (a copy)."""
    return obj.reshape(-1)[_index(pos, m, obj.shape[-1])].reshape(pos.shape[0], m, m)


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x with its real and imaginary parts rounded to `dtype` (the control)."""
    if dtype is None:
        return x
    return torch.view_as_complex(torch.view_as_real(x).to(dtype).to(torch.float64).contiguous())


def field(pos: torch.Tensor, m: int) -> tuple[slice, slice]:
    """The scanned field: the rectangle the views span."""
    lo, hi = pos.min(0).values.tolist(), pos.max(0).values.tolist()
    return slice(lo[0], hi[0] + m), slice(lo[1], hi[1] + m)


def iterate(exits, obj, probe, fmag, pos, transform_dtype=None, out=None):
    """One iteration in float64: (exits_new, obj_new, probe_new, err). The
    new exit waves go into `out` (default: a new complex128 array), in its
    dtype. With `transform_dtype` each frame's forward and inverse
    transform has its parts rounded to it (the control: bfloat16)."""
    dev = exits.device
    frames, m = exits.shape[0], exits.shape[-1]
    o = obj.to(device=dev, dtype=torch.complex128)
    p = probe.to(device=dev, dtype=torch.complex128)
    pos = pos.to(dev)
    h, w = o.shape
    if out is None:
        out = torch.empty(exits.shape, dtype=torch.complex128, device=dev)
    err = torch.empty(frames, dtype=torch.float64, device=dev)
    num = torch.zeros(h * w, 2, dtype=torch.float64, device=dev)
    den = torch.zeros(h * w, dtype=torch.float64, device=dev)
    p2 = p.abs() ** 2
    for j0 in range(0, frames, BLOCK):
        j1 = min(frames, j0 + BLOCK)
        idx = _index(pos[j0:j1], m, w)
        phi = p * o.reshape(-1)[idx].reshape(j1 - j0, m, m)
        psi = exits[j0:j1].to(torch.complex128)
        big = _rounded(torch.fft.fft2(2 * phi - psi), transform_dtype)
        a = fmag[j0:j1].to(device=dev, dtype=torch.float64)
        mag = big.abs()
        err[j0:j1] = ((mag - a) ** 2).mean((-2, -1))
        proj = torch.where(mag > 0, a * big / torch.where(mag > 0, mag, 1.0), a + 0j)
        new = psi + _rounded(torch.fft.ifft2(proj), transform_dtype) - phi
        out[j0:j1] = new.to(out.dtype)
        num.index_add_(0, idx, torch.view_as_real(p.conj() * new).reshape(-1, 2))
        den.index_add_(0, idx, p2.expand(j1 - j0, m, m).reshape(-1))
    num = torch.view_as_complex(num).reshape(h, w)
    den = den.reshape(h, w)
    rows, cols = field(pos, m)
    c_obj = OBJECT_INERTIA * den[rows, cols].mean()
    obj_new = (c_obj * o + num) / (c_obj + den)
    pnum = torch.zeros(m, m, dtype=torch.complex128, device=dev)
    pden = torch.zeros(m, m, dtype=torch.float64, device=dev)
    flat = obj_new.reshape(-1)
    for j0 in range(0, frames, BLOCK):
        j1 = min(frames, j0 + BLOCK)
        view = flat[_index(pos[j0:j1], m, w)].reshape(j1 - j0, m, m)
        pnum += (view.conj() * out[j0:j1].to(torch.complex128)).sum(0)
        pden += (view.abs() ** 2).sum(0)
    c_probe = PROBE_INERTIA * pden.mean()
    probe_new = (c_probe * p + pnum) / (c_probe + pden)
    return out, obj_new, probe_new, err


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|; NaN anywhere reads NaN."""
    d = (got.to(want.dtype) - want).abs()
    if torch.isnan(d).any():
        return float("nan")
    return float(d.max() / want.abs().max())


def errors(got, exits, obj, probe, fmag, pos) -> dict:
    """A program's (exits_new, obj_new, probe_new, err) against the
    reference on the same inputs: each the max |difference| over the
    reference's largest magnitude; the object's over the scanned field."""
    exits_new, obj_new, probe_new, err = got
    want = iterate(exits, obj, probe, fmag, pos)
    diffs, scales = [], []
    for j0 in range(0, exits.shape[0], BLOCK):
        j1 = min(exits.shape[0], j0 + BLOCK)
        w = want[0][j0:j1]
        diffs.append((exits_new[j0:j1].to(torch.complex128) - w).abs().max())
        scales.append(w.abs().max())
    rows, cols = field(pos, exits.shape[-1])
    return {"exit_err": float(torch.stack(diffs).max() / torch.stack(scales).max()),
            "object_err": _share(obj_new[rows, cols], want[1][rows, cols]),
            "probe_err": _share(probe_new, want[2]),
            "fourier_err": _share(err, want[3])}
