"""Sharded batch, real batch and 2D transforms over a DeviceMesh.

Counterpart of `watfft_tpu/parallel/sharded.py`. The JAX functions take
global arrays and let `shard_map` cut them; these follow torch's SPMD
idiom instead: every rank of the mesh calls the function with its own
shard (the block the JAX `in_specs` give that device) and gets back its
own output shard (the block of the `out_specs`). The mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named axes (`make_mesh`);
its device type is the device of every shard: a shard elsewhere raises,
it is never moved.

* `fft_batch_sharded`, `rfft_batch_sharded`, `irfft_batch_sharded`: the
  batch (axis 0) sharded, no collectives. Each rank runs the port's plane
  entry points (`FFTContext.forward_planes`: the c2c kernel #1/#4 for
  n <= 4096, the four-step kernels past it; `RFFTContext`: the fused r2c
  and c2r kernels #9/#10 for n <= 8192).
* `fft2_sharded`: [..., H, W] with H sharded. The row FFTs are local
  (#1/#4), one all-to-all swaps the sharded axis ([..., H/D, W] ->
  [..., H, W/D]), the column FFTs run down axis -2 through the strided
  column walk (#11, as the 2D path's column pass), and the reverse
  all-to-all restores the row shards.

The exchange (`swap`) packs a plane as [D, rows, ..., W/D] (one copy),
runs `dist.all_to_all_single` on the axis's group, and receives a buffer
that is the [..., H, W/D] plane with a single row stride, so the column
pass reads it as it lies. The column pass writes its output with the rows
leading, which is the reverse exchange's send buffer as it lies; the
received row shards are unpacked into [..., rows, W] (one copy). Every
exchange is differentiable: the adjoint of an all-to-all is the
all-to-all with the send and receive splits swapped (`exchange`), so the
gradient of a swap is the reverse swap.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import api, planner
from ..ops import fft2 as f2
from ..ops import stockham

__all__ = ["fft_batch_sharded", "rfft_batch_sharded", "irfft_batch_sharded",
           "fft2_sharded", "make_mesh", "mesh_device", "axis_group", "exchange",
           "swap", "pack", "unpack", "col_fft"]


# -- the mesh ------------------------------------------------------------------

def make_mesh(n_devices: int | None = None, axis: str = "x", device="cuda"):
    """A 1-D DeviceMesh named `axis` over every rank of the initialised
    process group, on `device` ("cuda" by default; "cpu" for a gloo CPU
    mesh). n_devices, if given, must be the world size: each rank holds a
    shard, so a mesh over some of the ranks would leave the others out."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    d = world if n_devices is None else int(n_devices)
    if d != world:
        raise ValueError(f"make_mesh({n_devices}): the mesh spans every rank of the process "
                         f"group, {world}")
    return init_device_mesh(stockham.check_device(device).type, (d,), mesh_dim_names=(axis,))


def mesh_device(mesh, *tensors) -> torch.device:
    """The mesh's device (checked: a CUDA mesh without CUDA raises); every
    tensor must lie on it."""
    dev = stockham.check_device(mesh.device_type)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"a shard on {t.device}, the mesh on {dev}: the sharded "
                             f"faces move no tensor")
    return dev


def axis_group(mesh, axis: str):
    """(process group, its size D, this rank's index in it) of a mesh axis."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: {names})")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


# -- the exchange --------------------------------------------------------------

def _all_to_all(x, group, send, recv) -> torch.Tensor:
    x = x.contiguous().view(-1)
    out = x.new_empty(x.numel() if recv is None else sum(recv))
    dist.all_to_all_single(out, x, recv, send, group=group)
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv, ctx.shape = group, send, recv, x.shape
        return _all_to_all(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.recv, ctx.send).view(ctx.shape), None, None, None


def exchange(x, group, send=None, recv=None) -> torch.Tensor:
    """`dist.all_to_all_single` of x's elements (in x's logical order) on
    `group`, into a new flat buffer. send / recv: the element counts to and
    from each rank (None: D equal chunks). Differentiable: the gradient
    runs the exchange back, with the two splits swapped."""
    if stockham._wants_grad(x):
        return _Exchange.apply(x, group, send, recv)
    return _all_to_all(x, group, send, recv)


def pack(t, d: int, reverse: bool = False) -> torch.Tensor:
    """The send order of a swap, as a view of t (`exchange` copies it where
    it is not contiguous). Forward: [L, rows, W] -> [D, rows, L, W/D], the
    column block j for rank j; reverse: [L, H, W'] -> [D, H/D, L, W'], the
    row block j for rank j (a plain view where t's rows lead in memory, as
    the column pass leaves them)."""
    if reverse:
        n_l, h, w = t.shape
        return t.permute(1, 0, 2).reshape(d, h // d, n_l, w)
    n_l, rows, w = t.shape
    return t.reshape(n_l, rows, d, w // d).permute(2, 1, 0, 3)


def unpack(buf, shape, d: int, reverse: bool = False) -> torch.Tensor:
    """A received buffer in the layout of a swap's output. Forward: the
    [L, D*rows, W/D] plane, a view (the row blocks arrive in rank order);
    reverse: [L, rows, D*W'], a copy (the column blocks interleave)."""
    n_l, rows, w = shape  # of the swap's input
    if reverse:
        return buf.view(d, rows // d, n_l, w).permute(2, 1, 0, 3).reshape(n_l, rows // d, d * w)
    return buf.view(d * rows, n_l, w // d).permute(1, 0, 2)


def swap(t, group, d: int, reverse: bool = False) -> torch.Tensor:
    """The sharded axis swap of one [L, rows, W] plane (JAX
    `_swap_sharded_axis`): forward to [L, D*rows, W/D], reverse back."""
    return unpack(exchange(pack(t, d, reverse), group), t.shape, d, reverse)


# -- the local transforms --------------------------------------------------------

def _local_fft(re, im, inverse: bool, device):
    """The FFT along axis -1 of a shard's batch-major planes at any batch:
    the port's planner through the plane entry of FFTContext."""
    ctx = api._ctx(api.FFTContext, re.shape[-1], device)
    return ctx.inverse_planes(re, im) if inverse else ctx.forward_planes(re, im)


def _local_rfft(x, device):
    """The real FFT along axis -1 of a shard: [..., n] -> planes [..., n//2+1]."""
    return api._ctx(api.RFFTContext, x.shape[-1], device).forward_planes(x)


def _local_irfft(re, im, device):
    """The normalized inverse of `_local_rfft`: [..., m+1] -> real [..., 2m];
    it reads the imaginary parts of the DC and Nyquist bins, as JAX's map."""
    return api._ctx(api.RFFTContext, 2 * (re.shape[-1] - 1), device).inverse_planes(re, im)


def _cols(re, im, inverse: bool):
    """DFT_H down axis -2 of [L, H, W'] f32 planes of any strides (re and im
    alike), written with the rows leading (pack(..., reverse=True) is then
    a view): the 2D path's column pass, the strided column walk (#11,
    counted as `fft2_cols`), or the port's 1D route for H past 4096."""
    if re.stride() != im.stride():
        re, im = re.contiguous(), im.contiguous()
    n_l, h, w = re.shape
    out = tuple(re.new_empty(h, n_l, w).permute(1, 0, 2) for _ in range(2))
    table = (stockham.device_tables(h, inverse, re.device)
             if h <= planner.STOCKHAM_MAX_N else None)
    xs = (re.stride(1), re.stride(2), re.stride(0))
    ys = (out[0].stride(1), out[0].stride(2), out[0].stride(0))
    f2._cols((re, im), xs, out, ys, h, w, n_l, inverse, table, plain=False)
    return out


class _ColFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, inverse):
        ctx.inverse = inverse
        return _cols(re, im, inverse)

    @staticmethod
    def backward(ctx, gre, gim):
        # VJP(fft) = H * ifft, VJP(ifft) = fft / H, on the same walk
        h = gre.shape[1]
        s = 1.0 / h if ctx.inverse else float(h)
        ore, oim = _ColFFT.apply(gre, gim, not ctx.inverse)
        return ore * s, oim * s, None


def col_fft(re, im, inverse: bool = False):
    """DFT along axis -2 of [L, H, W'] planes (differentiable)."""
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"the column pass takes float32 planes, got {re.dtype}, {im.dtype}")
    if stockham._wants_grad(re, im):
        return _ColFFT.apply(re, im, bool(inverse))
    return _cols(re, im, bool(inverse))


# -- the faces -----------------------------------------------------------------

def fft_batch_sharded(xre, xim, mesh, inverse: bool = False, axis: str = "x"):
    """Data-parallel batched FFT over axis -1: this rank's rows
    [r*B/D, (r+1)*B/D) of the [B, n] planes in, the same rows out. No
    collectives."""
    xre, xim = _tensor(xre), _tensor(xim)
    dev = mesh_device(mesh, xre, xim)
    axis_group(mesh, axis)
    return _local_fft(xre, xim, bool(inverse), dev)


def rfft_batch_sharded(x, mesh, axis: str = "x"):
    """Data-parallel batched real FFT: this rank's rows of real [B, n] in,
    its rows of the spectrum planes [B, n//2+1] out. No collectives."""
    x = _tensor(x)
    dev = mesh_device(mesh, x)
    axis_group(mesh, axis)
    return _local_rfft(x, dev)


def irfft_batch_sharded(re, im, mesh, axis: str = "x"):
    """Inverse of `rfft_batch_sharded`: this rank's rows of [B, m+1] planes
    in, its rows of real [B, 2m] out (normalized)."""
    re, im = _tensor(re), _tensor(im)
    dev = mesh_device(mesh, re, im)
    axis_group(mesh, axis)
    return _local_irfft(re, im, dev)


def fft2_sharded(xre, xim, mesh, inverse: bool = False, axis: str = "x",
                 batch_axis: str | None = None):
    """2D FFT over the trailing [H, W] axes of planes [..., H, W], H sharded
    over the mesh axis `axis`: this rank's rows [r*H/D, (r+1)*H/D) of every
    image in, the same rows of the transform out. On a 2-D mesh,
    `batch_axis` names the axis that shards the leading batch dim (each
    rank passes its images); the exchanges then run within `axis`'s group
    only. Requires W % D == 0 (H % D holds by construction)."""
    xre, xim = _tensor(xre), _tensor(xim)
    dev = mesh_device(mesh, xre, xim)
    if xre.shape != xim.shape or xre.dim() < 2:
        raise ValueError(f"expected two [..., H/D, W] planes of one shape, got "
                         f"{tuple(xre.shape)} and {tuple(xim.shape)}")
    if batch_axis is not None:
        if xre.dim() < 3:
            raise ValueError("batch_axis requires a leading batch dim")
        axis_group(mesh, batch_axis)
    group, d, _ = axis_group(mesh, axis)
    lead, (rows, w) = xre.shape[:-2], xre.shape[-2:]
    f2.validate_fft2_shape((rows * d, w))
    if w % d:
        raise ValueError(f"W={w} must divide by the mesh size {d}")
    re, im = _local_fft(xre, xim, bool(inverse), dev)                 # rows (#1/#4)
    re, im = (swap(t.reshape(-1, rows, w), group, d) for t in (re, im))
    re, im = col_fft(re, im, inverse)                                 # columns (#11)
    re, im = (swap(t, group, d, reverse=True) for t in (re, im))
    return re.reshape(*lead, rows, w), im.reshape(*lead, rows, w)
