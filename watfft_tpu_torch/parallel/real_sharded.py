"""Sharded real-input faces: the large real FFT, the 2D real FFT and the
batch-sharded STFT over a DeviceMesh.

Counterpart of `watfft_tpu/parallel/real_sharded.py`, under the SPMD
contract of `sharded.py` (each rank passes its shard and gets its own).

* `rfft_large_sharded` / `irfft_large_sharded`: one real N-point FFT,
  N = 2m, m = n1 * n2 (`large_split(m)`, both divisible by D). The
  m-point core z[j] = x[2j] + i x[2j+1] runs on the distributed four-step
  (`large_sharded`), reading the rank's even and odd columns through
  strides, and leaves Z[k1*n2 + k2] in the rank's [n1, n2/D] block
  (k2 in [r*c, (r+1)*c), c = n2/D). The Hermitian post needs
  B = Z[m - k] beside each Z[k]: the mirror of (k1, k2) is
  (n1-1-k1, n2-k2) for k2 != 0 and (n1-k1, 0) for k2 = 0, so rank r reads
  columns n2-k2 from rank D-1-r (all but its first column) and one column,
  the first of rank (D-r) % D, at its block's edge. One
  `all_to_all_single` with split sizes sends each rank only those columns
  (about one block each way; no rank gathers the spectrum); then
  `ops/rfft.py`'s `hermitian_post_pair` (the algebra of
  `hermitian_post_nb`) runs on the block and its mirror. The inverse runs
  the same exchange on the spectrum, `hermitian_pre_pair` and the
  four-step's inverse, which writes the signal's even and odd columns
  itself.
* `rfft2_sharded` / `irfft2_sharded`: [..., H, W] real, H sharded. The row
  rffts are local (the fused r2c #9; c2r #10 on the way back), the W/2
  main spectrum columns go through one swap pair and the strided column
  walk (#11), and the Nyquist column is all-gathered ([H] values a plane)
  and transformed on every rank, each keeping its rows (its gradient is a
  reduce-scatter, sum).
* `stft_sharded`: the port's `stft.stft` on the rank's batch rows; no
  collectives.

Layouts (per rank r of D):
  rfft_large_sharded   in: real [n2, 2*n1/D], the column block of x viewed
                       as [n2, 2*n1]; out: flat planes [n1*n2/D] (+1 on
                       rank 0), element i*(n2/D) + c holding bin
                       k = i*n2 + r*n2/D + c; rank 0's last element is the
                       Nyquist bin k = m (its imaginary part 0)
  irfft_large_sharded  in: exactly that layout; out: the forward's input
                       layout (normalized)
  rfft2_sharded        in: real [..., H/D, W]; out: planes [..., H/D, W/2+1]
  irfft2_sharded       the reverse
  stft_sharded         in: real [B/D, T]; out: planes [B/D, frames, n_fft/2+1]
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .. import stft as _stft
from ..ops import fft2 as f2
from ..ops import rfft as rf
from ..ops import stockham
from ..ops.fourstep import rfft_post_twiddles
from ..ops.large import large_split
from .large_sharded import _large, large_factors
from .sharded import (_local_irfft, _local_rfft, _tensor, axis_group, col_fft, exchange,
                      mesh_device, swap)

__all__ = ["rfft_large_sharded", "irfft_large_sharded", "rfft2_sharded", "irfft2_sharded",
           "stft_sharded"]


# -- the large real FFT ----------------------------------------------------------------

@functools.cache
def _post_block(n: int, d: int, rank: int, inverse: bool, device: torch.device):
    """w_n^{-+k} at the rank's bins k = k1*n2 + r*n2/D + c, as [n1, n2/D]."""
    n1, n2 = large_split(n // 2)
    c2 = n2 // d
    k = np.arange(n1)[:, None] * n2 + rank * c2 + np.arange(c2)[None, :]
    return tuple(torch.as_tensor(w[k], device=device) for w in rfft_post_twiddles(n, inverse))


def _mirror(are, aim, first, group, d: int, rank: int):
    """(B re, B im) [n1, c] with B[k] = A[m - k] for the rank's [n1, c] block
    of A (bin k = k1*n2 + r*c + k2l), through one exchange with split sizes;
    `first` (a pair of 0-d tensors) takes the place of B[0], which would
    read A[m], on rank 0."""
    n1, c = are.shape
    partner, edge = d - 1 - rank, (d - rank) % d
    cols = torch.stack((are[:, 1:], aim[:, 1:]))       # [2, n1, c-1]: to the partner
    col0 = torch.stack((are[:, 0], aim[:, 0]))         # [2, n1]: to the edge rank
    parts, sizes = [], []
    for t in range(d):  # by rank; the same ranks send to this one, so one list serves both
        sizes.append(0)
        for dest, part in ((partner, cols), (edge, col0)):
            if t == dest:
                parts.append(part.reshape(-1))
                sizes[-1] += part.numel()
    recv = exchange(torch.cat(parts), group, sizes, sizes)
    got, off = {}, 0
    for t in range(d):
        for dest, name, part in ((partner, "cols", cols), (edge, "col0", col0)):
            if t == dest:
                got[name] = recv[off:off + part.numel()].view(part.shape)
                off += part.numel()
    # column k2l holds the mirror column n2 - k2: the edge column, then the
    # partner's columns c-1 .. 1; rows n1-1-k1
    b = torch.flip(torch.cat([got["col0"][:, :, None], torch.flip(got["cols"], (2,))], 2), (1,))
    if rank == 0:  # column k2 = 0: rows (n1 - k1) % n1, and B[0] = first
        col = torch.cat([torch.stack(first).reshape(2, 1), b[:, :-1, 0]], 1)
        b = torch.cat([col[:, :, None], b[:, :, 1:]], 2)
    return b[0], b[1]


def rfft_large_sharded(x, mesh, axis: str = "x"):
    """One real N-point forward FFT over the mesh axis `axis`: this rank's
    real [n2, 2*n1/D] block in, its flat spectrum planes out (the layout
    in the module docstring; the Nyquist bin last on rank 0). N = 2m,
    (n1, n2) = large_split(m), both divisible by D."""
    x = _tensor(x)
    dev = mesh_device(mesh, x)
    group, d, rank = axis_group(mesh, axis)
    if x.dim() != 2:
        raise ValueError(f"expected the rank's real [n2, 2*n1/D] block, got {tuple(x.shape)}")
    a, b = x.shape
    m = a * b * d // 2
    n1, n2 = large_factors(m, d)
    if (a, b) != (n2, 2 * n1 // d):
        raise ValueError(f"N={2 * m}: the rank's block is {(n2, 2 * n1 // d)}, got {(a, b)}")
    x = x.to(torch.float32)
    zre, zim = _large(x[:, 0::2], x[:, 1::2], group, d, rank, False)     # [n1, c2]
    bre, bim = _mirror(zre, zim, (zre[0, 0], zim[0, 0]), group, d, rank)
    xre, xim = rf.hermitian_post_pair(zre, zim, bre, bim, *_post_block(2 * m, d, rank, False, dev))
    xre, xim = xre.reshape(-1), xim.reshape(-1)
    if rank == 0:  # X[m] = Re Z0 - Im Z0
        xre = torch.cat([xre, (zre[0, 0] - zim[0, 0]).reshape(1)])
        xim = torch.cat([xim, xim.new_zeros(1)])
    return xre, xim


def irfft_large_sharded(re, im, mesh, axis: str = "x"):
    """Inverse of `rfft_large_sharded`: its output layout in, its input
    layout out (normalized: the 0.5 fold in the pre-process, 1/m in the
    four-step's inverse). It reads the imaginary parts of the DC and
    Nyquist bins, as the JAX map does."""
    re, im = _tensor(re), _tensor(im)
    dev = mesh_device(mesh, re, im)
    group, d, rank = axis_group(mesh, axis)
    if re.dim() != 1 or re.shape != im.shape:
        raise ValueError(f"expected two flat spectrum planes of one shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    body = re.numel() - (rank == 0)
    m = body * d
    n1, n2 = large_factors(m, d)
    c2 = n2 // d
    if body != n1 * c2:
        raise ValueError(f"m={m}: the rank's spectrum block holds {n1 * c2} bins "
                         f"(+1 on rank 0), got {re.numel()}")
    re, im = re.to(torch.float32), im.to(torch.float32)
    xre, xim = re[:body].reshape(n1, c2), im[:body].reshape(n1, c2)
    nyq = (re[body], im[body]) if rank == 0 else None
    bre, bim = _mirror(xre, xim, nyq, group, d, rank)
    zre, zim = rf.hermitian_pre_pair(xre, xim, bre, -bim, *_post_block(2 * m, d, rank, True, dev))
    return _large(zre, zim, group, d, rank, True, real_out=True)


# -- the 2D real FFT --------------------------------------------------------------------

def _collect(fn, *args):
    """A tensor collective with torch's FutureWarning on its name muted
    (`all_gather_into_tensor` / `reduce_scatter_tensor`: their successors
    are missing from older torch)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(*args)


def _all_gather(x, group, d: int):
    """The pieces of the group's ranks stacked along dim 0, in rank order."""
    out = x.new_empty((d * x.shape[0],) + tuple(x.shape[1:]))
    _collect(dist.all_gather_into_tensor, out, x.contiguous(), group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, d):
        ctx.group, ctx.shape = group, x.shape
        return _all_gather(x, group, d)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty(ctx.shape)
        _collect(dist.reduce_scatter_tensor, out, g.contiguous(), dist.ReduceOp.SUM, ctx.group)
        return out, None, None


def _gather(x, group, d: int):
    """`_all_gather`, differentiable where a gradient can flow."""
    if stockham._wants_grad(x):
        return _Gather.apply(x, group, d)
    return _all_gather(x, group, d)


def _nyquist(nre, nim, inverse: bool, group, d: int, rank: int):
    """The Nyquist column of every image ([L, rows] planes): gathered over
    the group ([H, 2, L], the rows in rank order), its H-point transform
    down the rows on every rank, this rank's rows kept."""
    rows = nre.shape[1]
    piece = torch.stack((nre, nim)).permute(2, 0, 1)                  # [rows, 2, L]
    g = _gather(piece, group, d)
    yre, yim = col_fft(g[:, 0].T.unsqueeze(-1), g[:, 1].T.unsqueeze(-1), inverse)
    keep = slice(rank * rows, (rank + 1) * rows)
    return yre[:, keep, 0], yim[:, keep, 0]


def _check_rfft2(shape, d: int) -> None:
    f2.validate_rfft2_shape(shape)
    if (shape[-1] // 2) % d:
        raise ValueError(f"W/2={shape[-1] // 2} must divide by mesh size {d}")


def _columns(re, im, inverse: bool, group, d: int, rank: int):
    """The H-point transforms down every column of [L, rows, W/2+1] planes:
    the W/2 main columns through a swap pair and the column walk, the
    Nyquist column gathered."""
    half = re.shape[-1] - 1
    mre, mim = (swap(t[..., :half], group, d) for t in (re, im))
    mre, mim = col_fft(mre, mim, inverse)
    mre, mim = (swap(t, group, d, reverse=True) for t in (mre, mim))
    nre, nim = _nyquist(re[..., half], im[..., half], inverse, group, d, rank)
    return torch.cat([mre, nre[..., None]], -1), torch.cat([mim, nim[..., None]], -1)


def rfft2_sharded(x, mesh, axis: str = "x"):
    """2D real FFT over the trailing [H, W] axes, H sharded: this rank's rows
    of real [..., H, W] in, its rows of the spectrum planes
    [..., H, W//2+1] out. Requires (W/2) % D == 0 (H % D by construction)."""
    x = _tensor(x)
    dev = mesh_device(mesh, x)
    group, d, rank = axis_group(mesh, axis)
    if x.dim() < 2:
        raise ValueError(f"rfft2 needs [..., H/D, W], got shape {tuple(x.shape)}")
    lead, (rows, w) = x.shape[:-2], x.shape[-2:]
    _check_rfft2((rows * d, w), d)
    re, im = _local_rfft(x.reshape(-1, rows, w), dev)                     # rows (#9)
    re, im = _columns(re, im, False, group, d, rank)
    return re.reshape(*lead, rows, w // 2 + 1), im.reshape(*lead, rows, w // 2 + 1)


def irfft2_sharded(re, im, mesh, axis: str = "x"):
    """Inverse of `rfft2_sharded`: this rank's rows of [..., H, W//2+1]
    planes in, its rows of real [..., H, W] out (normalized)."""
    re, im = _tensor(re), _tensor(im)
    dev = mesh_device(mesh, re, im)
    group, d, rank = axis_group(mesh, axis)
    if re.shape != im.shape or re.dim() < 2:
        raise ValueError(f"expected two [..., H/D, W/2+1] planes of one shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    lead, (rows, m1) = re.shape[:-2], re.shape[-2:]
    w = 2 * (m1 - 1)
    _check_rfft2((rows * d, w), d)
    re, im = (t.reshape(-1, rows, m1).to(torch.float32) for t in (re, im))
    re, im = _columns(re, im, True, group, d, rank)
    return _local_irfft(re, im, dev).reshape(*lead, rows, w)                 # rows (#10)


# -- the STFT ---------------------------------------------------------------------------

def stft_sharded(x, mesh, n_fft: int = 1024, hop: int = 256, window: str = "hann",
                 axis: str = "x"):
    """Batch-sharded STFT (BASELINE config 4's multi-device face): this
    rank's rows of real [B, T] in, its rows of the spectrogram planes
    [B, frames, n_fft//2+1] out; the port's `stft.stft` on the rank's rows,
    no collectives."""
    x = _tensor(x)
    dev = mesh_device(mesh, x)
    axis_group(mesh, axis)
    return _stft.stft(x, n_fft=n_fft, hop=hop, window=window, device=dev)
