"""One large FFT over a DeviceMesh: the distributed four-step.

Counterpart of `watfft_tpu/parallel/large_sharded.py`. With N = n1 * n2
(`ops.large.large_split`, n1 and n2 divisible by the mesh size D), view
the sequence x as [n2, n1] (x[j1 + n1*j2] at row j2, column j1) and shard
its columns:

  1. stage 1 (#3, `_kernel_postmul`): the n2-point FFTs down the rank's
     [n2, n1/D] columns with the twiddle T[k2, j1] = w_N^{j1*k2} in the
     store: the strided c2c kernel with `MUL_STORE`, as the "2d" mode's
     first pass runs it (`ops/large.py` `_pass1(postmul=True)`), on the
     rank's columns of `ops.large.pm_grid` (cached per split, direction,
     D, rank and device: JAX rebuilds the whole table in f64 every call);
  2. one all-to-all: row block i of C [n2, n1/D] (contiguous: the send
     buffer as it lies) to rank i; rank r receives C's rows
     [r*n2/D, (r+1)*n2/D) from every rank, column block j from rank j;
     these are unpacked to [n2/D, n1] (a copy for D > 1, a view for D = 1);
  3. stage 2, the "2d" mode's outer pass (`_pass2(premul=False)`): the
     n1-point FFTs along j1, stored transposed (JAX's local transpose is
     the pass's strides), into D[k1, k2] [n1, n2/D].

The output is the [n1, n2/D] column block of X viewed as [n1, n2],
X[k1*n2 + k2] in natural order. The inverse takes that layout and gives
back the forward's: it is the same pipeline on the [n1, n2/D] block with
the factors swapped (n1' = n2, n2' = n1) in the inverse direction, so a
forward and an inverse compose with no re-layout, and the gradient of
either is the other (VJP(fft) = N * ifft, VJP(ifft) = fft / N).
"""

from __future__ import annotations

import functools

import torch

from .. import planner
from ..ops import large, stockham
from ..ops.large import MUL_STORE, large_split, strided_c2c
from .sharded import _tensor, axis_group, exchange, mesh_device

__all__ = ["fft_large_sharded", "large_factors"]


def large_factors(n: int, d: int) -> tuple[int, int]:
    """`large_split(n)`, refused unless the mesh size d divides both factors."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"the sharded four-step takes a power-of-two N >= 4, got N={n}")
    n1, n2 = large_split(n)
    if n2 < 2 or n2 > planner.STOCKHAM_MAX_N:
        raise ValueError(f"N={n} splits {n1}x{n2}: the four-step takes N = 2^8 .. 2^24")
    if n1 % d or n2 % d:
        raise ValueError(f"factors {n1}x{n2} must divide by mesh size {d}")
    return n1, n2


@functools.cache
def _pm_block(n1: int, n2: int, d: int, rank: int, inverse: bool, device: torch.device):
    """The rank's columns of the [n2, n1] twiddle grid, on the device."""
    c1 = n1 // d
    return tuple(torch.as_tensor(a, device=device) for a in
                 large.pm_grid(n1 * n2, n1, n2, inverse, slice(rank * c1, (rank + 1) * c1)))


def _core(xre, xim, group, d: int, rank: int, inverse: bool, out=None):
    """The four-step on the rank's [a, b] block (columns rank*b .. of the
    [a, b*D] view of the sequence; any strides): n2 = a, n1 = b*D. Returns
    (or writes into `out`, a pair of [n1, a/D] views) the rank's block of
    the transform viewed as [n1, n2]."""
    if xre.stride() != xim.stride():  # the kernel takes one set of strides for both
        xre, xim = xre.contiguous(), xim.contiguous()
    n2, c1 = xre.shape
    n1, c2 = c1 * d, n2 // d
    dev = xre.device
    t1 = stockham.device_tables(n2, inverse, dev)
    t2 = stockham.device_tables(n1, inverse, dev)
    pm = _pm_block(n1, n2, d, rank, inverse, dev)
    c = (xre.new_empty(n2, c1), xre.new_empty(n2, c1))
    # stage 1 (#3): x -> C[k2, j1l] = T * DFT_n2, C contiguous (the send order)
    strided_c2c((xre, xim), c, n2, (xre.stride(0), c1, c1),
                [(c1, xre.stride(1), 1, 1), (1, 0, 0, 0)], inverse, t1, "postmul",
                pm=pm, mul=MUL_STORE)
    # the exchange: row block i to rank i; [D, n2/D, n1/D] -> C_r[k2l, j1] [n2/D, n1]
    c = tuple(exchange(t, group).view(d, c2, c1).permute(1, 0, 2).reshape(c2, n1) for t in c)
    y = out if out is not None else (xre.new_empty(n1, c2), xre.new_empty(n1, c2))
    # stage 2 (the outer pass): DFT_n1 along j1, stored transposed into [n1, n2/D]
    strided_c2c(c, y, n1, (c[0].stride(1), y[0].stride(0), 0),
                [(c2, c[0].stride(0), y[0].stride(1), 0), (1, 0, 0, 0)], inverse, t2, "outer")
    return y


def _run(xre, xim, group, d, rank, inverse, real_out):
    """`_core`; real_out: the output pair interleaved into one real
    [n1, 2*n2/D] block (re at the even columns), as the sharded irfft
    returns its signal."""
    if not real_out:
        return _core(xre, xim, group, d, rank, inverse)
    n2, c1 = xre.shape
    y = xre.new_empty(c1 * d, 2 * (n2 // d))
    _core(xre, xim, group, d, rank, inverse, out=(y[:, 0::2], y[:, 1::2]))
    return y


class _LargeSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xre, xim, group, d, rank, inverse, real_out):
        ctx.group, ctx.d, ctx.rank, ctx.inverse, ctx.real_out = group, d, rank, inverse, real_out
        return _run(xre, xim, group, d, rank, inverse, real_out)

    @staticmethod
    def backward(ctx, *g):
        gre, gim = (g[0][:, 0::2], g[0][:, 1::2]) if ctx.real_out else g
        n = gre.numel() * ctx.d
        s = 1.0 / n if ctx.inverse else float(n)
        ore, oim = _core(stockham._dense(gre), stockham._dense(gim), ctx.group, ctx.d,
                         ctx.rank, not ctx.inverse)
        return ore * s, oim * s, None, None, None, None, None


def _large(xre, xim, group, d, rank, inverse, real_out=False):
    """`_run` with autograd where a gradient can flow."""
    if stockham._wants_grad(xre, xim):
        return _LargeSharded.apply(xre, xim, group, d, rank, bool(inverse), real_out)
    return _run(xre, xim, group, d, rank, bool(inverse), real_out)


def fft_large_sharded(xre, xim, mesh, inverse: bool = False, axis: str = "x"):
    """One N-point FFT sharded over the mesh axis `axis` (f32 planes).

    Forward: this rank's [n2, n1/D] column block of x viewed as [n2, n1]
    (columns [r*n1/D, (r+1)*n1/D)) in; its [n1, n2/D] column block of X
    viewed as [n1, n2] (X[k1*n2 + k2], k2 in [r*n2/D, (r+1)*n2/D)) out.
    inverse=True takes the forward's output layout and returns the
    forward's input layout (normalized), so the two compose.
    (n1, n2) = large_split(N); both must divide by D."""
    xre, xim = _tensor(xre), _tensor(xim)
    mesh_device(mesh, xre, xim)
    group, d, rank = axis_group(mesh, axis)
    if xre.dim() != 2 or xre.shape != xim.shape:
        raise ValueError(f"expected two 2-D block planes of one shape, got {tuple(xre.shape)} "
                         f"and {tuple(xim.shape)}")
    a, b = xre.shape
    n1, n2 = large_factors(a * b * d, d)
    want = (n1, n2 // d) if inverse else (n2, n1 // d)
    if (a, b) != want:
        raise ValueError(f"N={a * b * d} splits {n1}x{n2}: the rank's "
                         f"{'input' if not inverse else 'spectrum'} block is {want}, "
                         f"got {(a, b)}")
    xre, xim = (t.to(torch.float32) for t in (xre, xim))
    return _large(xre, xim, group, d, rank, inverse)
