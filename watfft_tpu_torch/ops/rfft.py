"""Real FFT (rfft / irfft) of n = 2m points, float32 or float64: tables,
plain version, hybrid and fused kernel paths, autograd.

Counterpart of `watfft_tpu/ops/pallas_rfft.py` (the matmul surface of
`watfft_tpu/ops/rfft.py` lives in `ops/fourstep.py`), and in float64 of
`watfft_tpu/ops/doublefloat.py`'s `df_rfft_nb` / `df_irfft_nb`: the f64 real
tier, which the JAX package runs on hi/lo f32 pairs and which here runs the
same kernels' FP64 instances with f64 tables.
The transform is the JAX package's pack-as-complex real FFT, with its row
conventions:

* forward: z[j] = x[2j] + i x[2j+1], Z = DFT_m(z), then the Hermitian post
  X[k] = E + w_n^k O, E = (A + conj B)/2, O = -i (A - conj B)/2, A = Z[k],
  B = Z[m-k]; the DC row wraps to Z[0], so X[0] = Re Z0 + Im Z0 and
  X[m] = Re Z0 - Im Z0, with imaginary parts exactly 0.
* inverse: the pre-process Z[k] = E + w_n^-k O, E = (A + B)/2,
  O = i (A - B)/2, A = X[k], B = conj X[m-k] for k = 0..m-1 (so it reads
  the imaginary parts of the DC and Nyquist rows), the m-point inverse
  with 1/m folded into its last stage, then o[2j] = Re z[j],
  o[2j+1] = Im z[j].

Three implementations of one function, on [n, B] views (the transform runs
along axis 0, the batch along axis 1, any strides):

* the plain version (`plain_rfft` / `plain_irfft` on complex tensors):
  torch ops, the deinterleave as strided views, `stockham.run_stages` for
  the m-point core and `hermitian_post_nb` / `hermitian_pre_nb` around it.
  The wrappers use it for CPU tensors.
* the hybrid (`rfft_nb` / `irfft_nb`): the c2c Stockham kernel reads the
  real rows as m interleaved complex points (re at 2j*sn, im at (2j+1)*sn,
  element stride 2*sn) or writes them back so, and the Hermitian post/pre
  run as torch ops beside it, as XLA runs them beside the Pallas core.
  It ports `_rfft_core_kernel`, `_irfft_core_kernel` and their `[n, 8, W]`
  variants (`_*_core_kernel_dma3d`), through strides.
* the fused kernels (`rfft_nb_fused` / `irfft_nb_fused`): `csrc/rfft.cu`,
  deinterleave + stages + Hermitian post (or pre + stages + re-interleave)
  in one pass; they port `_rfft_fused_kernel` and `_irfft_fused_kernel`.
* the large route (`ops/large.py`, `rfft_large*` / `irfft_large*`, for
  n > 8192): the hybrid's shape with the m-point core on the four-step
  kernels (`large.fft_large_views`), as `watfft_tpu/ops/large.py`'s
  `rfft_large_nb` / `irfft_large_nb` run it.

Batch-major planes (`rfft_bm` / `irfft_bm`) and complex tensors (`rfft` /
`irfft`) run the same code through other strides. Every form is
differentiable with the JAX package's adjoint identities
(pallas_rfft.py:866-988), run on the same kernels:

  VJP(rfft)(g)  = m * irfft(g'), g' = g with its real end rows doubled and
                  its imaginary end rows zeroed;
  VJP(irfft)(y) = rfft(y) / m with the real end rows halved and the
                  imaginary end rows set to -+ Re rfft(y)[m or 0] / 2.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import trace
from . import _build, stockham
from .fourstep import rfft_post_twiddles
from .large import fft_large_views
from .stockham import (WALK_BLOCK, WALK_ENGINE, WALK_RESIDENT, Tables, check_device,
                       check_dtype, complex_pairs, fft_views)

__all__ = ["rfft_post_twiddles", "RTables", "make_rtables", "device_rtables",
           "hermitian_post_nb", "hermitian_pre_nb", "hermitian_post_pair",
           "hermitian_pre_pair", "plain_rfft", "plain_irfft",
           "rfft_nb", "irfft_nb", "rfft_nb_fused", "irfft_nb_fused",
           "rfft_bm", "irfft_bm", "rfft", "irfft", "r2c_launch", "c2r_pairs", "c2r_launch"]


# -- tables --------------------------------------------------------------------

@dataclass(eq=False)
class RTables:
    """One real-FFT length and direction on one device: the m-point
    Stockham tables of that direction (`core`) and the post twiddles
    (`wre`, `wim`, 1-D, of the core's dtype: m+1 values forward, m
    inverse)."""
    core: Tables
    wre: torch.Tensor
    wim: torch.Tensor
    inverse: bool
    n: int = field(init=False)

    def __post_init__(self):
        self.n = 2 * self.core.n
        if self.wre.dtype != self.core.dtype or self.wim.dtype != self.core.dtype:
            raise TypeError(f"post twiddles {self.wre.dtype}, {self.wim.dtype} beside "
                            f"{self.core.dtype} core tables")
        want = self.n // 2 + (0 if self.inverse else 1)
        if self.wre.numel() != want or self.wim.numel() != want:
            raise ValueError(f"post twiddles for n={self.n} "
                             f"{'inverse' if self.inverse else 'forward'} take "
                             f"{want} values, got {self.wre.numel()} and {self.wim.numel()}")

    @property
    def dtype(self) -> torch.dtype:
        return self.core.dtype


def make_rtables(stages, offsets, twre, twim, wre, wim, inverse: bool, device,
                 dtype=torch.float32) -> RTables:
    """RTables of `dtype` on `device` from a host m-point plan, its twiddle
    pack and the post-twiddle columns (numpy)."""
    core = stockham.make_tables(stages, offsets, twre, twim, device, dtype)

    def put(a):
        return trace.h2d(np.asarray(a, np.float64).reshape(-1), core.twre.device, dtype)
    return RTables(core, put(wre), put(wim), bool(inverse))


@functools.cache
def _cached_rtables(n: int, inverse: bool, device: torch.device, dtype: torch.dtype) -> RTables:
    trace.counts["tables_built"] += 1
    m = n // 2
    npd = stockham.np_dtype(dtype)
    re, im, offsets = stockham.make_twiddle_pack(m, inverse, npd)
    return make_rtables(stockham.stage_plan(m), offsets, re, im,
                        *rfft_post_twiddles(n, inverse, npd), inverse, device, dtype)


def device_rtables(n: int, inverse: bool, device, dtype=torch.float32) -> RTables:
    """The port's own real-FFT tables for (n, direction) in `dtype`
    (float32 or float64), once per device."""
    return _cached_rtables(int(n), bool(inverse), check_device(device), dtype)


@functools.cache
def _cached_post(n: int, inverse: bool, device: torch.device):
    trace.counts["tables_built"] += 1
    return tuple(trace.h2d(a, device) for a in rfft_post_twiddles(n, inverse))


def _resolve(tables, n: int, inverse: bool, device, dtype: torch.dtype) -> RTables:
    """The tables for n points of data of `dtype` (the real signal or the
    spectrum): given ones checked, or the port's own of that precision."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"the real FFT takes a power-of-two n >= 4, got n={n}")
    if tables is None:
        return device_rtables(n, inverse, device, stockham.real_dtype(dtype))  # checks the device
    check_device(device)
    if tables.n != n or tables.inverse != inverse:
        raise ValueError(f"tables are for n={tables.n} "
                         f"{'inverse' if tables.inverse else 'forward'}, got n={n} "
                         f"{'inverse' if inverse else 'forward'}")
    check_dtype(tables.dtype, dtype)
    return tables


# -- Hermitian post / pre (torch; the JAX package runs them in XLA) ------------

def _post(n: int, inverse: bool, like):
    """The post twiddles in like's dtype, on its device."""
    npd = stockham.np_dtype(like.dtype)
    return (trace.h2d(a, like.device) for a in rfft_post_twiddles(n, inverse, npd))


def _column(w, like):
    """Table values as a column that broadcasts over like's trailing axes
    (both of one dtype)."""
    check_dtype(w.dtype, like.dtype)
    return w.reshape((-1,) + (1,) * (like.dim() - 1))


def hermitian_post_nb(zre, zim, n: int, wre=None, wim=None):
    """Time-major core planes [m, ...] -> spectrum planes [m+1, ...]; the
    algebra of pallas_rfft.py:390-417. wre/wim: the forward post twiddles
    (m+1 values) on zre's device; built here, in zre's dtype, if not given."""
    m = n // 2
    if wre is None:
        wre, wim = _post(n, False, zre)
    are, aim = zre[1:], zim[1:]
    xre_core, xim_core = hermitian_post_pair(
        are, aim, torch.flip(zre[1:], (0,)), torch.flip(zim[1:], (0,)),
        _column(wre[1:m], are), _column(wim[1:m], are))
    z0re, z0im = zre[:1], zim[:1]
    xre = torch.cat([z0re + z0im, xre_core, z0re - z0im])
    zero = torch.zeros_like(z0re)
    xim = torch.cat([zero, xim_core, zero])
    return xre, xim


def hermitian_pre_nb(xre, xim, n: int, wre=None, wim=None):
    """Time-major spectrum planes [m+1, ...] -> core planes [m, ...] for a
    normalized m-point inverse; the algebra of pallas_rfft.py:802-823.
    wre/wim: the inverse post twiddles (m values)."""
    m = n // 2
    if wre is None:
        wre, wim = _post(n, True, xre)
    are, aim = xre[:m], xim[:m]
    bre = torch.cat([xre[m:m + 1], torch.flip(xre[1:m], (0,))])
    bim = -torch.cat([xim[m:m + 1], torch.flip(xim[1:m], (0,))])
    return hermitian_pre_pair(are, aim, bre, bim, _column(wre, are), _column(wim, are))


def hermitian_post_pair(are, aim, bre, bim, wr, wi):
    """The forward post bin by bin: X[k] = E + w_n^k O with A = Z[k] (are,
    aim), B = Z[m-k] (bre, bim) and w_n^k (wr, wi), all broadcast alike.
    `hermitian_post_nb` runs it on the rows 1..m-1 of a core plane, the
    sharded large real FFT on a rank's block and its mirror
    (`parallel/real_sharded.py`)."""
    ere = 0.5 * (are + bre)
    eim = 0.5 * (aim - bim)
    dre = are - bre
    dim = aim + bim
    ore = 0.5 * dim
    oim = -0.5 * dre
    return ere + wr * ore - wi * oim, eim + wr * oim + wi * ore


def hermitian_pre_pair(are, aim, bre, bim, wr, wi):
    """The inverse pre-process bin by bin: Z[k] = E + w_n^-k O with
    A = X[k] (are, aim), B = conj X[m-k] (bre, bim: the conjugate already
    taken) and w_n^-k (wr, wi); what `hermitian_pre_nb` runs on the rows
    0..m-1."""
    ere = 0.5 * (are + bre)
    eim = 0.5 * (aim + bim)
    dre = are - bre
    dim = aim - bim
    ore = -0.5 * dim
    oim = 0.5 * dre
    return ere + wr * ore - wi * oim, eim + wr * oim + wi * ore


# -- the three implementations on [n, B] views ---------------------------------

def _plain_r2c(xv, rt: RTables):
    n = xv.shape[0]
    c = rt.core
    zre, zim = stockham.run_stages(xv[0::2], xv[1::2], n // 2, False, c.offsets,
                                   c.stages, c.twre, c.twim)
    return hermitian_post_nb(zre, zim, n, rt.wre, rt.wim)


def _plain_c2r(xre, xim, rt: RTables):
    n = rt.n
    c = rt.core
    zre, zim = hermitian_pre_nb(xre, xim, n, rt.wre, rt.wim)
    zre, zim = stockham.run_stages(zre, zim, n // 2, True, c.offsets, c.stages,
                                   c.twre, c.twim)
    return torch.stack([zre, zim], dim=1).reshape(n, -1)


def _hybrid_r2c(xv, ore, oim, rt: RTables) -> None:
    """Core: the c2c kernel reads x's even and odd rows as one complex
    plane; post: torch. Z takes x's layout, so its store coalesces alike."""
    n, batch = xv.shape
    m = n // 2
    if xv.stride(0) <= xv.stride(1):  # batch-major
        zre, zim = (xv.new_empty(batch, m).T for _ in range(2))
    else:
        zre, zim = (xv.new_empty(m, batch) for _ in range(2))
    fft_views(xv[0::2], xv[1::2], zre, zim, False, rt.core)
    if xv.device.type == "cuda":
        trace.launches["real_core_fwd"] += 1
    re, im = hermitian_post_nb(zre, zim, n, rt.wre, rt.wim)
    ore.copy_(re)
    oim.copy_(im)


def _hybrid_c2r(xre, xim, out, rt: RTables) -> None:
    """Pre: torch; core: the c2c kernel writes z[j] to out's rows 2j and
    2j + 1 (1/m folded in its inverse tables)."""
    zre, zim = hermitian_pre_nb(xre, xim, rt.n, rt.wre, rt.wim)
    fft_views(zre, zim, out[0::2], out[1::2], True, rt.core)
    if out.device.type == "cuda":
        trace.launches["real_core_inv"] += 1


def _large_r2c(xv, ore, oim, w) -> None:
    """The hybrid's shape on the four-step core: the large kernels read x's
    even and odd rows as one complex plane; post: torch. w: the forward
    post twiddles."""
    n, batch = xv.shape
    m = n // 2
    if xv.stride(0) <= xv.stride(1):  # batch-major
        zre, zim = (xv.new_empty(batch, m).T for _ in range(2))
    else:
        zre, zim = (xv.new_empty(m, batch) for _ in range(2))
    fft_large_views(xv[0::2], xv[1::2], zre, zim, False)
    re, im = hermitian_post_nb(zre, zim, n, *w)
    ore.copy_(re)
    oim.copy_(im)


def _large_c2r(xre, xim, out, w) -> None:
    """Pre: torch; core: the large kernels write z[j] to out's rows 2j and
    2j + 1 (1/m folded into the two passes' inverse tables)."""
    zre, zim = hermitian_pre_nb(xre, xim, out.shape[0], *w)
    fft_large_views(zre, zim, out[0::2], out[1::2], True)


# The n up to which the f32 r2c runs the engine's walk (rfft_r2c_kernel, a
# block a tile): one radix-m stage, 256 transforms a block, where eight
# blocks an SM measured faster than the resident kernel's two (PERF.md).
# The FP64 r2c takes a block a tile copied in by cp.async at every n, where
# it measured faster than both (PERF.md).
R2C_ENGINE_MAX_N = 8


def r2c_launch(n: int, x, y, size: int = 4) -> tuple[int, int, int]:
    """The last arguments of the r2c launch on signals of n points of
    `size`-byte reals (4: f32, 8: FP64): its walk (f32: WALK_ENGINE up to
    R2C_ENGINE_MAX_N, else WALK_RESIDENT; FP64: WALK_BLOCK) and, past the
    engine's walk, whether it copies z[j] = (x[2j], x[2j+1]) and stores each
    bin one point at a time (`complex_pairs`). x: (address, element stride,
    batch stride), y: (re address, im address, bin stride, batch stride),
    strides in reals."""
    if size == 4 and n <= R2C_ENGINE_MAX_N:
        return WALK_ENGINE, 0, 0
    xa, x_sn, x_sb = x
    return (WALK_RESIDENT if size == 4 else WALK_BLOCK,
            int(complex_pairs(xa, xa + size * x_sn, 2 * x_sn, x_sb, size)),
            int(complex_pairs(*y, size)))


# The n up to which the f32 c2r runs the engine's walk (irfft_c2r_kernel, a
# block a tile at up to eight blocks an SM): one radix-m stage where the
# engine measured 12-25% faster than the redesigned walk; resident blocks
# past it (1.4-1.5x faster than the engine's walk). The FP64 c2r runs the
# engine's walk at every n and takes no walk: a redesigned FP64 walk
# measured 0.2-4% slower at 11 of 12 n (PERF.md has the times).
C2R_ENGINE_MAX_N = 16


def c2r_pairs(x, y) -> tuple[int, int]:
    """Whether the f32 c2r's resident walk copies each bin and stores
    o[2j], o[2j+1] = z[j] one point at a time (`complex_pairs`). x: (re
    address, im address, bin stride, batch stride), y: (address, element
    stride, batch stride), strides in floats."""
    ya, y_sn, y_sb = y
    return int(complex_pairs(*x)), int(complex_pairs(ya, ya + 4 * y_sn, 2 * y_sn, y_sb))


def c2r_launch(n: int, x, y) -> tuple[int, int, int]:
    """The last arguments of the f32 c2r launch on spectra of n/2 + 1 bins:
    its walk (WALK_ENGINE up to C2R_ENGINE_MAX_N, without pairs; else
    WALK_RESIDENT with `c2r_pairs`)."""
    if n <= C2R_ENGINE_MAX_N:
        return WALK_ENGINE, 0, 0
    return (WALK_RESIDENT, *c2r_pairs(x, y))


def _launch_r2c(x, x_sn, x_sb, yre, yim, y_sn, y_sb, n, batch, rt: RTables) -> None:
    """The r2c kernel on real sequences of x (element j of sequence b at
    j*x_sn + b*x_sb floats) into spectrum planes at the addresses yre, yim
    (bin k of b at k*y_sn + b*y_sb floats)."""
    targs = _kernel_args(rt, x)
    f64 = rt.dtype == torch.float64
    launch = r2c_launch(n, (x.data_ptr(), x_sn, x_sb), (yre, yim, y_sn, y_sb), 8 if f64 else 4)
    key = "rfft_r2c_fused_f64" if f64 else "rfft_r2c_fused"
    _build.launch(key, x.device, "watfft_rfft_r2c_f64" if f64 else "watfft_rfft_r2c",
                  (x.data_ptr(), x_sn, x_sb, yre, yim, y_sn, y_sb, n, batch, *targs), launch,
                  lambda: f"n={n}, batch={batch}")


def _launch_c2r(x, xre, xim, x_sn, x_sb, y, y_sn, y_sb, n, batch, rt: RTables) -> None:
    """The c2r kernel on spectrum planes at the addresses xre, xim (of the
    tensor x) into the real sequences of y."""
    targs = _kernel_args(rt, x)
    f64 = rt.dtype == torch.float64
    launch = () if f64 else c2r_launch(n, (xre, xim, x_sn, x_sb), (y.data_ptr(), y_sn, y_sb))
    key = "irfft_c2r_fused_f64" if f64 else "irfft_c2r_fused"
    _build.launch(key, x.device, "watfft_irfft_c2r_f64" if f64 else "watfft_irfft_c2r",
                  (xre, xim, x_sn, x_sb, y.data_ptr(), y_sn, y_sb, n, batch, *targs), launch,
                  lambda: f"n={n}, batch={batch}")


def _kernel_args(rt: RTables, t):
    """The table arguments of a fused launch on t's device (twre, twim,
    radices, offsets, stage count, wre, wim); the caller has checked t's
    dtype against the tables'."""
    _build.same_device(rt.wre.device, t.device)
    c = rt.core
    return (c.twre.data_ptr(), c.twim.data_ptr(), c.c_radices, c.c_offsets, len(c.stages),
            rt.wre.data_ptr(), rt.wim.data_ptr())


# -- forms: tensors <-> [n, B] planes ------------------------------------------
# layout "nb": time-major planes [n, ...] <-> [m+1, ...]; "bm": batch-major
# planes [..., n] <-> [..., m+1]; "complex": real [..., n] <-> complex
# [..., m+1] (interleaved storage: im one real after re, stride 2). The
# fused kernels take the layouts as raw addresses and strides, which costs
# the host no view objects; the plain version and the hybrid take views.

def _strides(layout: str, rows: int, batch: int) -> tuple[int, int]:
    """(row stride, batch stride) in reals of [rows, batch] in a layout."""
    if layout == "nb":
        return batch, 1
    return (1, rows) if layout == "bm" else (2, 2 * rows)


def _spectrum(layout: str, batch: int, m1: int, re, im=None):
    """Addresses and strides of the spectrum: of the planes re/im, or of
    the complex tensor re (im None)."""
    if layout == "complex":
        p = re.data_ptr()
        return p, p + re.element_size() // 2, *_strides(layout, m1, batch)
    return re.data_ptr(), im.data_ptr(), *_strides(layout, m1, batch)


def _spectrum_views(layout: str, batch: int, m1: int, re, im=None):
    """[m+1, batch] views of the spectrum."""
    if layout == "nb":
        return re.view(m1, batch), im.view(m1, batch)
    if layout == "bm":
        return re.view(batch, m1).T, im.view(batch, m1).T
    v = torch.view_as_real(re).view(batch, m1, 2)
    return v[..., 0].T, v[..., 1].T


def _signal_view(t, n: int, batch: int, layout: str):
    return t.view(n, batch) if layout == "nb" else t.view(batch, n).T


def _tables(route: str, tables, n: int, inverse: bool, device, dtype):
    """RTables of the fused and hybrid routes for data of `dtype`; the large
    route's post twiddles (f32; its core tables are ops/large.py's)."""
    if route == "large":
        if tables is not None:
            raise ValueError("the large real route takes no RTables")
        return _cached_post(n, inverse, check_device(device))
    return _resolve(tables, n, inverse, device, dtype)


def _r2c(x, route: str, layout: str, tables):
    if x.is_complex():
        raise TypeError(f"the real FFT takes a real signal, got {x.dtype}")
    n = x.shape[0] if layout == "nb" else x.shape[-1]
    rt = _tables(route, tables, n, False, x.device, x.dtype)
    x = stockham._dense(x)
    m1 = n // 2 + 1
    batch = x.numel() // n
    if layout == "nb":
        out = (x.new_empty((m1,) + x.shape[1:]), x.new_empty((m1,) + x.shape[1:]))
    elif layout == "bm":
        out = (x.new_empty(x.shape[:-1] + (m1,)), x.new_empty(x.shape[:-1] + (m1,)))
    else:
        out = (x.new_empty(x.shape[:-1] + (m1,), dtype=x.dtype.to_complex()),)
    if batch and route == "fused" and _build.use_kernel(x):
        _launch_r2c(x, *_strides(layout if layout == "nb" else "bm", n, batch),
                    *_spectrum(layout, batch, m1, *out), n, batch, rt)
    elif batch:
        xv = _signal_view(x, n, batch, layout)
        ore, oim = _spectrum_views(layout, batch, m1, *out)
        if route == "hybrid":
            _hybrid_r2c(xv, ore, oim, rt)
        elif route == "large":
            _large_r2c(xv, ore, oim, rt)
        else:
            re, im = _plain_r2c(xv, rt)
            ore.copy_(re)
            oim.copy_(im)
    return out if layout != "complex" else out[0]


def _c2r(re, im, route: str, layout: str, tables):
    if layout == "complex":
        if not re.is_complex():
            raise TypeError(f"the complex inverse takes a complex spectrum, got {re.dtype}")
    elif re.shape != im.shape or re.dtype != im.dtype or re.device != im.device:
        raise ValueError(f"re and im planes differ: {re.shape} {re.dtype} "
                         f"{re.device} vs {im.shape} {im.dtype} {im.device}")
    m1 = re.shape[0] if layout == "nb" else re.shape[-1]
    n = 2 * (m1 - 1)
    rt = _tables(route, tables, n, True, re.device, re.dtype)
    re = stockham._dense(re)
    im = None if im is None else stockham._dense(im)
    batch = re.numel() // m1
    if layout == "nb":
        out = re.new_empty((n,) + re.shape[1:])
    else:
        out = re.new_empty(re.shape[:-1] + (n,), dtype=re.real.dtype)
    if batch and route == "fused" and _build.use_kernel(out):
        _launch_c2r(re, *_spectrum(layout, batch, m1, re, im), out,
                    *_strides(layout if layout == "nb" else "bm", n, batch), n, batch, rt)
    elif batch:
        xre, xim = _spectrum_views(layout, batch, m1, re, im)
        ov = _signal_view(out, n, batch, layout)
        if route == "hybrid":
            _hybrid_c2r(xre, xim, ov, rt)
        elif route == "large":
            _large_c2r(xre, xim, ov, rt)
        else:
            ov.copy_(_plain_c2r(xre, xim, rt))
    return out


# -- autograd ------------------------------------------------------------------

def _ends(m: int, end: float, like, ax: int):
    """The JAX package's _ends_mask: 1 everywhere, `end` on rows 0 and m of
    the bin axis ax of `like`."""
    s = torch.ones(m + 1, dtype=like.dtype, device=like.device)
    s[0] = s[m] = end
    return s if ax == -1 else s.reshape((-1,) + (1,) * (like.dim() - 1))


class _R2C(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, route, layout, tables):
        ctx.route, ctx.layout = route, layout
        return _r2c(x, route, layout, tables)

    @staticmethod
    def backward(ctx, *g):
        if ctx.layout == "complex":
            gre, gim, layout = g[0].real, g[0].imag, "bm"
        else:
            (gre, gim), layout = g, ctx.layout
        ax = 0 if layout == "nb" else -1
        m = gre.shape[ax] - 1
        gre = gre * _ends(m, 2.0, gre, ax)
        gim = gim * _ends(m, 0.0, gim, ax)
        return _C2R.apply(gre, gim, ctx.route, layout, None) * float(m), None, None, None


class _C2R(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, route, layout, tables):
        ctx.route, ctx.layout = route, layout
        return _c2r(re, im, route, layout, tables)

    @staticmethod
    def backward(ctx, y):
        layout = "bm" if ctx.layout == "complex" else ctx.layout
        ax = 0 if layout == "nb" else -1
        gre, gim = _R2C.apply(y, ctx.route, layout, None)
        m = gre.shape[ax] - 1
        r0, rm = gre.narrow(ax, 0, 1), gre.narrow(ax, m, 1)
        gre = gre * _ends(m, 0.5, gre, ax)
        gim = torch.cat([-0.5 * rm, gim.narrow(ax, 1, m - 1), -0.5 * r0], dim=ax)
        s = 1.0 / m
        if ctx.layout == "complex":
            return torch.complex(gre * s, gim * s), None, None, None, None
        return gre * s, gim * s, None, None, None


def _forward(x, route: str, layout, tables):
    if stockham._wants_grad(x):
        return _R2C.apply(x, route, layout, tables)
    return _r2c(x, route, layout, tables)


def _inverse(re, im, route: str, layout, tables):
    if stockham._wants_grad(*(t for t in (re, im) if t is not None)):
        return _C2R.apply(re, im, route, layout, tables)
    return _c2r(re, im, route, layout, tables)


def _route(fused: bool) -> str:
    return "fused" if fused else "hybrid"


# -- public forms --------------------------------------------------------------

def rfft_nb(x, tables: RTables | None = None):
    """Hybrid real FFT on time-major real [n, ...] -> spectrum planes
    [n//2+1, ...]: the c2c kernel through strides, the Hermitian post in
    torch. `[n, b]` and the `[n, 8, W]` view alike; any batch."""
    return _forward(x, "hybrid", "nb", tables)


def irfft_nb(xre, xim, tables: RTables | None = None):
    """Hybrid normalized inverse on time-major planes [m+1, ...] -> real
    [2m, ...]: the Hermitian pre in torch, the c2c kernel through strides."""
    return _inverse(xre, xim, "hybrid", "nb", tables)


def rfft_nb_fused(x, tables: RTables | None = None):
    """Fused real FFT, time-major real [n, ...] -> planes [n//2+1, ...]:
    one pass of the r2c kernel."""
    return _forward(x, "fused", "nb", tables)


def irfft_nb_fused(xre, xim, tables: RTables | None = None):
    """Fused normalized inverse, time-major planes [m+1, ...] -> real
    [2m, ...]: one pass of the c2r kernel."""
    return _inverse(xre, xim, "fused", "nb", tables)


def rfft_bm(x, fused: bool = True, tables: RTables | None = None):
    """Real FFT on batch-major real [..., n] -> planes [..., n//2+1]."""
    return _forward(x, _route(fused), "bm", tables)


def irfft_bm(xre, xim, fused: bool = True, tables: RTables | None = None):
    """Normalized inverse on batch-major planes [..., m+1] -> real [..., 2m]."""
    return _inverse(xre, xim, _route(fused), "bm", tables)


def rfft(x, fused: bool = True, tables: RTables | None = None):
    """Real FFT over the last axis: real [..., n] -> complex [..., n//2+1].
    On CUDA the kernel writes the interleaved complex storage itself."""
    return _forward(x, _route(fused), "complex", tables)


def irfft(x, fused: bool = True, tables: RTables | None = None):
    """Normalized inverse over the last axis: complex [..., m+1] -> real
    [..., 2m]. Reads the imaginary parts of the DC and Nyquist bins, as the
    JAX package does."""
    return _inverse(x, None, _route(fused), "complex", tables)


def plain_rfft(x, tables: RTables | None = None):
    """The plain version of `rfft`: torch ops on any device. The wrappers
    use it for CPU tensors; on CUDA it is the reference the kernels are
    held against."""
    n = x.shape[-1]
    rt = _resolve(tables, n, False, x.device, x.dtype)
    xv = stockham._dense(x).reshape(-1, n).T
    re, im = _plain_r2c(xv, rt)
    return torch.complex(re, im).T.reshape(x.shape[:-1] + (n // 2 + 1,))


def plain_irfft(x, tables: RTables | None = None):
    """The plain version of `irfft`: complex [..., m+1] -> real [..., 2m]."""
    m1 = x.shape[-1]
    n = 2 * (m1 - 1)
    rt = _resolve(tables, n, True, x.device, x.dtype)
    xv = stockham._dense(x).reshape(-1, m1).T
    return _plain_c2r(xv.real, xv.imag, rt).T.reshape(x.shape[:-1] + (n,))
