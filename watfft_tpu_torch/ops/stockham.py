"""Batched mixed-radix Stockham FFT: host tables, plain version, kernel wrapper.

Counterpart of `watfft_tpu/ops/pallas_stockham.py`. The transform is the
same: `stage_plan` splits n into radix-16 stages plus one {2,4,8}
remainder, `make_twiddle_pack` builds per-stage twiddle columns in f64 on
the host (1/n folded into the last inverse stage), and every stage is a
radix-R butterfly over R contiguous row blocks followed by the Stockham
interleave. Forward and inverse differ only by a sign flip.

Two implementations of one function:

* `run_stages` — the plain version, written in torch ops on `[n, ...]`
  planes of any float dtype and any power-of-two radix plan (including the
  JAX package's radix-32/64 plans); `plain_fft` applies it to complex
  tensors. The wrappers use it for CPU tensors.
* `csrc/stockham.cu` — the Hopper kernel, built at first use by `_build`.
  The wrappers launch it for every CUDA tensor; a kernel that fails to
  build or launch raises, there is no fallback.

The wrappers (`stockham_fft_nb` time-major planes, `stockham_fft_bm`
batch-major planes, `stockham_fft` complex tensors) are differentiable: the
gradient of the DFT is the conjugate transform, VJP(fft) = n * ifft and
VJP(ifft) = fft / n, run through the same wrapper
(pallas_stockham.py:590-600). The backward uses the port's own tables for
the conjugate direction.

The kernel takes separate re and im pointers with an element stride along
n and one along the batch, so one launch serves interleaved complex64
(stride 2, im at base + 4 bytes), split planes, batch-major `[B, n]` and
time-major `[n, B]` — the `[n, 8, W]` view of `_kernel_dma3d` included.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["stage_plan", "make_twiddle_pack", "run_stages", "plain_fft",
           "Tables", "make_tables", "device_tables", "stockham_fft_nb",
           "stockham_fft_bm", "stockham_fft", "launches"]

# Kernel launches made by the CUDA wrapper since the count was last reset.
launches = 0

# Largest radix of the default plan; the kernel takes 2, 4, 8 and 16.
MAX_RADIX = 16


def stage_plan(n: int) -> list[tuple[int, int]]:
    """Stage sequence as (R, l) pairs: radix-16 stages plus one {2,4,8}
    remainder — radix-8 leads, radix-2/4 sit at position 1. This is the JAX
    package's default rule (pallas_stockham.py:87-105) without its measured
    TPU overrides."""
    m = n.bit_length() - 1
    radices = []
    while m >= 4:
        radices.append(MAX_RADIX)
        m -= 4
    if m:
        rem = 1 << m
        if not radices:
            radices.append(rem)          # tiny n: single stage
        elif rem == 8:
            radices.insert(0, rem)
        else:
            radices.insert(1, rem)
    stages = []
    l = 1
    for r in radices:
        stages.append((r, l))
        l *= r
    return stages


def make_twiddle_pack(n: int, inverse: bool) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Pack per-stage twiddle columns w_{R*l}^{p*(row mod l)}, p=1..R-1, into
    [total, 1] f32 planes (f64 host math, phases reduced mod R*l). offsets[i]
    = row offset of stage i's block ((R-1)*(n/R) rows); -1 for the
    twiddle-free l==1 stage. The final stage carries the folded 1/n for the
    inverse. Same numpy code as pallas_stockham.py:114-142."""
    sign = +1.0 if inverse else -1.0
    res, ims, offsets = [], [], []
    off = 0
    stages = stage_plan(n)
    for idx, (r, l) in enumerate(stages):
        if l == 1:
            offsets.append(-1)
            continue
        rows = n // r
        k = np.arange(rows, dtype=np.int64) % l
        scale = (1.0 / n) if (inverse and idx == len(stages) - 1) else 1.0
        for p in range(1, r):
            ang = sign * 2.0 * np.pi * ((p * k) % (r * l)) / (r * l)
            res.append((scale * np.cos(ang)).astype(np.float32))
            ims.append((scale * np.sin(ang)).astype(np.float32))
        offsets.append(off)
        off += (r - 1) * rows
    if not res:  # single twiddle-free stage; keep a dummy row
        res, ims = [np.ones(1, np.float32)], [np.zeros(1, np.float32)]
    re = np.concatenate(res).reshape(-1, 1)
    im = np.concatenate(ims).reshape(-1, 1)
    return re, im, offsets


# -- plain version -------------------------------------------------------------

def _small_dft(res, ims, inverse: bool):
    """R-point DFT across R part-tensors via a recursive radix-2 network with
    scalar constant twiddles. X_q = sum_p part_p * w_R^{p*q},
    w_R = exp(-+2i pi / R). Python-float constants follow the tensor dtype."""
    r = len(res)
    if r == 1:
        return res, ims
    ere, eim = _small_dft(res[0::2], ims[0::2], inverse)
    ore, oim = _small_dft(res[1::2], ims[1::2], inverse)
    half = r // 2
    sign = +1.0 if inverse else -1.0
    out_re = [None] * r
    out_im = [None] * r
    for q in range(half):
        ang = sign * 2.0 * math.pi * q / r
        wr, wi = math.cos(ang), math.sin(ang)
        orq, oiq = ore[q], oim[q]
        if q == 0:  # w = 1
            tre, tim = orq, oiq
        elif 4 * q == r:  # w = -+i: (re,im) -> (+-im, -+re)
            if inverse:
                tre, tim = -oiq, orq
            else:
                tre, tim = oiq, -orq
        else:
            tre = orq * wr - oiq * wi
            tim = orq * wi + oiq * wr
        out_re[q] = ere[q] + tre
        out_im[q] = eim[q] + tim
        out_re[q + half] = ere[q] - tre
        out_im[q + half] = eim[q] - tim
    return out_re, out_im


def _stage(cre, cim, n, r, l, tw, inverse, scale0):
    """One Stockham stage on [n, ...] planes: twiddle, R-point DFT across
    the R row blocks, then interleave rows j*R*l + q*l + k."""
    q = n // r
    rest = tuple(cre.shape[1:])
    bs_re = [cre[p * q:(p + 1) * q] for p in range(r)]
    bs_im = [cim[p * q:(p + 1) * q] for p in range(r)]
    if tw is not None:
        twre, twim = tw
        col = (q,) + (1,) * len(rest)
        for p in range(1, r):
            wr = twre[(p - 1) * q:p * q].reshape(col)
            wi = twim[(p - 1) * q:p * q].reshape(col)
            br, bi = bs_re[p], bs_im[p]
            bs_re[p] = br * wr - bi * wi
            bs_im[p] = br * wi + bi * wr
    if scale0 is not None:  # inverse final stage: fold 1/n into the p=0 term
        bs_re[0] = bs_re[0] * scale0
        bs_im[0] = bs_im[0] * scale0
        if tw is None:  # twiddle-free final stage: scale every term
            for p in range(1, r):
                bs_re[p] = bs_re[p] * scale0
                bs_im[p] = bs_im[p] * scale0
    xs_re, xs_im = _small_dft(bs_re, bs_im, inverse)
    g = n // (r * l)
    return _interleave(xs_re, g, l, rest), _interleave(xs_im, g, l, rest)


def _interleave(parts, g, l, rest):
    """Stockham output permute: R parts of [g*l, ...] -> [n, ...] with rows
    j*R*l + q*l + k."""
    n = len(parts) * g * l
    return torch.stack([p.reshape(g, l, *rest) for p in parts], dim=1).reshape(n, *rest)


def run_stages(cre, cim, n, inverse, offsets, stages, twre, twim):
    """Run the full Stockham stage chain on [n, ...] planes (the transform
    runs along axis 0; any strides). twre/twim: the packed twiddle columns
    (any shape with `total` elements); arithmetic follows the planes' dtype."""
    twre = twre.reshape(-1).to(cre.dtype)
    twim = twim.reshape(-1).to(cre.dtype)
    for idx, (r, l) in enumerate(stages):
        is_final = idx == len(stages) - 1
        tw = None
        if offsets[idx] >= 0:
            o = offsets[idx]
            rows = (r - 1) * (n // r)
            tw = (twre[o:o + rows], twim[o:o + rows])
        scale0 = 1.0 / n if (inverse and is_final) else None
        cre, cim = _stage(cre, cim, n, r, l, tw, inverse, scale0)
    return cre, cim


# -- device tables -------------------------------------------------------------

@dataclass(eq=False)
class Tables:
    """One transform length and direction on one device: the stage plan as
    (R, l) pairs, each stage's offset into the twiddle pack (-1 for the
    twiddle-free l=1 stage) and the pack itself as 1-D f32 tensors. The
    plan's ctypes arrays for the kernel are built once, here."""
    stages: tuple[tuple[int, int], ...]
    offsets: tuple[int, ...]
    twre: torch.Tensor
    twim: torch.Tensor
    n: int = field(init=False)

    def __post_init__(self):
        self.n = math.prod(r for r, _ in self.stages)
        nst = len(self.stages)
        self.c_radices = (ctypes.c_int * nst)(*(r for r, _ in self.stages))
        self.c_offsets = (ctypes.c_int * nst)(*self.offsets)


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the Stockham FFT runs on CPU or CUDA tensors, got device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_tables(stages, offsets, twre, twim, device) -> Tables:
    """Tables on `device` from a host plan and twiddle pack (numpy)."""
    device = check_device(device)
    stages = tuple((int(r), int(l)) for r, l in stages)
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) != len(stages):
        raise ValueError(f"{len(stages)} stages but {len(offsets)} offsets")

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32).reshape(-1), device=device)
    return Tables(stages, offsets, put(twre), put(twim))


@functools.cache
def _cached_tables(n: int, inverse: bool, device: torch.device) -> Tables:
    re, im, offsets = make_twiddle_pack(n, inverse)
    return make_tables(stage_plan(n), offsets, re, im, device)


def device_tables(n: int, inverse: bool, device) -> Tables:
    """The port's own tables for (n, direction), built once per device."""
    return _cached_tables(int(n), bool(inverse), check_device(device))


# -- dispatch ------------------------------------------------------------------
# CPU tensors take the plain version on [n, B] views; CUDA tensors launch the
# kernel on raw addresses and strides, which costs the host no view objects.

def _plain_into(xre, xim, yre, yim, inverse: bool, tables: Tables) -> None:
    """y = DFT along axis 0 of the [n, B] views x, written into the views y."""
    ore, oim = run_stages(xre, xim, xre.shape[0], inverse, tables.offsets,
                          tables.stages, tables.twre, tables.twim)
    yre.copy_(ore)
    yim.copy_(oim)


def _launch(device, xre, xim, yre, yim, sn, sb, n, batch, inverse, tables) -> None:
    """Kernel on the [n, batch] planes whose element (k, b) sits k*sn + b*sb
    floats past the addresses xre, xim (input) and yre, yim (output)."""
    global launches
    from ._build import library

    if tables.twre.device != device:
        raise ValueError(f"tables on {tables.twre.device}, data on {device}")
    lib = library()
    with torch.cuda.device(device):
        err = lib.watfft_stockham_c2c(
            xre, xim, yre, yim, sn, sb, sn, sb, n, batch,
            tables.twre.data_ptr(), tables.twim.data_ptr(), tables.c_radices,
            tables.c_offsets, len(tables.stages), int(inverse),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"Stockham kernel launch failed (n={n}, batch={batch}): "
            f"{lib.watfft_error_string(err).decode()}")
    launches += 1


def _kernel_dtype(t: torch.Tensor, want: torch.dtype) -> None:
    if t.dtype != want:
        raise TypeError(f"the CUDA kernel takes {want}, got {t.dtype}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t with its lazy conj and neg bits applied, in contiguous memory. The
    kernel reads raw storage, where `x.conj()` or `x.conj().imag` still hold
    the unconjugated values; autograd hands backward such views too."""
    return t.resolve_conj().resolve_neg().contiguous()


def _resolve(tables, n: int, inverse: bool, device) -> Tables:
    if tables is None:
        return device_tables(n, inverse, device)  # checks the device
    check_device(device)
    if tables.n != n:
        raise ValueError(f"tables are for n={tables.n}, got n={n}")
    return tables


def _planes(re, im, inverse, time_major, tables):
    if re.shape != im.shape or re.dtype != im.dtype or re.device != im.device:
        raise ValueError(f"re and im planes differ: {re.shape} {re.dtype} "
                         f"{re.device} vs {im.shape} {im.dtype} {im.device}")
    n = re.shape[0] if time_major else re.shape[-1]
    tables = _resolve(tables, n, inverse, re.device)
    re, im = _dense(re), _dense(im)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    batch = re.numel() // n
    if batch == 0:
        return ore, oim
    if re.device.type == "cuda":
        _kernel_dtype(re, torch.float32)
        sn, sb = (batch, 1) if time_major else (1, n)
        _launch(re.device, re.data_ptr(), im.data_ptr(), ore.data_ptr(),
                oim.data_ptr(), sn, sb, n, batch, inverse, tables)
    elif time_major:
        _plain_into(*(t.view(n, batch) for t in (re, im, ore, oim)), inverse, tables)
    else:
        _plain_into(*(t.view(batch, n).T for t in (re, im, ore, oim)), inverse, tables)
    return ore, oim


def plain_fft(x, inverse: bool = False, tables: Tables | None = None):
    """The plain version of `stockham_fft`: the same plan in torch ops, on
    any device. The wrappers use it for CPU tensors; on CUDA it is the
    reference the kernel is held against."""
    n = x.shape[-1]
    tables = _resolve(tables, n, inverse, x.device)
    xr = torch.view_as_real(_dense(x)).reshape(x.numel() // n, n, 2)
    ore, oim = run_stages(xr[..., 0].T, xr[..., 1].T, n, inverse, tables.offsets,
                          tables.stages, tables.twre, tables.twim)
    return torch.complex(ore, oim).T.reshape(x.shape)


def _complex(x, inverse, tables):
    n = x.shape[-1]
    tables = _resolve(tables, n, inverse, x.device)
    if x.device.type != "cuda":
        return plain_fft(x, inverse, tables)
    _kernel_dtype(x, torch.complex64)
    x = _dense(x)
    out = torch.empty_like(x)
    batch = x.numel() // n
    if batch:
        # interleaved complex64: re at the base, im 4 bytes on, stride 2
        xp, yp = x.data_ptr(), out.data_ptr()
        _launch(x.device, xp, xp + 4, yp, yp + 4, 2, 2 * n, n, batch, inverse, tables)
    return out


class _PlanesFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, inverse, time_major, tables):
        ctx.inverse, ctx.time_major = inverse, time_major
        return _planes(re, im, inverse, time_major, tables)

    @staticmethod
    def backward(ctx, gre, gim):
        n = gre.shape[0] if ctx.time_major else gre.shape[-1]
        ore, oim = _PlanesFFT.apply(gre, gim, not ctx.inverse, ctx.time_major, None)
        s = 1.0 / n if ctx.inverse else float(n)
        return ore * s, oim * s, None, None, None


class _ComplexFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, inverse, tables):
        ctx.inverse = inverse
        return _complex(x, inverse, tables)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1]
        s = 1.0 / n if ctx.inverse else float(n)
        return _ComplexFFT.apply(g, not ctx.inverse, None) * s, None, None


def _wants_grad(*ts) -> bool:
    # autograd's bookkeeping added ~6 us to a ~21 us call on the H100's
    # host (PERF.md); skip it unless a gradient can flow
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def stockham_fft_nb(re, im, inverse: bool = False, tables: Tables | None = None):
    """Batched FFT on time-major planes [n, ...] (the transform runs along
    axis 0; `[n, b]` and the `[n, 8, W]` view alike). Returns new planes of
    the same shape. Any batch size; no padding."""
    if _wants_grad(re, im):
        return _PlanesFFT.apply(re, im, bool(inverse), True, tables)
    return _planes(re, im, bool(inverse), True, tables)


def stockham_fft_bm(re, im, inverse: bool = False, tables: Tables | None = None):
    """Batched FFT on batch-major planes [..., n]."""
    if _wants_grad(re, im):
        return _PlanesFFT.apply(re, im, bool(inverse), False, tables)
    return _planes(re, im, bool(inverse), False, tables)


def stockham_fft(x, inverse: bool = False, tables: Tables | None = None):
    """Batched FFT over the last axis of a complex tensor [..., n]. On CUDA
    the kernel reads and writes the interleaved complex64 storage itself:
    no split or assemble pass."""
    if _wants_grad(x):
        return _ComplexFFT.apply(x, bool(inverse), tables)
    return _complex(x, bool(inverse), tables)
