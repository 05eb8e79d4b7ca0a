"""Complex FFT of any length n by the Bluestein chirp-z transform: host
tables, plain versions, kernel wrappers, routes, autograd.

Counterpart of `watfft_tpu/ops/bluestein.py`. With jk = (j^2 + k^2 - (k - j)^2) / 2,

    X[k] = c_k * sum_j (x_j c_j) conj(c_{k-j}),   c_t = e^{-i pi t^2 / n},

a linear convolution, evaluated as a circular one of power-of-two length
m >= 2n - 1:

    X = c . IFFT_m(FFT_m(a) . B)[0..n),   a = c . x zero-extended to m,
    B = FFT_m(conj c, embedded circularly).

`chirp_tables` builds c and B once per (n, direction) on the host in f64
(the phase t^2 mod 2n is exact in int64) and rounds them to f32: the numpy
code of the JAX package's `_ChirpCache.get`, so the tables are its tables
bit for bit (B included, which it takes from numpy's f64 FFT of the
embedded kernel; no transform of the caller's data runs through a library
FFT). The inverse uses the conjugate chirp and a final 1/n.

Two routes, chosen by `planner.bluestein_kernel` from m alone:

* "bluestein-fused" (m <= planner.STOCKHAM_MAX_N, i.e. n <= 2048): one
  launch of the one-pass kernel of `csrc/bluestein.cu`, the counterpart of
  the JAX package's `_bluestein_fused` (#17 then #18). It multiplies the n
  input rows by the chirp, zero-extends them to m in shared memory, runs
  the m-point forward stages, multiplies by B, runs the m-point inverse
  stages and stores the first n rows times the final chirp, which carries
  the inverse's 1/n: one pass through device memory, 8n bytes read and 8n
  written per transform. The pair #17 (`bluestein_fwd`: x to the m-point
  spectrum times B) and #18 (`bluestein_inv`: that spectrum to the
  transform) remain as kernels of their own, the counterparts of
  `_bl_fwd_call` and `_bl_inv_call`.
* "bluestein-<route of m>" (n > 2048): the chirp multiplies and the zero
  extension as torch ops, the two m-point transforms on the port's own
  route for m (the four-step kernels to 2^24, the matmul surface past it),
  as `_bluestein_jit` runs them in XLA.

The plain versions (`plain_bluestein_fwd`, `plain_bluestein_inv`,
`plain_bluestein_onepass`) compute each kernel's function in torch ops
around `stockham.run_stages`; the wrappers use them for CPU tensors, and on
CUDA they are the references the kernels are held against. A CUDA tensor
launches the kernels or raises.

Forms: time-major planes [n, ...] (`bluestein_fft_nb`, the JAX signature),
batch-major planes [..., n] (`bluestein_fft_bm`) and complex tensors
[..., n] (`bluestein_fft`, whose interleaved complex64 storage the kernels
read and write themselves). Any batch, no padding. Every form is
differentiable: the transform is linear, and its adjoint is n * IFFT for
the forward and FFT / n for the normalized inverse (bluestein.py:302-315).
n = 1 is the identity (m = 1 has no stage to run).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import api, planner, trace
from ..planner import bluestein_m
from . import _build, large, stockham
from .stockham import Tables, check_device, run_stages

__all__ = ["bluestein_m", "chirp_tables", "BluesteinTables", "make_bluestein_tables",
           "device_bluestein_tables", "plain_bluestein_fwd", "plain_bluestein_inv",
           "plain_bluestein_onepass", "bluestein_fwd", "bluestein_inv", "bluestein_fft_nb",
           "bluestein_fft_bm", "bluestein_fft", "plain_bluestein_fft"]


@functools.cache
def chirp_tables(n: int, inverse: bool):
    """(m, cre, cim, bre, bim): the chirp c_t = e^{-+i pi (t^2 mod 2n) / n}
    ([n, 1] f32 columns) and B = FFT_m(conj c, circularly embedded) ([m, 1]),
    f64 host math (the code of watfft_tpu/ops/bluestein.py:51-76). The
    arrays are read-only: they are cached."""
    m = bluestein_m(n)
    t = np.arange(n, dtype=np.int64)
    ph = (t * t) % (2 * n)          # exact phase reduction
    sign = +1.0 if inverse else -1.0
    ang = sign * np.pi * ph.astype(np.float64) / n
    c = np.cos(ang) + 1j * np.sin(ang)
    b = np.conj(c)
    bc = np.zeros(m, np.complex128)
    bc[:n] = b
    bc[m - n + 1:] = b[1:][::-1]                 # b_{-t} = b_t
    bspec = np.fft.fft(bc)
    cols = []
    for a in (c.real, c.imag, bspec.real, bspec.imag):
        col = np.ascontiguousarray(a, np.float32).reshape(-1, 1)
        col.flags.writeable = False
        cols.append(col)
    return (m, *cols)


# -- tables ----------------------------------------------------------------------

@dataclass(eq=False)
class BluesteinTables:
    """One length n and direction on one device: the chirp c (`cre`, `cim`,
    n f32 values), the final chirp (`fre`, `fim`: c, times 1/n for the
    inverse), B (`bre`, `bim`, m values) and, for the fused route, the
    m-point forward (`fwd`) and inverse (`inv`) Stockham tables (None on
    the unfused route, whose m-point transforms bring their own)."""
    n: int
    inverse: bool
    cre: torch.Tensor
    cim: torch.Tensor
    fre: torch.Tensor
    fim: torch.Tensor
    bre: torch.Tensor
    bim: torch.Tensor
    fwd: Tables | None
    inv: Tables | None
    m: int = field(init=False)

    def __post_init__(self):
        self.m = self.bre.numel()
        if self.m < 2 * self.n - 1 or self.m & (self.m - 1) or self.cre.numel() != self.n:
            raise ValueError(f"Bluestein tables of {self.cre.numel()} chirp and {self.m} "
                             f"spectrum values for n={self.n}: need n and a power of two "
                             f">= 2n - 1")
        for t in (self.fwd, self.inv):
            if t is not None and t.n != self.m:
                raise ValueError(f"m-point tables for n={t.n}, m={self.m}")


def make_bluestein_tables(n: int, cre, cim, bre, bim, fwd: Tables | None, inv: Tables | None,
                          inverse: bool, device) -> BluesteinTables:
    """BluesteinTables on `device` from host columns (numpy, any shape):
    the chirp and B of `chirp_tables`, and the m-point Stockham tables
    (or None). The final chirp is c times f32(1/n) for the inverse, the
    JAX package's fold (bluestein.py:202-206)."""
    device = check_device(device)
    cre32 = np.asarray(cre, np.float32).reshape(-1)
    cim32 = np.asarray(cim, np.float32).reshape(-1)
    fre, fim = cre32, cim32
    if inverse:
        s = np.float32(1.0 / n)
        fre, fim = cre32 * s, cim32 * s

    def put(a):
        return trace.h2d(np.array(a, np.float32).reshape(-1), device)
    return BluesteinTables(int(n), bool(inverse), put(cre32), put(cim32), put(fre), put(fim),
                           put(bre), put(bim), fwd, inv)


@functools.cache
def _cached(n: int, inverse: bool, device: torch.device) -> BluesteinTables:
    trace.counts["tables_built"] += 1
    m, cre, cim, bre, bim = chirp_tables(n, inverse)
    fwd = inv = None
    if planner.bluestein_kernel(n) == "bluestein-fused":
        fwd = stockham.device_tables(m, False, device)
        inv = stockham.device_tables(m, True, device)
    return make_bluestein_tables(n, cre, cim, bre, bim, fwd, inv, inverse, device)


def device_bluestein_tables(n: int, inverse: bool, device) -> BluesteinTables:
    """The port's own tables for (n, direction), built once per device."""
    if n < 1:
        raise ValueError(f"the FFT takes n >= 1 points, got n={n}")
    return _cached(int(n), bool(inverse), check_device(device))


# -- each kernel: plain version and launch ---------------------------------------
# An operand is a pair of float tensors (re, im) whose first elements mark
# where the operand starts in their storage, plus its strides in floats
# (point, sequence). CUDA: their addresses go to the kernels; CPU (or
# plain=True): views of their storage go to the plain versions.

def _as(t: torch.Tensor, size, stride) -> torch.Tensor:
    return t.as_strided(size, stride, t.storage_offset())


def _cmul(are, aim, bre, bim):
    return are * bre - aim * bim, are * bim + aim * bre


def _col(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The table t as a column against the [rows, ...] planes `like`."""
    return t.view((t.numel(),) + (1,) * (like.dim() - 1))


def _plain_fwd(xre, xim, bt: BluesteinTables):
    """#17's function on [n, ...] planes (any strides) -> new [m, ...]
    planes: x times the chirp, zero-extended, the m-point forward stages,
    times B (bluestein.py:91-110)."""
    are, aim = _cmul(xre, xim, _col(bt.cre, xre), _col(bt.cim, xre))
    z = are.new_zeros((bt.m - bt.n,) + tuple(are.shape[1:]))
    t = bt.fwd
    ore, oim = run_stages(torch.cat([are, z]), torch.cat([aim, z]), bt.m, False, t.offsets,
                          t.stages, t.twre, t.twim)
    return _cmul(ore, oim, _col(bt.bre, ore), _col(bt.bim, ore))


def _plain_inv(fre, fim, bt: BluesteinTables):
    """#18's function on [m, ...] planes -> new [n, ...] planes: the m-point
    inverse stages (1/m in the last), the first n rows times the final
    chirp (bluestein.py:113-128)."""
    t = bt.inv
    ore, oim = run_stages(fre, fim, bt.m, True, t.offsets, t.stages, t.twre, t.twim)
    ore, oim = ore[:bt.n], oim[:bt.n]
    return _cmul(ore, oim, _col(bt.fre, ore), _col(bt.fim, ore))


def _plain_onepass(xre, xim, bt: BluesteinTables):
    """The one-pass kernel's function on [n, ...] planes -> new [n, ...]
    planes: #17's then #18's, the intermediate never leaving torch
    (`_bluestein_fused`, bluestein.py:192-213)."""
    return _plain_inv(*_plain_fwd(xre, xim, bt), bt)


def _plan(t: Tables) -> tuple:
    return t.twre.data_ptr(), t.twim.data_ptr(), t.c_radices, t.c_offsets, len(t.stages)


def _launch(key: str, x, xs, y, ys, n: int, batch: int, bt: BluesteinTables) -> None:
    """Launches the kernel `key` ("bluestein_fwd", "bluestein_inv" or
    "bluestein_onepass", counted under it in `trace.launches`; the unfused
    route counts as the four-step kernels) on the operands' raw addresses."""
    _build.kernel_dtype(x[0], torch.float32)
    args = (x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(), *xs, *ys,
            n, bt.m, batch)
    if key == "bluestein_fwd":
        args += (bt.cre.data_ptr(), bt.cim.data_ptr(), bt.bre.data_ptr(), bt.bim.data_ptr(),
                 *_plan(bt.fwd))
    elif key == "bluestein_inv":
        args += (bt.fre.data_ptr(), bt.fim.data_ptr(), *_plan(bt.inv))
    else:
        args += (bt.cre.data_ptr(), bt.cim.data_ptr(), bt.bre.data_ptr(), bt.bim.data_ptr(),
                 bt.fre.data_ptr(), bt.fim.data_ptr(), *_plan(bt.fwd), *_plan(bt.inv))
    _build.launch(key, x[0].device, "watfft_" + key, args, (),
                  lambda: f"n={n}, m={bt.m}, batch={batch}")


def _fwd(x, xs, y, ys, batch: int, bt: BluesteinTables, plain: bool) -> None:
    """#17: y [m points] = FFT_m(c . x zero-extended) . B, per sequence."""
    if _build.use_kernel(x[0], plain):
        _launch("bluestein_fwd", x, xs, y, ys, bt.n, batch, bt)
        return
    ore, oim = _plain_fwd(*(_as(t, (bt.n, batch), xs) for t in x), bt)
    _as(y[0], (bt.m, batch), ys).copy_(ore)
    _as(y[1], (bt.m, batch), ys).copy_(oim)


def _inv(x, xs, y, ys, batch: int, bt: BluesteinTables, plain: bool) -> None:
    """#18: y [n points] = IFFT_m(x)[0..n) . final chirp, per sequence."""
    if _build.use_kernel(x[0], plain):
        _launch("bluestein_inv", x, xs, y, ys, bt.n, batch, bt)
        return
    ore, oim = _plain_inv(*(_as(t, (bt.m, batch), xs) for t in x), bt)
    _as(y[0], (bt.n, batch), ys).copy_(ore)
    _as(y[1], (bt.n, batch), ys).copy_(oim)


def _onepass(x, xs, y, ys, batch: int, bt: BluesteinTables, plain: bool) -> None:
    """The fused route: y [n points] = DFT_n(x), per sequence, in one launch."""
    if _build.use_kernel(x[0], plain):
        _launch("bluestein_onepass", x, xs, y, ys, bt.n, batch, bt)
        return
    ore, oim = _plain_onepass(*(_as(t, (bt.n, batch), xs) for t in x), bt)
    _as(y[0], (bt.n, batch), ys).copy_(ore)
    _as(y[1], (bt.n, batch), ys).copy_(oim)


def _check_planes(a, b) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"re and im planes differ: {a.shape} {a.dtype} {a.device} vs "
                         f"{b.shape} {b.dtype} {b.device}")


def _kernel_planes(xre, xim, rows: int, n: int, inverse: bool, tables, kernel, plain: bool):
    """One kernel (`_fwd`, `_inv` or `_onepass`) on the JAX kernels'
    time-major planes [rows, b], on the port's tables or (the plain
    versions) the caller's."""
    _check_planes(xre, xim)
    if xre.dim() != 2 or xre.shape[0] != rows:
        raise ValueError(f"expected [{rows}, b] planes, got {tuple(xre.shape)}")
    inverse = bool(inverse)
    if tables is None:
        bt = device_bluestein_tables(n, inverse, xre.device)
    elif (tables.n, tables.inverse) != (n, inverse):
        raise ValueError(f"tables are for n={tables.n} "
                         f"{'inverse' if tables.inverse else 'forward'}, got n={n} "
                         f"{'inverse' if inverse else 'forward'}")
    else:
        bt = tables
    if bt.fwd is None:
        raise ValueError(f"n={n}: m={bt.m} is past the fused kernels' one block "
                         f"(planner.bluestein_kernel)")
    b = xre.shape[1]
    x = (stockham._dense(xre), stockham._dense(xim))
    rows_out = bt.m if kernel is _fwd else n
    y = (x[0].new_empty(rows_out, b), x[1].new_empty(rows_out, b))
    if b:
        kernel(x, (b, 1), y, (b, 1), b, bt, plain)
    return y


def bluestein_fwd(xre, xim, inverse: bool = False):
    """#17 alone on time-major planes [n, b] -> [m, b] (the shapes of the
    JAX package's `_bl_fwd_call`). `inverse` picks the direction's tables
    (the conjugate chirp); the m-point stages are forward either way."""
    n = xre.shape[0]
    return _kernel_planes(xre, xim, n, n, inverse, None, _fwd, plain=False)


def plain_bluestein_fwd(xre, xim, inverse: bool = False, tables: BluesteinTables | None = None):
    """The plain version of `bluestein_fwd`, on any device; `tables` (for
    example the JAX package's, through `convert.bluestein_tables_from_jax`)
    replace the port's own."""
    n = xre.shape[0]
    return _kernel_planes(xre, xim, n, n, inverse, tables, _fwd, plain=True)


def bluestein_inv(fre, fim, n: int, inverse: bool = False):
    """#18 alone on time-major planes [m, b] -> [n, b] (`_bl_inv_call`'s
    shapes): the m-point inverse, the first n rows times the final chirp
    (with 1/n for the Bluestein inverse)."""
    return _kernel_planes(fre, fim, bluestein_m(n), n, inverse, None, _inv, plain=False)


def plain_bluestein_inv(fre, fim, n: int, inverse: bool = False,
                        tables: BluesteinTables | None = None):
    """The plain version of `bluestein_inv`, on any device; `tables` as for
    `plain_bluestein_fwd`."""
    return _kernel_planes(fre, fim, bluestein_m(n), n, inverse, tables, _inv, plain=True)


def plain_bluestein_onepass(xre, xim, inverse: bool = False,
                            tables: BluesteinTables | None = None):
    """The plain version of the one-pass kernel on time-major planes
    [n, b] -> [n, b] (the shapes of the JAX package's `_bluestein_fused`;
    on the card `bluestein_fft_nb` launches the kernel for n <= 2048), on
    any device: the plain versions of #17 and #18 in turn; `tables` as for
    `plain_bluestein_fwd`."""
    n = xre.shape[0]
    return _kernel_planes(xre, xim, n, n, inverse, tables, _onepass, plain=True)


# -- the routes on [n, batch] operands ----------------------------------------------

def _fft_m(a: torch.Tensor, inverse: bool, plain: bool) -> torch.Tensor:
    """The m-point transform of the complex [batch, m] a on the port's route
    for m (`api.fft`: the four-step kernels or the matmul surface); with
    plain=True the four-step kernels' plain version."""
    if plain and planner.c2c_kernel(a.shape[-1], "float32", a.shape[0]) != "fourstep":
        return large.plain_fft_large(a, inverse)
    return (api.ifft if inverse else api.fft)(a, device=a.device)


def _unfused(x, xs, y, batch: int, bt: BluesteinTables, plain: bool) -> None:
    """The route past one block (bluestein.py:267-286) on batch-major
    [batch, m] complex64: x times the chirp, zero-extended; FFT_m; times B;
    IFFT_m; the first n rows times the final chirp (the inverse's 1/n
    folded in, as on the fused route)."""
    n, m = bt.n, bt.m
    xv = torch.complex(*(_as(t, (batch, n), (xs[1], xs[0])) for t in x))
    a = xv.new_zeros(batch, m)
    torch.mul(xv, torch.complex(bt.cre, bt.cim), out=a[:, :n])
    f = _fft_m(a, False, plain)
    f *= torch.complex(bt.bre, bt.bim)
    g = _fft_m(f, True, plain)[:, :n] * torch.complex(bt.fre, bt.fim)
    _as(y[0], (batch, n), (xs[1], xs[0])).copy_(g.real)
    _as(y[1], (batch, n), (xs[1], xs[0])).copy_(g.imag)


def _run(x, xs, y, batch: int, bt: BluesteinTables, plain: bool) -> None:
    """y = DFT_n(x) (normalized inverse for bt.inverse) for `batch`
    sequences; point k of sequence s at k*xs[0] + s*xs[1] floats past x's
    first elements (y likewise)."""
    n = bt.n
    if n == 1:
        for src, dst in zip(x, y):
            _as(dst, (batch,), (xs[1],)).copy_(_as(src, (batch,), (xs[1],)))
        return
    if bt.fwd is None:  # the unfused route (planner.bluestein_kernel)
        _unfused(x, xs, y, batch, bt, plain)
        return
    _onepass(x, xs, y, xs, batch, bt, plain)


# -- forms, autograd ------------------------------------------------------------------
# layout "nb": planes [n, ...]; "bm": planes [..., n]; "complex": complex
# [..., n] (interleaved storage: re and im 4 bytes apart, stride 2).

def _forms(a, b, inverse: bool, layout: str, plain: bool = False):
    if _build.use_kernel(a, plain):  # the unfused route would run any dtype; the kernels take f32
        _build.kernel_dtype(a, torch.complex64 if layout == "complex" else torch.float32)
    if layout == "complex":
        n = a.shape[-1]
        x = stockham._dense(a)
        out = torch.empty_like(x)
        fx, fo = torch.view_as_real(x).view(-1), torch.view_as_real(out).view(-1)
        xo, yo = (fx, fx[1:]), (fo, fo[1:])  # re at the base, im 4 bytes on
    else:
        _check_planes(a, b)
        n = a.shape[0] if layout == "nb" else a.shape[-1]
        x = a
        xo = (stockham._dense(a), stockham._dense(b))
        out = yo = (torch.empty_like(xo[0]), torch.empty_like(xo[1]))
    bt = device_bluestein_tables(n, inverse, x.device)
    batch = x.numel() // n
    if batch:
        strides = {"nb": (batch, 1), "bm": (1, n), "complex": (2, 2 * n)}[layout]
        _run(xo, strides, yo, batch, bt, plain)
    return out


class _BluesteinFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, inverse, layout):
        ctx.inverse, ctx.layout = inverse, layout
        out = _forms(a, b, inverse, layout)
        return out if layout == "complex" else tuple(out)

    @staticmethod
    def backward(ctx, *g):
        # the adjoint of FFT_n is n * IFFT_n, that of the normalized IFFT_n
        # is FFT_n / n, both through this Function (bluestein.py:302-315)
        layout = ctx.layout
        n = g[0].shape[0] if layout == "nb" else g[0].shape[-1]
        s = 1.0 / n if ctx.inverse else float(n)
        if layout == "complex":
            return (_BluesteinFFT.apply(g[0], None, not ctx.inverse, layout) * s,
                    None, None, None)
        ore, oim = _BluesteinFFT.apply(g[0], g[1], not ctx.inverse, layout)
        return ore * s, oim * s, None, None


def _transform(a, b, inverse, layout):
    if stockham._wants_grad(*(t for t in (a, b) if t is not None)):
        return _BluesteinFFT.apply(a, b, bool(inverse), layout)
    out = _forms(a, b, bool(inverse), layout)
    return out if layout == "complex" else tuple(out)


def bluestein_fft_nb(xre, xim, inverse: bool = False):
    """Complex FFT of any length n on time-major f32 planes [n, ...] (the
    JAX package's signature). The inverse is normalized (1/n). Any batch,
    no padding; differentiable."""
    return _transform(xre, xim, inverse, "nb")


def bluestein_fft_bm(xre, xim, inverse: bool = False):
    """Complex FFT of any length n on batch-major planes [..., n]."""
    return _transform(xre, xim, inverse, "bm")


def bluestein_fft(x, inverse: bool = False):
    """Complex FFT of any length n over the last axis of a complex tensor
    [..., n]; on CUDA the kernels read and write the interleaved complex64
    storage."""
    return _transform(x, None, inverse, "complex")


def plain_bluestein_fft(x, inverse: bool = False):
    """The plain version of `bluestein_fft` on any device: the one-pass
    kernel's plain version on the same strided views (on the unfused route,
    the four-step kernels' plain version). On CUDA it is the reference the
    kernels are held against."""
    return _forms(x, None, bool(inverse), "complex", plain=True)
