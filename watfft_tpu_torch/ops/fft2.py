"""2D FFT over the trailing [h, w] axes: validation, plain versions, kernels,
autograd, and the 2D real FFT on it.

Counterpart of `watfft_tpu/ops/fft2.py`. A 2D FFT is separable: the h-point
FFTs down the w columns of each image, then the w-point FFTs along its h
rows (1/h and 1/w folded into the inverse's last stages). Three routes
compute it (`planner.fft2_kernel` picks one):

* "fft2-cube": one kernel holds whole images of h*w <= planner.CUBE_MAX_N
  points in shared memory and runs both passes there (#15
  `_fft2_cube_kernel`; `csrc/fft2.cu`);
* "fft2-2pass" (h, w <= 4096): the column pass, i.e. the strided c2c kernel
  of `csrc/large.cu` with n = h over the batch (column, image) (#11 as
  `fft2.py:191` uses it; counted as "fft2_cols"), into one intermediate
  buffer, then the row pass: the c2c kernel of `csrc/stockham.cu` on the
  rows of all images where they lie on one stride (#16
  `_rowfft_lanes_kernel`, "fft2_rows"), else the strided c2c kernel with
  n = w over the batch (row, image) (#14 `_fft2_k2_kernel` on the native
  [h, w, B] layout, "fft2_k2");
* "fft2-axes" (an axis over 4096): the same two passes, each axis over 4096
  on the port's 1D route for its n (the four-step kernels of `ops/large.py`,
  or the matmul surface past 2^24), as the JAX package runs XLA matmuls
  there (`fft2.py:63-68`).

What the TPU kernels did to keep 128 lanes full (the [h, w, B] lane layout,
the thin-batch route, the in-VMEM swaps) is strides here: each kernel takes
an element stride per axis, so one code path serves batch-major planes
[..., h, w] (`fft2_planes`), interleaved complex64 (`fft2_complex`), the
native [h, w, B] layout (`fft2_nb`) and the real input packed as complex
(`rfft2_planes`: z[j] = x[2j] + i x[2j+1] is the storage of x itself). Any
batch runs, with no padding and no moveaxis copies. CPU tensors run the
plain versions (`stockham.run_stages` on strided views); CUDA tensors launch
the kernels or raise. Every form is differentiable with the JAX custom VJP:
VJP(fft2) = h*w * ifft2, VJP(ifft2) = fft2 / (h*w).

`rfft2_planes` / `irfft2_planes` run one half-width 2D FFT and the 2D
Hermitian recombination `herm2_post_nb` / `herm2_pre_nb` (the algebra of
`fft2.py:327-411`, torch ops here as XLA ops there).
"""

from __future__ import annotations

import functools

import torch
from torch.autograd import profiler

from .. import planner, trace
from ..plan import build_tree, is_power_of_two
from . import fourstep, large
from . import rfft as rf
from . import stockham
from .stockham import Tables, check_device

__all__ = ["validate_fft2_shape", "validate_rfft2_shape", "ROUTES", "launches",
           "fft2_nb", "fft2_planes", "fft2_complex", "plain_fft2",
           "fft2_cube", "plain_fft2_cube", "cube2_block", "cube2_launch",
           "fft2_cols", "plain_fft2_cols", "fft2_k2", "plain_fft2_k2", "fft2_rows",
           "plain_fft2_rows",
           "herm2_post_nb", "herm2_pre_nb", "rfft2_planes", "irfft2_planes"]

# Kernel launches made by the CUDA wrappers since the counts were last set
# to 0: the cube (#15), the column pass (the strided c2c kernel), the
# native-layout row pass (#14, the same kernel) and the row pass on the
# c2c kernel (#16; those also count in `stockham.launches`).
launches = {"fft2_cube": 0, "fft2_cols": 0, "fft2_k2": 0, "fft2_rows": 0}

ROUTES = ("fft2-cube", "fft2-2pass", "fft2-axes")


def validate_fft2_shape(shape) -> None:
    """Typed boundary check for the public fft2/ifft2 API: trailing [h, w]
    must be powers of two >= 2 (the messages of watfft_tpu/ops/fft2.py:35)."""
    if len(shape) < 2:
        raise ValueError(
            f"fft2 needs at least 2 trailing axes [h, w], got shape {tuple(shape)}")
    h, w = shape[-2], shape[-1]
    for name, n in (("h", h), ("w", w)):
        if not is_power_of_two(int(n)) or n < 2:
            raise ValueError(
                f"fft2 axis {name} must be a power of two >= 2, got {n} "
                f"(shape {tuple(shape)})")


def validate_rfft2_shape(shape) -> None:
    validate_fft2_shape(shape)
    if shape[-1] < 4:
        raise ValueError(
            f"rfft2 needs w >= 4 (pack-as-complex m = w/2 >= 2), "
            f"got shape {tuple(shape)}")


# -- the passes ------------------------------------------------------------------
# An operand is a pair of flat float tensors (re, im) whose first elements
# mark where it starts in their storage (im may be re[1:], as in
# interleaved complex64), plus its strides in floats along h, w and the
# images. CUDA: their addresses go to the kernels; CPU (or plain=True):
# strided views of their storage go to the plain versions.

def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return t.device.type == "cuda" and not plain


def _merge(axes):
    """Two batch axes (count, x stride, y stride) as one, where their
    entries lie on one stride in both x and y; else None."""
    (na, xa, ya), (nb, xb, yb) = axes
    if nb == 1:
        return na, xa, ya
    if na == 1:
        return nb, xb, yb
    if xb == na * xa and yb == na * ya:
        return na * nb, xa, ya
    if xa == nb * xb and ya == nb * yb:
        return na * nb, xb, yb
    return None


@functools.cache
def _fourstep_tables(n: int, inverse: bool, device: torch.device):
    trace.counts["tables_built"] += 1
    tree = build_tree(n, inverse=inverse)
    return fourstep.fft_tables(tree, device), fourstep.shape_info(tree)


def _long_axis(x, y, n, sn, batch, inverse, plain) -> None:
    """DFT_n along an axis over 4096 points on one batch axis: the 1D
    route of the port for that n (planner.c2c_kernel)."""
    count, xb, yb = batch
    kind = planner.c2c_kernel(n, "float32", count, time_major=sn[0] > xb)
    if kind == "fourstep":  # the matmul surface runs on batch-major planes
        xv = [large._as(t, (count, n), (xb, sn[0])).contiguous() for t in x]
        ore, oim = fourstep.apply_tables(*xv, *_fourstep_tables(n, inverse, x[0].device))
        large._as(y[0], (count, n), (yb, sn[1])).copy_(ore)
        large._as(y[1], (count, n), (yb, sn[1])).copy_(oim)
        return
    lt = large.device_large_tables(n, inverse, x[0].device)
    large._run(x, (sn[0], xb), y, (sn[1], yb), count, lt, kind[len("large-"):], plain)


def _pass(x, y, n, sn, axes, inverse, table, key, plain) -> None:
    """y = DFT_n along one image axis of x, batched over the two other axes.
    sn: that axis's (x, y) element strides; axes: the other image axis and
    the images, as (count, x stride, y stride). With a Stockham table the
    strided c2c kernel (the cube's plain version takes an axis of 8192 so
    too); without one, an axis over 4096 on the 1D route of its n."""
    if table is not None:
        large.strided_c2c(x, y, n, (*sn, 0), [(*a, 0) for a in axes], inverse, table, key,
                          plain=plain, counts=launches)
        return
    merged = _merge(axes)
    if merged is not None:
        _long_axis(x, y, n, sn, merged, inverse, plain)
        return
    (na, xa, ya), (nb, xb, yb) = axes  # one call per image
    for i in range(nb):
        _long_axis(tuple(t[i * xb:] for t in x), tuple(t[i * yb:] for t in y), n, sn,
                   (na, xa, ya), inverse, plain)


def _cols(x, xs, y, ys, h, w, batch, inverse, table, plain) -> None:
    """The h-point FFTs down the columns of every image."""
    _pass(x, y, h, (xs[0], ys[0]), [(w, xs[1], ys[1]), (batch, xs[2], ys[2])], inverse, table,
          "fft2_cols", plain)


def _rows(x, xs, y, ys, h, w, batch, inverse, table, plain) -> None:
    """The w-point FFTs along the rows of every image: the c2c kernel (#16)
    where the rows of all images lie on one stride, else the strided c2c
    kernel over (row, image) (#14)."""
    rows = _merge([(h, xs[0], ys[0]), (batch, xs[2], ys[2])])
    if rows is not None and w <= planner.STOCKHAM_MAX_N and _use_kernel(x[0], plain):
        count, x_sr, y_sr = rows
        stockham._kernel_dtype(x[0], torch.float32)
        stockham._launch(x[0].device, torch.float32, x[0].data_ptr(), x[1].data_ptr(),
                         y[0].data_ptr(), y[1].data_ptr(), xs[1], x_sr, ys[1], y_sr, w, count,
                         inverse, table)
        launches["fft2_rows"] += 1
        return
    _pass(x, y, w, (xs[1], ys[1]), [(h, xs[0], ys[0]), (batch, xs[2], ys[2])], inverse, table,
          "fft2_k2", plain)


# -- the cube's launch ----------------------------------------------------------------
# The redesigned cube (csrc/fft2.cu fft2_cube_block_kernel, a block a tile):
# the host picks each launch's walk, one-point accesses and where the row
# pass stores, and passes them; the C entry sizes the block and refuses
# what the layout does not allow (PERF.md has the times that chose the
# rule).
SECTOR_BYTES = 32
# Native planes of at least this many points an image take the engine's
# walk: one image fills a block (the port's plans), which reads it an image
# stride apart in either walk, and the engine's walk measured up to 2%
# faster there.
CUBE2_ENGINE_NATIVE_POINTS = 4096
# Plans with no radix-16 axis (a caller's own tables) take the engine's
# walk from this many points: past it they may need a 512-thread block,
# which the redesigned walk builds only for radix pairs with a radix-16
# axis (the port's own plans wherever a block takes 512 threads).
CUBE2_SMALL_RADIX_POINTS = 2048


def _plan_radices(h: int, w: int) -> tuple[int, int]:
    """The largest radix of the port's own h- and w-point plans."""
    return tuple(max(r for r, _ in stockham.stage_plan(n)) for n in (h, w))


def cube2_block(h: int, w: int, x, y, radix=None) -> tuple[int, int, int, int]:
    """The redesigned walk's last arguments on h x w images: (WALK_BLOCK,
    pairs_x, pairs_y, direct). A block a tile, copying x and storing y one
    point at a time where `complex_pairs` (with an even row stride)
    allows, its row pass's last stage storing y itself where y's point
    stride is the smaller one and a row's threads span a 32-byte sector
    (else a loop stores the tile along the smaller stride after the pass).
    x, y: (re address, im address, row, point and image strides in
    floats); radix: the largest radix of the two plans (default: the
    port's own)."""
    radix = radix or _plan_radices(h, w)
    pairs = [int(stockham.complex_pairs(re, im, sw, sb) and sh % 2 == 0)
             for re, im, sh, sw, sb in (x, y)]
    y_sw, y_sb = y[3:]
    direct = y_sw <= y_sb and (w // radix[1]) * 4 * y_sw >= SECTOR_BYTES
    return stockham.WALK_BLOCK, *pairs, int(direct)


def cube2_launch(h: int, w: int, x, y, radix=None) -> tuple[int, int, int, int]:
    """The last arguments of a cube launch (walk, pairs_x, pairs_y,
    direct): the engine's walk, which takes none of the other three, on
    native planes (x's image stride the smaller) of at least
    CUBE2_ENGINE_NATIVE_POINTS an image and on plans with no radix-16 axis
    from CUBE2_SMALL_RADIX_POINTS; else `cube2_block`'s."""
    radix = radix or _plan_radices(h, w)
    if ((x[4] < x[3] and h * w >= CUBE2_ENGINE_NATIVE_POINTS)
            or (max(radix) < stockham.MAX_RADIX and h * w >= CUBE2_SMALL_RADIX_POINTS)):
        return stockham.WALK_ENGINE, 0, 0, 0
    return cube2_block(h, w, x, y, radix)


def _launch_cube(x, xs, y, ys, h, w, batch, inverse, th: Tables, tw: Tables) -> None:
    lib = large._library(x[0], th.twre.device)
    ptrs = [t.data_ptr() for t in (*x, *y)]
    launch = cube2_launch(h, w, (*ptrs[:2], *xs), (*ptrs[2:], *ys), (th.radix, tw.radix))
    with torch.cuda.device(x[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        span = trace.begin("launch.fft2_cube") if profiler._is_profiler_enabled else None
        err = lib.watfft_fft2_cube(
            *ptrs, *xs, *ys, h, w, batch, th.twre.data_ptr(), th.twim.data_ptr(),
            th.c_radices, th.c_offsets, len(th.stages), tw.twre.data_ptr(), tw.twim.data_ptr(),
            tw.c_radices, tw.c_offsets, len(tw.stages), int(inverse), stream, *launch)
        if span is not None:
            trace.end(span)
    large._check(lib, err, "fft2_cube", h * w, batch, launches)


def _tables(tables, h, w, inverse, device, route):
    """The (h-point, w-point) Stockham tables: the caller's or the port's
    own. The large route of an axis over 4096 takes its own tables."""
    if tables is None:
        return tuple(stockham.device_tables(n, inverse, device)
                     if route == "fft2-cube" or n <= planner.STOCKHAM_MAX_N else None
                     for n in (h, w))
    if route == "fft2-axes":
        raise ValueError("the fft2-axes route runs its long axis on the large path's own "
                         "tables; pass tables=None")
    check_device(device)
    th, tw = tables
    if th.n != h or tw.n != w:
        raise ValueError(f"tables are for {th.n}x{tw.n}, got {h}x{w}")
    return th, tw


def _route(route, h, w, batch, layout) -> str:
    """The planner's route, or the one a check asked for, if it takes h x w."""
    if route is None:
        return planner.fft2_kernel(h, w, batch, layout)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "fft2-cube" and h * w > planner.CUBE_MAX_N:
        raise ValueError(f"the fft2-cube route takes h*w <= {planner.CUBE_MAX_N}, got {h}x{w}")
    if route == "fft2-2pass" and max(h, w) > planner.STOCKHAM_MAX_N:
        raise ValueError(f"the fft2-2pass route takes h, w <= {planner.STOCKHAM_MAX_N}, "
                         f"got {h}x{w}")
    return route


def _run(x, xs, y, ys, h, w, batch, inverse, route, tables, plain=False) -> None:
    """y = DFT2(x) for `batch` images of h x w points: element (i, j) of
    image s at i*xs[0] + j*xs[1] + s*xs[2] floats past x's first elements
    (y likewise)."""
    if batch == 0:
        return
    th, tw = _tables(tables, h, w, inverse, x[0].device, route)
    if route == "fft2-cube" and _use_kernel(x[0], plain):
        _launch_cube(x, xs, y, ys, h, w, batch, inverse, th, tw)
        return
    # one intermediate buffer, in x's order of axes (batch-major or native)
    c = tuple(x[0].new_empty(batch * h * w) for _ in range(2))
    cs = (w, 1, h * w) if xs[1] <= xs[2] else (w * batch, batch, 1)
    _cols(x, xs, c, cs, h, w, batch, inverse, th, plain)
    _rows(c, cs, y, ys, h, w, batch, inverse, tw, plain)


# -- forms, autograd -------------------------------------------------------------
# layout "bm": planes [..., h, w]; "nb": native planes [h, w, ...]; "complex":
# complex [..., h, w] (interleaved storage: re and im 4 bytes apart, stride
# 2); "real": real [..., h, 2w] read or written as the complex [..., h, w]
# of z[j] = x[2j] + i x[2j+1] (the same storage).

def _dims(a, layout):
    """(h, w, the images' shape) of an input."""
    if layout == "nb":
        return a.shape[0], a.shape[1], tuple(a.shape[2:])
    w = a.shape[-1] // 2 if layout == "real" else a.shape[-1]
    return a.shape[-2], w, tuple(a.shape[:-2])


def _strides(layout, h, w, batch):
    return {"bm": (w, 1, h * w), "nb": (w * batch, batch, 1),
            "complex": (2 * w, 2, 2 * h * w), "real": (2 * w, 2, 2 * h * w)}[layout]


def _operand(layout, a, b):
    if layout in ("complex", "real"):
        f = (torch.view_as_real(a) if layout == "complex" else a).reshape(-1)
        return f, f[1:]
    return a.reshape(-1), b.reshape(-1)


def _output(layout, like, h, w, images):
    """The output tensors of a layout and their operand."""
    real = like.real.dtype if like.is_complex() else like.dtype
    if layout == "complex":
        out = like.new_empty(images + (h, w), dtype=real.to_complex())
    elif layout == "real":
        out = like.new_empty(images + (h, 2 * w), dtype=real)
    else:
        shape = (h, w) + images if layout == "nb" else images + (h, w)
        out = (like.new_empty(shape, dtype=real), like.new_empty(shape, dtype=real))
        return out, _operand(layout, *out)
    return out, _operand(layout, out, None)


def _apply(a, b, inverse, lin, lout, route, tables, plain=False):
    if b is not None and (a.shape != b.shape or a.dtype != b.dtype or a.device != b.device):
        raise ValueError(f"re and im planes differ: {a.shape} {a.dtype} "
                         f"{a.device} vs {b.shape} {b.dtype} {b.device}")
    h, w, images = _dims(a, lin)
    batch = a.numel() // (h * w * (2 if lin == "real" else 1))
    route = _route(route, h, w, batch, lin)
    a = stockham._dense(a)
    b = None if b is None else stockham._dense(b)
    out, y = _output(lout, a, h, w, images)
    _run(_operand(lin, a, b), _strides(lin, h, w, batch), y, _strides(lout, h, w, batch),
         h, w, batch, bool(inverse), route, tables, plain)
    return out


class _FFT2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, inverse, lin, lout, route, tables):
        h, w, _ = _dims(a, lin)
        ctx.args = (h * w, inverse, lin, lout, route)
        return _apply(a, b, inverse, lin, lout, route, tables)

    @staticmethod
    def backward(ctx, *g):
        hw, inverse, lin, lout, route = ctx.args
        s = 1.0 / hw if inverse else float(hw)
        gb = g[1] if len(g) == 2 else None
        out = _FFT2.apply(g[0], gb, not inverse, lout, lin, route, None)
        if isinstance(out, tuple):
            return out[0] * s, out[1] * s, None, None, None, None, None
        return out * s, None, None, None, None, None, None


def _transform(a, b, inverse, lin, lout, route, tables):
    if stockham._wants_grad(*(t for t in (a, b) if t is not None)):
        return _FFT2.apply(a, b, bool(inverse), lin, lout, route, tables)
    return _apply(a, b, bool(inverse), lin, lout, route, tables)


def fft2_planes(xre, xim, inverse: bool = False, tables=None):
    """2D FFT of [..., h, w] split planes (f32 on CUDA). h, w powers of two
    >= 2; any leading shape. tables: the (h-point, w-point) `stockham.Tables`
    of the direction, default the port's own. The planner picks the route."""
    return _planes_route(xre, xim, inverse, None, tables)


def fft2_nb(xre, xim, inverse: bool = False, tables=None):
    """2D FFT on native-layout planes [h, w, ...] (the image batch trailing,
    the JAX package's [h, w, B] lane layout; any batch). Output keeps the
    [h, w, ...] orientation."""
    return _nb_route(xre, xim, inverse, None, tables)


def fft2_complex(x, inverse: bool = False, tables=None):
    """2D FFT over the trailing [h, w] axes of a complex tensor; on CUDA the
    kernels read and write the interleaved complex64 storage."""
    return _complex_route(x, inverse, None, tables)


# The forms on a route of the caller's choice (one of ROUTES; None: the
# planner's): what the checks and timings that hold each route alone call.

def _planes_route(re, im, inverse, route, tables=None):
    validate_fft2_shape(re.shape)
    return _transform(re, im, inverse, "bm", "bm", route, tables)


def _nb_route(re, im, inverse, route, tables=None):
    validate_fft2_shape(re.shape[:2] if re.dim() >= 2 else re.shape)
    return _transform(re, im, inverse, "nb", "nb", route, tables)


def _complex_route(x, inverse, route, tables=None):
    validate_fft2_shape(x.shape)
    if not x.is_complex():
        raise TypeError(f"fft2_complex takes a complex tensor, got {x.dtype}")
    return _transform(x, None, inverse, "complex", "complex", route, tables)


def plain_fft2(x, inverse: bool = False, tables=None):
    """The plain version of `fft2_complex` on any device: each pass in torch
    ops on the same strided views (the cube's plain version is the two
    passes). On CUDA it is the reference the kernels are held against."""
    validate_fft2_shape(x.shape)
    return _apply(x, None, bool(inverse), "complex", "complex", None, tables, plain=True)


# -- each kernel on the JAX package's layouts --------------------------------------

def _native(xre, xim, inverse, tables, route, plain):
    """The cube or both passes on native [h, w, B] planes."""
    if xre.dim() != 3 or xre.shape != xim.shape:
        raise ValueError(f"expected [h, w, B] planes, got {tuple(xre.shape)} "
                         f"and {tuple(xim.shape)}")
    validate_fft2_shape(xre.shape[:2])
    return _apply(xre, xim, bool(inverse), "nb", "nb", route, tables, plain)


def fft2_cube(xre, xim, inverse: bool = False, tables=None):
    """The cube (#15) on native [h, w, B] planes, h*w <= CUBE_MAX_N: the
    whole 2D FFT of each image in one block. Returns [h, w, B] planes."""
    return _native(xre, xim, inverse, tables, "fft2-cube", plain=False)


def plain_fft2_cube(xre, xim, inverse: bool = False, tables=None):
    """The plain version of `fft2_cube`, on any device: the column pass,
    then the row pass, in torch ops."""
    return _native(xre, xim, inverse, tables, "fft2-cube", plain=True)


def _one_pass(xre, xim, inverse, table, plain, axis):
    """One pass on native [h, w, B] planes: along h (axis 0) or w (axis 1)."""
    if xre.dim() != 3 or xre.shape != xim.shape:
        raise ValueError(f"expected [h, w, B] planes, got {tuple(xre.shape)} "
                         f"and {tuple(xim.shape)}")
    validate_fft2_shape(xre.shape[:2])
    h, w, b = xre.shape
    n = (h, w)[axis]
    if n > planner.STOCKHAM_MAX_N:
        raise ValueError(f"one pass takes an axis of at most {planner.STOCKHAM_MAX_N} points, "
                         f"got {n}")
    table = stockham._resolve(table, n, bool(inverse), xre.device, xre.dtype)
    x = (stockham._dense(xre).reshape(-1), stockham._dense(xim).reshape(-1))
    out = (torch.empty_like(xre), torch.empty_like(xim))
    s = _strides("nb", h, w, b)
    if b:
        f = _cols if axis == 0 else _pass_k2
        f(x, s, tuple(t.view(-1) for t in out), s, h, w, b, bool(inverse), table, plain)
    return out


def _pass_k2(x, xs, y, ys, h, w, batch, inverse, table, plain) -> None:
    _pass(x, y, w, (xs[1], ys[1]), [(h, xs[0], ys[0]), (batch, xs[2], ys[2])], inverse, table,
          "fft2_k2", plain)


def fft2_cols(xre, xim, inverse: bool = False, tables: Tables | None = None):
    """The column pass on native [h, w, B] planes: the h-point FFTs over
    axis 0 (the strided c2c kernel; #11 as the JAX 2-pass route uses it)."""
    return _one_pass(xre, xim, inverse, tables, False, 0)


def plain_fft2_cols(xre, xim, inverse: bool = False, tables: Tables | None = None):
    """The plain version of `fft2_cols`, on any device."""
    return _one_pass(xre, xim, inverse, tables, True, 0)


def fft2_k2(xre, xim, inverse: bool = False, tables: Tables | None = None):
    """#14 `_fft2_k2_kernel`: the w-point FFTs over axis 1 of native
    [h, w, B] planes, orientation kept (the strided c2c kernel, batch over
    (B, h))."""
    return _one_pass(xre, xim, inverse, tables, False, 1)


def plain_fft2_k2(xre, xim, inverse: bool = False, tables: Tables | None = None):
    """The plain version of `fft2_k2`, on any device."""
    return _one_pass(xre, xim, inverse, tables, True, 1)


def _row_fft(xre, xim, inverse, table, plain):
    if xre.dim() != 2 or xre.shape != xim.shape:
        raise ValueError(f"expected [rows, w] planes, got {tuple(xre.shape)} "
                         f"and {tuple(xim.shape)}")
    rows, w = xre.shape
    table = stockham._resolve(table, w, bool(inverse), xre.device, xre.dtype)
    x = (stockham._dense(xre).reshape(-1), stockham._dense(xim).reshape(-1))
    out = (torch.empty_like(xre), torch.empty_like(xim))
    if rows:  # `rows` images of one row each
        s = (w, 1, w)
        _rows(x, s, tuple(t.view(-1) for t in out), s, 1, w, rows, bool(inverse), table, plain)
    return out


def fft2_rows(xre, xim, inverse: bool = False, tables: Tables | None = None):
    """#16 `_rowfft_lanes_kernel`: the w-point FFT of each row of [rows, w]
    planes (the c2c kernel on the rows; no transpose)."""
    return _row_fft(xre, xim, inverse, tables, plain=False)


def plain_fft2_rows(xre, xim, inverse: bool = False, tables: Tables | None = None):
    """The plain version of `fft2_rows`, on any device."""
    return _row_fft(xre, xim, inverse, tables, plain=True)


# -- 2D real FFT (rfft2 / irfft2) -------------------------------------------------
# Pack along w, z[.., j] = x[.., 2j] + i x[.., 2j+1] (the storage of x
# read as complex), one half-width 2D FFT Zf = fft2(z) and the 2D Hermitian
# recombination, for k = 0..m (m = w/2):
#   A[k1, k] = Zf[k1, k % m],  B[k1, k] = conj(Zf[(-k1) % h, (m - k) % m]),
#   X[k1, k] = (A + B)/2 + W_w^k (-i/2)(A - B);
# and its exact inverse, for k = 0..m-1 (reading the imaginary parts of the
# DC and Nyquist columns, as the JAX package does):
#   Zf[k1, k] = (X + conj Xm)/2 + i/2 conj(W_w^k) (X - conj Xm),
#   Xm[k1, k] = X[(-k1) % h, m - k].

def _axmirror(a, ax):
    """The index map k -> (-k) % n along axis ax: [Y0, Y1, ..] -> [Y0, flip(rest)]."""
    ax = ax % a.dim()
    rest = torch.flip(a.narrow(ax, 1, a.shape[ax] - 1), (ax,))
    return torch.cat([a.narrow(ax, 0, 1), rest], dim=ax)


def _herm2_tw(w, inverse, like, kax):
    """W_w^{-+k} (rf.rfft_post_twiddles) shaped to broadcast along kax."""
    wre, wim = rf._cached_post(w, inverse, check_device(like.device))
    shape = [1] * like.dim()
    shape[kax % like.dim()] = wre.numel()
    return wre.reshape(shape), wim.reshape(shape)


def herm2_post_nb(zre, zim, w: int, hax: int, kax: int):
    """fft2 of the row-packed z [.., h, m, ..] -> rfft2 bins [.., h, m+1, ..]
    (the algebra of watfft_tpu/ops/fft2.py:368)."""
    m = w // 2
    ax = kax % zre.dim()
    a0re, a0im = zre.narrow(ax, 0, 1), zim.narrow(ax, 0, 1)
    are = torch.cat([zre, a0re], dim=ax)            # A: Zf[k % m]
    aim = torch.cat([zim, a0im], dim=ax)
    core_re = torch.flip(zre.narrow(ax, 1, m - 1), (ax,))
    core_im = torch.flip(zim.narrow(ax, 1, m - 1), (ax,))
    mre = torch.cat([a0re, core_re, a0re], dim=ax)  # Zf[(m - k) % m]
    mim = torch.cat([a0im, core_im, a0im], dim=ax)
    bre = _axmirror(mre, hax)                       # conj and (-k1) % h
    bim = -_axmirror(mim, hax)
    ere, eim = 0.5 * (are + bre), 0.5 * (aim + bim)
    dre, dim = are - bre, aim - bim
    ore, oim = 0.5 * dim, -0.5 * dre
    wr, wi = _herm2_tw(w, False, zre, kax)
    return ere + wr * ore - wi * oim, eim + wr * oim + wi * ore


def herm2_pre_nb(xre, xim, w: int, hax: int, kax: int):
    """Inverse of `herm2_post_nb`: bins [.., h, m+1, ..] -> packed Zf
    [.., h, m, ..] (watfft_tpu/ops/fft2.py:393)."""
    m = w // 2
    ax = kax % xre.dim()
    are, aim = xre.narrow(ax, 0, m), xim.narrow(ax, 0, m)
    mre = torch.flip(xre.narrow(ax, 1, m), (ax,))
    mim = torch.flip(xim.narrow(ax, 1, m), (ax,))
    bre = _axmirror(mre, hax)
    bim = -_axmirror(mim, hax)
    ere, eim = 0.5 * (are + bre), 0.5 * (aim + bim)
    dre, dim = are - bre, aim - bim
    ore, oim = -0.5 * dim, 0.5 * dre
    wr, wi = _herm2_tw(w, True, xre, kax)
    return ere + wr * ore - wi * oim, eim + wr * oim + wi * ore


def rfft2_planes(x):
    """2D real FFT of real [..., h, w] -> spectrum planes [..., h, w//2+1]
    (numpy.fft.rfft2 over the trailing axes). h, w powers of two, w >= 4.
    The half-width 2D FFT reads x's own storage as complex; the
    recombination runs in torch."""
    validate_rfft2_shape(x.shape)
    if x.is_complex():
        raise TypeError(f"rfft2 takes a real input, got {x.dtype}")
    zre, zim = _transform(x, None, False, "real", "bm", None, None)
    return herm2_post_nb(zre, zim, x.shape[-1], hax=-2, kax=-1)


def irfft2_planes(re, im):
    """Inverse of `rfft2_planes`: spectrum planes [..., h, m+1] -> real
    [..., h, 2m] (normalized, numpy.fft.irfft2 semantics on Hermitian
    spectra). The half-width inverse writes the real output's storage."""
    w = 2 * (re.shape[-1] - 1)
    validate_rfft2_shape(tuple(re.shape[:-1]) + (w,))
    zre, zim = herm2_pre_nb(re, im, w, hax=-2, kax=-1)
    return _transform(zre, zim, True, "bm", "real", None, None)
