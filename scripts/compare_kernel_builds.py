"""Check that the CUDA kernels of two checkouts agree bit for bit.

Builds the port's CUDA library from this checkout and from another one (for
example the parent commit, unpacked with `git archive` into a directory
that .gitignore lists) and runs both libraries on the same inputs, through
this checkout's wrappers, which launch the entry points of whichever
library `_build.library` returns:

* `watfft_stockham_c2c` at every n = 2..4096, forward and inverse, in the
  interleaved complex64 and time-major planes layouts;
* `watfft_rfft_r2c` and `watfft_irfft_c2r` at every n = 4..8192, in the
  batch-major layout;
* `watfft_strided_c2c` (the four-step passes: pipe2 with its load and store
  multiplies, the 2d mode's post-multiplying and outer passes, the 2D
  column and row passes) at n = 2^13..2^16 and `watfft_large_cube` at
  2^13 and 2^14;
* `watfft_fft2_cube` at h x w = 2x2..128x128 and on the extremes 2x8192,
  8192x2;
* `watfft_bluestein_fwd` / `watfft_bluestein_inv` at n = 3..2000 (the
  pair in turn on complex64, a batch-major intermediate between them);
* the FP64 instances `watfft_stockham_c2c_f64` (n = 2..4096, complex128
  and time-major planes), `watfft_rfft_r2c_f64` and `watfft_irfft_c2r_f64`
  (n = 4..8192, batch-major);
* where both builds have them: the bf16 instances `watfft_stockham_c2c_bf16`
  (interop: time-major and batch-major planes) and
  `watfft_stockham_c2c_bf16c` (compute: time-major planes) at n = 2..4096,
  `watfft_dft_matmul` at n = 1..128 (complex64 layout; past n =
  `mxu_dft.SIMT_MAX_N` this build runs the 3xTF32 tensor-core kernel, which
  sums in another order than the FP32-core kernel, so there the two are
  held within chip_smoke's KERNEL_LIMIT, max |diff| / max |other|, not bit
  for bit) and
  `watfft_bluestein_onepass` at n = 3..2000 (three layouts); an entry point
  the other build lacks is counted under "skipped",

* the batch-major walk, which this build takes on the redesigned kernels:
  the c2c kernel in f32 and FP64 at n = 2..4096 in four layouts
  (`chip_smoke.walk_layouts`: complex, split planes, views one scalar off
  alignment, the real core's even and odd rows) at batch 1, a tail under
  one tile, more tiles than the resident grid and 2^20 points; the hybrid
  real route; the rows pass of one 4096^2 image; the FP64 r2c at
  n = 4..8192 in four layouts;

* the redesigned f32 c2r at n = 4..8192 in four layouts
  (`chip_smoke.c2r_layouts`: complex, split planes, time-major planes, the
  interleaved spectrum one scalar off alignment into signal rows one scalar
  off) at batch 1, 3, past the resident grid by a tail and 2^20 points;
  the redesigned 2D cube at every h*w <= 2^14 in four
  layouts (`chip_smoke.cube2_layouts`: complex64, batch-major and native
  planes, the packed real layout of rfft2 / irfft2) at batch 1, 5 and past
  the SMs by a tail, and on interleaved views one float off alignment;

* the walks down columns, where this build takes the column tile: the
  c2c kernel's four instances on time-major planes at n = 512..4096 with
  a batch tail (C * 132 + 3 columns), and the strided kernel through
  `fft2_cols` (native [h, w, B], h = 1024..4096, w = 2 and 16), `fft2_k2`
  on native [2, 4096, B] and the pipe2 stages on [n2, n1, b] blocks, with
  odd batches;

* the strided kernel's 8-byte stores into complex64, where this build
  takes them (`large.store_pairs`): pipe2 and the 2d mode at [16, 2^20],
  [64, 2^16] and [5, 2^18], and the 2D column pass from and into
  complex64 on [3, 1024, 1024] and [5, 512, 2048],

* the 2D passes at 4096^2 x 8 and 2048^2 x 3 on complex64 and pipe2 at
  [2, 2^24], whose column passes (and stage 1) this build runs on the
  cluster tile,

at batch 3 and at 2^20 points per call (2^19 in FP64), or at the listed
shapes, forward and inverse, with this checkout's tables for both. The
outputs are compared with torch.equal (#20 past SIMT_MAX_N: within
KERNEL_LIMIT). Where this build takes the cluster tile (columns of 2048
and 4096 points; `strided.cluster_tile` counts it) and the other build
has no such entry, the other build runs the one-SM column tile it had
and the two are held within KERNEL_LIMIT (the cluster tile's K x 512
split is another order of the same operations), counted under
`<kind>_cluster`. A build without the column tile
ignores the C the wrappers pass it, and one without the strided kernel's
8-byte stores the flag that asks for them. Where both builds were compiled in this
run, each kernel instance of the other build is also held to the same
registers, spills and stack in this one (ptxas -v; instances only this
build has are listed as new). Needs one CUDA device:

    python3 scripts/compare_kernel_builds.py OTHER_CHECKOUT

Prints one JSON line and exits 1 if any output or any instance's resources
differ.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from watfft_tpu_torch import trace  # noqa: E402
from watfft_tpu_torch.ops import _build  # noqa: E402
from watfft_tpu_torch.ops import bluestein as bl  # noqa: E402
from watfft_tpu_torch.ops import fft2 as f2  # noqa: E402
from watfft_tpu_torch.ops import large as lg  # noqa: E402
from watfft_tpu_torch.ops import mxu_dft as md  # noqa: E402
from watfft_tpu_torch.ops import rfft as rf  # noqa: E402
from watfft_tpu_torch.ops import stockham as st  # noqa: E402

POINTS = 1 << 20
LARGE_SIZES = [1 << k for k in range(13, 17)]
FFT2_SHAPES = [(1 << a, 1 << a) for a in range(1, 8)] + [(2, 1 << 13), (1 << 13, 2), (16, 256)]
BLUESTEIN_SIZES = (3, 17, 100, 400, 1000, 1009, 2000)
DFT_SIZES = [1 << k for k in range(8)] + [12, 100]


def other_build(checkout: Path):
    """The other checkout's `_build` module, loaded as a module of this
    checkout's `watfft_tpu_torch.ops`, so that its relative import of
    `trace` resolves (to this checkout's counters); it builds and loads the
    other checkout's sources into the other checkout's `build/`."""
    spec = importlib.util.spec_from_file_location(
        "watfft_tpu_torch.ops._other_build",
        checkout / "watfft_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_library(checkout: Path):
    return other_build(checkout).library()


def ptxas_resources(log: str) -> dict:
    """Each kernel instance of a ptxas -v log: (registers, stack bytes,
    spill stores, spill loads), under its mangled name with the anonymous
    namespace's per-build tag taken out."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON", m.group(1))
            out[cur] = [None, 0, 0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out[cur][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


# Kernels this build redesigned with other template arguments, or whose
# instances went (#20's FP32-core kernel past n = 2) (mangled-name
# patterns): the other build's instances of these may be missing here
# (listed as retired), while every other instance must keep its resources.
RETIRED = (r"11cube_kernelILb[01]EEE?v", r"17dft_matmul_kernelILi\d+ELi8ELi\d+EEEv")
# Instances this build keeps under more template arguments (the other
# build's mangled-name pattern and its name here): the strided column
# tile's took PAIRS, whose false instance is the one the other build has.
# Their resources are held like every other instance's.
RENAMED = ((r"(19strided_cols_kernelILb[01]ELi\d)EE", r"\1ELb0EE"),)


def renamed(name: str) -> str:
    """An instance of the other build under this build's name for it."""
    for pat, repl in RENAMED:
        name = re.sub(pat, repl, name)
    return name


def compare_ptxas(this_log: str, other_log: str) -> dict:
    this = ptxas_resources(this_log)
    other = {renamed(k): v for k, v in ptxas_resources(other_log).items()}
    if not this or not other:
        return {"ptxas": "not compared (a library was loaded, not built, in this run)"}
    retired = sorted(k for k in other if k not in this
                     and any(re.search(rf"(?<!\d){pat}", k) for pat in RETIRED))
    changed = [f"{k}: {other[k]} -> {this.get(k)}" for k in other
               if this.get(k) != other[k] and k not in retired]
    return {"ptxas_instances": len(other), "ptxas_same": not changed,
            "ptxas_changed": changed[:20], "ptxas_retired": retired,
            "ptxas_new": {k: this[k] for k in sorted(set(this) - set(other))}}


@contextlib.contextmanager
def using(lib):
    """The wrappers launch `lib`'s entry points inside the block; a library
    without the cluster tile's entry gets the one-SM column tile it had
    where this build takes the cluster tile."""
    own, cluster = _build.library, st.cluster_tile
    _build.library = lambda: lib
    try:
        getattr(lib, "watfft_strided_cluster")
    except AttributeError:
        st.cluster_tile = lambda *args, **kwargs: 0
    try:
        yield
    finally:
        _build.library, st.cluster_tile = own, cluster


def c2c(x, inverse, time_major):
    if time_major:
        return st.stockham_fft_nb(x.real.T.contiguous(), x.imag.T.contiguous(), inverse)
    return (st.stockham_fft(x, inverse),)


def bluestein_pair(x, inverse):
    """#17 then #18 on the complex [batch, n] x, a batch-major [2, batch * m]
    intermediate between them (the fused route before the one-pass
    kernel)."""
    batch, n = x.shape
    bt = bl.device_bluestein_tables(n, inverse, x.device)
    fx = torch.view_as_real(x.contiguous()).view(-1)
    out = torch.empty_like(fx)
    f = torch.empty(2, batch * bt.m, device=x.device)
    bl._fwd((fx, fx[1:]), (2, 2 * n), (f[0], f[1]), (1, bt.m), batch, bt, False)
    bl._inv((f[0], f[1]), (1, bt.m), (out, out[1:]), (2, 2 * n), batch, bt, False)
    return out


def bluestein_onepass(x, inverse, layout):
    """The fused route (the one-pass kernel) on x in `layout`."""
    if layout == "complex":
        return (bl.bluestein_fft(x, inverse),)
    re, im = x.real.contiguous(), x.imag.contiguous()
    if layout == "bm":
        return bl.bluestein_fft_bm(re, im, inverse)
    return bl.bluestein_fft_nb(re.T.contiguous(), im.T.contiguous(), inverse)


def cube_views(flat, n, batch, off, inverse):
    """The cube on [n, batch] views of interleaved points whose re sits
    `off` floats past flat's start, into the same layout `1 - off` floats
    in: one side 8-byte aligned, the other not."""
    y = torch.zeros_like(flat)
    views = [torch.as_strided(t, (n, batch), (2, 2 * n), o)
             for t, o in ((flat, off), (flat, off + 1), (y, 1 - off), (y, 2 - off))]
    lg.fft_large_views(*views, inverse, mode="cube")
    return y


def cube2_views(flat, h, w, batch, off):
    """The 2D cube on interleaved images whose re sits `off` floats past
    flat's start, into the same layout `1 - off` floats in: one side 8-byte
    aligned, the other not."""
    y = torch.zeros_like(flat)
    s = (2 * w, 2, 2 * h * w)
    f2._run((flat[off:], flat[off + 1:]), s, (y[1 - off:], y[2 - off:]), s, h, w, batch, False,
            "fft2-cube", None)
    return y


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernel_builds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    other = other_build(Path(sys.argv[1]).resolve())
    libs = (_build.library(), other.library())
    resources = compare_ptxas(_build.build_info.get("log", ""), other.build_info.get("log", ""))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    def crand(shape):
        return torch.complex(rand(shape), rand(shape))

    cases, differ, skipped = {}, [], {}

    def has(lib, entry) -> bool:
        try:
            getattr(lib, entry)
            return True
        except AttributeError:
            return False

    def same(kind, what, fn, entry=None, limit=None):
        """The outputs of both builds equal (within `limit`, max |diff| /
        max |other|, where given). Where this build takes the cluster tile
        and the other has none (its one-SM column tile: another order of
        the same operations), within KERNEL_LIMIT, counted under
        `<kind>_cluster`."""
        if entry is not None and not all(has(lib, entry) for lib in libs):
            skipped[kind] = skipped.get(kind, 0) + 1
            return
        outs = []
        for lib in libs:
            before = trace.counts["strided.cluster_tile"]
            with using(lib):
                out = fn()
            outs.append(out if isinstance(out, (tuple, list)) else (out,))
            if lib is libs[0] and trace.counts["strided.cluster_tile"] > before and not has(
                    libs[1], "watfft_strided_cluster"):
                kind, limit = f"{kind}_cluster", cs.KERNEL_LIMIT
        cases[kind] = cases.get(kind, 0) + 1
        if limit is None:
            ok = all(torch.equal(a, b) for a, b in zip(*outs))
        else:
            ok = all(cs.rel_diff(a, b) <= limit for a, b in zip(*outs))
        if not ok:
            differ.append(f"{kind} {what}")

    for n in (1 << k for k in range(1, 13)):
        for batch in (3, POINTS // n):
            x = crand((batch, n))
            for inverse in (False, True):
                for tm in (False, True):
                    same("stockham_c2c", (n, batch, inverse, tm),
                         lambda: c2c(x, inverse, tm))
    for n in (1 << k for k in range(2, 14)):
        for batch in (3, POINTS // n):
            x = rand((batch, n))
            sre, sim = rand((batch, n // 2 + 1)), rand((batch, n // 2 + 1))
            same("rfft_r2c", (n, batch), lambda: rf.rfft_bm(x))
            same("irfft_c2r", (n, batch), lambda: (rf.irfft_bm(sre, sim),))
    for n in LARGE_SIZES:
        x = crand((3, n))
        for inverse in (False, True):
            for mode in ("pipe2", "2d", "cube") if n <= 1 << 14 else ("pipe2", "2d"):
                kind = "large_cube" if mode == "cube" else "strided_c2c"
                same(kind, (n, mode, inverse), lambda: lg.fft_large_complex(x, inverse, mode=mode))
    for h, w in FFT2_SHAPES:
        x = crand((3, h, w))
        for inverse in (False, True):
            for route in ("fft2-cube", "fft2-2pass"):
                if route == "fft2-2pass" and max(h, w) > 4096:
                    continue
                kind = "fft2_cube" if route == "fft2-cube" else "strided_c2c"
                same(kind, (h, w, route, inverse),
                     lambda: f2._complex_route(x, inverse, route))
    for n in BLUESTEIN_SIZES:
        x = crand((3, n))
        for inverse in (False, True):
            same("bluestein_fwd_inv", (n, inverse), lambda: bluestein_pair(x, inverse))
    for n in (1 << k for k in range(1, 13)):
        for batch in (3, POINTS // 2 // n):
            x = crand((batch, n)).to(torch.complex128)
            for inverse in (False, True):
                for tm in (False, True):
                    same("stockham_c2c_f64", (n, batch, inverse, tm),
                         lambda: c2c(x, inverse, tm))
    for n in (1 << k for k in range(2, 14)):
        for batch in (3, POINTS // 2 // n):
            x = rand((batch, n)).double()
            sre, sim = (rand((batch, n // 2 + 1)).double() for _ in range(2))
            same("rfft_r2c_f64", (n, batch), lambda: rf.rfft_bm(x))
            same("irfft_c2r_f64", (n, batch), lambda: (rf.irfft_bm(sre, sim),))
    for n in (1 << k for k in range(1, 13)):
        for batch in (3, POINTS // n):
            re, im = rand((n, batch)).bfloat16(), rand((n, batch)).bfloat16()
            t32 = st.device_tables(n, False, dev)
            t16 = st.device_tables(n, False, dev, torch.bfloat16)
            same("stockham_c2c_bf16", (n, batch), lambda: st.stockham_fft_nb(re, im, tables=t32),
                 "watfft_stockham_c2c_bf16")
            same("stockham_c2c_bf16", (n, batch, "bm"),
                 lambda: st.stockham_fft_bm(re.T.contiguous(), im.T.contiguous(), tables=t32),
                 "watfft_stockham_c2c_bf16")
            same("stockham_c2c_bf16c", (n, batch),
                 lambda: st.stockham_fft_nb(re, im, tables=t16), "watfft_stockham_c2c_bf16c")
    for n in DFT_SIZES:
        for batch in (3, POINTS // n):
            x = crand((batch, n))
            for inverse in (False, True):
                same("dft_matmul", (n, batch, inverse), lambda: md.dft_matmul(x, inverse),
                     "watfft_dft_matmul",
                     None if n <= md.SIMT_MAX_N else cs.KERNEL_LIMIT)
    for n in BLUESTEIN_SIZES:
        for batch in (3, POINTS // bl.bluestein_m(n)):
            x = crand((batch, n))
            for inverse in (False, True):
                for layout in ("complex", "bm", "nb"):
                    same("bluestein_onepass", (n, batch, inverse, layout),
                         lambda: bluestein_onepass(x, inverse, layout),
                         "watfft_bluestein_onepass")
    # the walks down columns at the tiles of this build, with batch tails
    for n in (512, 1024, 2048, 4096):
        for dtype, tdtype, entry in ((torch.float32, torch.float32, None),
                                     (torch.float64, torch.float64, None),
                                     (torch.bfloat16, torch.float32, "watfft_stockham_c2c_bf16"),
                                     (torch.bfloat16, torch.bfloat16,
                                      "watfft_stockham_c2c_bf16c")):
            C = st.tile_shape(n, dtype.itemsize, 2 * tdtype.itemsize, batch=POINTS // n)[0]
            for batch in (C * st.SMS + 3, POINTS // n):
                re, im = (rand((n, batch)).to(dtype) for _ in range(2))
                for inverse in (False, True):
                    tabs = st.device_tables(n, inverse, dev, tdtype)
                    same(f"column_tile_c2c_{dtype}_{tdtype}", (n, batch, inverse),
                         lambda: st.stockham_fft_nb(re, im, tables=tabs), entry)
    cplanes = [(lambda x: (x.real.contiguous(), x.imag.contiguous()))(crand(shape))
               for shape in [(h, w, b) for h in (1024, 2048, 4096) for w, b in ((2, 265), (16, 33))]
               + [(2, 4096, 265), (2, 4096, 64)]]
    for xre, xim in cplanes:
        for inverse in (False, True):
            fn = f2.fft2_k2 if xre.shape[0] == 2 else f2.fft2_cols
            same("column_tile_strided", (fn.__name__, tuple(xre.shape), inverse),
                 lambda: fn(xre, xim, inverse))
    for n2, n1, b in ((1024, 1024, 3), (1024, 16, 67), (4096, 64, 9), (2048, 32, 33)):
        xre, xim = rand((n2, n1, b)), rand((n2, n1, b))
        for inverse in (False, True):
            same("column_tile_strided", ("stage1", (n2, n1, b), inverse),
                 lambda: lg.stage1(xre, xim, inverse))
            x2re, x2im = rand((n1, n2, b)), rand((n1, n2, b))
            same("column_tile_strided", ("stage2", (n1, n2, b), inverse),
                 lambda: lg.stage2(x2re, x2im, inverse))
    # the 2D passes at h = 2048 and 4096, whose column pass this build runs
    # on the cluster tile, as fft2 launches them on complex64 (the wstack
    # cell's chunk shape at 4096), and pipe2 at 2^24 (its stage 1, n2 = 4096)
    for b, h in ((8, 4096), (3, 2048)):
        x = crand((b, h, h))
        for inverse in (False, True):
            same("strided_c2c", (h, h, b, "fft2-2pass", inverse),
                 lambda: f2._complex_route(x, inverse, "fft2-2pass"))
        del x
    x = crand((2, 1 << 24))
    for inverse in (False, True):
        same("strided_c2c", (1 << 24, "pipe2", inverse),
             lambda: lg.fft_large_complex(x, inverse, mode="pipe2"))
    del x
    # the strided kernel's 8-byte stores (this build's launches count them)
    for batch, n in ((16, 1 << 20), (64, 1 << 16), (5, 1 << 18)):
        x = crand((batch, n))
        for inverse in (False, True):
            for mode in ("pipe2", "2d"):
                same("strided_pairs", (n, batch, mode, inverse),
                     lambda: lg.fft_large_complex(x, inverse, mode=mode))
    for b, h, w in ((3, 1024, 1024), (5, 512, 2048)):
        # the 2D column pass from complex64 into complex64
        fx, xs = torch.view_as_real(crand((b, h, w))).reshape(-1), (2 * w, 2, 2 * h * w)
        for inverse in (False, True):
            th = st.device_tables(h, inverse, dev)

            def cols():
                fy = torch.empty(2 * b * h * w, device=dev)
                f2._cols((fx, fx[1:]), xs, (fy, fy[1:]), xs, h, w, b, inverse, th, False)
                return fy
            same("strided_pairs", ((b, h, w), "fft2_cols", inverse), cols)
    cases["strided_pairs_stores"] = trace.counts["strided.pairs_store"]
    # the redesigned cube: three layouts, batch 1, a few sequences, more
    # than the SMs hold at once by a tail, and 2^20 points; views 4 bytes
    # off 8-byte alignment (4-byte copies and stores); the real route's
    # m = 8192 core on the even and odd rows of its signal
    for n in (1 << 13, 1 << 14):
        for batch in (1, 3, st.SMS + 5, 2 * st.SMS + 5, POINTS // n):
            x = crand((batch, n))
            re_, im_ = x.real.contiguous(), x.imag.contiguous()
            for inverse in (False, True):
                same("large_cube", (n, batch, inverse, "complex"),
                     lambda: lg.fft_large_complex(x, inverse, mode="cube"))
                same("large_cube", (n, batch, inverse, "bm"),
                     lambda: lg.fft_large_bm(re_, im_, inverse, mode="cube"))
                if batch <= 3:
                    same("large_cube", (n, batch, inverse, "nb"),
                         lambda: lg.fft_large_nb(re_.T.contiguous(), im_.T.contiguous(),
                                                 inverse, mode="cube"))
        flat = rand(2 * n * 7 + 3)
        for off in (0, 1):
            for inverse in (False, True):
                same("large_cube", (n, "views", off, inverse),
                     lambda: cube_views(flat, n, 7, off, inverse))
    xr = rand((2 * st.SMS + 5, 1 << 14))
    same("large_cube", ("rfft_large", tuple(xr.shape)), lambda: lg.rfft_large(xr))
    # the redesigned r2c: three layouts and rows 4 bytes off 8-byte alignment,
    # batch 1, under the grid, past it by a tail and at 2^20 points
    for n in (1 << k for k in range(2, 14)):
        T = st.engine_transforms(n // 2, max(r for r, _ in st.stage_plan(n // 2)))
        for batch in (1, 3, 2 * st.SMS * T + 3, POINTS // n + 1):
            flat = rand(batch * n + 1)
            xa, xm = flat[:-1].view(batch, n), flat[1:].view(batch, n)  # xm: 4 bytes off
            xt = xa.T.contiguous()
            same("rfft_r2c_resident", (n, batch, "complex"), lambda: rf.rfft(xa))
            same("rfft_r2c_resident", (n, batch, "bm"), lambda: rf.rfft_bm(xa))
            same("rfft_r2c_resident", (n, batch, "nb"), lambda: rf.rfft_nb_fused(xt))
            same("rfft_r2c_resident", (n, batch, "misaligned"), lambda: rf.rfft(xm))
    # the redesigned batch-major walk of the c2c kernel, f32 and FP64: four
    # layouts (complex, split planes, views one scalar off alignment, the
    # real core's even and odd rows), batch 1, a tail under one tile, more
    # tiles than the resident grid by a tail, and 2^20 points; the hybrid
    # real route on it; the rows pass of one 4096^2 image
    for cdtype in (torch.complex64, torch.complex128):
        for n in (1 << k for k in range(1, 13)):
            T = st.engine_transforms(n, max(r for r, _ in st.stage_plan(n)))
            for batch in (1, T // 2 + 1, 2 * st.SMS * T + T // 2 + 1, POINTS // n):
                x = crand((batch, n)).to(cdtype)
                for inverse in (False, True):
                    for layout, fn in cs.walk_layouts(x, inverse).items():
                        same(f"c2c_walk_{cdtype}", (n, batch, inverse, layout), fn)
        for n in (1 << k for k in range(2, 14)):
            xr = rand((POINTS // n, n)).to(cdtype.to_real())
            sre, sim = (rand((POINTS // n, n // 2 + 1)).to(xr.dtype) for _ in range(2))
            same(f"c2c_walk_{cdtype}", (n, "hybrid"), lambda: rf.rfft_bm(xr, fused=False))
            same(f"c2c_walk_{cdtype}", (n, "hybrid_inv"),
                 lambda: (rf.irfft_bm(sre, sim, fused=False),))
    xm = crand((cs.FFT2_MAIN, cs.FFT2_MAIN))
    for inverse in (False, True):
        same("c2c_walk_rows", (cs.FFT2_MAIN, inverse),
             lambda: f2._complex_route(xm, inverse, "fft2-2pass"))
    # the FP64 r2c: four layouts, batch 1, 3, past the grid and 2^19 points
    for n in (1 << k for k in range(2, 14)):
        T = st.engine_transforms(n // 2, max(r for r, _ in st.stage_plan(n // 2)))
        for batch in (1, 3, 2 * st.SMS * T + 3, POINTS // 2 // n + 1):
            flat = rand(batch * n + 1).double()
            xa, xm_ = flat[:-1].view(batch, n), flat[1:].view(batch, n)
            xt = xa.T.contiguous()
            same("rfft_r2c_f64_walk", (n, batch, "complex"), lambda: rf.rfft(xa))
            same("rfft_r2c_f64_walk", (n, batch, "bm"), lambda: rf.rfft_bm(xa))
            same("rfft_r2c_f64_walk", (n, batch, "nb"), lambda: rf.rfft_nb_fused(xt))
            same("rfft_r2c_f64_walk", (n, batch, "misaligned"), lambda: rf.rfft(xm_))
    # the redesigned f32 c2r: four layouts, batch 1, 3, past the resident
    # grid by a tail, and 2^20 points
    for n in (1 << k for k in range(2, 14)):
        m1 = n // 2 + 1
        T = st.engine_transforms(n // 2, max(r for r, _ in st.stage_plan(n // 2)))
        for batch in (1, 3, 2 * st.SMS * T + 3, POINTS // n):
            spec = torch.complex(rand((batch, m1)), rand((batch, m1)))
            for layout, fn in cs.c2r_layouts(spec).items():
                same("irfft_c2r_walk", (n, batch, layout), fn)
    # the redesigned 2D cube: every h*w <= 2^14, four layouts, batch 1, 5
    # and past the SMs by a tail, both directions; views one float off
    for h, w in cs.FFT2_PAIRS:
        for batch in (1, 5, 2 * st.SMS + 5 if h * w >= 1024 else 300):
            x = crand((batch, h, w))
            for inverse in (False, True):
                for layout, (fn, _) in cs.cube2_layouts(x, inverse).items():
                    same("fft2_cube_walk", (h, w, batch, inverse, layout), fn)
        flat = rand(2 * 7 * h * w + 3)
        for off in (0, 1):
            same("fft2_cube_walk", (h, w, "views", off),
                 lambda: cube2_views(flat, h, w, 7, off))
    torch.cuda.synchronize()
    ptxas_ok = resources.get("ptxas_same", True)
    print(json.dumps({"bit_identical": not differ, "cases": cases, "skipped": skipped,
                      "differ": differ[:20], **resources,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if differ or not ptxas_ok else 0


if __name__ == "__main__":
    sys.exit(main())
