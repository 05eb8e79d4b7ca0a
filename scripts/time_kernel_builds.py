"""Time routes of several builds of the port's CUDA library on one card, in
turns.

Builds the library from this checkout and from one or more others (each
unpacked with `git archive` into a directory that .gitignore lists, as for
`compare_kernel_builds.py`) and times routes through this checkout's
wrappers with each library in turn (this, the others in order, then the
same in reverse; CUDA events, the median of 25 calls each time,
`chip_smoke.time_ms`). A library that lacks the column tile ignores the C
the wrappers pass it and runs the engine's own walk. Routes (`--routes`,
comma-separated, default all):

* `bluestein`: `bluestein_fft` / `_bm` / `_nb` at [4096, 1000] in three
  layouts and both directions, and at 2^22 points for each fused n of
  `chip_smoke.BL_TIME_SIZES` (complex64 and time-major planes); the pair
  #17 + #18 of this build beside them;
* `columns`: the walks down columns: `stockham_fft_nb` on time-major planes
  at n = 16..4096 (2^22 points; f32 also at batches of 6..600) in each of
  the four instances (f32,
  FP64, bf16 interop, bf16 compute), the 2D column pass and the whole fft2
  on one 4096 x 4096 complex64 image, pipe2 on [16, 2^20] complex64 and
  its stages on time-major [n2, n1, b] blocks;
* `dft`: the small-n DFT matmul (#20) at 2^22 points for n = 1..128 (the
  powers of two, 3, 12 and 100) in complex64, batch-major and time-major
  planes, forward, and inverse on complex64;
* `cube`: the cube (#12) at [2048, 8192] and [256, 16384], complex64 and
  split planes, both directions, and the real large route (rfft_large /
  irfft_large) at [2048, 2^14], whose m = 8192 core the planner sends to
  the cube;
* `fft2`: the 2D cube (#15) at every square 16^2..128^2 at 2^24 points in
  complex64, batch-major and native planes, both directions, and
  `rfft2` / `irfft2` at those shapes;
* `main`: the batch-major walks (`main_cases`): the c2c kernel at every
  n = 2..4096 in complex64, split planes and complex128, both directions,
  the 4096^2 rows pass, the real core batch-major and time-major, the
  fused r2c and c2r at every n = 4..8192 in f32 and FP64, and the
  end-to-end `create_fft_f32(1024)`, `create_fft(1024)` and 4096^2 fft2.

`--sweep` also times this build's `columns` cases at every column tile C
from T up to what shared memory holds, in blocks of 256 and 512 threads
(`config.COLUMN_TILE`), beside the kept tile of `tile_shape`. `--walks`
also times this build's `main` cases in each batch-major walk, forced
(`chip_smoke.forced_walk`: the engine's, resident blocks, a block a
tile), in turns, the `fft2` cases in each walk and store of the cube
(`chip_smoke.cube2_times`) and the `dft` cases on #20's tensor-core
kernel forced (`chip_smoke.forced_mma`; the rule takes the FP32 cores at
n <= 2). Needs one CUDA device:

    python3 scripts/time_kernel_builds.py [--routes R] [--sweep] [--walks] [OTHER_CHECKOUT ...]

Prints one JSON line per case (device ms: `this_ms`, each build's two turns
averaged, and `other_ms` in the order of the arguments; with --sweep
`sweep_ms` by C, with --walks `walk_ms` by walk) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import watfft_tpu_torch as wtt  # noqa: E402
from compare_kernel_builds import other_library, using  # noqa: E402
from watfft_tpu_torch import config, planner  # noqa: E402
from watfft_tpu_torch.ops import _build  # noqa: E402
from watfft_tpu_torch.ops import bluestein as bl  # noqa: E402
from watfft_tpu_torch.ops import fft2 as f2  # noqa: E402
from watfft_tpu_torch.ops import large as lg  # noqa: E402
from watfft_tpu_torch.ops import mxu_dft as md  # noqa: E402
from watfft_tpu_torch.ops import rfft as rf  # noqa: E402
from watfft_tpu_torch.ops import stockham as st  # noqa: E402

ROUTES = ("bluestein", "columns", "cube", "dft", "fft2", "main")
# #20's timed n, at cs.POINTS points each
DFT_TIME_SIZES = [1, 2, 3, 4, 8, 12, 16, 32, 64, 100, 128]
# the real large route's shape (signals, n): its m = 8192 core on the cube
CUBE_REAL = (cs.CUBE_B, 1 << 14)
# batches of few columns, where a block per SM comes before a wider tile
TAIL_BATCHES = (6, 100, 300, 600)


def layouts(x: torch.Tensor, inverse: bool) -> dict:
    re, im = x.real.contiguous(), x.imag.contiguous()
    tre, tim = re.T.contiguous(), im.T.contiguous()
    return {"complex": lambda: bl.bluestein_fft(x, inverse),
            "bm": lambda: bl.bluestein_fft_bm(re, im, inverse),
            "nb": lambda: bl.bluestein_fft_nb(tre, tim, inverse)}


def in_turns(libs, fn) -> list:
    """Each build's ms, the mean of its two turns: 0, 1, ..., k, k, ..., 1, 0
    (None for a build that refuses the launch)."""
    ms = [[] for _ in libs]
    order = list(range(len(libs)))
    for k in order + order[::-1]:
        with using(libs[k]):
            try:
                ms[k].append(cs.time_ms(fn)[0])
            except RuntimeError:
                ms[k].append(None)
    return [None if None in v else sum(v) / len(v) for v in ms]


def bluestein_cases(gen, dev) -> list:
    cases = []
    x = cs.rand_complex((cs.BL_MAIN_B, cs.BL_MAIN_N), gen, dev)
    for inverse in (False, True):
        for layout, fn in layouts(x, inverse).items():
            row = {"route": "bluestein", "shape": [cs.BL_MAIN_B, cs.BL_MAIN_N],
                   "layout": layout, "inverse": inverse}
            if layout == "complex":
                fwd, inv, _, _, _ = cs._bl_passes(x, "complex", inverse)
                row["pair_ms"] = cs.time_ms(lambda: (fwd(), inv()))[0]
            cases.append((row, fn, None))
    for n in cs.BL_TIME_SIZES:
        batch = cs.POINTS // n
        if planner.bluestein_kernel(n, batch) != "bluestein-fused":
            continue
        fns = layouts(cs.rand_complex((batch, n), gen, dev), False)
        cases += [({"route": "bluestein", "shape": [batch, n], "layout": layout,
                    "inverse": False}, fns[layout], None) for layout in ("complex", "nb")]
    return cases


def column_cases(gen, dev) -> list:
    """(row, fn, (n, point bytes)) for each walk down columns; the last item
    names the tiles a sweep may try."""
    cases = []
    shapes = [(n, cs.POINTS // n) for n in (16, 32, 64, 128, 256, *cs.COL_SIZES)]
    tails = [(n, b) for n in cs.COL_SIZES[1:] for b in TAIL_BATCHES]
    for tier, dtype, tdtype, _ in cs.COL_TIERS:
        for n, b in shapes + (tails if tier == "f32" else []):
            re, im = (cs.rand_real((n, b), gen, dev).to(dtype) for _ in range(2))
            tabs = st.device_tables(n, False, dev, tdtype)
            C = st.tile_shape(n, dtype.itemsize, 2 * tdtype.itemsize, batch=b)
            cases.append(({"route": "columns", "case": f"c2c_nb_{tier}", "shape": [n, b],
                           "tile": C}, lambda re=re, im=im, tabs=tabs: st.stockham_fft_nb(
                               re, im, tables=tabs), (n, 2 * tdtype.itemsize)))
    m = cs.FFT2_MAIN
    xm = cs.rand_complex((m, m), gen, dev)
    col, _, _, _ = cs._passes(xm, m, m, 1)
    cases.append(({"route": "columns", "case": "fft2_cols", "shape": [m, m],
                   "tile": st.tile_shape(m, 4, 8, batch=m)}, col, (m, 8)))
    cases.append(({"route": "columns", "case": "fft2", "shape": [m, m]},
                  lambda: f2.fft2_complex(xm), (m, 8)))
    n1, n2 = lg.large_split(cs.LARGE_N)
    x = cs.rand_complex((cs.LARGE_B, cs.LARGE_N), gen, dev)
    cases.append(({"route": "columns", "case": "pipe2", "shape": [cs.LARGE_B, cs.LARGE_N]},
                  lambda: lg.fft_large_complex(x, mode="pipe2"), (n2, 8)))
    blocks = tuple(cs.rand_real((n2, n1, cs.LARGE_B), gen, dev) for _ in range(2))
    cases.append(({"route": "columns", "case": "pipe2_stage1_nb",
                   "shape": [n2, n1, cs.LARGE_B]}, lambda: lg.stage1(*blocks), (n2, 8)))
    cases.append(({"route": "columns", "case": "pipe2_stage2_nb",
                   "shape": [n2, n1, cs.LARGE_B]}, lambda: lg.stage2(*blocks), (n1, 8)))
    return cases


def cube_cases(gen, dev) -> list:
    """The cube (#12) at its main shapes in complex64 and split planes,
    both directions, and the real large route at n = 2^14, whose m = 8192
    core the planner sends to the cube."""
    cases = []
    for b, n in cs.CUBE_SHAPES:
        x = cs.rand_complex((b, n), gen, dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        for inverse in (False, True):
            cases.append(({"route": "cube", "case": "complex", "shape": [b, n],
                           "inverse": inverse, "threads": lg.cube_threads(n)},
                          lambda x=x, inv=inverse: lg.fft_large_complex(x, inv, mode="cube"),
                          None))
            cases.append(({"route": "cube", "case": "bm", "shape": [b, n], "inverse": inverse,
                           "threads": lg.cube_threads(n)},
                          lambda re=re, im=im, inv=inverse: lg.fft_large_bm(re, im, inv,
                                                                            mode="cube"),
                          None))
    b, n = CUBE_REAL
    xr = cs.rand_real((b, n), gen, dev)
    spec = lg.rfft_large(xr)
    cases.append(({"route": "cube", "case": "rfft_large", "shape": [b, n],
                   "core": planner.large_mode(n // 2, b)}, lambda: lg.rfft_large(xr), None))
    cases.append(({"route": "cube", "case": "irfft_large", "shape": [b, n],
                   "core": planner.large_mode(n // 2, b)}, lambda: lg.irfft_large(spec),
                  None))
    return cases


def dft_cases(gen, dev) -> list:
    """#20 at 2^22 points for each n of DFT_TIME_SIZES: complex64,
    batch-major and time-major planes forward, complex64 inverse."""
    cases = []
    for n in DFT_TIME_SIZES:
        b = cs.POINTS // n
        x = cs.rand_complex((b, n), gen, dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        tre, tim = re.T.contiguous(), im.T.contiguous()
        cases += [({"route": "dft", "case": key, "shape": [b, n]}, fn, None) for key, fn in (
            ("complex", lambda x=x: md.dft_matmul(x)),
            ("complex_inv", lambda x=x: md.dft_matmul(x, True)),
            ("bm", lambda re=re, im=im: md.dft_matmul_bm(re, im)),
            ("nb", lambda tre=tre, tim=tim: md.dft_matmul_nb(tre, tim)))]
    return cases


def fft2_cases(gen, dev) -> list:
    """The 2D cube at every square 16^2..128^2 (2^24 points) in complex64,
    batch-major and native planes, both directions, and rfft2 / irfft2 of
    real images of those shapes."""
    cases = []
    for k in range(4, 8):
        h = w = 1 << k
        b = cs.FFT2_TIME_POINTS // (h * w)
        x = cs.rand_complex((b, h, w), gen, dev)
        for inverse in (False, True):
            fns = cs.cube2_layouts(x, inverse)
            cases += [({"route": "fft2", "case": layout, "shape": [b, h, w],
                        "inverse": inverse}, fns[layout][0], None)
                      for layout in ("complex", "bm", "nb")]
        xr = cs.rand_real((b, h, 2 * w), gen, dev)
        spec = torch.fft.rfft2(xr)
        cases.append(({"route": "fft2", "case": "rfft2", "shape": [b, h, 2 * w]},
                      lambda xr=xr: wtt.rfft2(xr), None))
        cases.append(({"route": "fft2", "case": "irfft2", "shape": [b, h, 2 * w]},
                      lambda spec=spec: wtt.irfft2(spec), None))
    return cases


def main_cases(gen, dev) -> list:
    """The batch-major walks: the c2c kernel at every n = 2..4096 (2^22
    points) on complex64 and split planes and on complex128, both
    directions; the rows pass of one 4096^2 image (#16); the real core
    batch-major (`rfft_bm` / `irfft_bm`, fused=False) and time-major
    (`rfft_nb` / `irfft_nb`, the column tile) at 4096 x 1024; the fused r2c
    at every n = 4..8192 (2^22 real points) in f32 and FP64; the c2r at
    4096 x 1024; and `create_fft_f32(1024)`, `create_fft(1024)` on
    [4096, 1024] and fft2 on one 4096^2 image."""
    cases = []
    for n in cs.SIZES:
        b = cs.POINTS // n
        x = cs.rand_complex((b, n), gen, dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        x64 = cs.rand_c128((b, n), gen, dev)
        for inverse in (False, True):
            cases.append(({"route": "main", "case": "c2c_complex", "shape": [b, n],
                           "inverse": inverse},
                          lambda x=x, inv=inverse: st.stockham_fft(x, inv), None))
            cases.append(({"route": "main", "case": "c2c_bm", "shape": [b, n],
                           "inverse": inverse},
                          lambda re=re, im=im, inv=inverse: st.stockham_fft_bm(re, im, inv),
                          None))
            cases.append(({"route": "main", "case": "c2c_complex128", "shape": [b, n],
                           "inverse": inverse},
                          lambda x=x64, inv=inverse: st.stockham_fft(x, inv), None))
    m = cs.FFT2_MAIN
    xm = cs.rand_complex((m, m), gen, dev)
    _, rows, _, _ = cs._passes(xm, m, m, 1)
    cases.append(({"route": "main", "case": "fft2_rows", "shape": [m, m]}, rows, None))
    n, b = cs.MAIN_N, cs.MAIN_B
    xr = cs.rand_real((b, n), gen, dev)
    spec = torch.fft.rfft(xr)
    sre, sim = spec.real.contiguous(), spec.imag.contiguous()
    xt, tre, tim = xr.T.contiguous(), sre.T.contiguous(), sim.T.contiguous()
    cases += [({"route": "main", "case": key, "shape": [b, n]}, fn, None) for key, fn in (
        ("real_core_fwd_bm", lambda: rf.rfft_bm(xr, fused=False)),
        ("real_core_inv_bm", lambda: rf.irfft_bm(sre, sim, fused=False)),
        ("real_core_fwd_nb", lambda: rf.rfft_nb(xt)),
        ("real_core_inv_nb", lambda: rf.irfft_nb(tre, tim)))]
    for n in cs.REAL_SIZES:
        b = cs.POINTS // n
        xr = cs.rand_real((b, n), gen, dev)
        xd = xr.double()
        spec = torch.fft.rfft(xr)
        sre, sim = spec.real.contiguous(), spec.imag.contiguous()
        specd = torch.fft.rfft(xd)
        cases.append(({"route": "main", "case": "r2c", "shape": [b, n]},
                      lambda xr=xr: rf.rfft_bm(xr), None))
        cases.append(({"route": "main", "case": "r2c_f64", "shape": [b, n]},
                      lambda xd=xd: rf.rfft(xd), None))
        cases.append(({"route": "main", "case": "c2r", "shape": [b, n]},
                      lambda sre=sre, sim=sim: rf.irfft_bm(sre, sim), None))
        cases.append(({"route": "main", "case": "c2r_f64", "shape": [b, n]},
                      lambda s=specd: rf.irfft(s), None))
    n, b = cs.MAIN_N, cs.MAIN_B
    x32, x64 = cs.rand_complex((b, n), gen, dev), cs.rand_c128((b, n), gen, dev)
    ctx32, ctx64 = wtt.create_fft_f32(n, device=dev), wtt.create_fft(n, device=dev)
    cases += [({"route": "main", "case": key, "shape": shape}, fn, None) for key, shape, fn in (
        ("create_fft_f32_fwd", [b, n], lambda: ctx32.forward(x32)),
        ("create_fft_f32_inv", [b, n], lambda: ctx32.inverse(x32)),
        ("create_fft_fwd", [b, n], lambda: ctx64.forward(x64)),
        ("fft2", [m, m], lambda: wtt.fft2(xm)))]
    return cases


def sweep(fn, n: int, point: int) -> dict:
    """ms at every tile from C = T up to the opt-in shared memory, in blocks
    of 256 and 512 threads ("C/threads"), this build."""
    out, C = {}, st.engine_transforms(n)
    while C * st.smem_stride(n) * point <= st.SMEM_OPTIN_BYTES:
        for threads in (256, 512):
            if C == st.engine_transforms(n) and threads == 512:
                continue
            if C != st.engine_transforms(n) and not threads * 16 <= C * n <= threads * n:
                continue  # a block holds whole groups, and a thread a column
            config.COLUMN_TILE = (C, threads)
            try:
                out[f"{C}/{threads}"] = cs.time_ms(fn)[0]
            except (RuntimeError, ValueError) as exc:
                out[f"{C}/{threads}"] = f"refused: {exc}"
            finally:
                config.COLUMN_TILE = None
        C *= 2
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other checkouts to build and time in turns")
    ap.add_argument("--routes", default=",".join(ROUTES))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--walks", action="store_true")
    args = ap.parse_args()
    routes = args.routes.split(",")
    if not set(routes) <= set(ROUTES):
        ap.error(f"routes are {ROUTES}, got {routes}")
    if not torch.cuda.is_available():
        print("time_kernel_builds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name, limit = cs.card()
    libs = [_build.library(), *(other_library(Path(a).resolve()) for a in args.others)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    makers = {"bluestein": bluestein_cases, "columns": column_cases, "cube": cube_cases,
              "dft": dft_cases, "fft2": fft2_cases, "main": main_cases}
    for route in routes:
        for row, fn, tiles in makers[route](gen, dev):
            this, *other = in_turns(libs, fn)
            row = {**row, "this_ms": this, "other_ms": other}
            if args.sweep and tiles is not None:
                row["sweep_ms"] = sweep(fn, *tiles)
            if args.walks and route == "main":
                row["walk_ms"] = cs.walk_times(fn)
            if args.walks and route == "fft2":
                row["walk_ms"] = cs.cube2_times(fn)
            if args.walks and route == "dft":
                with cs.forced_mma():
                    row["walk_ms"] = {"mma": cs.time_ms(fn)[0]}
            print(json.dumps({**row, "card": name, "power_limit": limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
