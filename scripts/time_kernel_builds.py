"""Time the fused Bluestein route of several builds of the port's CUDA
library on one card, in turns.

Builds the library from this checkout and from one or more others (each
unpacked with `git archive` into a directory that .gitignore lists, as for
`compare_kernel_builds.py`) and times `bluestein_fft` / `bluestein_fft_bm`
/ `bluestein_fft_nb` through this checkout's wrappers with each library in
turn (this, the others in order, then the same in reverse; CUDA events,
the median of 25 calls each time, `chip_smoke.time_ms`), at [4096, 1000]
in three layouts and both directions, and at 2^22 points per call for
each fused n of `chip_smoke.BL_TIME_SIZES` (complex64 and time-major
planes). The pair #17 + #18 of this
build is timed beside them. Needs one CUDA device:

    python3 scripts/time_kernel_builds.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Prints one JSON line per shape (device ms, each build's two turns
averaged: `this_ms`, and `other_ms` in the order of the arguments) and the
card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from compare_kernel_builds import other_library, using  # noqa: E402
from watfft_tpu_torch import planner  # noqa: E402
from watfft_tpu_torch.ops import _build  # noqa: E402
from watfft_tpu_torch.ops import bluestein as bl  # noqa: E402


def layouts(x: torch.Tensor, inverse: bool) -> dict:
    re, im = x.real.contiguous(), x.imag.contiguous()
    tre, tim = re.T.contiguous(), im.T.contiguous()
    return {"complex": lambda: bl.bluestein_fft(x, inverse),
            "bm": lambda: bl.bluestein_fft_bm(re, im, inverse),
            "nb": lambda: bl.bluestein_fft_nb(tre, tim, inverse)}


def in_turns(libs, fn) -> list[float]:
    """Each build's ms, the mean of its two turns: 0, 1, ..., k, k, ..., 1, 0."""
    ms = [[] for _ in libs]
    order = list(range(len(libs)))
    for k in order + order[::-1]:
        with using(libs[k]):
            ms[k].append(cs.time_ms(fn)[0])
    return [sum(v) / len(v) for v in ms]


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_kernel_builds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name, limit = cs.card()
    libs = [_build.library(), *(other_library(Path(a).resolve()) for a in sys.argv[1:])]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    x = cs.rand_complex((cs.BL_MAIN_B, cs.BL_MAIN_N), gen, dev)
    for inverse in (False, True):
        for layout, fn in layouts(x, inverse).items():
            cases.append(((cs.BL_MAIN_B, cs.BL_MAIN_N), layout, inverse, fn, x))
    for n in cs.BL_TIME_SIZES:
        batch = cs.POINTS // n
        if planner.bluestein_kernel(n, batch) != "bluestein-fused":
            continue
        xn = cs.rand_complex((batch, n), gen, dev)
        fns = layouts(xn, False)
        cases += [((batch, n), layout, False, fns[layout], xn) for layout in ("complex", "nb")]
    for shape, layout, inverse, fn, xs in cases:
        this, *other = in_turns(libs, fn)
        row = {"shape": list(shape), "layout": layout, "inverse": inverse, "this_ms": this,
               "other_ms": other}
        if layout == "complex":
            fwd, inv, _, _, _ = cs._bl_passes(xs, "complex", inverse)
            row["pair_ms"] = cs.time_ms(lambda: (fwd(), inv()))[0]
        print(json.dumps({**row, "card": name, "power_limit": limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
