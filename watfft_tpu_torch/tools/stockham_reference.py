"""Stage-logging numpy Stockham reference, held against the port's stages
and its CUDA kernels.

The port's counterpart of `tools/stockham_reference.py` (a port of
tools/stockham_reference.js of wat-fft): a host implementation in
complex128 of exactly the port's stage plan, twiddle pack and interleave
(`ops.stockham.stage_plan`, `make_twiddle_pack`; not the JAX package's
plan, which carries TPU overrides), returning every stage's output.

* `stockham_reference` runs the plan in float64 arithmetic on tables of a
  given dtype (the kernels' f32 or f64 tables), so a stage's value dump
  diffs against the port's own stage.
* `diff_stages` runs the port's plain stage `ops.stockham._stage` one stage
  at a time, with the arguments `run_stages` passes it, and reports the
  first stage whose output leaves the reference's by more than `STAGE_LIMIT`.
  A kernel cannot be stopped after stage i (the C entry refuses a plan whose
  radices do not multiply to n), so the stage-by-stage diff is of the plain
  version.
* `check_kernels` holds each kernel instance's final output against the
  reference at one n, both directions: the batch-major walk (#1/#4) through
  `stockham_fft_bm`, the time-major column tile (#2) through
  `stockham_fft_nb`, and the FP64 instance (#19) on float64 tables in both
  layouts. The time-major instances run a batch wide enough for the
  wrapper's column tile (`ops.stockham.tile_shape`) wherever the plan takes
  one (n >= 16), and each record names the launch's tile. The limit is
  `utils.tolerances.MAX_REL` of the dtype, relative to the largest output;
  on CUDA each instance must also have launched its kernel.

    python -m watfft_tpu_torch.tools.stockham_reference [n ...] [--log] [--inverse] [--cpu]

Sizes default to every power of two 2..4096 (the kernels run to 4096;
larger sizes check the reference and the stages only); `--inverse` checks
the inverse direction alone, `--log` dumps every stage. Runs on the CUDA
device unless `--cpu`, and exits 2 without one. Exit code 0 iff every
check passes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config, planner, registry
from ..ops import stockham as st
from ..utils.tolerances import MAX_REL
from . import device_or_exit

__all__ = ["stockham_reference", "diff_stages", "check_kernels", "INSTANCES", "STAGE_LIMIT",
           "REF_LIMIT", "run", "main"]

# A stage of the plain version against the reference's, of the stage's
# largest value: the dtype's limit against the f64 oracle (the stages run
# in float32).
STAGE_LIMIT = MAX_REL
# The reference on f32 tables against numpy's FFT, of the largest output (the
# tables' rounding alone: about 1e-8).
REF_LIMIT = 1e-6
# (name, dtype, layout, the TPU kernel it replaces): the kernel instances
# `check_kernels` holds against the reference.
INSTANCES = (("c2c-bm", "float32", "bm", "#1/#4"), ("c2c-nb", "float32", "nb", "#2"),
             ("fp64-bm", "float64", "bm", "#19"), ("fp64-nb", "float64", "nb", "#19"))
_COUNTER = {"float32": "stockham_c2c", "float64": "stockham_c2c_f64"}
_NP = {"float32": np.float32, "float64": np.float64}
_COMPLEX = {"float32": np.complex64, "float64": np.complex128}


def stockham_reference(x: np.ndarray, inverse: bool = False, log: bool = False,
                       tables_dtype=np.float32) -> tuple[np.ndarray, list[np.ndarray]]:
    """x: [n, b] complex (time-major). The FFT along axis 0 in complex128 on
    the port's plan and a twiddle pack of `tables_dtype`, and the output of
    every stage. The inverse's 1/n sits where the port folds it: in the last
    stage's twiddles for p >= 1 and on its p = 0 block, on every block of a
    twiddle-free last stage."""
    n, b = x.shape
    stages = st.stage_plan(n)
    twre, twim, offsets = st.make_twiddle_pack(n, inverse, dtype=tables_dtype)
    tw = twre.astype(np.float64).ravel() + 1j * twim.astype(np.float64).ravel()
    sign = +1.0 if inverse else -1.0
    c = x.astype(np.complex128)
    outs = []
    for idx, (r, l) in enumerate(stages):
        q = n // r
        parts = [c[p * q:(p + 1) * q].copy() for p in range(r)]
        o = offsets[idx]
        if o >= 0:
            for p in range(1, r):
                parts[p] *= tw[o + (p - 1) * q:o + p * q, None]
        if inverse and idx == len(stages) - 1:
            for p in range(r if o < 0 else 1):
                parts[p] /= n
        w = np.exp(sign * 2j * np.pi / r)
        dft = [sum(parts[p] * w ** (p * s) for p in range(r)) for s in range(r)]
        g = n // (r * l)
        c = np.stack([d.reshape(g, l, b) for d in dft], axis=1).reshape(n, b)
        outs.append(c)
        if log:
            print(f"  stage {idx}: R={r} l={l} twoff={o} first={c[0, 0]:.6f} "
                  f"norm={np.linalg.norm(c):.6f}")
    return c, outs


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def diff_stages(x: np.ndarray, inverse: bool, device) -> tuple[int | None, list[float]]:
    """Run the port's plain stage `_stage` one stage at a time on the
    [n, b] input (rounded to float32) on `device`, with the port's f32
    tables, and diff each stage's output with the reference's. The 1/n of
    the inverse is passed on the plan's last stage alone, as `run_stages`
    passes it. Returns the first stage past `STAGE_LIMIT["float32"]` of the
    stage's largest value (None if none) and every stage's difference."""
    n = x.shape[0]
    x = x.astype(np.complex64)
    _, want = stockham_reference(x, inverse)
    stages = st.stage_plan(n)
    twre, twim, offsets = st.make_twiddle_pack(n, inverse)
    twre = torch.as_tensor(twre.ravel(), device=device)
    twim = torch.as_tensor(twim.ravel(), device=device)
    cre = torch.as_tensor(np.ascontiguousarray(x.real), device=device)
    cim = torch.as_tensor(np.ascontiguousarray(x.imag), device=device)
    first, diffs = None, []
    for idx, (r, l) in enumerate(stages):
        tw = None
        if offsets[idx] >= 0:
            o, rows = offsets[idx], (r - 1) * (n // r)
            tw = (twre[o:o + rows], twim[o:o + rows])
        scale0 = 1.0 / n if (inverse and idx == len(stages) - 1) else None
        cre, cim = st._stage(cre, cim, n, r, l, tw, inverse, scale0)
        got = cre.cpu().numpy().astype(np.float64) + 1j * cim.cpu().numpy()
        diffs.append(_rel(got, want[idx]))
        if first is None and diffs[-1] > STAGE_LIMIT["float32"]:
            first = idx
    return first, diffs


def _signal(n: int, b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, b)) + 1j * rng.uniform(-1, 1, (n, b))


def _batch(n: int, dt: str, layout: str) -> int:
    """The batch of an instance at n points: 2^15 / n + 3 (a partial tile of
    the batch-major walk); on time-major planes, where the plan takes a
    column tile, at least SMS / 2 times the widest tile + 3, so that the
    wrapper's rule (C at most 2 * batch / SMS) gives that tile, a partial
    one at the batch's end."""
    b = (1 << 15) // n + 3
    radix = max(r for r, _ in st.stage_plan(n))
    if layout == "nb" and radix == st.MAX_RADIX:
        size = np.dtype(dt).itemsize
        cols, _ = st.tile_shape(n, size, 2 * size, None, radix, None)
        b = max(b, st.SMS // 2 * cols + 3)
    return b


def _tile(n: int, dt: str, layout: str, b: int) -> tuple[int, int]:
    """The column tile (C, threads) the wrapper gives the launch on these
    planes ((0, 0): the engine's walk, `ops.stockham.column_tile`)."""
    size = np.dtype(dt).itemsize
    walk = (b, 1) if layout == "nb" else (1, n)
    return st.column_tile(n, (walk, walk), size, 2 * size,
                          max(r for r, _ in st.stage_plan(n)), b)


def check_kernels(n: int, device, directions=(False, True)) -> list[dict]:
    """Each of `INSTANCES` at n points on `device`, each direction, against
    the reference on the same input and tables of its dtype: one record an
    instance and direction, with its batch (`_batch`), its column tile, its
    error of the largest output, the limit (`MAX_REL`), the kernels it
    launched (`registry.launch_counts`) and `ok`. A time-major instance
    whose plan takes a column tile fails without one (unless
    `config.COLUMN_TILE` is set); on CUDA an instance that launched no
    kernel of its dtype fails."""
    batch = {(dt, layout): _batch(n, dt, layout) for _, dt, layout, _ in INSTANCES}
    x = _signal(n, max(batch.values()), n)
    cuda = torch.device(device).type == "cuda"
    tiled = max(r for r, _ in st.stage_plan(n)) == st.MAX_RADIX and config.COLUMN_TILE is None
    recs = []
    for inverse in directions:
        want = {dt: stockham_reference(x[:, :batch[dt, "nb"]].astype(_COMPLEX[dt]), inverse,
                                       tables_dtype=_NP[dt])[0] for dt in _NP}
        for name, dt, layout, tpu in INSTANCES:
            b = batch[dt, layout]
            xc = x[:, :b].astype(_COMPLEX[dt])
            planes = [np.ascontiguousarray(p if layout == "nb" else p.T)
                      for p in (xc.real, xc.imag)]
            re, im = (torch.as_tensor(p, device=device) for p in planes)
            fn = st.stockham_fft_nb if layout == "nb" else st.stockham_fft_bm
            tile = _tile(n, dt, layout, b)
            before = registry.launch_counts()
            yre, yim = fn(re, im, inverse)
            if cuda:
                torch.cuda.synchronize(device)
            after = registry.launch_counts()
            launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            got = yre.cpu().numpy().astype(np.float64) + 1j * yim.cpu().numpy()
            err = _rel(got if layout == "nb" else got.T, want[dt][:, :b])
            ok = (err < MAX_REL[dt] and (not cuda or launched.get(_COUNTER[dt], 0) > 0)
                  and (layout != "nb" or not tiled or tile != (0, 0)))
            recs.append({"instance": name, "replaces": tpu, "dtype": dt, "n": n, "batch": b,
                         "tile": list(tile), "inverse": inverse, "max_rel": err,
                         "limit": MAX_REL[dt], "launched": launched, "ok": ok})
    return recs


def run(argv=None) -> tuple[int, list[dict]]:
    """The command line's work: its exit code and its records, one for each
    size and direction of the reference and the stages (`stages`) and one
    for each kernel check (`check_kernels`)."""
    p = argparse.ArgumentParser(prog="stockham_reference", description=__doc__.splitlines()[0])
    p.add_argument("sizes", nargs="*", type=int,
                   help="powers of two >= 2 (default 2..4096)")
    p.add_argument("--log", action="store_true", help="dump every stage")
    p.add_argument("--inverse", action="store_true", help="the inverse direction alone")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    sizes = args.sizes or [1 << k for k in range(1, 13)]
    for n in sizes:
        if n < 2 or n & (n - 1):
            p.error(f"sizes are powers of two >= 2, got {n}")
    device = device_or_exit(args.cpu, "stockham_reference")
    directions = (True,) if args.inverse else (False, True)
    recs = []
    for n in sizes:
        x = _signal(n, 4, n)
        plan = [r for r, _ in st.stage_plan(n)]
        for inverse in directions:
            word = "inverse" if inverse else "forward"
            if args.log:
                print(f"n={n} {word} plan={plan}")
            got, _ = stockham_reference(x, inverse, log=args.log)
            want = np.fft.ifft(x, axis=0) if inverse else np.fft.fft(x, axis=0)
            err = _rel(got, want)
            first, diffs = diff_stages(x, inverse, device)
            good = err < REF_LIMIT and first is None
            recs.append({"stages": plan, "n": n, "inverse": inverse, "ref_err": err,
                         "stage_diffs": diffs, "first": first, "ok": good})
            where = "none" if first is None else f"stage {first}"
            print(f"n={n} {word}: reference vs np.fft {err:.2e} (limit {REF_LIMIT:.0e}); "
                  f"plain stages on {device} vs reference, worst {max(diffs):.2e}, "
                  f"first past {STAGE_LIMIT['float32']:.0e}: {where} "
                  f"{'OK' if good else 'MISMATCH'}")
            if args.log or first is not None:
                for i, d in enumerate(diffs):
                    print(f"  stage {i}: R={plan[i]} diff {d:.2e}")
        if n > planner.STOCKHAM_MAX_N:
            print(f"n={n}: past the c2c kernel's {planner.STOCKHAM_MAX_N} points, no kernel run")
            continue
        for rec in check_kernels(n, device, directions):
            recs.append(rec)
            print(f"n={n} {'inverse' if rec['inverse'] else 'forward'} {rec['instance']} "
                  f"({rec['replaces']}, {rec['dtype']}, batch {rec['batch']}, "
                  f"tile {tuple(rec['tile'])}): "
                  f"{rec['max_rel']:.2e} of the largest output (limit {rec['limit']:.0e}), "
                  f"launched {rec['launched']} {'OK' if rec['ok'] else 'MISMATCH'}")
    return (0 if all(r["ok"] for r in recs) else 1), recs


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
