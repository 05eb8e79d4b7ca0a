"""Accuracy report across every registered surface x size.

The port's counterpart of `tools/accuracy_report.py` (a port of
tools/accuracy_report.js of wat-fft): max-rel / rms-rel / quality
(= max_rel / (eps * sqrt(log2 N)), should stay ~flat with N) per surface x
implementation x size, through the same `measure_accuracy` as
`tests/test_torch_accuracy.py`, so tool and test cannot disagree. Then the
2D faces (`fft2_planes`, `rfft2_planes` / `irfft2_planes`, with the round
trip's largest error `inv_abs`) and the bf16 tier: the interop instance
and, under `config.BF16_COMPUTE`, the compute instance (the `-c` rows),
its quality against bfloat16's own eps. Each row names the kernels it
launched (`registry.launch_counts`).

Every dtype runs in this one process, on the card unless `--cpu` is given.

    python -m watfft_tpu_torch.tools.accuracy_report [--sizes 16,64,...]
        [--dtype float32|float64|bfloat16] [--cpu]

`main` returns the rows; the command exits 1 if any row is an ERROR.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config, registry
from ..utils.accuracy import measure_accuracy, to_host
from ..utils.tolerances import quality
from . import device_or_exit

PROG = "python -m watfft_tpu_torch.tools.accuracy_report"
SURFACES = (("complex-forward", "c2c", False), ("complex-inverse", "c2c", True),
            ("real-forward", "r2c", False), ("real-inverse", "c2r", True))
# The 2D faces' shapes, the JAX report's
FFT2_SHAPES = ((128, 256, 256), (512, 512))
RFFT2_SHAPES = ((128, 256, 256), (1024, 1024))


def _print(row: dict) -> None:
    dt = "bf16" if row["dtype"] == "bfloat16" else row["dtype"]
    head = f"{row['surface']:<18} {row['impl']:<16} {dt:<8} {row['n']:>7}"
    if row["error"]:
        print(f"{head} ERROR: {row['error'][:60]}", flush=True)
        return
    tail = f"  inv_abs {row['inv_abs']:.2e}" if "inv_abs" in row else ""
    if row["launches"]:
        tail += "  " + " ".join(f"{k}={v}" for k, v in row["launches"].items())
    print(f"{head} {row['max_rel']:>10.2e} {row['rms_rel']:>10.2e} {row['quality']:>8.2f}{tail}",
          flush=True)


def _row(surface: str, impl: str, dtype: str, n: int, measure) -> dict:
    """One measured row, with the kernel launches it made (none on the CPU,
    none for torch.fft and the matmul surface)."""
    row = {"surface": surface, "impl": impl, "dtype": dtype, "n": n, "error": None}
    before = registry.launch_counts()
    try:
        row.update(measure())
    except Exception as ex:  # a broken surface is a row of the report, and the exit code
        row["error"] = f"{type(ex).__name__}: {ex}"
    row["launches"] = {k: v - before[k] for k, v in registry.launch_counts().items()
                       if v != before[k]}
    _print(row)
    return row


def _registry_rows(entries, sizes, dtype, kind, inverse, device, impl=None) -> list[dict]:
    rows = []
    for e in entries:
        for n in sizes:
            if not e.min_size <= n <= e.max_size:
                continue

            def measure(e=e, n=n):
                r = measure_accuracy(e.make(n, device), n, dtype, kind=kind, inverse=inverse,
                                     surface=e.name)
                return {"max_rel": r.max_rel, "rms_rel": r.rms_rel, "quality": r.quality}
            rows.append(_row(e.surface, impl or e.name, dtype, n, measure))
    return rows


def _fft2_row(shape, device, rng) -> dict:
    from ..ops.fft2 import fft2_planes

    def measure():
        a = rng.uniform(-1, 1, shape).astype(np.float32)
        b = rng.uniform(-1, 1, shape).astype(np.float32)
        re, im = fft2_planes(torch.as_tensor(a, device=device), torch.as_tensor(b, device=device))
        got = to_host(re) + 1j * to_host(im)
        want = np.fft.fft2(a.astype(np.float64) + 1j * b.astype(np.float64), axes=(-2, -1))
        bre, bim = fft2_planes(re, im, inverse=True)
        inv = max(np.max(np.abs(to_host(bre) - a)), np.max(np.abs(to_host(bim) - b)))
        return _errors_2d(got, want, shape, inv)
    return _row("2d-forward", "fft2-planes", "float32", shape[-2] * shape[-1], measure)


def _rfft2_row(shape, device, rng) -> dict:
    from ..ops.fft2 import irfft2_planes, rfft2_planes

    def measure():
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        re, im = rfft2_planes(torch.as_tensor(x, device=device))
        got = to_host(re) + 1j * to_host(im)
        want = np.fft.rfft2(x.astype(np.float64), axes=(-2, -1))
        inv = np.max(np.abs(to_host(irfft2_planes(re, im)) - x))
        return _errors_2d(got, want, shape, inv)
    return _row("2d-real", "rfft2-planes", "float32", shape[-2] * shape[-1], measure)


def _errors_2d(got, want, shape, inv) -> dict:
    """Errors of a 2D face as the JAX report takes them: normalized by the
    largest output; quality at N = h*w."""
    scale = np.max(np.abs(want))
    err = np.abs(got - want)
    max_rel = float(np.max(err) / scale)
    return {"max_rel": max_rel, "rms_rel": float(np.sqrt(np.mean(err ** 2)) / scale),
            "quality": quality(max_rel, shape[-2] * shape[-1], "float32"),
            "inv_abs": float(inv), "shape": list(shape)}


def _bf16_rows(sizes, device) -> list[dict]:
    rows = []
    saved = config.BF16_COMPUTE
    for surface, kind, inverse in SURFACES[:2]:
        for e in registry.entries(surface, "bfloat16"):
            for tier, flag in ((e.name, False), (e.name + "-c", True)):
                config.BF16_COMPUTE = flag
                try:
                    rows += _registry_rows([e], sizes, "bfloat16", kind, inverse, device, tier)
                finally:
                    config.BF16_COMPUTE = saved
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--sizes", default="16,64,256,1024,4096")
    ap.add_argument("--dtype", default=None, choices=["float32", "float64", "bfloat16"])
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    device = device_or_exit(args.cpu, PROG)
    sizes = [int(s) for s in args.sizes.split(",")]
    dtypes = [args.dtype] if args.dtype else ["float32", "float64", "bfloat16"]

    print(f"{'surface':<18} {'impl':<16} {'dtype':<8} {'n':>7} "
          f"{'max_rel':>10} {'rms_rel':>10} {'quality':>8}", flush=True)
    rows = []
    for surface, kind, inverse in SURFACES:
        for dtype in dtypes:
            if dtype != "bfloat16":
                rows += _registry_rows(registry.entries(surface, dtype, include_baselines=True),
                                       sizes, dtype, kind, inverse, device)
    if "float32" in dtypes:
        rng = np.random.default_rng(2026)
        rows += [_fft2_row(s, device, rng) for s in FFT2_SHAPES]
        rows += [_rfft2_row(s, device, rng) for s in RFFT2_SHAPES]
    if "bfloat16" in dtypes:
        rows += _bf16_rows(sizes, device)
    return rows


if __name__ == "__main__":
    sys.exit(1 if any(r["error"] for r in main()) else 0)
