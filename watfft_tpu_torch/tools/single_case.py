"""Single-case runner: one surface x size x signal x dtype, bin by bin.

The port's counterpart of `tools/single_case.py` (after the CLI test mode
of wat-fft, `node tests/fft.test.js 64 random`): when a sweep fails, run
exactly one case and see the worst bins beside the f64 oracle, and which
kernels each implementation launched.

    python -m watfft_tpu_torch.tools.single_case 64 random               # complex forward
    python -m watfft_tpu_torch.tools.single_case 1024 sine --surface real-forward
    python -m watfft_tpu_torch.tools.single_case 256 impulse --impl stockham-cuda --bins 16
    python -m watfft_tpu_torch.tools.single_case 64 random --dtype float64 --inverse --cpu

Every registry entry of the surface and dtype that covers n runs (`--impl`
picks one, the `torch-fft` baseline included) through `entry.make(n,
device)`, on the CUDA device unless `--cpu`; without one it exits 2. The
oracle is `reference.dft` in float64 (numpy's FFT in complex128 past 4096
points, where the O(n^2) DFT is too large). Exit code 1 if an entry goes
past 4x its dtype's limit: `utils.tolerances.MAX_REL` in float32 and
float64, in bfloat16 the bf16 tier's limit against the oracle (`BF16_LIMIT`,
the tier `config.BF16_COMPUTE` selects).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config, registry
from ..reference import dft as ref
from ..utils.tolerances import MAX_REL
from . import device_or_exit

__all__ = ["BF16_LIMIT", "EXACT_MAX_N", "case", "limit", "run_entry", "run", "main"]

# The bf16 tiers against the f64 oracle, of the largest output (interop:
# f32 stages between bf16 loads and stores; compute: bf16 stages), as the
# tests and chip_smoke.py hold them.
BF16_LIMIT = {"interop": 3e-2, "compute": 5e-2}
# Past this n the oracle is numpy's FFT in complex128, not the O(n^2) DFT.
EXACT_MAX_N = 4096


def limit(dtype: str) -> float:
    """The dtype's limit against the oracle, of the largest output."""
    if dtype == "bfloat16":
        return BF16_LIMIT["compute" if config.BF16_COMPUTE else "interop"]
    return MAX_REL[dtype]


def case(surface: str, n: int, signal: str) -> tuple[np.ndarray, np.ndarray]:
    """(input, f64 oracle output) of one case. The real inverse takes the
    forward oracle's spectrum and must give back the time-domain signal."""
    exact = n <= EXACT_MAX_N
    if surface.startswith("real"):
        sig = ref.REAL_SIGNALS[signal](n)
        spec = ref.real_dft(sig) if exact else np.fft.rfft(sig)
        return (sig, spec) if surface == "real-forward" else (spec, sig.astype(np.complex128))
    x = ref.SIGNALS[signal](n)
    if surface == "complex-forward":
        return x, ref.dft(x) if exact else np.fft.fft(x)
    return x, ref.idft(x) if exact else np.fft.ifft(x)


def run_entry(e, n: int, x: np.ndarray, device) -> tuple[np.ndarray, dict]:
    """The entry's output for one input row (complex128 on the host) and the
    kernels it launched, from `registry.launch_counts()` before and after."""
    before = registry.launch_counts()
    out = e.make(n, device)(x[None, :])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    after = registry.launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    got = out.detach().cpu()
    got = got.to(torch.complex128) if got.is_complex() else got.to(torch.float64)
    return got.numpy()[0].astype(np.complex128), launched


def _worst(err: np.ndarray, bins: int) -> np.ndarray:
    """The indices of the `bins` largest errors (all where 0), in bin order."""
    if bins == 0 or bins >= err.size:
        return np.arange(err.size)
    return np.sort(np.argpartition(-err, bins - 1)[:bins])


def run(argv=None) -> tuple[int, list[dict]]:
    """The command line's work: its exit code and one record an entry
    (name, surface, dtype, n, signal, max_rel, tolerance, launched, ok)."""
    p = argparse.ArgumentParser(prog="single_case", description=__doc__.splitlines()[0])
    p.add_argument("n", type=int)
    p.add_argument("signal", choices=sorted(set(ref.SIGNALS) | set(ref.REAL_SIGNALS)))
    p.add_argument("--surface", default="complex-forward", choices=registry.SURFACES)
    p.add_argument("--inverse", action="store_true",
                   help="shorthand: flips *-forward to *-inverse")
    p.add_argument("--dtype", default="float32", choices=("float32", "float64", "bfloat16"))
    p.add_argument("--impl", default=None,
                   help="run only the implementation with this registry name")
    p.add_argument("--bins", type=int, default=32,
                   help="print at most this many bins (worst first), 0 = all")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    device = device_or_exit(args.cpu, "single_case")

    surface = args.surface.replace("-forward", "-inverse") if args.inverse else args.surface
    if surface.startswith("real") and args.signal not in ref.REAL_SIGNALS:
        p.error(f"signal {args.signal!r} is complex-only")
    cands = registry.entries(surface, args.dtype, include_baselines=args.impl is not None)
    if args.impl is not None:
        cands = [e for e in cands if e.name == args.impl]
        if not cands:
            names = [e.name for e in registry.entries(surface, args.dtype, True)]
            p.error(f"no impl {args.impl!r} for {surface}/{args.dtype}; have {names}")
    cands = [e for e in cands if e.min_size <= args.n <= e.max_size]
    if not cands:
        print(f"no registered implementation covers {surface}/{args.dtype} n={args.n}")
        return 1, []

    x, expected = case(surface, args.n, args.signal)
    tolerance = 4 * limit(args.dtype)
    scale = max(float(np.max(np.abs(expected))), 1e-30)
    recs = []
    for e in cands:
        got, launched = run_entry(e, args.n, x, device)
        err = np.abs(got - expected) / scale
        worst = float(np.max(err))
        ok = worst < tolerance
        recs.append({"name": e.name, "surface": surface, "dtype": args.dtype, "n": args.n,
                     "signal": args.signal, "max_rel": worst, "tolerance": tolerance,
                     "launched": launched, "ok": ok})
        print(f"\n== {e.name}  {surface}/{args.dtype}  n={args.n}  signal={args.signal}  "
              f"max-rel={worst:.3e}  tol={tolerance:.1e}  {'OK' if ok else 'FAIL'}")
        print(f"   on {device}, launched: "
              + (", ".join(f"{k} {v}" for k, v in launched.items()) or "no kernel of the port"))
        print(f"{'bin':>8} {'got':>28} {'expected':>28} {'rel-err':>10}")
        for k in _worst(err, args.bins).tolist():
            g, w = got[k], expected[k]
            print(f"{k:>8} {g.real:+.6e}{g.imag:+.6e}j {w.real:+.6e}{w.imag:+.6e}j"
                  f" {err[k]:>10.2e}")
    return (0 if all(r["ok"] for r in recs) else 1), recs


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
