"""CLI: self-test and audio analysis.

  python -m watfft_tpu_torch [size] [signal] [--dtype float32|float64] [--cpu]
      The counterpart of `python -m watfft_tpu` (reference parity: wat-fft's
      CLI test mode `node tests/fft.test.js 64 random`). Runs every
      complex-forward registry entry in range, the torch.fft baseline
      included, for one size and signal against the f64 oracle and prints
      each one's error; exits 1 on any FAIL or ERROR. Both dtypes run on
      the card (the FP64 kernels; the JAX package runs float64 on the host
      CPU for want of f64 units on the TPU).

  python -m watfft_tpu_torch analyze file.wav [--html out.html] [--cpu]
      The user-audio path of the playground report
      (`watfft_tpu_torch.tools.playground_report`): decodes the WAV with the
      stdlib, runs the STFT mel spectrogram and an rfft spectrum on the
      device and writes a self-contained interactive HTML page; a file that
      is not a readable WAV exits 2.

Without a CUDA device and without --cpu both exit 2 and name the missing
device; with --cpu they run the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

PROG = "python -m watfft_tpu_torch"


def _analyze(argv) -> None:
    from .tools import device_or_exit
    from .tools import playground_report as pr

    ap = argparse.ArgumentParser(prog=f"{PROG} analyze")
    ap.add_argument("wav", help="input WAV file (PCM 8/16/24/32-bit)")
    ap.add_argument("--html", default=None, help="output path (default: <wav>.html)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device_or_exit(args.cpu, f"{PROG} analyze")
    pr_args = ["--wav", args.wav, args.html or (os.path.splitext(args.wav)[0] + ".html")]
    if args.cpu:
        pr_args.append("--cpu")
    try:
        pr.main(pr_args)
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "analyze":
        _analyze(argv[1:])
        return
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("size", nargs="?", type=int, default=64)
    ap.add_argument("signal", nargs="?", default="random")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from . import registry
    from .reference import dft as ref
    from .tools import device_or_exit
    from .utils.accuracy import to_host
    from .utils.tolerances import MAX_REL

    device = device_or_exit(args.cpu, PROG)
    n = args.size
    x = ref.make_signal(args.signal, n)
    expected = ref.dft(x)
    scale = max(float(np.max(np.abs(expected))), 1e-30)

    print(f"size={n} signal={args.signal} dtype={args.dtype} device={device}")
    failures = 0
    for e in registry.entries("complex-forward", args.dtype, include_baselines=True):
        if not e.min_size <= n <= e.max_size:
            continue
        try:
            got = to_host(e.make(n, device)(x))
            err = float(np.max(np.abs(got - expected))) / scale
            ok = err < MAX_REL[args.dtype] * 4
            print(f"  {e.surface:<16} {e.name:<20} err={err:.3e} {'OK' if ok else 'FAIL'}")
            failures += 0 if ok else 1
        except Exception as ex:  # a broken surface is a row, and the exit code
            print(f"  {e.surface:<16} {e.name:<20} ERROR: {str(ex)[:60]}")
            failures += 1
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
