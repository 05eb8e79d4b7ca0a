"""Runs one cell of the benchmark once and prints its result as the last line
of standard output.

    python fftbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (as many as the cell asks for); without one it exits 2 and
prints no result. The compared numbers, each beside its limit, are the last
lines of standard error and the result's last key.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (/proc: the interpreter's own
    start-up counts as set-up too)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "watfft_tpu"}
# build and kernel caches at fixed paths inside the checkout (the port builds
# its library under build/watfft_tpu_torch/ itself)
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    import argparse
    import json

    t_process = time.perf_counter() - _process_age()  # the start, on perf_counter's clock
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "fftbench", sub)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT  # the checkout's root, not fftbench/, comes first
    else:
        sys.path.insert(0, ROOT)
    import torch

    from fftbench import harness

    cell = harness.resolve(harness.load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fftbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    result["device"]["power_limit"] = _power_limit()
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"fftbench: the process holds {found}: JAX or the JAX package was "
              f"loaded; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _power_limit() -> str | None:
    """The card's power limit as nvidia-smi reads it (None if it cannot)."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                            "-i", "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip() or None


if __name__ == "__main__":
    sys.exit(main())
