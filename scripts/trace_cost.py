"""The host cost of the port's spans: the closed-loop stream cells of
`fftbench/` (one caller, a synchronize after each request, where the host
is exposed), run in this checkout and in others in turns, with no profiler
session (spans off, as the benchmark's measured windows run) and inside one
(spans on, CUDA activity alone, as its traced slices run).

    python3 scripts/trace_cost.py OTHER [OTHER ...] [--sets 3] [--seconds 5]

Each set runs every checkout once, in a process of its own, on one seed a
set, in the order given (this checkout first) and in the reverse order in
every other set. A process runs both stream
cells (`c2c_n1024.stream` on `traffic/closed_b1.json`, `stft_n1024.stream`
on `traffic/closed_c1_t16000.json`; they have files but no entry in
`BENCHMARK.json`, so they are added to a spec built in memory) off, then
on, through `harness.resolve` and `harness.run`. Prints one JSON line a
process, then the medians over the sets of `host_us_per_call.stream` (the
median host time of one call of the port) and `request_p95_ms` by checkout,
cell and mode. Needs a CUDA card; each checkout builds its kernels on its
first run.

    python3 scripts/trace_cost.py OTHER --same-process [--seconds 5]

holds the two ports in one process instead (OTHER's package copied under
build/trace_cost/ as `watfft_other`, with OTHER's kernels, or this
checkout's where OTHER has none built), with no profiler session, and
interleaves their requests: a c2c forward and inverse on one transform of
1024 points, then a stft and istft of one clip of 16,000 samples, each
side in turn, a synchronize after each request. Prints the median host
time of each call by side, which process-to-process noise does not move.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"c2c_n1024.stream": ("c2c_n1024", "closed_b1"),
         "stft_n1024.stream": ("stft_n1024", "closed_c1_t16000")}
METRICS = [{"name": "host_us_per_call.stream", "unit": "us"},
           {"name": "request_p95_ms", "unit": "ms"},
           {"name": "launches_per_call.stream", "unit": "launches"}]


def child(root: str, seed: int, seconds: float) -> dict:
    """Both stream cells of the checkout at `root`, off then on."""
    sys.path.insert(0, root)
    from torch.profiler import ProfilerActivity, profile

    from fftbench import harness

    spec = harness.load_spec()
    spec["workloads"] = spec["workloads"] + [
        {"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "cost"}
        for name, (config, traffic) in CELLS.items()]
    out = {}
    for name in CELLS:
        cell = harness.resolve(spec, name)
        cell.end_to_end = METRICS
        off = harness.run(cell, seed, seconds, False, "cuda")
        with profile(activities=[ProfilerActivity.CUDA]):
            on = harness.run(cell, seed, seconds, False, "cuda")
        out[name] = {mode: {"correct": r["correct"], "attempted": r["attempted"],
                            **{k: v["value"] for k, v in r["metrics"].items()}}
                     for mode, r in (("off", off), ("on", on))}
    return out


def same_process(other: str, seconds: float, seed: int) -> dict:
    """This checkout's port and OTHER's in one process, their requests
    interleaved; the median host time of each call, in us, by side."""
    import shutil
    import time
    from pathlib import Path

    copy = Path(ROOT) / "build" / "trace_cost"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(Path(other) / "watfft_tpu_torch", copy / "watfft_other",
                    ignore=shutil.ignore_patterns("__pycache__"))
    built = Path(other) / "build" / "watfft_tpu_torch"
    shutil.copytree(built if built.is_dir() else Path(ROOT) / "build" / "watfft_tpu_torch",
                    copy / "build" / "watfft_tpu_torch")
    sys.path[:0] = [ROOT, str(copy)]
    import torch
    import watfft_other
    import watfft_tpu_torch

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.view_as_complex(torch.rand((1, 1024, 2), generator=g, device=dev) * 2 - 1)
    clip = torch.rand((1, 16000), generator=g, device=dev) * 2 - 1
    sides = {"this": watfft_tpu_torch, "other": watfft_other}
    ctxs = {side: mod.create_fft_f32(1024, device=dev) for side, mod in sides.items()}
    perf = time.perf_counter

    def request(side: str) -> list:
        st, ctx = sides[side].stft, ctxs[side]
        t0 = perf()
        y = ctx.forward(x)
        t1 = perf()
        ctx.inverse(y)
        t2 = perf()
        sync()
        t3 = perf()
        re, im = st.stft(clip, 1024, 256, device=dev)
        t4 = perf()
        st.istft(re, im, 1024, 256, length=clip.shape[-1], device=dev)
        t5 = perf()
        sync()
        return [t1 - t0, t2 - t1, t4 - t3, t5 - t4]

    calls = ("forward", "inverse", "stft", "istft")
    times = {side: {c: [] for c in calls} for side in sides}
    for side in sides:  # warm-up: tables, windows, the library
        request(side)
    end, order = perf() + seconds, list(sides)
    while perf() < end:
        for side in order:
            for c, t in zip(calls, request(side)):
                times[side][c].append(t)
        order.reverse()
    return {side: {c: statistics.median(v) * 1e6 for c, v in by.items()}
            for side, by in times.items()} | {"requests": len(times["this"]["forward"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*")
    ap.add_argument("--sets", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=2**31 + 20)
    ap.add_argument("--same-process", action="store_true",
                    help="both ports in one process, their requests interleaved")
    ap.add_argument("--child", nargs=3, metavar=("ROOT", "SEED", "SECONDS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        root, seed, seconds = args.child
        print(json.dumps(child(root, int(seed), float(seconds))), flush=True)
        return 0
    if args.same_process:
        for other in args.others:
            print(json.dumps({"checkout": os.path.abspath(other),
                              **same_process(os.path.abspath(other), args.seconds, args.seed)}))
        return 0
    roots = [ROOT] + [os.path.abspath(o) for o in args.others]
    runs = {r: [] for r in roots}
    for k in range(args.sets):
        seed = args.seed + 7919 * k
        for root in roots if k % 2 == 0 else roots[::-1]:
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                                str(seed), str(args.seconds)], cwd=root, capture_output=True,
                               text=True)
            if p.returncode:
                print(p.stderr[-3000:], file=sys.stderr)
                return p.returncode
            line = json.loads(p.stdout.strip().splitlines()[-1])
            print(json.dumps({"set": k, "seed": seed, "root": root, "cells": line}), flush=True)
            runs[root].append(line)
    for root, lines in runs.items():
        for name in CELLS:
            for mode in ("off", "on"):
                med = {m["name"]: statistics.median(line[name][mode][m["name"]]
                                                    for line in lines)
                       for m in METRICS[:2]}
                print(json.dumps({"root": root, "cell": name, "mode": mode, "median": med,
                                  "all_correct": all(line[name][mode]["correct"]
                                                     for line in lines)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
