"""Readings from which each compared number's limit is set: the program's
sound runs over many seeds (the lower reading: their largest) and the
control's over a few (the upper reading: its smallest), each a short window
at the cell's own load through the same loop and check as a run, in one
process.

    python fftbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--seconds 2]

The control is the configuration's `control_calls()`: the computation in the
nearest precision below the configuration's (bfloat16 for float32). Prints
one JSON line a run, then the summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT
    from fftbench import harness

    cell = harness.resolve(harness.load_spec(), args.workload)
    readings = {"program": {}, "control": {}}
    for side, seeds, calls_of in (("program", args.seeds, None),
                                  ("control", args.control_seeds,
                                   lambda wl: wl.control_calls())):
        for seed in seeds:
            r = harness.run(cell, seed, args.seconds, False, args.device, calls_of=calls_of)
            values = {k: c["value"] for k, c in r["checks"].items()}
            print(json.dumps({"side": side, "seed": seed, "attempted": r["attempted"],
                              "values": values, "metrics": r["metrics"]}), flush=True)
            for k, v in values.items():
                readings[side].setdefault(k, []).append(v)
    summary = {k: {"lower": max(v), "upper": min(readings["control"].get(k, [float("nan")]))}
               for k, v in readings["program"].items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
