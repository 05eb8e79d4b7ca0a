"""Reductions of a profiler trace (the Chrome trace `torch.profiler` exports)
to the numbers the per-layer metrics read.

An event is a dict with `cat`, `name`, `ts` and `dur` (microseconds). Device
work is every event of the categories in `DEVICE`; the traced window is the
`fftbench.window` span the harness puts around the traced slice; the host's
spans are the other `fftbench.*` spans. The port's kernels are known by the
`__global__` names in its CUDA sources, read at run time.
"""

from __future__ import annotations

import bisect
import re
from pathlib import Path

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "fftbench.window"
CSRC = Path(__file__).resolve().parent.parent / "watfft_tpu_torch" / "ops" / "csrc"
TOP = 10


def port_kernels(csrc: Path = CSRC) -> set:
    """The names of the `__global__` functions in the port's CUDA sources."""
    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        text = src.read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            i = m.end()
            if text.startswith("__launch_bounds__", i):  # skip its balanced (...)
                i = text.index("(", i)
                depth = 0
                while True:
                    depth += {"(": 1, ")": -1}.get(text[i], 0)
                    i += 1
                    if depth == 0:
                        break
            name = re.match(r"\s*(\w+)", text[i:])
            if name:
                names.add(name.group(1))
    return names


def base_name(kernel: str) -> str:
    """`void (anonymous namespace)::k<float, 4>(float const*, ...)` -> `k`."""
    s = kernel.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip()


def _cat(e: dict) -> str:
    return str(e.get("cat", "")).lower()


def window(events: list) -> tuple[float, float]:
    """(start, end) in microseconds of the traced window's span."""
    for e in events:
        if e.get("name") == WINDOW and _cat(e) == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise ValueError(f"no {WINDOW} span in the trace")


def device_ops(events: list, lo: float, hi: float) -> list:
    """(start, end, name) of the device's work, clipped to [lo, hi]."""
    out = []
    for e in events:
        if _cat(e) in DEVICE and "dur" in e:
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            s, t = max(s, lo), min(t, hi)
            if t > s:
                out.append((s, t, str(e.get("name", ""))))
    return sorted(out)


def merged(ops: list) -> list:
    """The union of the ops' intervals, as sorted disjoint (start, end)."""
    out = []
    for s, t, _ in ops:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_spans(events: list) -> list:
    """The benchmark's host spans but the window, as sorted (start, end, name)."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events
                  if _cat(e) == "user_annotation" and str(e.get("name", "")).startswith("fftbench.")
                  and e["name"] != WINDOW)


def label(spans: list, starts: list, t: float) -> str:
    """The span the host was in at time t (the spans do not overlap)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        return spans[i][2]
    return "host.other"


def summary(events: list, port: set) -> dict:
    """The traced window's length, the device's busy time (the union of its
    work), the time in the port's kernels and in all device work, the
    device ops that took most time and the idle time by the host span it
    fell in, each list at most `TOP` long, in seconds."""
    lo, hi = window(events)
    ops = device_ops(events, lo, hi)
    busy = merged(ops)
    by_name, port_us = {}, 0.0
    for s, t, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        if base_name(name) in port:
            port_us += t - s
    spans = host_spans(events)
    starts = [s for s, _, _ in spans]
    idle = {}
    for s, t in gaps(busy, lo, hi):
        key = label(spans, starts, (s + t) / 2)
        idle[key] = idle.get(key, 0.0) + (t - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "port_s": port_us * 1e-6,
            "device_s": sum(by_name.values()) * 1e-6,
            "device_ops": [[name, us * 1e-6] for name, us in top],
            "idle_gaps": [[name, us * 1e-6] for name, us in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}


def idle_pct(summary: dict | None) -> float | None:
    """The share of the traced window with no work on the device; None where
    the trace holds no device work at all (nothing was traced there)."""
    if not summary or summary["window_s"] <= 0 or summary["device_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
