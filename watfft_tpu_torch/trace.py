"""Spans and counters of the port's own work, and their place on the device
trace's clock.

A span is one step of a call: its name, its start and end on
`time.perf_counter_ns()`, the span it ran inside (0 for none) and a call
id. A root span is a public entry its caller called (`api.forward`,
`stft.stft`, ...) and takes a new call id; the spans inside it, nested
public entries included, share that id. The names follow the port's
layers:

  api.<entry>     a public method of FFTContext / RFFTContext or a
                  functional entry (api.fft, api.rfft2, ...); a root
  stft.stft, stft.istft, and the STFT's steps (stft.window, stft.frame,
                  istft.window, istft.frame_window, istft.overlap_add,
                  istft.norm, istft.divide)
  launch.<name>   one call into the CUDA library, which launches one
                  kernel; <name> is the kernel's launch counter, as
                  `registry.launch_counts()` names it
  h2d             one copy from host memory to a device (`h2d`, `to`)

Spans record only while a `torch.profiler` session is active (torch's
`torch.autograd.profiler._is_profiler_enabled`): with no session a span
costs its caller one test of that flag, read inline
(`profiler._is_profiler_enabled`: a call would cost more than the test),
and creates nothing. Spans are kept in a bounded buffer of plain tuples
(the oldest dropped past `CAPACITY`), read by `spans()`, `chrome_events()`
and `merge_into()`.

Counters are always on, plain integer adds beside the kernels' launch
counters (`counts`, `routes`): `h2d_copies` and `h2d_bytes` (copies from
host memory to a device), `tables_built` (misses of the port's table and
context caches, and each STFT window built) and each route FFTContext
took (the route of a call is not a span: the launch spans name its
kernels). `counters()` returns them with every launch counter.

`align()` lays the spans on a device trace's clock. With CUDA activity
alone `torch.profiler` still records the host's CUDA runtime calls
(`cudaLaunchKernel`, ...) on the kernels' clock, each with the
correlation id of the device op it started; every `launch.*` span holds
one such call (and every `h2d` span the call that started its copy), so
the offset from `perf_counter_ns` to the trace is the one that puts the
calls inside their spans. `attribute()` then puts each device op down to
the innermost span that launched it and each idle gap to the innermost
span the host was in.
"""

from __future__ import annotations

import bisect
import collections
import functools
import json
import os
import re
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["CAPACITY", "Span", "begin", "end", "call", "h2d", "to", "counts", "routes",
           "counters", "spans", "clear", "chrome_events", "kernel_names", "Alignment",
           "clock_guess", "align", "attribute", "summary", "merge_into"]

CAPACITY = 1 << 20

counts = {"h2d_copies": 0, "h2d_bytes": 0, "tables_built": 0}
# FFTContext's routes (`planner.c2c_kernel`), each counted as it is taken: a
# plain dict with every key in place, the cheapest count on the hot path
routes = dict.fromkeys(("stockham", "large-cube", "large-pipe2", "fourstep"), 0)


class Span(NamedTuple):
    id: int
    name: str
    t0: int          # perf_counter_ns at the start
    t1: int          # and at the end
    parent: int      # the id of the span it ran inside, 0 for a root
    call: int        # the call id its root took
    tid: int         # the thread (`threading.get_ident()`)


# What a span records, when it closes: (name, t0, t1, thread). Its
# id, parent and call id are read from how the spans of a thread nest
# (`spans()`): recording stays two clock reads and an append.
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)


def begin(name: str) -> tuple:
    """Opens span `name`; returns its token for `end`. Callers open spans
    only while a profiler session is active."""
    return name, time.perf_counter_ns()


def end(token: tuple) -> None:
    """Closes and records the span of `token`. A span an exception skips
    the end of is not recorded; the spans inside it then belong to the
    span around it."""
    _buffer.append((token[0], token[1], time.perf_counter_ns(), threading.get_ident()))


def call(name: str, fn, *args):
    """fn(*args) inside span `name`, closed however fn ends; what public
    entries run while a profiler session is active."""
    token = begin(name)
    try:
        return fn(*args)
    finally:
        end(token)


def h2d(a, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(a, device=device, dtype=dtype)` for `a` in host
    memory (a numpy array or a CPU tensor). Where `device` is not the host
    it is a copy: counted in `h2d_copies` and `h2d_bytes` (the bytes of
    the tensor made) and, while tracing, recorded as an `h2d` span."""
    token = begin("h2d") if _profiler._is_profiler_enabled else None
    out = torch.as_tensor(a, device=device, dtype=dtype)
    if not out.is_cpu:
        if token is not None:
            end(token)
        counts["h2d_copies"] += 1
        counts["h2d_bytes"] += out.nbytes
    return out


def to(x: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """`x.to(device=device, dtype=dtype)`; a move from host memory goes
    through `h2d`, which counts it where `device` is not the host."""
    if x.is_cpu:
        return h2d(x, device, dtype)
    return x.to(device=device, dtype=dtype)


def counters() -> dict:
    """Every counter of the port: `counts`, `route.<route>` and
    `launch.<kernel>` (`registry.launch_counts()`). Read before and after
    a step, their differences are what the step did."""
    from .registry import launch_counts

    out = dict(counts)
    out.update(("route." + k, v) for k, v in sorted(routes.items()))
    out.update(("launch." + k, v) for k, v in launch_counts().items())
    return out


def spans() -> list[Span]:
    """The recorded spans by thread and start (a span before the spans it
    holds), numbered in that order, each with its parent's id (0 for a
    root: a span no other span of its thread holds) and its root's call
    id."""
    out, stack, calls = [], [], 0
    for name, t0, t1, tid in sorted(_buffer, key=lambda r: (r[3], r[1], -r[2])):
        while stack and (stack[-1].tid != tid or stack[-1].t1 <= t0):
            stack.pop()
        if stack:
            parent, call_id = stack[-1].id, stack[-1].call
        else:
            calls += 1
            parent, call_id = 0, calls
        span = Span(len(out) + 1, name, t0, t1, parent, call_id, tid)
        out.append(span)
        stack.append(span)
    return out


def clear() -> None:
    """Empties the buffer."""
    _buffer.clear()


def chrome_events(offset_ns: float = 0.0, recorded: list[Span] | None = None) -> list[dict]:
    """The spans (default: all recorded) as Chrome-trace complete events
    named `watfft.<span>` of this process, at `perf_counter_ns +
    offset_ns` nanoseconds on the trace's timeline (in its microseconds)."""
    pid = os.getpid()
    out = []
    for s in spans() if recorded is None else recorded:
        out.append({"ph": "X", "cat": "watfft", "name": "watfft." + s.name, "pid": pid,
                    "tid": s.tid, "ts": (s.t0 + offset_ns) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
                    "args": {"span": s.id, "parent": s.parent, "call": s.call}})
    return out


# -- the device trace's clock ----------------------------------------------------------

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = ("cuda_runtime", "cuda_driver")
WINDOW_NS = 1_000_000  # how far from the first guess the offset is looked for


@dataclass
class Alignment:
    """perf_counter_ns + offset_ns = nanoseconds on the trace's timeline.
    residual_ns: the width of the interval of offsets that puts the most
    `launch.*` and `h2d` spans around their runtime calls; held: the share
    of the `launch.*` spans that hold exactly one launch after alignment.
    Both None where the trace has no runtime call to fit (the offset is
    then the clocks' guess, unmeasured). guess_ns: the guess the fit
    started from."""
    offset_ns: float
    residual_ns: float | None
    launch_spans: int
    held: float | None
    guess_ns: float | None = None


def _cat(e: dict) -> str:
    return str(e.get("cat", "")).lower()


def _corr(e: dict):
    return (e.get("args") or {}).get("correlation")


def clock_guess(base_ns: int) -> float:
    """The offset from `perf_counter_ns` to a trace whose timestamps count
    from `base_ns` on the wall clock (`time.time_ns`), from the two
    clocks read together now (the closest of a few readings)."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        w = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, w - (p0 + p1) / 2)
    return best[1] - base_ns


_CSRC = Path(__file__).resolve().parent / "ops" / "csrc"


def _kernel_name(text: str, i: int) -> str | None:
    """The name of the `__global__ void` function whose declaration goes on
    at text[i:], past a `__launch_bounds__(...)` of any nesting."""
    if text.startswith("__launch_bounds__", i):
        depth, i = 0, text.index("(", i)
        while True:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
            if depth == 0:
                break
    m = re.match(r"\s*(\w+)", text[i:])
    return m and m.group(1)


@functools.cache
def kernel_names() -> frozenset:
    """The names of the `__global__` functions of the port's CUDA sources."""
    names = set()
    for src in sorted(_CSRC.glob("*.cu*")):
        text = src.read_text()
        names.update(_kernel_name(text, m.end())
                     for m in re.finditer(r"__global__\s+void\s+", text))
    names.discard(None)
    return frozenset(names)


def _base(kernel: str) -> str:
    """`void (anonymous namespace)::k<float, 4>(float const*, ...)` -> `k`."""
    s = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", s, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


def _anchor_calls(events: list, kernels) -> dict:
    """The runtime calls, as sorted (start, end) ns, that a span of each
    kind holds: under "launch" those that launched a kernel named in
    `kernels` (any kernel where None), under "h2d" those that started a
    copy from host memory."""
    started = {}
    for e in events:
        cat, name = _cat(e), str(e.get("name", ""))
        if cat == "kernel" and (kernels is None or _base(name) in kernels):
            started[_corr(e)] = "launch"
        elif cat == "gpu_memcpy" and "HtoD" in name:
            started[_corr(e)] = "h2d"
    started.pop(None, None)
    calls = {"launch": [], "h2d": []}
    for e in events:
        if _cat(e) in RUNTIME and _corr(e) in started:
            ts = float(e["ts"])
            calls[started[_corr(e)]].append((ts * 1e3, (ts + float(e.get("dur", 0))) * 1e3))
    return {k: sorted(v) for k, v in calls.items()}


def _anchor(span: Span) -> str | None:
    if span.name.startswith("launch."):
        return "launch"
    return "h2d" if span.name == "h2d" else None


def align(recorded: list[Span], events: list, guess_ns: float | None = None) -> Alignment:
    """The offset that puts the runtime call each `launch.*` span holds
    (the one that launched its kernel, one of `kernel_names()`) inside it,
    and each `h2d` span's (the one that started its copy). Each
    pairing of a span (s, e) with a call of its kind (r, r + d) within
    WINDOW_NS of `guess_ns` (default: the first launch call less the
    first launch span) allows the offsets [r + d - e, r - s]; the offset
    is the middle of the interval that the most spans allow, the nearest
    the guess of equals. `held` counts the launch spans alone."""
    calls = _anchor_calls(events, kernel_names())
    anchors = sorted((s.t0, s.t1, _anchor(s)) for s in recorded if _anchor(s))
    launches = [(s, e) for s, e, kind in anchors if kind == "launch"]
    if not launches or not calls["launch"]:
        return Alignment(0.0 if guess_ns is None else guess_ns, None, len(launches), None,
                         guess_ns)
    if guess_ns is None:
        guess_ns = calls["launch"][0][0] - launches[0][0]
    starts = {k: [c[0] for c in v] for k, v in calls.items()}
    marks = []
    for i, (s, e, kind) in enumerate(anchors):
        for j in range(bisect.bisect_left(starts[kind], s + guess_ns - WINDOW_NS),
                       bisect.bisect_right(starts[kind], e + guess_ns + WINDOW_NS)):
            lo, hi = calls[kind][j][1] - e, calls[kind][j][0] - s
            if lo <= hi:
                marks += [(lo, 0, i), (hi, 1, i)]
    marks.sort()  # at one offset, intervals open before others close
    active = collections.Counter()  # a span's intervals open at the sweep's offset
    spanned = best = 0              # the spans with one open, and the most so far
    region = lo = None
    for pos, closing, i in marks:
        if not closing:
            active[i] += 1
            if active[i] == 1:
                spanned += 1
                if spanned > best:
                    best, lo, region = spanned, pos, None
                elif spanned == best:
                    lo = pos
            continue
        active[i] -= 1
        if active[i] == 0:
            if spanned == best and lo is not None:
                if region is None or (abs((lo + pos) / 2 - guess_ns)
                                      < abs((region[0] + region[1]) / 2 - guess_ns)):
                    region = (lo, pos)
                lo = None
            spanned -= 1
    if region is None:
        return Alignment(guess_ns, None, len(launches), 0.0, guess_ns)
    offset = (region[0] + region[1]) / 2
    one, launch_calls, launch_starts = 0, calls["launch"], starts["launch"]
    for s, e in launches:
        a = bisect.bisect_left(launch_starts, s + offset)
        b = bisect.bisect_right(launch_starts, e + offset)
        one += b - a == 1 and launch_calls[a][1] <= e + offset
    return Alignment(offset, region[1] - region[0], len(launches), one / len(launches),
                     guess_ns)


def _innermost(recorded: list[Span]) -> list:
    """The spans' union as sorted disjoint (start, end, span) pieces, each
    the innermost span there (the spans of one thread nest)."""
    pieces, stack, t = [], [], None

    def cut(upto, span):
        if t is not None and upto > t:
            pieces.append((t, upto, span))

    for s in sorted(recorded, key=lambda s: (s.t0, -s.t1)):
        while stack and stack[-1].t1 <= s.t0:
            top = stack.pop()
            cut(top.t1, top)
            t = max(t, top.t1)
        if stack:
            cut(s.t0, stack[-1])
        stack.append(s)
        t = s.t0 if t is None else max(t, s.t0)
    while stack:
        top = stack.pop()
        cut(top.t1, top)
        t = max(t, top.t1)
    return pieces


def _busy(events: list) -> tuple[list, list]:
    """The device's busy intervals (ns, merged, sorted) and their running
    sums of length, for overlap queries."""
    ops = sorted((float(e["ts"]) * 1e3, (float(e["ts"]) + float(e["dur"])) * 1e3)
                 for e in events if _cat(e) in DEVICE and "dur" in e)
    merged = []
    for s, t in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    sums = [0.0]
    for s, t in merged:
        sums.append(sums[-1] + t - s)
    return merged, sums


def _busy_within(merged: list, sums: list, starts: list, a: float, b: float) -> float:
    """Busy time of the device within [a, b]."""
    i = bisect.bisect_right(starts, a)  # intervals from i on start after a
    j = bisect.bisect_left(starts, b)   # intervals before j start before b
    total = sums[j] - sums[i]
    if i > 0:
        total += max(0.0, min(merged[i - 1][1], b) - a)
    if j > i:
        total -= max(0.0, merged[j - 1][1] - b)
    return total


def attribute(recorded: list[Span], events: list, offset_ns: float) -> dict:
    """The spans against the device trace, `offset_ns` apart (`align`):
    by span name its `count`, host `self_s` (time it was the innermost
    span), `idle_s` (of that, the time the device was idle) and
    `device_s` (the device ops launched from inside it, through their
    runtime calls' correlation ids); and in all `device_s`,
    `device_in_span_s`, `idle_in_span_s`, `h2d_s`, `h2d_count` and
    `roots`, the spans' call count. Times in seconds."""
    by = {}

    def row(name):
        if name not in by:
            by[name] = {"count": 0, "self_s": 0.0, "idle_s": 0.0, "device_s": 0.0}
        return by[name]

    for s in recorded:
        row(s.name)["count"] += 1
    merged, sums = _busy(events)
    bstarts = [m[0] for m in merged]
    pieces = _innermost(recorded)
    idle_total = 0.0
    for a, b, s in pieces:
        idle = (b - a) - _busy_within(merged, sums, bstarts, a + offset_ns, b + offset_ns)
        r = row(s.name)
        r["self_s"] += (b - a) * 1e-9
        r["idle_s"] += idle * 1e-9
        idle_total += idle
    pstarts = [p[0] for p in pieces]
    calls = {_corr(e): float(e["ts"]) * 1e3 for e in events if _cat(e) in RUNTIME}
    device = in_span = 0.0
    for e in events:
        if _cat(e) not in DEVICE or "dur" not in e:
            continue
        dur = float(e["dur"]) * 1e3
        device += dur
        t = calls.get(_corr(e))
        if t is None:
            continue
        k = bisect.bisect_right(pstarts, t - offset_ns) - 1
        if k >= 0 and pieces[k][1] >= t - offset_ns:
            row(pieces[k][2].name)["device_s"] += dur * 1e-9
            in_span += dur
    h2d_spans = [s for s in recorded if s.name == "h2d"]
    return {"by_span": by, "device_s": device * 1e-9, "device_in_span_s": in_span * 1e-9,
            "idle_in_span_s": idle_total * 1e-9,
            "h2d_s": sum(s.t1 - s.t0 for s in h2d_spans) * 1e-9, "h2d_count": len(h2d_spans),
            "roots": sum(s.parent == 0 for s in recorded)}


def summary(recorded: list[Span], trace: dict) -> dict:
    """`attribute` at the offset `align` fits, for a `torch.profiler`
    export (its `traceEvents` and `baseTimeNanoseconds`), with the fit's
    `offset_ns`, `residual_ns`, `launch_spans`, `held` and `guess_ns`."""
    events = trace["traceEvents"]
    base = trace.get("baseTimeNanoseconds")
    fit = align(recorded, events, None if base is None else clock_guess(int(base)))
    return {**attribute(recorded, events, fit.offset_ns), "offset_ns": fit.offset_ns,
            "residual_ns": fit.residual_ns, "launch_spans": fit.launch_spans,
            "held": fit.held, "guess_ns": fit.guess_ns}


def merge_into(trace_path) -> Alignment:
    """Writes the recorded spans into a `torch.profiler` Chrome-trace
    export (`prof.export_chrome_trace(trace_path)`), aligned on its
    runtime calls, so they show beside the kernels; returns the fit."""
    path = Path(trace_path)
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds")
    recorded = spans()
    fit = align(recorded, trace["traceEvents"], None if base is None else clock_guess(int(base)))
    trace["traceEvents"] = trace["traceEvents"] + chrome_events(fit.offset_ns, recorded)
    path.write_text(json.dumps(trace))
    return fit
