"""The port's own spans of the traced slice against the slice's device trace:
what the `program_span` metrics read (`port_idle_pct.batch`,
`host_wait_pct.batch`, `h2d_per_call.batch`).

The spans come from `watfft_tpu_torch.trace` in this process; they record
only while a profiler session is active, so its buffer holds the traced
slice alone. The device events, and the runtime calls that carry each
kernel's correlation id, come from the trace the harness has just written
(`fftbench/out/<cell>.trace.json`); the port's `trace.summary` lays the
spans on that trace's clock and puts each idle gap and device op down to
its span. The slice's length is the harness's (`run.trace["window_s"]`),
whose own spans are not in the file; spans that ended that long before the
last one are an earlier session's and are left out. A port without the
tracer, or a run without a trace, gives None.
"""

from __future__ import annotations

import json

_last: dict = {}


def trace_path(run):
    return run.cell.root / "fftbench" / "out" / f"{run.cell.name}.trace.json"


def port(run) -> dict | None:
    """`watfft_tpu_torch.trace.summary` of this process's spans against the
    run's trace file (computed once a run), or None."""
    if not run.trace or run.trace.get("window_s", 0) <= 0:
        return None
    try:
        from watfft_tpu_torch import trace
    except ImportError:
        return None
    path = trace_path(run)
    if not path.is_file():
        return None
    key = (id(run), str(path), path.stat().st_mtime_ns)
    if key not in _last:
        recorded = trace.spans()
        if recorded:
            start = max(s.t1 for s in recorded) - run.trace["window_s"] * 1e9
            recorded = [s for s in recorded if s.t0 >= start]
        _last.clear()
        _last[key] = trace.summary(recorded, json.loads(path.read_text()))
    return _last[key]
