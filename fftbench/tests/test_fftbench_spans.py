"""The readers of the port's spans (`port_idle_pct.batch`,
`host_wait_pct.batch`, `h2d_per_call.batch`, through `fftbench/spans.py`)
on synthetic spans and a synthetic trace file whose answers are known: a
cell with no copy reads 0.0, a run with no trace reads None, and so does a
port without the tracer."""

from __future__ import annotations

import json
import sys

import pytest
import watfft_tpu_torch

from fftbench import harness, spans

ROOT = harness.ROOT
READERS = ("port_idle_pct.batch", "host_wait_pct.batch", "h2d_per_call.batch")
PORT = "void (anonymous namespace)::rfft_r2c_resident_kernel<16, float>(float const*, long)"
MUL = "void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor<float> >(int)"
US = 1000  # ns


def reader(name):
    return harness.load_module(ROOT / "fftbench" / "metrics" / f"{name}.py", "m_" + name)


def span(i, name, t0, t1, parent=0, call=1):
    from watfft_tpu_torch import trace
    return trace.Span(i, name, int(t0 * US), int(t1 * US), parent, call, 1)


def ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "args": {"correlation": corr}}


def requests(copies: bool, count=20, period=100):
    """`count` requests of one root each, every `period` us: [0, 80] of it
    the root; with `copies` an `h2d` span at [5, 35] (the device busy from
    its end); a launch span at [40, 50] holding its runtime call at [44,
    46] (so the fitted offset is 0), whose kernel runs [60, 95]; a torch
    multiply launched at 70 runs [95, 100]. The device is idle in the root
    from 0 to 60, with copies but at [35, 36], the copy."""
    recorded, events = [], []
    for k in range(count):
        t = k * period
        sid = 10 * k
        recorded.append(span(sid + 1, "stft.stft", t, t + 80, 0, k + 1))
        if copies:
            recorded.append(span(sid + 2, "h2d", t + 5, t + 35, sid + 1, k + 1))
            events += [ev("cuda_runtime", "cudaMemcpyAsync", t + 6, 28, sid + 2),
                       ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t + 35, 1, sid + 2)]
        recorded.append(span(sid + 3, "launch.rfft_r2c_fused", t + 40, t + 50, sid + 1, k + 1))
        events += [ev("cuda_runtime", "cudaLaunchKernel", t + 44, 2, sid + 3),
                   ev("kernel", PORT, t + 60, 35, sid + 3),
                   ev("cuda_runtime", "cudaLaunchKernel", t + 70, 2, sid + 4),
                   ev("kernel", MUL, t + 95, 5, sid + 4)]
    return recorded, events


@pytest.fixture
def run_with(tmp_path, monkeypatch):
    """A run of cell `x` under tmp_path whose trace file holds `events` and
    whose tracer holds `recorded`."""
    from watfft_tpu_torch import trace

    def make(recorded, events, window_s=2000e-6, traced=True):
        spans._last.clear()
        monkeypatch.setattr(trace, "spans", lambda: recorded)
        monkeypatch.setattr(trace, "clock_guess", lambda base: 0.0)
        out = tmp_path / "fftbench" / "out"
        out.mkdir(parents=True, exist_ok=True)
        (out / "x.trace.json").write_text(json.dumps(
            {"traceEvents": events, "baseTimeNanoseconds": 1}))
        cell = harness.Cell(name="x", chips=1, config={}, adapter=None, traffic={}, loop=None,
                            end_to_end=[], per_layer=[], root=tmp_path)
        return harness.Run(cell=cell, device_kind="NVIDIA H100 80GB HBM3",
                           trace={"window_s": window_s, "requests": 20} if traced else None)
    return make


def test_readers_where_the_port_copies(run_with):
    run = run_with(*requests(copies=True))
    # idle in the roots: 59 us a request (5 + 30 in h2d + 4 + 10 in the
    # launch + 10), 20 requests in 2000 us
    assert reader("port_idle_pct.batch").read(run) == pytest.approx(100 * 20 * 59 / 2000)
    assert reader("host_wait_pct.batch").read(run) == pytest.approx(100 * 20 * 30 / 2000)
    assert reader("h2d_per_call.batch").read(run) == 1.0
    s = spans.port(run)
    assert s["held"] == 1.0 and abs(s["offset_ns"]) < 1e3
    assert s["by_span"]["h2d"]["device_s"] == pytest.approx(20 * 1e-6)


def test_readers_where_the_port_makes_no_copy(run_with):
    run = run_with(*requests(copies=False))
    assert reader("h2d_per_call.batch").read(run) == 0.0
    assert reader("host_wait_pct.batch").read(run) == 0.0
    assert reader("port_idle_pct.batch").read(run) == pytest.approx(100 * 20 * 60 / 2000)


def test_readers_without_a_trace_read_nothing(run_with):
    run = run_with(*requests(copies=True), traced=False)
    assert [reader(name).read(run) for name in READERS] == [None, None, None]


def test_readers_without_spans_read_nothing(run_with):
    """A traced run in which the port recorded nothing: a port that lacks
    these spans, as an older one does."""
    run = run_with([], requests(copies=True)[1])
    assert [reader(name).read(run) for name in READERS] == [None, None, None]


def test_readers_without_the_tracer_read_nothing(run_with, monkeypatch):
    run = run_with(*requests(copies=True))
    spans._last.clear()
    monkeypatch.delattr(watfft_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "watfft_tpu_torch.trace", None)  # import fails
    assert [reader(name).read(run) for name in READERS] == [None, None, None]


def test_trace_path_is_the_harness_s(small_cell):
    cell = small_cell("stft_n1024.batch")
    run = harness.Run(cell=cell, device_kind="cpu")
    assert spans.trace_path(run) == ROOT / "fftbench" / "out" / "stft_n1024.batch.trace.json"


def test_spans_of_an_earlier_session_are_left_out(run_with):
    recorded, events = requests(copies=True)
    earlier = [s._replace(id=s.id + 1000, t0=s.t0 - 10**10, t1=s.t1 - 10**10)
               for s in recorded if s.name != "h2d"]
    run = run_with(earlier + recorded, events)
    assert spans.port(run)["roots"] == 20
    assert reader("h2d_per_call.batch").read(run) == 1.0
