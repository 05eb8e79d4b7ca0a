"""The port's spans and counters (`watfft_tpu_torch.trace`).

Without a profiler session a public call records no span and opens none;
under `torch.profiler` (CPU activity here) the calls of the c2c context and
of the STFT record their span trees, the launches included through a
stand-in for the kernels' library. The counters: tables built once a size,
copies and bytes at the copy helper. The alignment with a device trace on
synthetic events: the offset given back, an idle gap put down to its
innermost span, a device op to the span whose runtime call launched it.
No JAX is needed.
"""

import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from watfft_tpu_torch import api, planner, registry, stft, trace
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import rfft as rf
from watfft_tpu_torch.ops import stockham as st

N_FFT, HOP, T = 64, 16, 400


def _f32(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, shape)
                            .astype(np.float32))


@pytest.fixture
def traced():
    """Records the spans of the block it guards, from an empty buffer."""
    trace.clear()

    @contextlib.contextmanager
    def session():
        with profile(activities=[ProfilerActivity.CPU]):
            yield
    yield session
    trace.clear()


@pytest.fixture
def stand_in(monkeypatch):
    """The wrappers launch on CPU tensors into a library that does nothing
    and returns 0 (the outputs stay as allocated)."""
    lib = types.SimpleNamespace(watfft_stockham_c2c=lambda *a: 0,
                                watfft_rfft_r2c=lambda *a: 0, watfft_irfft_c2r=lambda *a: 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(st, "_use_kernel", lambda t, plain=False: not plain)
    monkeypatch.setattr(rf, "_use_kernel", lambda t: True)


def _tree(recorded):
    """{span name: [names of the spans it holds]} and the roots' names."""
    by_id = {s.id: s for s in recorded}
    kids = {}
    for s in recorded:
        if s.parent:
            kids.setdefault(by_id[s.parent].name, []).append(s.name)
    return kids, [s.name for s in recorded if s.parent == 0]


# -- off: nothing recorded, nothing opened ---------------------------------------------

def test_no_profiler_records_no_span_and_opens_none(monkeypatch):
    trace.clear()
    assert not torch.autograd.profiler._is_profiler_enabled

    def refuse(*a, **k):
        raise AssertionError("a span was opened with no profiler session")
    monkeypatch.setattr(trace, "begin", refuse)
    monkeypatch.setattr(trace, "call", refuse)
    monkeypatch.setattr(trace, "Span", refuse)
    x = torch.complex(_f32((3, 64)), _f32((3, 64), 1))
    ctx = api.create_fft_f32(64, device="cpu")
    ctx.inverse(ctx.forward(x))
    ctx.inverse_planes(*ctx.forward_planes(x.real, x.imag))
    api.fft(x, device="cpu")
    api.fft2(x.reshape(3, 8, 8), device="cpu")
    re, im = stft.stft(_f32((2, T)), N_FFT, HOP, device="cpu")
    stft.istft(re, im, N_FFT, HOP, length=T, device="cpu")
    assert len(trace._buffer) == 0


# -- on: the span trees ----------------------------------------------------------------

def test_span_tree_of_one_forward(traced, stand_in):
    ctx = api.create_fft_f32(1024, device="cpu")
    x = torch.complex(_f32((4, 1024)), _f32((4, 1024), 1))
    before = trace.routes.get("stockham", 0)
    with traced():
        ctx.forward(x)
    recorded = trace.spans()
    kids, roots = _tree(recorded)
    assert roots == ["api.forward"]
    assert kids == {"api.forward": ["launch.stockham_c2c"]}
    assert len({s.call for s in recorded}) == 1
    assert trace.routes["stockham"] == before + 1  # the route is a counter, not a span
    for s in recorded:
        assert s.t0 <= s.t1 and s.tid > 0
    root, = [s for s in recorded if s.parent == 0]
    assert all(root.t0 <= s.t0 and s.t1 <= root.t1 for s in recorded)


def test_span_tree_of_stft_and_istft(traced, stand_in):
    x = _f32((2, T))
    with traced():
        re, im = stft.stft(x, N_FFT, HOP, device="cpu")
        stft.istft(re, im, N_FFT, HOP, length=T, device="cpu")
    recorded = trace.spans()
    kids, roots = _tree(recorded)
    assert roots == ["stft.stft", "stft.istft"]
    assert kids["stft.stft"] == ["stft.window", "stft.frame", "api.forward_planes"]
    assert kids["api.forward_planes"] == ["launch.rfft_r2c_fused"]
    assert kids["stft.istft"] == ["istft.window", "api.inverse_planes", "istft.frame_window",
                                  "istft.overlap_add", "istft.norm", "istft.divide"]
    assert kids["api.inverse_planes"] == ["launch.irfft_c2r_fused"]
    by_id = {s.id: s for s in recorded}
    for s in recorded:  # each span carries the call id of its root
        root = s
        while root.parent:
            root = by_id[root.parent]
        assert s.call == root.call
    assert len({s.call for s in recorded}) == 2


def test_a_raising_call_leaves_no_span_open(traced, stand_in):
    ctx = api.create_fft_f32(64, device="cpu")
    with traced():
        with pytest.raises(ValueError):
            ctx.forward(torch.zeros(3, 32, dtype=torch.complex64))
        ctx.forward(torch.zeros(3, 64, dtype=torch.complex64))
    recorded = trace.spans()
    roots = [s for s in recorded if s.parent == 0]
    assert [r.name for r in roots] == ["api.forward", "api.forward"]
    assert roots[0].call != roots[1].call
    # the raising call raised in its input check, before its launch span
    assert [s.name for s in recorded if s.parent == roots[0].id] == []
    assert [s.name for s in recorded if s.parent == roots[1].id] == ["launch.stockham_c2c"]


def test_chrome_events_are_named_watfft(traced):
    with traced():
        api.fft(torch.zeros(2, 16, dtype=torch.complex64), device="cpu")
    events = trace.chrome_events(1000.0)
    assert events and all(e["name"].startswith("watfft.") and e["cat"] == "watfft"
                          and e["pid"] == os.getpid() and e["ph"] == "X" for e in events)
    first = min(trace.spans(), key=lambda s: s.t0)
    assert min(e["ts"] for e in events) == pytest.approx((first.t0 + 1000.0) / 1e3)
    assert {e["name"] for e in events} >= {"watfft.api.fft", "watfft.api.forward"}


def test_buffer_keeps_the_newest_spans(monkeypatch, traced):
    assert trace._buffer.maxlen == trace.CAPACITY == 1 << 20
    monkeypatch.setattr(trace, "_buffer", type(trace._buffer)(maxlen=3))
    with traced():
        for _ in range(2):
            api.fft(torch.zeros(2, 16, dtype=torch.complex64), device="cpu")
    # the last three to close, numbered by start: the first call's root
    # and the second call's two
    assert [(s.name, s.parent) for s in trace.spans()] == [
        ("api.fft", 0), ("api.fft", 0), ("api.forward", 2)]


# -- counters --------------------------------------------------------------------------

def test_tables_built_once_a_size(monkeypatch):
    st._cached_tables.cache_clear()
    monkeypatch.setattr(api, "_ctx_cache", {})
    x = torch.complex(_f32((2, 512)), _f32((2, 512), 1))

    def built(fn):
        before = trace.counts["tables_built"]
        fn()
        return trace.counts["tables_built"] - before
    assert built(lambda: api.fft(x, device="cpu")) == 2       # the context and the tables
    assert built(lambda: api.fft(x, device="cpu")) == 0
    assert built(lambda: api.ifft(x, device="cpu")) == 1      # the inverse tables
    assert built(lambda: api.ifft(x, device="cpu")) == 0
    assert built(lambda: stft._window("hann", N_FFT, "cpu")) == 1  # each window built


def test_h2d_counts_copies_and_bytes_at_the_helper(traced):
    before = dict(trace.counts)
    a = np.ones(8, np.float32)
    assert trace.h2d(a, "cpu").data_ptr() == torch.as_tensor(a).data_ptr()  # no copy
    assert trace.counts == before
    with traced():
        out = trace.h2d(a, "meta", torch.float64)
    assert out.device.type == "meta" and out.dtype == torch.float64
    assert trace.counts["h2d_copies"] == before["h2d_copies"] + 1
    assert trace.counts["h2d_bytes"] == before["h2d_bytes"] + 64
    assert [s.name for s in trace.spans()] == ["h2d"]
    w = stft._window("hann", N_FFT, torch.device("meta"))
    assert w.shape == (N_FFT,)
    assert trace.counts["h2d_copies"] == before["h2d_copies"] + 2
    assert trace.counts["h2d_bytes"] == before["h2d_bytes"] + 64 + 4 * N_FFT


def test_to_counts_only_a_move_from_the_host(traced):
    before = dict(trace.counts)
    a = torch.ones(4, dtype=torch.float32)
    assert trace.to(a, torch.device("cpu")) is a                  # no move
    assert trace.to(a, "cpu", torch.float64).dtype == torch.float64  # a cast on the host
    on_meta = torch.empty(4, device="meta")
    assert trace.to(on_meta, "meta", torch.float64).device.type == "meta"  # not from the host
    assert trace.counts == before
    with traced():
        out = trace.to(a, "meta", torch.float64)
    assert out.device.type == "meta" and out.dtype == torch.float64
    assert trace.counts["h2d_copies"] == before["h2d_copies"] + 1
    assert trace.counts["h2d_bytes"] == before["h2d_bytes"] + 32
    assert [s.name for s in trace.spans()] == ["h2d"]


def test_counters_gather_routes_and_launches():
    api.create_fft_f32(128, device="cpu").forward(torch.zeros(2, 128, dtype=torch.complex64))
    got = trace.counters()
    assert got["route.stockham"] >= 1
    # every route the planner gives FFTContext has its counter in place
    taken = {planner.c2c_kernel(n, dtype, batch, time_major)
             for n in (1024, 8192, planner.CUBE_MAX_N * 2, planner.LARGE_MAX_N * 2)
             for dtype in ("float32", "float64") for batch in (1, 1 << 20)
             for time_major in (False, True)}
    assert taken == set(trace.routes)
    assert {"h2d_copies", "h2d_bytes", "tables_built"} <= set(got)
    launches = {k[len("launch."):]: v for k, v in got.items() if k.startswith("launch.")}
    assert launches == registry.launch_counts()


# -- the device trace's clock, on synthetic events ---------------------------------------

PORT = "void (anonymous namespace)::stockham_c2c_resident_kernel<float>(float const*, long)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor<float> >(int)"


def _span(i, name, t0, t1, parent=0, call=1):
    return trace.Span(i, name, int(t0), int(t1), parent, call, 1)


def _ev(cat, name, ts_ns, dur_ns, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_ns / 1e3, "dur": dur_ns / 1e3,
            "args": {"correlation": corr}}


def _synthetic(offset, count=300, seed=3):
    """Requests of one root each: a launch span holding its runtime call
    (a port kernel), and a torch launch a few microseconds after it."""
    rng = np.random.default_rng(seed)
    spans, events, t = [], [], 1_000_000
    for k in range(count):
        s0 = t + int(rng.integers(1000, 4000))
        s1 = s0 + int(rng.integers(4000, 8000))
        call = s0 + int(rng.integers(200, s1 - s0 - 1700))
        spans += [_span(2 * k + 1, "api.forward", t, s1 + 2000, 0, k + 1),
                  _span(2 * k + 2, "launch.stockham_c2c", s0, s1, 2 * k + 1, k + 1)]
        events += [_ev("cuda_runtime", "cudaLaunchKernel", call + offset, 1500, 2 * k + 1),
                   _ev("kernel", PORT, call + offset + 30_000, 20_000, 2 * k + 1),
                   _ev("cuda_runtime", "cudaLaunchKernel", s1 + 3000 + offset, 1000, 2 * k + 2),
                   _ev("kernel", TORCH, call + offset + 50_000, 5_000, 2 * k + 2)]
        t = s1 + int(rng.integers(3000, 40_000))
    return spans, events


@pytest.mark.parametrize("guess", [None, 0.0, 300_000.0, -500_000.0])
def test_align_gives_back_the_offset(guess):
    offset = 123_456_789_000.0
    spans, events = _synthetic(offset)
    fit = trace.align(spans, events, None if guess is None else offset + guess)
    assert isinstance(fit, trace.Alignment)
    assert abs(fit.offset_ns - offset) < 1000.0
    assert fit.residual_ns < 2000.0 and fit.launch_spans == 300 and fit.held == 1.0


def test_kernel_names_are_read_from_the_sources():
    names = trace.kernel_names()
    assert {"stockham_c2c_resident_kernel", "rfft_r2c_resident_kernel",
            "irfft_c2r_resident_kernel", "cube_kernel", "strided_cols_kernel",
            "dft_mma_kernel", "bluestein_onepass_kernel"} <= names
    assert "__launch_bounds__" not in names and "void" not in names


def test_kernel_names_match_the_benchmark_s():
    """The benchmark's harness reads the port's kernel names on its own
    (`fftbench.traces.port_kernels`); both must name the same kernels."""
    from fftbench import traces

    assert trace.kernel_names() == frozenset(traces.port_kernels())


def test_align_reads_only_the_port_s_launches(monkeypatch):
    """A torch launch just past each span at a steady distance would hold
    every span at a wrong offset; only the port's kernels' calls count."""
    offset = 5_000_000.0
    spans, events = _synthetic(offset)
    fit = trace.align(spans, events, offset + 5_500.0)
    assert abs(fit.offset_ns - offset) < 1000.0
    monkeypatch.setattr(trace, "kernel_names", lambda: None)  # any kernel's call
    fit = trace.align(spans, events, offset + 5_500.0)
    assert abs(fit.offset_ns - offset) > 1000.0


def test_align_without_runtime_calls_keeps_the_guess():
    spans, events = _synthetic(0.0, count=5)
    device_only = [e for e in events if e["cat"] == "kernel"]
    fit = trace.align(spans, device_only, 42.0)
    assert (fit.offset_ns, fit.residual_ns, fit.held) == (42.0, None, None)


def test_gaps_go_to_the_innermost_span():
    # root 0-100 us, child 20-60, grandchild 30-40; the device idle at 32-38
    # (grandchild), 50-55 (child) and 80-90 (root), busy otherwise
    us = 1000
    spans = [_span(1, "stft.istft", 0, 100 * us), _span(2, "api.inverse_planes", 20 * us,
                                                        60 * us, 1),
             _span(3, "launch.irfft_c2r_fused", 30 * us, 40 * us, 2)]
    busy = [(0, 32), (38, 50), (55, 80), (90, 100)]
    offset = 5_000_000.0
    events = [_ev("kernel", PORT, a * us + offset, (b - a) * us, 100 + i)
              for i, (a, b) in enumerate(busy)]
    got = trace.attribute(spans, events, offset)
    idle = {k: v["idle_s"] for k, v in got["by_span"].items()}
    assert idle == pytest.approx({"launch.irfft_c2r_fused": 6e-6, "api.inverse_planes": 5e-6,
                                  "stft.istft": 10e-6})
    self_s = {k: v["self_s"] for k, v in got["by_span"].items()}
    assert self_s == pytest.approx({"launch.irfft_c2r_fused": 10e-6,
                                    "api.inverse_planes": 30e-6, "stft.istft": 60e-6})
    assert got["idle_in_span_s"] == pytest.approx(21e-6) and got["roots"] == 1


def test_device_op_goes_to_the_span_of_its_runtime_call():
    us, offset = 1000, -7_000.0
    spans = [_span(1, "stft.stft", 0, 50 * us), _span(2, "stft.frame", 10 * us, 20 * us, 1),
             _span(3, "h2d", 30 * us, 45 * us, 1)]
    events = [_ev("cuda_runtime", "cudaLaunchKernel", 12 * us + offset, us, 7),
              _ev("kernel", TORCH, 400 * us + offset, 9 * us, 7),          # long after
              _ev("cuda_runtime", "cudaMemcpyAsync", 31 * us + offset, 13 * us, 8),
              _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 43 * us + offset, 2 * us, 8),
              _ev("kernel", TORCH, 500 * us + offset, 4 * us, 9)]         # launched elsewhere
    got = trace.attribute(spans, events, offset)
    assert got["by_span"]["stft.frame"]["device_s"] == pytest.approx(9e-6)
    assert got["by_span"]["h2d"]["device_s"] == pytest.approx(2e-6)
    assert got["by_span"]["stft.stft"]["device_s"] == 0.0
    assert got["device_s"] == pytest.approx(15e-6)
    assert got["device_in_span_s"] == pytest.approx(11e-6)
    assert (got["h2d_count"], got["h2d_s"]) == (1, pytest.approx(15e-6))


def test_summary_and_merge_into(tmp_path, monkeypatch):
    offset = 2_000_000_000.0
    spans, events = _synthetic(offset, count=40)
    base = 1_700_000_000_000_000_000
    doc = {"traceEvents": events, "baseTimeNanoseconds": base}
    # the clocks' guess 20 us off the true offset
    monkeypatch.setattr(trace, "clock_guess", lambda b: offset + 20_000.0 if b == base else 0)
    got = trace.summary(spans, doc)
    assert abs(got["offset_ns"] - offset) < 1000.0 and got["held"] == 1.0
    assert got["roots"] == 40 and got["by_span"]["launch.stockham_c2c"]["count"] == 40
    assert got["by_span"]["launch.stockham_c2c"]["device_s"] == pytest.approx(40 * 20e-6)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setattr(trace, "spans", lambda: spans)
    fit = trace.merge_into(path)
    merged = json.loads(path.read_text())["traceEvents"]
    added = [e for e in merged if e.get("cat") == "watfft"]
    assert len(merged) == len(events) + len(spans) and len(added) == len(spans)
    assert not any(e["name"].startswith("fftbench.") for e in added)
    launch = min((e for e in added if e["name"] == "watfft.launch.stockham_c2c"),
                 key=lambda e: e["ts"])
    runtime = min((e for e in events if e["cat"] == "cuda_runtime"), key=lambda e: e["ts"])
    assert launch["ts"] <= runtime["ts"] <= runtime["ts"] + runtime["dur"] <= (
        launch["ts"] + launch["dur"])
    assert fit.held == 1.0
