"""The rawspec_n1048576 configuration and its cell: the cell resolves with
its files; the plain reference (`reference/rawspec.py`) agrees with a numpy
float64 model; on the CPU at a small size a sound run is correct, and the
bfloat16 control is not, nor is any of three faults planted in the timed
path (no shift, one polarisation dropped, one spectrum skipped); the
least bytes; the reader of this cell (`large_pipe2_roofline`) on
synthetic spans whose answers are known, and None without a trace or
without the spectrometer's spans.

The cell's small request is `small()` here: a smaller nfft and nint, which
conftest's `SMALL` (a request alone) cannot set.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from fftbench import harness, spans
from fftbench.reference import rawspec as ref

ROOT = harness.ROOT
CELL = "rawspec_n1048576.batch"
SPEC = harness.load_spec()
PORT = "void (anonymous namespace)::strided_cols_kernel<0, 8>(float const*, long)"
TORCH = "void at::native::elementwise_kernel<128, 4>(int)"
US = 1000  # ns


def small(nfft=1024, nint=3, chans=2, spectra=6):
    """The cell at a size the CPU runs in a second: its files, a smaller
    nfft and nint, two integrations of two channels a request."""
    cell = harness.resolve(SPEC, CELL)
    cell.config = dict(cell.config, nfft=nfft, nint=nint)
    cell.traffic = dict(cell.traffic, request={"chans": chans, "nint": spectra}, pool_mib=1,
                        check=3)
    return cell


def test_the_cell_resolves():
    cell = harness.resolve(SPEC, CELL)
    assert (cell.config["nfft"], cell.config["nint"], cell.config["pols"]) == (1 << 20, 51, 2)
    assert cell.config["reduced"] == [] and set(cell.config["limits"]) == {"power_err"}
    assert cell.traffic["request"] == {"chans": 64, "nint": 51}
    assert cell.loop.__file__ == str(ROOT / "fftbench" / "loops" / "pipeline.py")
    assert {m["name"] for m in cell.end_to_end} == {"gpoints_per_s", "workspace_mib", "setup_s"}
    assert {"large_pipe2_roofline", "request_roofline", "torch_ops_pct.batch",
            "device_idle_pct.batch"} <= {m["name"] for m in cell.per_layer}
    wl = cell.adapter.Workload(cell.config, cell.traffic["request"], torch.device("cpu"))
    assert wl.input_bytes == 64 * 51 * 2**20 * 2 * 2  # 12.75 GiB
    assert wl.points == 51 * 128 * 2**20
    assert wl.least_bytes == wl.input_bytes + 4 * 64 * 2**20
    assert harness.pool_count(cell.traffic, wl.input_bytes) == 1


def test_a_request_of_part_of_an_integration_is_refused():
    cell = harness.resolve(SPEC, CELL)
    with pytest.raises(ValueError, match="whole integrations"):
        cell.adapter.Workload(cell.config, {"chans": 64, "nint": 50}, torch.device("cpu"))


@pytest.mark.parametrize("nfft,nint,pols", [(16, 3, 2), (1024, 2, 1), (64, 1, 3)])
def test_reference_matches_numpy(nfft, nint, pols):
    chans, nout = 2, 2
    rng = np.random.default_rng(nfft)
    v = rng.integers(-127, 128, (chans, nfft * nint * nout, pols, 2)).astype(np.int8)
    x = v.astype(np.float64)
    z = (x[..., 0] + 1j * x[..., 1]).reshape(chans, nout, nint, nfft, pols)
    want = np.fft.fftshift((np.abs(np.fft.fft(z, axis=3)) ** 2).sum(axis=(2, 4)), axes=-1)
    got = ref.integrate(torch.from_numpy(v), nfft, nint).numpy()
    assert np.abs(got - want).max() <= 1e-12 * want.max()


def test_power_err_reads_the_worst_row_and_nan():
    v = torch.from_numpy(np.random.default_rng(1).integers(-127, 128, (2, 64, 2, 2))
                         .astype(np.int8))
    want = ref.integrate(v, 16, 2)  # [2, 2, 16]
    got = want.clone()
    got[1, 0, 3] += 0.25 * want[1, 0].max()
    assert ref.power_err(got, v, 16, 2) == pytest.approx(0.25)
    got[0, 1, 0] = float("nan")
    assert np.isnan(ref.power_err(got, v, 16, 2))


def test_sound_run_is_correct():
    r = harness.run(small(), 2**31 + 11, 0.2, False, "cpu")
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 3 and r["checks"]["power_err"]["value"] <= 1e-6


def test_control_is_not_correct():
    r = harness.run(small(), 2**31 + 12, 0.2, False, "cpu",
                    calls_of=lambda wl: wl.control_calls())
    assert not r["correct"] and r["checks"]["power_err"]["value"] >= 1e-4, r["checks"]


def _faulty(wl, fault):
    sp, nfft, nint = wl.spectrometer, wl.nfft, wl.nint

    def call(v):
        if fault == "no_shift":
            return torch.roll(sp.integrate(v, nfft, nint, device=wl.device), nfft // 2, -1)
        if fault == "one_pol":
            return sp.integrate(v[:, :, :1].contiguous(), nfft, nint, device=wl.device)
        v = v.clone()  # "skip": the second spectrum of every stream left out
        v[:, nfft:2 * nfft] = 0
        return sp.integrate(v, nfft, nint, device=wl.device)
    return [("integrate", call)]


@pytest.mark.parametrize("fault", ["no_shift", "one_pol", "skip"])
def test_fault_in_the_timed_path_is_not_correct(fault):
    r = harness.run(small(), 2**31 + 13, 0.2, False, "cpu",
                    calls_of=lambda wl: _faulty(wl, fault))
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_one_spectrum_skipped_of_the_cell_s_51_is_not_correct():
    """At the cell's nint one spectrum is 2% of the power: far past the
    limit (a small nfft keeps it a CPU test)."""
    r = harness.run(small(nfft=256, nint=51, chans=1, spectra=51), 2**31 + 14, 0.05, False,
                    "cpu", calls_of=lambda wl: _faulty(wl, "skip"))
    assert not r["correct"] and r["checks"]["power_err"]["value"] >= 1e-3, r["checks"]


def test_least_bytes_are_the_request_input_and_output():
    cell = small()
    wl = cell.adapter.Workload(cell.config, cell.traffic["request"], torch.device("cpu"))
    x = wl.make_pool(1, 1)[0]
    outs = harness.issue(wl.calls(), x)
    assert wl.least_bytes == x.nbytes + sum(t.nbytes for t in harness.flatten(outs))
    assert wl.input_bytes == x.nbytes and x.dtype == torch.int8
    assert int(x.min()) >= -127 and int(x.max()) <= 127
    assert cell.adapter.pipe2_least_bytes(10) == 320


def test_pool_is_drawn_from_the_seed():
    cell = small()
    wl = cell.adapter.Workload(cell.config, cell.traffic["request"], torch.device("cpu"))
    a, b = wl.make_pool(2**40 + 3, 2), wl.make_pool(2**40 + 3, 2)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    assert not torch.equal(a, wl.make_pool(2**40 + 4, 2))


# -- the readers, on synthetic spans -------------------------------------------------------

def reader():
    return harness.load_module(ROOT / "fftbench" / "metrics" / "large_pipe2_roofline.py",
                               "m_large_pipe2_roofline")


def _span(i, name, t0, t1, parent, call):
    from watfft_tpu_torch import trace
    return trace.Span(i, name, int(t0 * US), int(t1 * US), parent, call, 1)


def _ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "args": {"correlation": corr}}


def requests(count=4, period=1000):
    """`count` calls of the spectrometer, one every `period` us: the root
    [0, 900]; `spec.unpack` [10, 30] launches a torch kernel of 50 us;
    `api.forward` [30, 70] holds `launch.large_stage1` [35, 45] and
    `launch.large_stage2` [50, 60], whose kernels take 200 us each;
    `spec.detect` [70, 100] and `spec.shift` [100, 110] launch torch
    kernels of 100 and 10 us. The device runs them back to back from 40."""
    recorded, events = [], []
    steps = [("spec.unpack", 10, 30, TORCH, 50), ("launch.large_stage1", 35, 45, PORT, 200),
             ("launch.large_stage2", 50, 60, PORT, 200), ("spec.detect", 70, 100, TORCH, 100),
             ("spec.shift", 100, 110, TORCH, 10)]
    for k in range(count):
        t, sid = k * period, 10 * k
        recorded.append(_span(sid + 1, "spectrometer.integrate", t, t + 900, 0, k + 1))
        recorded.append(_span(sid + 2, "api.forward", t + 30, t + 70, sid + 1, k + 1))
        dev = t + 40
        for i, (name, a, b, kernel, dur) in enumerate(steps):
            parent = sid + 2 if name.startswith("launch.") else sid + 1
            corr = sid + 3 + i
            recorded.append(_span(corr, name, t + a, t + b, parent, k + 1))
            events += [_ev("cuda_runtime", "cudaLaunchKernel", t + (a + b) / 2 - 1, 2, corr),
                       _ev("kernel", kernel, dev, dur, corr)]
            dev += dur
    return recorded, events


@pytest.fixture
def run_with(tmp_path, monkeypatch):
    """A traced run of the cell under tmp_path whose trace file holds
    `events` and whose tracer holds `recorded`."""
    from watfft_tpu_torch import trace

    def make(recorded, events, traced=True):
        spans._last.clear()
        monkeypatch.setattr(trace, "spans", lambda: recorded)
        monkeypatch.setattr(trace, "clock_guess", lambda base: 0.0)
        cell = harness.resolve(SPEC, CELL)
        cell.root = tmp_path
        out = tmp_path / "fftbench" / "out"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{CELL}.trace.json").write_text(json.dumps(
            {"traceEvents": events, "baseTimeNanoseconds": 1}))
        return harness.Run(cell=cell, device_kind="NVIDIA H100 80GB HBM3",
                           points_per_request=10**6, peaks={"hbm_bytes_per_s": 1e12},
                           trace={"window_s": 4000e-6, "requests": 4} if traced else None)
    return make


def test_reader_on_synthetic_spans(run_with):
    run = run_with(*requests())
    # 4 calls x 10^6 points x 32 B at 10^12 B/s = 128 us against 4 x 400 us
    assert reader().read(run) == pytest.approx(100 * 128 / 1600)
    s = spans.port(run)
    assert s["held"] == 1.0 and s["roots"] == 4


def test_reader_without_a_trace_reads_nothing(run_with):
    run = run_with(*requests(), traced=False)
    assert reader().read(run) is None


def test_reader_without_the_spectrometer_s_spans_reads_nothing(run_with):
    """A run whose port recorded no spectrometer call: another cell's, or a
    port without the spectrometer."""
    recorded, events = requests()
    other = [s._replace(name="api.forward") if s.name == "spectrometer.integrate" else s
             for s in recorded if not s.name.startswith("spec.")]
    run = run_with(other, events)
    assert reader().read(run) is None
    assert reader().read(run_with([], events)) is None
