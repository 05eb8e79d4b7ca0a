"""The ptycho_dm_n128 configuration and its cell: the cell resolves with its
files; the plain reference (`reference/ptycho.py`) agrees with a numpy
float64 loop; on the CPU at a small size a sound run is correct, and the
bfloat16 control is not, nor is any of three faults planted in the timed
path (a frame left out, the object or the probe not updated); the least
bytes, the model probe and the raster; the readers of this cell
(`fft2_cube_roofline`, `ptycho_<pass>_roofline`) on synthetic spans whose
answers are known, and None without a trace or without the iteration's
spans.

The cell's small request is `small()` here: smaller frames, scan and
object, which conftest's `SMALL` (a request alone) cannot set.
"""

from __future__ import annotations

import json
import math
import types

import numpy as np
import pytest
import torch

from fftbench import harness, spans
from fftbench.reference import ptycho as ref

ROOT = harness.ROOT
CELL = "ptycho_dm_n128.batch"
SPEC = harness.load_spec()
US = 1000  # ns
READERS = ["fft2_cube_roofline", "ptycho_exit_roofline", "ptycho_fourier_roofline",
           "ptycho_update_roofline", "ptycho_probe_roofline"]


def small(m=16, scan=6, step=4):
    """The cell at a size the CPU runs in a second: its files, smaller
    frames, scan and object."""
    cell = harness.resolve(SPEC, CELL)
    cell.config = dict(cell.config, m=m, scan=scan, step=step,
                       object_side=(scan - 1) * step + m, probe_diameter=m // 2)
    cell.traffic = dict(cell.traffic, request={"frames": scan * scan}, pool_mib=1, check=3)
    return cell


def workload(cell):
    return cell.adapter.Workload(cell.config, cell.traffic["request"], torch.device("cpu"))


def test_the_cell_resolves():
    cell = harness.resolve(SPEC, CELL)
    c = cell.config
    assert (c["m"], c["scan"], c["step"], c["object_side"]) == (128, 128, 16, 2160)
    assert c["reduced"] == [] and cell.chips == 1
    assert set(c["limits"]) == {"exit_err", "object_err", "probe_err", "fourier_err"}
    assert set(c["limit_readings"]) == set(c["limits"])
    assert cell.traffic["request"] == {"frames": 16384}
    assert cell.loop.__file__ == str(ROOT / "fftbench" / "loops" / "pipeline.py")
    assert {m["name"] for m in cell.end_to_end} == {"gpoints_per_s", "workspace_mib", "setup_s"}
    assert {*READERS, "request_roofline", "torch_ops_pct.batch", "device_idle_pct.batch",
            "port_idle_pct.batch", "host_wait_pct.batch",
            "h2d_per_call.batch"} == {m["name"] for m in cell.per_layer}
    wl = cell.adapter.Workload(c, cell.traffic["request"], torch.device("meta"))
    assert wl.input_bytes == 16384 * 128 ** 2 * 8  # 2 GiB
    assert wl.points == 2 ** 29
    assert wl.least_bytes == 28 * 2 ** 28 + 16 * 2160 ** 2 + 16 * 128 ** 2
    assert harness.pool_count(cell.traffic, wl.input_bytes) == 1


def test_a_scan_that_disagrees_with_its_object_is_refused():
    cell = small()
    with pytest.raises(ValueError, match="disagree"):
        cell.adapter.Workload(dict(cell.config, object_side=99), cell.traffic["request"],
                              torch.device("cpu"))


def _numpy_iteration(e, o, p, a, pos):
    m = p.shape[0]
    new, err = np.empty_like(e), np.empty(len(e))
    num, den = np.zeros_like(o), np.zeros(o.shape)
    for j, (r, c) in enumerate(pos):
        phi = p * o[r:r + m, c:c + m]
        f = np.fft.fft2(2 * phi - e[j])
        mag = np.abs(f)
        err[j] = np.mean((mag - a[j]) ** 2)
        proj = np.where(mag > 0, a[j] * f / np.where(mag > 0, mag, 1), a[j])
        new[j] = e[j] + np.fft.ifft2(proj) - phi
        num[r:r + m, c:c + m] += np.conj(p) * new[j]
        den[r:r + m, c:c + m] += np.abs(p) ** 2
    lo, hi = pos.min(0), pos.max(0) + m
    c_obj = 1e-4 * den[lo[0]:hi[0], lo[1]:hi[1]].mean()
    o2 = (c_obj * o + num) / (c_obj + den)
    pnum, pden = np.zeros_like(p), np.zeros(p.shape)
    for j, (r, c) in enumerate(pos):
        pnum += np.conj(o2[r:r + m, c:c + m]) * new[j]
        pden += np.abs(o2[r:r + m, c:c + m]) ** 2
    c_probe = 1e-9 * pden.mean()
    return new, o2, (c_probe * p + pnum) / (c_probe + pden), err


@pytest.mark.parametrize("block", [1, 3, 256])
def test_reference_matches_numpy(block, monkeypatch):
    monkeypatch.setattr(ref, "BLOCK", block)
    g = np.random.default_rng(block)
    m, pos = 8, np.array([[0, 0], [2, 5], [3, 1], [4, 4], [1, 3]])
    o = 1 + 0.1 * (g.uniform(-1, 1, (12, 14)) + 1j * g.uniform(-1, 1, (12, 14)))
    p = g.uniform(-1, 1, (m, m)) + 1j * g.uniform(-1, 1, (m, m))
    e = g.uniform(-1, 1, (5, m, m)) + 1j * g.uniform(-1, 1, (5, m, m))
    a = g.uniform(0, 8, (5, m, m))
    e[1] = 0  # a frame whose transform is 0 where 2 phi = psi: here nowhere
    want = _numpy_iteration(e, o, p, a, pos)
    got = ref.iterate(*(torch.from_numpy(t) for t in (e, o, p, a, pos)))
    for x, y in zip(got, want):
        assert np.abs(x.numpy() - y).max() <= 1e-12 * np.abs(y).max()


def test_errors_read_the_worst_and_nan():
    g = torch.Generator().manual_seed(1)
    state = [torch.randn(3, 4, 4, dtype=torch.complex128, generator=g),
             1 + 0.1 * torch.randn(6, 6, dtype=torch.complex128, generator=g),
             torch.randn(4, 4, dtype=torch.complex128, generator=g),
             torch.rand(3, 4, 4, dtype=torch.float64, generator=g),
             torch.tensor([[0, 0], [2, 2], [1, 0]])]
    want = ref.iterate(*state)
    got = [t.clone() for t in want]
    got[0][1, 2, 3] += 0.25 * want[0].abs().max()
    errs = ref.errors(got, *state)
    assert errs["exit_err"] == pytest.approx(0.25) and errs["object_err"] == 0
    got[2][0, 0] = float("nan")
    assert math.isnan(ref.errors(got, *state)["probe_err"])
    got[0][0, 0, 0] = float("nan")
    assert math.isnan(ref.errors(got, *state)["exit_err"])


def test_sound_run_is_correct():
    r = harness.run(small(), 2**31 + 31, 0.2, False, "cpu")
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 1
    assert max(c["value"] for c in r["checks"].values()) <= 1e-5


def test_control_is_not_correct():
    r = harness.run(small(), 2**31 + 32, 0.2, False, "cpu",
                    calls_of=lambda wl: wl.control_calls())
    assert not r["correct"], r["checks"]
    assert all(c["value"] > c["limit"] for c in r["checks"].values()), r["checks"]


def _faulty(wl, fault):
    def call(x):
        got = list(wl.ptycho.dm_iterate(x, wl.obj, wl.probe, wl.fmag, wl.pos, out=wl.out,
                                        device=wl.device))
        if fault == "frame_left_out":
            got[0][0] = x[0]
        elif fault == "object_kept":
            got[1] = wl.obj
        else:  # "probe_kept"
            got[2] = wl.probe
        return tuple(got)
    return [("dm", call)]


@pytest.mark.parametrize("fault", ["frame_left_out", "object_kept", "probe_kept"])
def test_fault_in_the_timed_path_is_not_correct(fault):
    r = harness.run(small(), 2**31 + 33, 0.2, False, "cpu",
                    calls_of=lambda wl: _faulty(wl, fault))
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_least_bytes():
    a = harness.resolve(SPEC, CELL).adapter
    f, m, s = 3, 4, 10
    assert a.cube_least_bytes(2 * f * m * m) == 2 * 16 * f * m * m
    assert a.ROOT_SPAN == "ptycho.dm"
    assert a.exit_least_bytes(f, m, s) == 16 * f * m * m + 8 * s * s + 8 * m * m
    assert a.fourier_least_bytes(f, m, s) == 20 * f * m * m
    assert a.update_least_bytes(f, m, s) == 24 * f * m * m + 20 * s * s + 8 * m * m
    assert a.probe_least_bytes(f, m, s) == 8 * f * m * m + 8 * s * s + 12 * m * m
    assert a.request_least_bytes(f, m, s) == 28 * f * m * m + 16 * s * s + 16 * m * m


def test_the_model_probe_and_the_raster():
    a = harness.resolve(SPEC, CELL).adapter
    p = a.model_probe(128, 64, 4.0)
    inside = p.abs() > 0
    assert p.dtype == torch.complex64 and torch.allclose(p.abs()[inside], torch.tensor(1.0))
    assert abs(int(inside.sum()) - math.pi * 32 ** 2) < 2 * math.pi * 32
    assert p[64, 64] == 1 and not inside[64, 64 + 33] and inside[64, 64 + 32]
    # 4 turns at the edge: the phase at r = 32 is 8 pi, a whole number of turns
    assert torch.angle(p[64, 96]).abs() < 1e-5 and torch.angle(p[64, 80]).item() == pytest.approx(
        2 * math.pi * 4 * 0.25 - 2 * math.pi, abs=1e-5)
    pos = a.raster(3, 16)
    assert pos.dtype == torch.int32 and pos.tolist() == [[r, c] for r in (0, 16, 32)
                                                         for c in (0, 16, 32)]


def test_pool_and_state_are_drawn_from_the_seed():
    wl = workload(small())
    a = wl.make_pool(2**40 + 3, 2)
    obj, fmag = wl.obj.clone(), wl.fmag.clone()
    b = wl.make_pool(2**40 + 3, 2)
    assert torch.equal(a, b) and torch.equal(obj, wl.obj) and torch.equal(fmag, wl.fmag)
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a, wl.make_pool(2**40 + 4, 2))
    assert a.dtype == torch.complex64 and wl.fmag.dtype == torch.float32
    assert (wl.obj - 1).abs().max() <= 0.1 * math.sqrt(2)
    phi = wl.probe * ref.views(obj, wl.pos, wl.m)
    assert (b[0] - phi).abs().max() <= 0.1 * math.sqrt(2) + 1e-6
    assert wl.out.shape == a[0].shape


# -- the readers, on synthetic spans -------------------------------------------------------

def reader(name):
    return harness.load_module(ROOT / "fftbench" / "metrics" / f"{name}.py", "m_" + name)


def _span(i, name, t0, t1, parent, call):
    from watfft_tpu_torch import trace
    return trace.Span(i, name, int(t0 * US), int(t1 * US), parent, call, 1)


def _ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "args": {"correlation": corr}}


# (launch span, its parent, start, end, the kernel, its device us)
STEPS = [("launch.ptycho_exit", "ptycho.exit", 10, 20, "ptycho_exit_kernel", 1000),
         ("launch.fft2_cube", "api.fft2", 30, 40, "fft2_cube_block_kernel<16, 16, false, 512>",
          2000),
         ("launch.ptycho_fourier", "ptycho.fourier", 50, 60, "ptycho_fourier_kernel", 1500),
         ("launch.fft2_cube", "api.ifft2", 70, 80, "fft2_cube_block_kernel<16, 16, true, 512>",
          2000),
         ("launch.ptycho_update", "ptycho.update", 90, 100, "ptycho_update_kernel", 2500),
         ("launch.ptycho_probe", "ptycho.probe", 120, 130, "ptycho_probe_kernel", 500)]


def requests(count=4, period=10000):
    """`count` calls of the iteration, one every `period` us, each one
    chunk: every pass in its step span, holding its launch, whose kernel
    takes the given device time; the device runs them back to back."""
    recorded, events = [], []
    for k in range(count):
        t, sid = k * period, 20 * k
        recorded.append(_span(sid + 1, "ptycho.dm", t, t + 9000, 0, k + 1))
        dev = t + 40
        for i, (name, step, a, b, kernel, dur) in enumerate(STEPS):
            recorded.append(_span(sid + 2 + 2 * i, step, t + a - 2, t + b + 2, sid + 1, k + 1))
            corr = sid + 3 + 2 * i
            recorded.append(_span(corr, name, t + a, t + b, sid + 2 + 2 * i, k + 1))
            events += [_ev("cuda_runtime", "cudaLaunchKernel", t + (a + b) / 2 - 1, 2, corr),
                       _ev("kernel", f"void (anonymous namespace)::{kernel}(float const*)", dev,
                           dur, corr)]
            dev += dur
    return recorded, events


@pytest.fixture
def run_with(tmp_path, monkeypatch):
    """A traced run of the cell under tmp_path whose trace file holds
    `events` and whose tracer holds `recorded`: the cell's request."""
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
                           points_per_request=2 ** 29, peaks={"hbm_bytes_per_s": 1e12},
                           trace={"window_s": 40000e-6, "requests": 4} if traced else None)
    return make


def test_readers_on_synthetic_spans(run_with):
    run = run_with(*requests())
    a = run.cell.adapter
    f, m, s = 16384, 128, 2160
    for name, least, dev_us in (("fft2_cube_roofline",
                                 lambda f, m, s: a.cube_least_bytes(2 * f * m * m), 4000),
                                ("ptycho_exit_roofline", a.exit_least_bytes, 1000),
                                ("ptycho_fourier_roofline", a.fourier_least_bytes, 1500),
                                ("ptycho_update_roofline", a.update_least_bytes, 2500),
                                ("ptycho_probe_roofline", a.probe_least_bytes, 500)):
        # 4 calls x the least bytes at 10^12 B/s against 4 x the device time
        assert reader(name).read(run) == pytest.approx(
            100 * 4 * least(f, m, s) / 1e12 / (4 * dev_us * 1e-6)), name
    s = spans.port(run)
    assert s["held"] == 1.0 and s["roots"] == 4


def test_the_cube_reader_takes_the_cell_s_root_and_bytes(run_with):
    """The cube's reader is any cell's: the root span and the least bytes
    are the configuration's; the four passes' readers read the difference
    map's alone."""
    recorded, events = requests()
    other = [s._replace(name="other.request") if s.name == "ptycho.dm" else s
             for s in recorded]
    run = run_with(other, events)
    run.cell.adapter = types.SimpleNamespace(ROOT_SPAN="other.request",
                                             cube_least_bytes=lambda points: 10 * points)
    assert reader("fft2_cube_roofline").read(run) == pytest.approx(
        100 * 4 * 10 * 2 ** 29 / 1e12 / (4 * 4000e-6))
    assert all(reader(name).read(run) is None for name in READERS
               if name != "fft2_cube_roofline")
    run.cell.adapter = types.SimpleNamespace(cube_least_bytes=lambda points: 10 * points)
    assert reader("fft2_cube_roofline").read(run) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_a_trace_reads_nothing(name, run_with):
    assert reader(name).read(run_with(*requests(), traced=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_iteration_s_spans_reads_nothing(name, run_with):
    """A run whose port recorded no iteration (another cell's, or a port
    without it, as the parent commit) or none of its launches."""
    recorded, events = requests()
    other = [s._replace(name="api.fft2") if s.name == "ptycho.dm" else s for s in recorded]
    assert reader(name).read(run_with(other, events)) is None
    assert reader(name).read(run_with([], events)) is None
    bare = [s for s in recorded if not s.name.startswith("launch.")]
    assert reader(name).read(run_with(bare, events)) is None
