"""The wstack_n4096 configuration and its cell: the cell resolves with its
files; the plain reference (`reference/wstack.py`) agrees with a numpy
float64 model; on the CPU at a small size a sound run is correct, and the
bfloat16 control is not, nor is any of three faults planted in the timed
path (a plane skipped, no w-screen, the centring shift dropped); the least
bytes and the taper; the readers of this cell (`fft2_2pass_roofline`,
`wstack_accum_roofline`) on synthetic spans whose answers are known, and
None without a trace or without the imager's spans.

The cell's small request is `small()` here: a smaller grid and fewer
layers, which conftest's `SMALL` (a request alone) cannot set.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from fftbench import harness, spans
from fftbench.reference import wstack as ref

ROOT = harness.ROOT
CELL = "wstack_n4096.batch"
SPEC = harness.load_spec()
COLS = "void (anonymous namespace)::strided_cols_kernel<1, 16>(float const*, long)"
ROWS = "void (anonymous namespace)::stockham_c2c_resident_kernel<float>(float const*, long)"
ACCUM = "void (anonymous namespace)::wstack_accum_kernel<4>(float const*, float*, long)"
US = 1000  # ns


def small(n=128, layers=5):
    """The cell at a size the CPU runs in a second: its files, a smaller
    grid and fewer layers a request."""
    cell = harness.resolve(SPEC, CELL)
    cell.config = dict(cell.config, n=n)
    cell.traffic = dict(cell.traffic, request={"layers": layers}, pool_mib=1, check=3)
    return cell


def workload(cell):
    return cell.adapter.Workload(cell.config, cell.traffic["request"], torch.device("cpu"))


def test_the_cell_resolves():
    cell = harness.resolve(SPEC, CELL)
    assert cell.config["n"] == 4096 and cell.config["reduced"] == []
    assert set(cell.config["limits"]) == {"image_err"}
    assert cell.traffic["request"] == {"layers": 128}
    assert cell.loop.__file__ == str(ROOT / "fftbench" / "loops" / "pipeline.py")
    assert {m["name"] for m in cell.end_to_end} == {"gpoints_per_s", "workspace_mib", "setup_s"}
    assert {"fft2_2pass_roofline", "wstack_accum_roofline", "request_roofline",
            "torch_ops_pct.batch", "device_idle_pct.batch", "port_idle_pct.batch",
            "host_wait_pct.batch", "h2d_per_call.batch"} == {m["name"] for m in cell.per_layer}
    wl = cell.adapter.Workload(cell.config, cell.traffic["request"], torch.device("meta"))
    assert wl.input_bytes == 128 * 4096 ** 2 * 8  # 16 GiB
    assert wl.points == 128 * 4096 ** 2
    assert wl.least_bytes == wl.input_bytes + 4 * 4096 ** 2
    assert harness.pool_count(cell.traffic, wl.input_bytes) == 1
    assert wl.pixel_scale == pytest.approx(20 * math.pi / (180 * 3600))


@pytest.mark.parametrize("layers,n", [(3, 16), (2, 64), (1, 8)])
def test_reference_matches_numpy(layers, n):
    rng = np.random.default_rng(n)
    grids = rng.uniform(-1, 1, (layers, n, n)) + 1j * rng.uniform(-1, 1, (layers, n, n))
    w = rng.uniform(-2000, 2000, layers)
    ps, taper = 0.4 / n, rng.uniform(0.5, 1.0, n)
    lm = (np.arange(n) - n // 2) * ps
    nn = np.sqrt(1 - lm[:, None] ** 2 - lm[None, :] ** 2)
    want = sum((np.exp(2j * np.pi * wk * (nn - 1))
                * np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(g)))).real
               for wk, g in zip(w, grids)) * nn / np.outer(taper, taper)
    got = ref.invert(torch.from_numpy(grids), torch.from_numpy(w), ps,
                     torch.from_numpy(taper)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_image_err_reads_the_worst_and_nan():
    rng = np.random.default_rng(1)
    grids = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8)) + 0j)
    w, taper = torch.tensor([1.0, -1.0], dtype=torch.float64), torch.ones(8)
    want = ref.invert(grids, w, 0.05, taper)
    got = want.clone()
    got[3, 5] += 0.25 * want.abs().max()
    assert ref.image_err(got, grids, w, 0.05, taper) == pytest.approx(0.25)
    got[0, 1] = float("nan")
    assert np.isnan(ref.image_err(got, grids, w, 0.05, taper))


def test_sound_run_is_correct():
    r = harness.run(small(), 2**31 + 21, 0.2, False, "cpu")
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 1 and r["checks"]["image_err"]["value"] <= 1e-6


def test_control_is_not_correct():
    r = harness.run(small(), 2**31 + 22, 0.2, False, "cpu",
                    calls_of=lambda wl: wl.control_calls())
    assert not r["correct"] and r["checks"]["image_err"]["value"] >= 5e-4, r["checks"]


def _faulty(wl, fault):
    im, w, ps, taper, dev = wl.imaging, wl.w, wl.pixel_scale, wl.taper, wl.device

    def call(g):
        if fault == "skip":  # the first plane left out
            return im.wstack_invert(g[1:], w[1:], ps, taper, device=dev)
        if fault == "no_screen":
            return im.wstack_invert(g, torch.zeros_like(w), ps, taper, device=dev)
        n = g.shape[-1]  # "no_shift": the image left where the transform puts it
        return torch.roll(im.wstack_invert(g, w, ps, taper, device=dev), (n // 2, n // 2),
                          (0, 1))
    return [("invert", call)]


@pytest.mark.parametrize("fault", ["skip", "no_screen", "no_shift"])
def test_fault_in_the_timed_path_is_not_correct(fault):
    r = harness.run(small(), 2**31 + 23, 0.2, False, "cpu",
                    calls_of=lambda wl: _faulty(wl, fault))
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_one_plane_skipped_of_the_cell_s_128_is_not_correct():
    """At the cell's 128 layers one plane is under 1% of the image: still
    far past the limit (a small grid keeps it a CPU test)."""
    r = harness.run(small(n=32, layers=128), 2**31 + 24, 0.05, False, "cpu",
                    calls_of=lambda wl: _faulty(wl, "skip"))
    assert not r["correct"] and r["checks"]["image_err"]["value"] >= 1e-3, r["checks"]


def test_least_bytes_are_the_request_input_and_output():
    cell = small()
    wl = workload(cell)
    x = wl.make_pool(1, 1)[0]
    outs = harness.issue(wl.calls(), x)
    assert wl.least_bytes == x.nbytes + sum(t.nbytes for t in harness.flatten(outs))
    assert wl.input_bytes == x.nbytes and x.dtype == torch.complex64
    assert cell.adapter.fft2_least_bytes(10) == 320
    assert cell.adapter.wstack_least_bytes(3, 4) == 8 * 3 * 16 + 4 * 16


def test_pool_is_drawn_from_the_seed_inside_the_uv_disc():
    cell = small()
    wl = workload(cell)
    a, b = wl.make_pool(2**40 + 3, 2), wl.make_pool(2**40 + 3, 2)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    assert not torch.equal(a, wl.make_pool(2**40 + 4, 2))
    n = cell.config["n"]
    uv = (torch.arange(n, dtype=torch.float64) - n // 2) / (n * wl.pixel_scale)
    outside = uv[:, None] ** 2 + uv[None, :] ** 2 > wl.uv_max ** 2
    assert outside.any() and torch.all(a[..., outside] == 0)
    inside = torch.view_as_real(a[..., ~outside])
    assert inside.abs().max() <= 1 and inside.abs().max() > 0.99


def test_the_taper_and_w():
    cell = harness.resolve(SPEC, CELL)
    t = cell.adapter.kb_taper(4096, 7, 16.38)
    assert t.dtype == torch.float32 and t[2048] == 1.0
    assert t[0].item() == pytest.approx(0.01946, rel=1e-3)  # the edge
    assert torch.equal(t[1:], t[1:].flip(0)) and t.argmax() == 2048 and (t == 1).sum() == 1
    wl = workload(small())
    assert wl.w.dtype == torch.float64 and wl.w[0] == -2000 and wl.w[-1] == 2000


# -- the readers, on synthetic spans -------------------------------------------------------

def reader(name):
    return harness.load_module(ROOT / "fftbench" / "metrics" / f"{name}.py", "m_" + name)


def _span(i, name, t0, t1, parent, call):
    from watfft_tpu_torch import trace
    return trace.Span(i, name, int(t0 * US), int(t1 * US), parent, call, 1)


def _ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "args": {"correlation": corr}}


STEPS = [("launch.fft2_cols", 35, 45, COLS, 3000), ("launch.stockham_c2c", 50, 60, ROWS, 3000),
         ("launch.wstack_accum", 75, 95, ACCUM, 1000)]
PARENTS = {"launch.fft2_cols": "api.ifft2", "launch.stockham_c2c": "api.ifft2",
           "launch.wstack_accum": "wstack.finalise"}


def requests(count=4, period=10000):
    """`count` calls of the imager, one every `period` us: the root [0,
    9000]; `api.ifft2` [30, 70] holds `launch.fft2_cols` [35, 45] and
    `launch.stockham_c2c` [50, 60], whose kernels take 3000 us each;
    `wstack.finalise` [70, 100] holds `launch.wstack_accum` [75, 95], whose
    kernel takes 1000 us. The device runs them back to back from 40."""
    recorded, events = [], []
    for k in range(count):
        t, sid = k * period, 10 * k
        ids = {"imaging.wstack": sid + 1, "api.ifft2": sid + 2, "wstack.finalise": sid + 3}
        recorded.append(_span(sid + 1, "imaging.wstack", t, t + 9000, 0, k + 1))
        recorded.append(_span(sid + 2, "api.ifft2", t + 30, t + 70, sid + 1, k + 1))
        recorded.append(_span(sid + 3, "wstack.finalise", t + 70, t + 100, sid + 1, k + 1))
        dev = t + 40
        for i, (name, a, b, kernel, dur) in enumerate(STEPS):
            corr = sid + 4 + i
            recorded.append(_span(corr, name, t + a, t + b, ids[PARENTS[name]], k + 1))
            events += [_ev("cuda_runtime", "cudaLaunchKernel", t + (a + b) / 2 - 1, 2, corr),
                       _ev("kernel", kernel, dev, dur, corr)]
            dev += dur
    return recorded, events


@pytest.fixture
def run_with(tmp_path, monkeypatch):
    """A traced run of the cell under tmp_path whose trace file holds
    `events` and whose tracer holds `recorded`: two 4096^2 planes a
    request."""
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
                           points_per_request=2 * 4096 ** 2, peaks={"hbm_bytes_per_s": 1e12},
                           trace={"window_s": 40000e-6, "requests": 4} if traced else None)
    return make


def test_readers_on_synthetic_spans(run_with):
    run = run_with(*requests())
    n2 = 4096 ** 2
    # 4 calls x 2 n^2 points x 32 B at 10^12 B/s against 4 x 6000 us
    assert reader("fft2_2pass_roofline").read(run) == pytest.approx(
        100 * 4 * 2 * n2 * 32 / 1e12 / (4 * 6000e-6))
    # 4 calls x (8 B x 2 planes + 4 B) x n^2 at 10^12 B/s against 4 x 1000 us
    assert reader("wstack_accum_roofline").read(run) == pytest.approx(
        100 * 4 * 20 * n2 / 1e12 / (4 * 1000e-6))
    s = spans.port(run)
    assert s["held"] == 1.0 and s["roots"] == 4


@pytest.mark.parametrize("name", ["fft2_2pass_roofline", "wstack_accum_roofline"])
def test_reader_without_a_trace_reads_nothing(name, run_with):
    assert reader(name).read(run_with(*requests(), traced=False)) is None


@pytest.mark.parametrize("name", ["fft2_2pass_roofline", "wstack_accum_roofline"])
def test_reader_without_the_imager_s_spans_reads_nothing(name, run_with):
    """A run whose port recorded no imager call (another cell's, or a port
    without the imager, as the parent commit) or none of its launches."""
    recorded, events = requests()
    other = [s._replace(name="api.fft2") if s.name == "imaging.wstack" else s for s in recorded]
    assert reader(name).read(run_with(other, events)) is None
    assert reader(name).read(run_with([], events)) is None
    bare = [s for s in recorded if not s.name.startswith("launch.")]
    assert reader(name).read(run_with(bare, events)) is None
