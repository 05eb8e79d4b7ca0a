"""The reductions of a trace, the metric readers, the least bytes and the
sample of kept requests, on synthetic inputs whose answers are known."""

from __future__ import annotations

import pytest
import torch

from fftbench import harness, traces

ROOT = harness.ROOT


def reader(name):
    return harness.load_module(ROOT / "fftbench" / "metrics" / f"{name}.py", "m_" + name)


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


PORT = "void (anonymous namespace)::stockham_c2c_resident_kernel<float>(float const*, long)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float> >(int)"

# window [100, 200] us; device work: the port's kernel 110-140, torch's
# 135-150 (overlapping it by 5), a copy 170-180 and a kernel cut by the
# window's end 195-210; the host in `fftbench.forward` 100-150 and
# `fftbench.sync` 150-200
EVENTS = [
    {"ph": "M", "name": "process_name"},
    ev("user_annotation", "fftbench.window", 100.0, 100.0),
    ev("user_annotation", "fftbench.forward", 100.0, 50.0),
    ev("user_annotation", "fftbench.sync", 150.0, 50.0),
    ev("gpu_user_annotation", "fftbench.window", 100.0, 100.0),
    ev("cpu_op", "aten::empty_like", 101.0, 2.0),
    ev("kernel", PORT, 110.0, 30.0),
    ev("kernel", TORCH, 135.0, 15.0),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 170.0, 10.0),
    ev("Kernel", PORT, 195.0, 15.0),
    ev("kernel", PORT, 20.0, 30.0),  # before the window: not counted
]


def test_base_name():
    assert traces.base_name(PORT) == "stockham_c2c_resident_kernel"
    assert traces.base_name(TORCH) == "vectorized_elementwise_kernel"
    assert traces.base_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert traces.base_name("cube_kernel<1, 256>(float*)") == "cube_kernel"


def test_port_kernels_are_read_from_the_sources():
    names = traces.port_kernels()
    assert {"stockham_c2c_resident_kernel", "rfft_r2c_resident_kernel",
            "irfft_c2r_resident_kernel", "stockham_cols_kernel", "cube_kernel",
            "dft_mma_kernel", "bluestein_onepass_kernel"} <= names
    assert "__launch_bounds__" not in names and "void" not in names


def test_port_kernels_from_a_new_source(tmp_path):
    (tmp_path / "new.cu").write_text(
        "__global__ void __launch_bounds__(kT, f<Real>(P))\nnew_kernel(float* x) {}\n"
        "template <int P> __global__ void plain_kernel(int n) {}\n")
    assert traces.port_kernels(tmp_path) == {"new_kernel", "plain_kernel"}


def test_summary_on_synthetic_events():
    s = traces.summary(EVENTS, {"stockham_c2c_resident_kernel"})
    assert s["window_s"] == pytest.approx(100e-6)
    # union: 110-150 (40), 170-180 (10), 195-200 (5)
    assert s["busy_s"] == pytest.approx(55e-6)
    assert s["port_s"] == pytest.approx(35e-6)  # 30 + the 5 inside the window
    assert s["device_s"] == pytest.approx(60e-6)  # sums, overlap counted twice
    assert s["device_ops"][0] == [PORT, pytest.approx(35e-6)]
    assert [n for n, _ in s["device_ops"]] == [PORT, TORCH, "Memcpy HtoD (Pageable -> Device)"]
    # idle: 100-110 in forward (10); 150-170 and 180-195 in sync (35)
    assert dict(s["idle_gaps"]) == {"fftbench.sync": pytest.approx(35e-6),
                                    "fftbench.forward": pytest.approx(10e-6)}
    assert traces.idle_pct(s) == pytest.approx(45.0)


def test_gaps_and_labels():
    assert traces.gaps([[2, 3], [5, 8]], 0, 10) == [(0, 2), (3, 5), (8, 10)]
    assert traces.gaps([], 0, 1) == [(0, 1)]
    spans = [(0.0, 1.0, "a"), (2.0, 3.0, "b")]
    starts = [0.0, 2.0]
    assert [traces.label(spans, starts, t) for t in (0.5, 1.5, 2.5, 9)] == \
        ["a", "host.other", "b", "host.other"]


def test_no_window_span_raises():
    with pytest.raises(ValueError):
        traces.summary([ev("kernel", PORT, 0, 1)], set())


def make_run(**kw):
    cell = harness.Cell(name="x", chips=1, config={}, adapter=None, traffic={}, loop=None,
                        end_to_end=[], per_layer=[], root=ROOT)
    return harness.Run(cell=cell, device_kind="NVIDIA H100 80GB HBM3", **kw)


def test_device_readers():
    s = traces.summary(EVENTS, {"stockham_c2c_resident_kernel"})
    run = make_run(trace=dict(s, requests=2), least_bytes_per_request=1000,
                   peaks={"hbm_bytes_per_s": 1e9})
    # 2 requests x 1000 B at 1 GB/s = 2 us of least time over 55 us busy
    assert reader("request_roofline").read(run) == pytest.approx(100 * 2e-6 / 55e-6)
    assert reader("torch_ops_pct.batch").read(run) == pytest.approx(100 * 25 / 60)
    assert reader("device_idle_pct.batch").read(run) == pytest.approx(45.0)
    assert reader("device_idle_pct.stream").read(run) == pytest.approx(45.0)


def test_device_readers_without_a_trace_read_nothing():
    run = make_run()
    for name in ("request_roofline", "torch_ops_pct.batch", "device_idle_pct.batch",
                 "device_idle_pct.stream"):
        assert reader(name).read(run) is None
    empty = traces.summary([ev("user_annotation", "fftbench.window", 0, 10)], set())
    run = make_run(trace=dict(empty, requests=5), least_bytes_per_request=1,
                   peaks={"hbm_bytes_per_s": 1.0})
    assert reader("request_roofline").read(run) is None  # never a 0% share
    assert reader("device_idle_pct.batch").read(run) is None
    run = make_run(trace=dict(traces.summary(EVENTS, set()), requests=1),
                   least_bytes_per_request=1)
    assert reader("request_roofline").read(run) is None  # no peak for the card


def test_host_readers():
    run = make_run(window_s=2.0, requests=4, points_per_request=10**9 // 2,
                   calls_per_request=2, latencies_s=[i / 1000 for i in range(1, 101)],
                   host_call_s=[1e-6, 3e-6, 2e-6], launches={"stockham_c2c": 6},
                   workspace_bytes=3 * 2**20, setup_s=4.5)
    assert reader("gpoints_per_s").read(run) == pytest.approx(1.0)
    assert reader("request_p95_ms").read(run) == pytest.approx(95.05)
    assert reader("host_us_per_call.stream").read(run) == pytest.approx(2.0)
    assert reader("launches_per_call.stream").read(run) == pytest.approx(0.75)
    assert reader("workspace_mib").read(run) == pytest.approx(3.0)
    assert reader("setup_s").read(run) == 4.5
    assert reader("request_p95_ms").read(make_run()) is None
    assert reader("workspace_mib").read(make_run(cuda=False)) is None


@pytest.mark.parametrize("workload", ["c2c_n1024.batch", "stft_n1024.batch"])
def test_least_bytes_are_the_request_input_and_outputs(workload, small_cell):
    cell = small_cell(workload)
    wl = cell.adapter.Workload(cell.config, cell.traffic["request"], torch.device("cpu"))
    x = wl.make_pool(1, 1)[0]
    outs = harness.issue(wl.calls(), x)
    assert wl.least_bytes == x.nbytes + sum(t.nbytes for t in harness.flatten(outs))
    assert wl.input_bytes == x.nbytes


def test_points(small_cell):
    cpu = torch.device("cpu")
    cell = small_cell("c2c_n1024.batch")
    assert cell.adapter.Workload(cell.config, {"batch": 4096}, cpu).points == 2 * 4096 * 1024
    cell = small_cell("stft_n1024.batch")
    wl = cell.adapter.Workload(cell.config, {"batch": 16, "samples": 66304}, cpu)
    assert (wl.frames, wl.points) == (256, 2 * 4096 * 1024)
    assert wl.least_bytes == 4 * 16 * (66304 + 2 * 256 * 513 + 66304)
    wl = cell.adapter.Workload(cell.config, {"batch": 1, "samples": 16000}, cpu)
    assert (wl.frames, wl.points) == (59, 2 * 59 * 1024)
    assert wl.least_bytes == 4 * (16000 + 2 * 59 * 513 + 15872)


def test_reservoir_is_seeded_and_uniform():
    def kept(seed, n, k=4):
        r = harness.Reservoir(k, seed)
        slots = [-1] * k
        for i in range(n):
            s = r.slot(i)
            if s >= 0:
                slots[s] = i
        return slots
    assert kept(5, 1000) == kept(5, 1000)
    assert kept(5, 3, 4)[:3] == [0, 1, 2] and kept(5, 3, 4)[3] == -1
    hits = [0] * 10
    for seed in range(2000):
        for i in kept(seed, 100):
            hits[i // 10] += 1
    # each tenth of the window holds a tenth of the 8000 kept, within 4 sigma
    assert all(abs(h - 800) < 4 * 800 ** 0.5 for h in hits), hits


def test_kept_copies_the_sampled_outputs():
    outs = [torch.zeros(3), (torch.zeros(2), torch.zeros(2))]
    kept = harness.Kept(2, outs, 1)
    for i in range(50):
        kept.offer(i, i % 7, [torch.full((3,), float(i)), (torch.full((2,), -1.0 * i),
                                                            torch.zeros(2))])
    for k, bufs in kept.filled():
        i = int(bufs[0][0])
        assert k == i % 7 and bool((bufs[1] == -i).all())
