"""One run of one cell: the inputs from the seed, the warm-up, the measured
window, the traced slice, and the check of the window's outputs against the
plain reference.

Everything that belongs to one configuration, traffic mix or metric is found
by its name in `BENCHMARK.json`:

* a configuration is its JSON file (`file`) and, beside it, the module of the
  same stem: its `Workload` (the port's entry, the inputs, the points and the
  least bytes of a request, the check against `fftbench/reference/`);
* a traffic mix is `fftbench/traffic/<traffic>.json`: its sizes and the
  name of its `loop`, the file `fftbench/loops/<loop>.py` whose `drive`
  issues the requests;
* a metric is `fftbench/metrics/<name>.py`, whose `read(run)` returns the
  number or None (nothing to read: the metric is left out of the line).

The module imports torch and the benchmark's own files; the port comes in
through each configuration's module, and JAX never.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

from fftbench import traces as tr

ROOT = Path(__file__).resolve().parent.parent
HERE = "fftbench"
WARMUP_REQUESTS = 3
TRACE_SECONDS = 0.5  # the traced slice after the window: long enough for
                     # thousands of requests, short enough to parse in seconds


@dataclass
class Cell:
    """A workload of `BENCHMARK.json` with its files loaded."""
    name: str
    chips: int
    config: dict
    adapter: ModuleType
    traffic: dict
    loop: ModuleType
    end_to_end: list
    per_layer: list
    root: Path


@dataclass
class Run:
    """What one run measured: the input of every metric reader."""
    cell: Cell
    device_kind: str
    cuda: bool = True
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: int = 0
    points_per_request: int = 0
    least_bytes_per_request: int = 0
    calls_per_request: int = 0
    latencies_s: list = field(default_factory=list)
    host_call_s: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    workspace_bytes: int = 0
    trace: dict | None = None
    peaks: dict = field(default_factory=dict)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _metrics_of(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def resolve(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload`, with its configuration, adapter, traffic
    mix, loop and metric entries, all found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    file = root / entry["file"]
    traffic = json.loads((root / HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=json.loads(file.read_text()),
                adapter=load_module(file.with_suffix(".py"), f"fftbench_config_{w['config']}"),
                traffic=traffic,
                loop=load_module(root / HERE / "loops" / f"{traffic['loop']}.py",
                                 f"fftbench_loop_{traffic['loop']}"),
                end_to_end=_metrics_of(spec["end_to_end"], workload),
                per_layer=_metrics_of(spec["per_layer"], workload), root=root)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """Which requests of the window are kept for the check: a uniform sample
    of `k` of however many the window completes, drawn from the seed (Li's
    algorithm L: one comparison a request, a draw only at a replacement)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 1])
        self.w = math.exp(math.log(self._u()) / k)
        self.next = k + self._skip()

    def _u(self) -> float:
        u = self.rng.random()
        return u if u > 0.0 else 0.5

    def _skip(self) -> int:
        return int(math.floor(math.log(self._u()) / math.log1p(-self.w)))

    def slot(self, i: int) -> int:
        """The slot that request i replaces, or -1 if it is not kept."""
        if i < self.k:
            return i
        if i != self.next:
            return -1
        s = int(self.rng.integers(self.k))
        self.w *= math.exp(math.log(self._u()) / self.k)
        self.next += self._skip() + 1
        return s


def flatten(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flatten(o)]
    return [out]


class Kept:
    """Device buffers, made in set-up, that hold copies of the sampled
    requests' outputs; the copies are enqueued in stream order."""

    def __init__(self, k: int, outs: list, seed: int):
        self.reservoir = Reservoir(k, seed)
        self.bufs = [[torch.empty_like(t) for t in flatten(outs)] for _ in range(k)]
        self.index = [-1] * k

    def offer(self, i: int, pool_index: int, outs: list) -> bool:
        """Copies request i's outputs if the sample keeps it; says whether."""
        s = self.reservoir.slot(i)
        if s < 0:
            return False
        for buf, t in zip(self.bufs[s], flatten(outs)):
            buf.copy_(t)
        self.index[s] = pool_index
        return True

    def filled(self):
        return [(k, bufs) for k, bufs in zip(self.index, self.bufs) if k >= 0]


_NULL = contextlib.nullcontext()


def nospan(name: str):
    return _NULL


def pick(pool: torch.Tensor, i: int, span=nospan):
    """Request i's input: pool entry i mod len(pool)."""
    with span("rotate"):
        k = i % len(pool)
        return k, pool[k]


def issue(calls: list, x, span=nospan, host: list | None = None) -> list:
    """One request: the chain of `calls` (name, fn), the first on `x`, each
    next one on the output before it; the host time of every call of the
    port is appended to `host`. Returns every call's output."""
    perf = time.perf_counter
    outs = []
    for name, fn in calls:
        with span(name):
            t0 = perf()
            x = fn(x)
            if host is not None:
                host.append(perf() - t0)
        outs.append(x)
    return outs


def pool_count(traffic: dict, input_bytes: int) -> int:
    """Distinct inputs in the pool: at least `pool_mib` MiB of them, so that
    each request reads its input from HBM, not from the L2."""
    return max(1, math.ceil(traffic["pool_mib"] * 2**20 / input_bytes))


def launch_counts() -> dict:
    from watfft_tpu_torch import registry
    return registry.launch_counts()


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class Spans:
    """The benchmark's host spans of the traced slice, on the wall clock
    (`time.time_ns`, the clock the profiler's trace counts from)."""

    def __init__(self):
        self.done = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.done.append(("fftbench." + name, t0, time.time_ns()))

    def events(self, base_ns: int) -> list:
        """As trace events: microseconds from the trace's base time."""
        return [{"cat": "user_annotation", "name": name, "ts": (t0 - base_ns) / 1e3,
                 "dur": (t1 - t0) / 1e3} for name, t0, t1 in self.done]


def traced_slice(loop, calls, pool, device, out_path: Path, first: int) -> dict:
    """The traced slice: `TRACE_SECONDS` of the same loop under the profiler.
    The profiler records the device's work alone (CUPTI), so the host runs
    as it does untraced; the benchmark's spans come from its own clock."""
    from torch.profiler import ProfilerActivity, profile

    spans = Spans()
    sync(device)
    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with spans("window"):
            r = loop.drive(calls, pool, TRACE_SECONDS, device, span=spans, first=first)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    trace = json.loads(out_path.read_text())
    events = trace["traceEvents"] + spans.events(int(trace["baseTimeNanoseconds"]))
    return {"requests": r["requests"], **tr.summary(events, tr.port_kernels())}


def check(cell: Cell, wl, pool: torch.Tensor, kept: Kept) -> dict:
    """Holds every kept request against the reference: the worst reading of
    each compared number beside its limit, and the requests that failed."""
    limits = cell.config.get("limits", {})
    worst, failed, checked = {}, 0, 0
    for k, outs in kept.filled():
        readings = wl.check(pool[k], outs)
        checked += 1
        bad = False
        for name, value in readings.items():
            value = float(value)
            limit = limits.get(name)
            if not math.isfinite(value) or limit is None or value > limit:
                bad = True
            if name not in worst or not value <= worst[name]:
                worst[name] = value
        failed += bad
    checks = {name: {"value": v, "limit": limits.get(name)} for name, v in worst.items()}
    return {"checked": checked, "failed": failed, "checks": checks,
            "correct": checked > 0 and failed == 0}


def read_metrics(entries: list, run: Run, root: Path) -> dict:
    out = {}
    for m in entries:
        reader = load_module(root / HERE / "metrics" / f"{m['name']}.py",
                             "fftbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def peaks(root: Path, kind: str) -> dict:
    return json.loads((root / HERE / "peaks.json").read_text()).get(kind, {})


def run(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
        t_process: float | None = None, calls_of=None) -> dict:
    """One run of `cell`; returns the result line's fields. `t_process` is the
    process's start on `time.perf_counter`'s clock (set-up counts from it);
    `calls_of(workload)` gives other calls than `workload.calls()` (the
    control, the fault tests)."""
    t_process = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    wl = cell.adapter.Workload(cell.config, cell.traffic["request"], device)
    calls = wl.calls() if calls_of is None else calls_of(wl)
    pool = wl.make_pool(seed, pool_count(cell.traffic, wl.input_bytes))
    for i in range(WARMUP_REQUESTS):  # builds the kernels and the tables
        outs = issue(calls, pool[i % len(pool)])
    kept = Kept(int(cell.traffic["check"]), outs, seed)
    for buf, t in zip(kept.bufs[0], flatten(outs)):  # the copies' path, warmed
        buf.copy_(t)
    del outs
    sync(device)
    gc.collect()
    gc.freeze()
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if cuda else 0
    launches0 = launch_counts()
    setup_s = time.perf_counter() - t_process

    w = cell.loop.drive(calls, pool, seconds, device, kept=kept)

    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    r = Run(cell=cell, device_kind=kind, cuda=cuda, setup_s=setup_s, window_s=w["window_s"],
            requests=w["requests"], points_per_request=wl.points,
            least_bytes_per_request=wl.least_bytes, calls_per_request=len(calls),
            latencies_s=w["latencies_s"], host_call_s=w["host_call_s"],
            launches=_diff(launch_counts(), launches0),
            workspace_bytes=max(0, window_peak - base), peaks=peaks(cell.root, kind))
    if traced:
        out_path = cell.root / HERE / "out" / f"{cell.name}.trace.json"
        r.trace = traced_slice(cell.loop, calls, pool, device, out_path, w["requests"])
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device) if cuda else 0)
    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end, r, cell.root)
    verdict = check(cell, wl, pool, kept)
    result = {"correct": verdict["correct"], "attempted": r.requests,
              "failed": verdict["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if traced:
        result["device"].update(busy_s=r.trace["busy_s"], window_s=r.trace["window_s"])
        result["breakdown"] = {"device_ops": r.trace["device_ops"],
                               "idle_gaps": r.trace["idle_gaps"]}
    result["checks"] = verdict["checks"]
    return result

