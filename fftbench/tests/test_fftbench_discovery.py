"""The harness finds every configuration, traffic mix and metric by its name
in BENCHMARK.json, and a new one is picked up from new files alone."""

from __future__ import annotations

import json
import re
import shutil
import weakref
from pathlib import Path

import pytest
import torch

from fftbench import harness

ROOT = harness.ROOT
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves(workload):
    cell = harness.resolve(SPEC, workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert hasattr(cell.adapter, "Workload")
    assert (ROOT / "fftbench" / "loops" / f"{cell.traffic['loop']}.py").is_file()
    assert callable(cell.loop.drive)
    assert {"request", "pool_mib", "check"} <= set(cell.traffic)
    assert cell.end_to_end and cell.per_layer
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    reader = harness.load_module(ROOT / "fftbench" / "metrics" / f"{metric}.py", "m")
    assert callable(reader.read)


def test_spec_names_and_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for section, allowed in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
        for e in SPEC[section]:
            assert set(e) <= allowed, (section, e["name"])
            assert NAME.match(e["name"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("fftbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


DUMMY_PY = '''
import torch

class Workload:
    """Negation, held against the negation of the input."""
    def __init__(self, config, request, device):
        self.n, self.batch, self.device = config["n"], request["batch"], device
        self.input_bytes, self.points, self.least_bytes = 4 * self.n * self.batch, self.n, 8
    def calls(self):
        return [("negate", torch.neg)]
    def make_pool(self, seed, count):
        g = torch.Generator(device=self.device).manual_seed(seed)
        return torch.rand((count, self.batch, self.n), generator=g, device=self.device)
    def check(self, x, outs):
        return {"neg_err": float((outs[0] + x).abs().max())}
'''


def test_new_configuration_mix_and_metric_need_no_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    metric as new files and new entries; the harness runs the new cell."""
    shutil.copytree(ROOT / "fftbench", tmp_path / "fftbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    d = tmp_path / "fftbench"
    (d / "configs" / "dummy_n8.json").write_text(json.dumps(
        {"name": "dummy_n8", "n": 8, "reduced": [], "limits": {"neg_err": 0.0}}))
    (d / "configs" / "dummy_n8.py").write_text(DUMMY_PY)
    (d / "traffic" / "closed_b3.json").write_text(json.dumps(
        {"loop": "closed", "request": {"batch": 3}, "pool_mib": 1, "check": 2}))
    (d / "metrics" / "requests_done.py").write_text("def read(run):\n    return run.requests\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "dummy_n8", "source": "https://example.org",
                            "file": "fftbench/configs/dummy_n8.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "dummy_n8.closed", "config": "dummy_n8",
                              "traffic": "closed_b3", "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["dummy_n8.closed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve(harness.load_spec(tmp_path), "dummy_n8.closed", tmp_path)
    r = harness.run(cell, 7, 0.2, False, "cpu")
    assert r["correct"] and r["failed"] == 0
    assert r["checks"] == {"neg_err": {"value": 0.0, "limit": 0.0}}
    assert r["metrics"]["requests_done"]["value"] == r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "requests_done"}  # workspace_mib: a card only
    assert list(r)[-1] == "checks"


PACED_PY = '''
"""Requests in pairs: two enqueued back to back, then a synchronize."""
import time
from fftbench import harness

def drive(calls, pool, seconds, device, kept=None, span=harness.nospan, first=0):
    host, i, t0 = [], 0, time.perf_counter()
    while time.perf_counter() < t0 + seconds or i % 2:
        k, x = harness.pick(pool, first + i, span)
        outs = harness.issue(calls, x, span, host)
        if kept is not None:
            kept.offer(i, k, outs)
        if i % 2:
            harness.sync(device)
        i += 1
    return {"requests": i, "window_s": time.perf_counter() - t0, "latencies_s": [],
            "host_call_s": host}
'''


def test_new_loop_needs_no_edit(tmp_path):
    """A copy of the benchmark gains a kind of loop as a new file, and a mix
    and a cell that use it; the harness drives the cell with that loop."""
    shutil.copytree(ROOT / "fftbench", tmp_path / "fftbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    d = tmp_path / "fftbench"
    (d / "loops" / "paced.py").write_text(PACED_PY)
    (d / "traffic" / "paced_b2.json").write_text(json.dumps(
        {"loop": "paced", "request": {"batch": 2}, "pool_mib": 1, "check": 3}))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "c2c_n1024.paced", "config": "c2c_n1024",
                              "traffic": "paced_b2", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve(harness.load_spec(tmp_path), "c2c_n1024.paced", tmp_path)
    assert cell.loop.__file__ == str(d / "loops" / "paced.py")
    r = harness.run(cell, 2**31 + 21, 0.2, False, "cpu")
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 2 and r["attempted"] % 2 == 0


@pytest.mark.parametrize("loop", ["closed", "pipeline"])
def test_loops_hold_no_output_into_the_next_request(loop):
    """`workspace_mib` is the library's: by the next request's first call the
    loop has let go of the outputs before it."""
    drive = harness.load_module(ROOT / "fftbench" / "loops" / f"{loop}.py", "l").drive
    last = []

    def call(x):
        assert not last or last[-1]() is None
        y = x + 1
        last.append(weakref.ref(y))
        return y
    pool = torch.zeros((4, 8))
    outs = harness.issue([("a", call), ("b", torch.neg)], pool[0])
    kept = harness.Kept(2, outs, 5)
    del outs
    last.clear()
    r = drive([("a", call), ("b", torch.neg)], pool, 0.05, torch.device("cpu"), kept=kept)
    assert r["requests"] > 2
