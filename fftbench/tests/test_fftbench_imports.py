"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the port. Names are compared whole, by the part
before the first dot: `watfft_tpu_torch` is the port, `watfft_tpu` the JAX
package."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "fftbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "watfft_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "watfft_tpu_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "math", "torch", "numpy"}


def test_the_names_are_compared_whole():
    assert "watfft_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "watfft_tpu.ops".split(".")[0] in FORBIDDEN


RUN_ALL = """
import json, sys
sys.path.insert(0, sys.argv[1])
from fftbench import harness
spec = harness.load_spec()
for w in spec["workloads"]:
    cell = harness.resolve(spec, w["name"])
    name = cell.config["name"]
    cell.traffic = dict(cell.traffic, request=json.loads(sys.argv[2])[name], pool_mib=1, check=1)
    harness.run(cell, 3, 0.05, False, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_of_every_cell_loads_no_jax():
    """Every cell, run on the CPU in a fresh process, leaves no JAX module
    and nothing of the JAX package in `sys.modules`: what the port loads at
    run time, which a scan of the sources cannot see."""
    from conftest import SMALL

    env = dict(os.environ, USE_FLAX="0")
    p = subprocess.run([sys.executable, "-c", RUN_ALL, str(ROOT), json.dumps(SMALL)],
                       capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "watfft_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN
