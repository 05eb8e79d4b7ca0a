"""Shared helpers of the benchmark's tests (CPU, small sizes)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each workload at a size the CPU holds in a test: the real configuration,
# its traffic mix with smaller requests and a small pool
SMALL = {"c2c_n1024": {"batch": 6}, "stft_n1024": {"batch": 2, "samples": 5120}}


@pytest.fixture
def small_cell():
    from fftbench import harness

    def make(workload: str, spec: dict | None = None):
        cell = harness.resolve(spec or harness.load_spec(), workload)
        cell.traffic = dict(cell.traffic, request=SMALL[cell.config["name"]], pool_mib=1,
                            check=3)
        return cell
    return make
