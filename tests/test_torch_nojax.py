"""The port and chip_smoke.py import without JAX and without the JAX package.

A CUDA host need not have JAX, so `watfft_tpu_torch` must never import it
(nor `watfft_tpu`, whose __init__ imports JAX). Checked in a fresh
interpreter in which both imports are made to fail.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["watfft_tpu"] = None
import watfft_tpu_torch
import watfft_tpu_torch.convert, watfft_tpu_torch.planner, watfft_tpu_torch.ops._build
import chip_smoke
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("jax", "jaxlib", "watfft_tpu"))
print(json.dumps({{"loaded": loaded, "launches": watfft_tpu_torch.ops.stockham.launches}}))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"loaded": [], "launches": 0}  # importing chip_smoke ran nothing
