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
import watfft_tpu_torch.ops.rfft, watfft_tpu_torch.stft
import watfft_tpu_torch.ops.large, watfft_tpu_torch.ops.fourstep, watfft_tpu_torch.plan
import watfft_tpu_torch.ops.fft2
import watfft_tpu_torch.fftlib, watfft_tpu_torch.ops.bluestein
import watfft_tpu_torch.config, watfft_tpu_torch.ops.mxu_dft
import watfft_tpu_torch.parallel.sharded, watfft_tpu_torch.parallel.large_sharded
import watfft_tpu_torch.parallel.real_sharded, watfft_tpu_torch.parallel.dryrun
import chip_smoke
import torch
x = torch.zeros(16, 4, dtype=torch.bfloat16)   # the bf16 path and #20 on the CPU
watfft_tpu_torch.ops.stockham.stockham_fft_nb(x, x)
watfft_tpu_torch.ops.mxu_dft.dft_matmul_nb(x.float(), x.float())
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("jax", "jaxlib", "watfft_tpu"))
print(json.dumps({{"loaded": loaded, "launches": watfft_tpu_torch.ops.stockham.launches,
                  "real_launches": sum(watfft_tpu_torch.ops.rfft.launches.values()),
                  "large_launches": sum(watfft_tpu_torch.ops.large.launches.values()),
                  "fft2_launches": sum(watfft_tpu_torch.ops.fft2.launches.values()),
                  "bluestein_launches": sum(watfft_tpu_torch.ops.bluestein.launches.values()),
                  "dft_launches": watfft_tpu_torch.ops.mxu_dft.launches,
                  "bf16_launches": watfft_tpu_torch.ops.stockham.launches_bf16
                  + watfft_tpu_torch.ops.stockham.launches_bf16c}}))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # importing chip_smoke ran nothing, and the CPU calls launched nothing
    assert out == {"loaded": [], "launches": 0, "real_launches": 0, "large_launches": 0,
                   "fft2_launches": 0, "bluestein_launches": 0, "dft_launches": 0,
                   "bf16_launches": 0}
