"""The port and chip_smoke.py import without JAX and without the JAX package.

A CUDA host need not have JAX, so `watfft_tpu_torch` must never import it
(nor `watfft_tpu`, whose __init__ imports JAX). Checked in a fresh
interpreter in which both imports are made to fail, for every module of
the port (the registry, the native loader, the CLI and the tools
included: the stage-logging reference, the index visualizer, the
single-case runner and the dead-surface lint), and no import launches a
kernel.
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
import watfft_tpu_torch.registry, watfft_tpu_torch.native, watfft_tpu_torch.__main__
import watfft_tpu_torch.utils.accuracy, watfft_tpu_torch.tools
import watfft_tpu_torch.tools.accuracy_report, watfft_tpu_torch.tools.permutation_validator
import watfft_tpu_torch.tools.butterfly_tester, watfft_tpu_torch.tools.playground_report
import watfft_tpu_torch.tools.stockham_reference, watfft_tpu_torch.tools.index_visualizer
import watfft_tpu_torch.tools.single_case, watfft_tpu_torch.tools.lint_dead_surfaces
import chip_smoke
import torch
x = torch.zeros(16, 4, dtype=torch.bfloat16)   # the bf16 path and #20 on the CPU
watfft_tpu_torch.ops.stockham.stockham_fft_nb(x, x)
watfft_tpu_torch.ops.mxu_dft.dft_matmul_nb(x.float(), x.float())
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in ("jax", "jaxlib", "watfft_tpu"))
print(json.dumps({{"loaded": loaded,
                  "launches": sum(watfft_tpu_torch.trace.launches.values())}}))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # importing chip_smoke ran nothing, and the CPU calls launched nothing
    assert out == {"loaded": [], "launches": 0}
