"""The port's command-line tools, counterparts of the JAX package's
`tools/*.py` that import it: `accuracy_report`, `permutation_validator`,
`butterfly_tester`, `playground_report` (behind
`python -m watfft_tpu_torch analyze`), `stockham_reference`,
`index_visualizer`, `single_case` and `lint_dead_surfaces`. Run each as
`python -m watfft_tpu_torch.tools.<name>`; those that touch a device run
on the CUDA device unless asked for the CPU.
"""

from __future__ import annotations

import sys

import torch

__all__ = ["device_or_exit"]


def device_or_exit(cpu: bool, prog: str) -> str:
    """"cpu" where asked for; else "cuda", or exit 2 naming the missing
    device (no tool falls back to the CPU by itself)."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (torch.cuda.is_available() is false); "
              f"pass --cpu to run the kernels' plain versions on the CPU", file=sys.stderr)
        sys.exit(2)
    return "cuda"
