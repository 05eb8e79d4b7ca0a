"""Prove every Stockham stage of the port's plans moves each row exactly
once, and that the stages compose to a naturally ordered output.

The port's counterpart of `tools/permutation_validator.py` (a port of
tools/permutation_validator.js of wat-fft: symbolic tracing that each
output position is written exactly once). It traces INDICES, not values,
through the data movement of the port's stage, `ops.stockham._stage`: the
R contiguous row blocks of q = n/R rows, the R-point DFT across them (part
p' of the output at position t takes position t of every block), and the
Stockham interleave `ops.stockham._interleave`, run on index tensors.

Each row carries a label: after the stages that multiply to L points, row
j*L + k must hold frequency k of the L-point DFT of the subsequence
x[j], x[j + n/L], x[j + 2n/L], ... (offset j, stride n/L). For every stage
(R, l) of `stage_plan(n)` the trace checks that the output rows are a
permutation (each written exactly once), that the R inputs of each output
are the R interleaved subsequences the radix-R step combines, and that
the output labels follow the rule at L = R*l; after the last stage (L = n)
row k holds frequency k: natural order.

    python -m watfft_tpu_torch.tools.permutation_validator [sizes...]

Sizes default to every power of two 2..8192. Exit code 0 iff every check
passes.
"""

from __future__ import annotations

import sys

import torch

from ..ops.stockham import _interleave, stage_plan


def trace_stage(n: int, r: int, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(part, position) of each output row of the stage (R, l) on n rows:
    output part p' at block position t, through the stage's own interleave."""
    q, g = n // r, n // (r * l)
    pos = _interleave([torch.arange(q) for _ in range(r)], g, l, ())
    part = _interleave([torch.full((q,), p) for p in range(r)], g, l, ())
    return part, pos


def validate(n: int) -> bool:
    stages = stage_plan(n)
    rows = torch.arange(n)
    off, freq = rows.clone(), torch.zeros(n, dtype=torch.long)  # L = 1: row j holds x[j]
    big_l = 1
    for idx, (r, l) in enumerate(stages):
        where = f"n={n} stage {idx} (R={r}, l={l})"
        if l != big_l:
            print(f"{where}: l is not the product of the stages before it ({big_l})")
            return False
        q, g = n // r, n // (r * l)
        part, pos = trace_stage(n, r, l)
        if torch.unique(part * q + pos).numel() != n:
            print(f"{where}: NOT a permutation")
            return False
        # the R inputs of output position t: rows p*q + t, which must hold
        # the subsequences at offsets p*g + j (stride n/l), frequency k
        j, k = pos // l, pos % l
        for p in range(r):
            src = p * q + pos
            if not (torch.equal(off[src], p * g + j) and torch.equal(freq[src], k)):
                print(f"{where}: block {p} does not hold the subsequences the radix-{r} "
                      f"step combines")
                return False
        off, freq = j, k + l * part
        big_l = r * l
        if not (torch.equal(off, rows // big_l) and torch.equal(freq, rows % big_l)):
            print(f"{where}: output rows out of Stockham order")
            return False
    if big_l != n or not torch.equal(freq, rows):
        print(f"n={n}: the stages multiply to {big_l} points, or the output is not in "
              f"natural order")
        return False
    print(f"n={n}: {len(stages)} stages {[r for r, _ in stages]}, every row written "
          f"exactly once, output in natural order")
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sizes = [int(s) for s in argv] or [1 << k for k in range(1, 14)]
    return 0 if all([validate(n) for n in sizes]) else 1


if __name__ == "__main__":
    sys.exit(main())
