"""Accuracy tolerance model: a copy of `watfft_tpu/utils/tolerances.py`.

The port is held to the same limits as the JAX package (reference:
tests/accuracy.test.js:21-30, tests/per_bin_f32.test.js:37,
tests/ifft.test.js:9-10 of wat-fft), in both tiers the port runs: float32
and float64 (the FP64 kernels and the float64 matmul surface). `EPS` and
`quality` (tools/accuracy_report.js:13-16 of wat-fft) also serve the bf16
tiers.
"""

from __future__ import annotations

import math

# Max relative error vs f64 reference DFT (set ~4x above measured baselines so
# order-of-magnitude regressions fail without flaking).
MAX_REL = {"float32": 5e-6, "float64": 1e-9}
RMS_REL = {"float32": 2e-6, "float64": 5e-10}

# Per-bin tolerance: one pure sinusoid per bin, all energy must land in bin k.
PER_BIN = {"float32": lambda n: n * 5e-6, "float64": lambda n: n * 1e-10}

# Roundtrip (forward then inverse) tolerances.
ROUNDTRIP = {"float32": 1e-4, "float64": 1.5e-10}

# Metamorphic/property tests (tests/correctness/test-helper.js:141-145).
REL_TOL = 1e-9
ABS_TOL = 1e-8

EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52,
       # 8-bit mantissa: quality for the bf16 tiers is measured against
       # bfloat16's own machine epsilon, so ~1 still means "as good as the
       # dtype allows" (the tiers are I/O- or compute-rounding-limited).
       "bfloat16": 2.0 ** -8}


def quality(max_rel: float, n: int, dtype: str) -> float:
    """max_rel / (eps * sqrt(log2 N)) — should stay roughly flat with N.

    Reference: tools/accuracy_report.js:13-16 of wat-fft. Values in the
    0.3–3 range are near-optimal for a radix-4 FFT.
    """
    return max_rel / (EPS[dtype] * math.sqrt(math.log2(n)))
