"""Accuracy tolerance model: a copy of `watfft_tpu/utils/tolerances.py`.

The port is held to the same limits as the JAX package (reference:
tests/accuracy.test.js:21-30, tests/per_bin_f32.test.js:37,
tests/ifft.test.js:9-10 of wat-fft). Only the f32 tier is ported so far;
the f64 entries stay so the two tables read alike.
"""

from __future__ import annotations

# Max relative error vs f64 reference DFT (set ~4x above measured baselines so
# order-of-magnitude regressions fail without flaking).
MAX_REL = {"float32": 5e-6, "float64": 1e-9}
RMS_REL = {"float32": 2e-6, "float64": 5e-10}

# Per-bin tolerance: one pure sinusoid per bin, all energy must land in bin k.
PER_BIN = {"float32": lambda n: n * 5e-6, "float64": lambda n: n * 1e-10}

# Roundtrip (forward then inverse) tolerances.
ROUNDTRIP = {"float32": 1e-4, "float64": 1.5e-10}
