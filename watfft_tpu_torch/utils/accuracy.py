"""Relative-error measure shared by the port's tests and `chip_smoke.py`:
`rel_errors`, copied from `watfft_tpu/utils/accuracy.py`."""

from __future__ import annotations

import numpy as np

__all__ = ["rel_errors"]


def rel_errors(got: np.ndarray, expected: np.ndarray) -> tuple[float, float]:
    """(max_rel, rms_rel) with errors normalized by the spectrum's RMS
    magnitude (denominator floor), matching the reference's relative-error
    treatment that avoids division blowup at near-zero bins."""
    got = np.asarray(got, np.complex128)
    expected = np.asarray(expected, np.complex128)
    err = np.abs(got - expected)
    scale = max(float(np.sqrt(np.mean(np.abs(expected) ** 2))), 1e-300)
    rel = err / np.maximum(np.abs(expected), scale)
    return float(np.max(rel)), float(np.sqrt(np.mean(rel**2)))
