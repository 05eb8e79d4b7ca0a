"""Accuracy measurement shared by the port's tools, tests and `chip_smoke.py`.

A copy of `watfft_tpu/utils/accuracy.py` (port of tools/accuracy_report.js
of wat-fft, whose `measureAccuracy()` the reference's tests import "so tool
and test cannot disagree"): `tests/test_torch_accuracy.py` and
`watfft_tpu_torch.tools.accuracy_report` both call `measure_accuracy`.

Metrics per (surface, size): max relative error, RMS relative error, and
`quality = max_rel / (eps * sqrt(log2 N))`, which should stay ~flat with N.
The transform may return a numpy array or a torch tensor on any device;
`to_host` copies it to a numpy array.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..reference import dft as ref
from .tolerances import quality

__all__ = ["AccuracyResult", "measure_accuracy", "rel_errors", "to_host"]


@dataclass
class AccuracyResult:
    surface: str
    n: int
    dtype: str
    max_rel: float
    rms_rel: float

    @property
    def quality(self) -> float:
        return quality(self.max_rel, self.n, self.dtype)


def to_host(a) -> np.ndarray:
    """a as a numpy array on the host: torch tensors of any device are
    copied (bfloat16 widened to float32, which numpy lacks)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


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


@functools.lru_cache(maxsize=16)
def _case(n: int, kind: str, inverse: bool, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The seeded input and its f64 oracle output (watfft_tpu/utils/accuracy.py:55-69),
    kept for the next surface measured at the same point: the O(N^2) oracle
    is most of a report's host time."""
    rng = ref.seeded_rng(seed)
    if kind == "c2c":
        x = (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n))
        expected = ref.idft(x) if inverse else ref.dft(x)
    elif kind == "r2c":
        x = rng.uniform(-1, 1, n)
        expected = ref.real_dft(x)
    elif kind == "c2r":
        sig = rng.uniform(-1, 1, n)
        x = ref.real_dft(sig)
        expected = sig.astype(np.complex128)
    else:
        raise ValueError(kind)
    return x, expected


def measure_accuracy(transform, n: int, dtype: str, kind: str = "c2c",
                     inverse: bool = False, seed: int = 12345,
                     surface: str = "?") -> AccuracyResult:
    """Run `transform` on a seeded random input and compare against the f64
    reference DFT. `transform` maps a host array [n] -> spectrum/signal (a
    numpy array, or a torch tensor on any device)."""
    x, expected = _case(int(n), kind, bool(inverse), int(seed))
    got = to_host(transform(x.copy()))
    mx, rms = rel_errors(got, expected)
    return AccuracyResult(surface=surface, n=n, dtype=dtype, max_rel=mx, rms_rel=rms)
