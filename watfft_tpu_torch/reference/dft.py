"""O(N^2) reference DFT ground truth + deterministic signal generators.

numpy-only copy of `watfft_tpu/reference/dft.py` (the complex half: `dft`,
`idft`, `seeded_rng`, `make_signal`). The port cannot import that module:
importing anything under `watfft_tpu` imports JAX, and a CUDA host need not
have JAX. Everything here is host-side numpy float64 — the oracle that the
port's tests and `chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dft", "idft", "SIGNALS", "make_signal", "seeded_rng"]


def dft(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Direct O(N^2) complex DFT: X[k] = sum_n x[n] exp(-2i pi n k / N),
    always computed in complex128."""
    x = np.asarray(x).astype(np.complex128)
    n = x.shape[axis]
    w = _dft_matrix(n, sign=-1.0)
    return np.moveaxis(np.tensordot(np.moveaxis(x, axis, -1), w, axes=([-1], [0])), -1, axis)


def idft(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Direct O(N^2) inverse DFT with 1/N normalization."""
    x = np.asarray(x).astype(np.complex128)
    n = x.shape[axis]
    w = _dft_matrix(n, sign=+1.0) / n
    return np.moveaxis(np.tensordot(np.moveaxis(x, axis, -1), w, axes=([-1], [0])), -1, axis)


def _dft_matrix(n: int, sign: float) -> np.ndarray:
    k = np.arange(n, dtype=np.int64)
    # phase reduced mod n before the trig call so f64 sin/cos stay fully
    # accurate at large n
    ang = sign * 2.0 * np.pi * (np.outer(k, k) % n) / n
    return np.cos(ang) + 1j * np.sin(ang)


def seeded_rng(seed: int = 12345) -> np.random.Generator:
    return np.random.default_rng(seed)


def _impulse(n: int) -> np.ndarray:
    x = np.zeros(n, dtype=np.complex128)
    x[0] = 1.0
    return x


def _shifted_impulse(n: int, shift: int = 1) -> np.ndarray:
    x = np.zeros(n, dtype=np.complex128)
    x[shift % n] = 1.0
    return x


def _constant(n: int) -> np.ndarray:
    return np.ones(n, dtype=np.complex128)


def _single_freq(n: int, k: int = 1) -> np.ndarray:
    t = np.arange(n)
    return np.exp(2j * np.pi * k * t / n)


def _cosine(n: int, k: int = 1) -> np.ndarray:
    return np.cos(2 * np.pi * k * np.arange(n) / n).astype(np.complex128)


def _sine(n: int, k: int = 1) -> np.ndarray:
    return np.sin(2 * np.pi * k * np.arange(n) / n).astype(np.complex128)


def _alternating(n: int) -> np.ndarray:
    x = np.ones(n, dtype=np.complex128)
    x[1::2] = -1.0
    return x


def _random_complex(n: int, seed: int = 12345) -> np.ndarray:
    rng = seeded_rng(seed)
    return (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)).astype(np.complex128)


SIGNALS = {
    "impulse": _impulse,
    "shifted_impulse": _shifted_impulse,
    "constant": _constant,
    "single_freq": _single_freq,
    "cosine": _cosine,
    "sine": _sine,
    "alternating": _alternating,
    "random": _random_complex,
}


def make_signal(name: str, n: int, **kw) -> np.ndarray:
    return SIGNALS[name](n, **kw)
