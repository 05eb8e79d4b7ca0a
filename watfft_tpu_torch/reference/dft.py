"""O(N^2) reference DFT ground truth + deterministic signal generators.

numpy-only copy of `watfft_tpu/reference/dft.py` (`dft`, `idft`,
`real_dft`, `real_idft`, `dft2`, `seeded_rng`, `make_signal`). The real pair is
computed in blocks of bins, so n = 8192 needs ~100 MB, not the full n x n
matrix. The port cannot import that module:
importing anything under `watfft_tpu` imports JAX, and a CUDA host need not
have JAX. Everything here is host-side numpy float64 — the oracle that the
port's tests and `chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dft", "idft", "real_dft", "real_idft", "dft2", "SIGNALS", "make_signal",
           "seeded_rng"]


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


_BLOCK = 512  # bins per block of the real oracle's matrix


def _phases(n: int, k0: int, k1: int) -> np.ndarray:
    """2 pi (t*k mod n) / n for t = 0..n-1 and bins k0..k1-1: [n, k1-k0]."""
    t = np.arange(n, dtype=np.int64)
    return 2.0 * np.pi * (np.outer(t, np.arange(k0, k1, dtype=np.int64)) % n) / n


def real_dft(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Real-input DFT returning the N//2+1 Hermitian-unique bins, complex128
    (tests/dft-reference.js:62-88, realDFT, of wat-fft)."""
    x = np.moveaxis(np.asarray(x).astype(np.float64), axis, -1)
    n = x.shape[-1]
    bins = n // 2 + 1
    out = np.empty(x.shape[:-1] + (bins,), np.complex128)
    for k0 in range(0, bins, _BLOCK):
        k1 = min(k0 + _BLOCK, bins)
        ang = _phases(n, k0, k1)
        out[..., k0:k1] = x @ np.cos(ang) - 1j * (x @ np.sin(ang))
    return np.moveaxis(out, -1, axis)


def real_idft(spec: np.ndarray, n: int, axis: int = -1) -> np.ndarray:
    """Inverse of real_dft: N//2+1 bins -> N real samples (1/N normalized),
    the real part of the inverse DFT of the Hermitian extension; so the
    imaginary parts of the DC and Nyquist bins do not enter (to rounding)."""
    spec = np.moveaxis(np.asarray(spec).astype(np.complex128), axis, -1)
    bins = n // 2 + 1
    if spec.shape[-1] != bins:
        raise ValueError(f"expected {bins} bins for n={n}, got {spec.shape[-1]}")
    weight = np.full(bins, 2.0)
    weight[0] = weight[-1] = 1.0  # DC and Nyquist appear once in the extension
    spec = spec * weight / n
    out = np.zeros(spec.shape[:-1] + (n,))
    for k0 in range(0, bins, _BLOCK):
        k1 = min(k0 + _BLOCK, bins)
        ang = _phases(n, k0, k1).T  # [bins in block, n]
        out += spec[..., k0:k1].real @ np.cos(ang) - spec[..., k0:k1].imag @ np.sin(ang)
    return np.moveaxis(out, -1, axis)


def dft2(x: np.ndarray) -> np.ndarray:
    """2D reference DFT over the trailing two axes, complex128."""
    return dft(dft(x, axis=-1), axis=-2)


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
