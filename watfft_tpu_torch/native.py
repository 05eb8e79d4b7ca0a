"""ctypes binding for the native C++ host layer (`native/watfft_native.cpp`).

The port's own loader for the library the JAX package's `native.py` binds:
an independent long-double O(N^2) DFT oracle, the twiddle-pack generator
and the DFT-matrix generator, a second implementation stack to hold the
numpy host tables and oracle against. The library is plain host code
shared by both packages; this module imports nothing of `watfft_tpu`.

`available()` loads the tracked `native/libwatfft_native.so`. `build()`
compiles `native/watfft_native.cpp` with g++ into the git-ignored
`build/watfft_tpu_torch/` (or a directory the caller names) and loads that
build; it never writes under `native/`. Both return False where there is
no library or no compiler, and callers decide what that means; the
functions raise without a library.

`twiddle_pack` follows the stage plan compiled into the library, the JAX
package's (radix-32/64 overrides included), not the port's `stage_plan`.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "dft", "twiddle_pack", "dft_matrix", "library_path"]

_ROOT = Path(__file__).resolve().parents[1]
_SOURCE = _ROOT / "native" / "watfft_native.cpp"
_TRACKED = _ROOT / "native" / "libwatfft_native.so"
_BUILD_DIR = _ROOT / "build" / "watfft_tpu_torch"
CXX_FLAGS = ["-O2", "-fPIC", "-shared"]

_lib: ctypes.CDLL | None = None
_path: Path | None = None


def _load(path: Path) -> ctypes.CDLL | None:
    global _lib, _path
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    d = ctypes.POINTER(ctypes.c_double)
    f = ctypes.POINTER(ctypes.c_float)
    lib.wf_dft_c128.argtypes = [d, d, d, d, ctypes.c_int32, ctypes.c_int32]
    lib.wf_twiddle_pack_rows.argtypes = [ctypes.c_int32]
    lib.wf_twiddle_pack_rows.restype = ctypes.c_int32
    lib.wf_twiddle_pack.argtypes = [ctypes.c_int32, ctypes.c_int32, f, f]
    lib.wf_dft_matrix.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_double, d, d]
    lib.wf_version.restype = ctypes.c_int32
    _lib, _path = lib, path
    return lib


def available() -> bool:
    """Whether a library is loaded, loading the tracked one if none is."""
    if _lib is None and _TRACKED.exists():
        _load(_TRACKED)
    return _lib is not None


def library_path() -> Path | None:
    """The file of the loaded library, None before one is loaded."""
    return _path


def build(force: bool = False, directory=None) -> bool:
    """Compile the library from source with g++ and load it; True on
    success. Without `force` a loaded (or loadable tracked) library is
    kept. directory: where the build goes, `build/watfft_tpu_torch/` at the
    repository root by default."""
    if not force and available():
        return True
    cxx = shutil.which("g++")
    if cxx is None or not _SOURCE.exists():
        return False
    out_dir = Path(directory) if directory is not None else _BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libwatfft_native.so"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(_SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        return False
    return _load(out) is not None


def _lib_or_raise() -> ctypes.CDLL:
    if not available():
        raise RuntimeError("native library not loaded; run watfft_tpu_torch.native.build()")
    return _lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def dft(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Independent O(N^2) long-double DFT over the last axis (unscaled
    inverse)."""
    lib = _lib_or_raise()
    x = np.asarray(x, np.complex128)
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    out = np.empty_like(flat)
    for i in range(flat.shape[0]):
        xre = np.ascontiguousarray(flat[i].real)
        xim = np.ascontiguousarray(flat[i].imag)
        ore = np.empty(n, np.float64)
        oim = np.empty(n, np.float64)
        lib.wf_dft_c128(_dp(xre), _dp(xim), _dp(ore), _dp(oim), np.int32(n),
                        np.int32(1 if inverse else -1))
        out[i] = ore + 1j * oim
    return out.reshape(x.shape)


def twiddle_pack(n: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """The twiddle pack of the library's stage plan as [rows, 1] f32 planes
    (the layout of `ops.stockham.make_twiddle_pack`)."""
    lib = _lib_or_raise()
    rows = lib.wf_twiddle_pack_rows(np.int32(n))
    re = np.empty(rows, np.float32)
    im = np.empty(rows, np.float32)
    lib.wf_twiddle_pack(np.int32(n), np.int32(1 if inverse else 0), _fp(re), _fp(im))
    return re.reshape(-1, 1), im.reshape(-1, 1)


def dft_matrix(n: int, sign: int, scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """W[j, k] = scale * exp(sign * 2i pi j k / n) as f64 (re, im) planes."""
    lib = _lib_or_raise()
    wre = np.empty((n, n), np.float64)
    wim = np.empty((n, n), np.float64)
    lib.wf_dft_matrix(np.int32(n), np.int32(sign), np.float64(scale), _dp(wre), _dp(wim))
    return wre, wim
