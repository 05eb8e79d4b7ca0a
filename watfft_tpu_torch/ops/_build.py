"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles the `.cu` sources under `csrc/` — and nothing else — for
Hopper (`sm_90a`) into one shared library with a plain C interface, under
`build/watfft_tpu_torch/` at the repository root (git-ignored). The file
name carries a hash of the sources, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. A failed build raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "build_info"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "watfft_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Filled by `library()`: the library's path and the compiler's report
# (ptxas -v: registers, shared memory and spills per kernel; empty when an
# existing build was loaded).
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


@functools.cache
def library() -> ctypes.CDLL:
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = _BUILD_DIR / f"libwatfft_kernels-{digest.hexdigest()[:16]}.so"
    log = ""
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.watfft_stockham_c2c.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i64,
                                        p, p, ip, ip, i32, i32, p]
    lib.watfft_stockham_c2c.restype = i32
    lib.watfft_error_string.argtypes = [i32]
    lib.watfft_error_string.restype = ctypes.c_char_p
    build_info.update(path=str(out), log=log)
    return lib
