"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles each `.cu` source under `csrc/` — and nothing else — for
Hopper (`sm_90a`), all sources at once in parallel processes, and links the
objects into one shared library with a plain C interface, under
`build/watfft_tpu_torch/` at the repository root (git-ignored). The file
name carries a hash of the sources and the shared headers (`.cuh`), so an
edited kernel or header is rebuilt and an unchanged one is loaded as it is.
A failed build raises with the compiler's output; nothing falls back.

`launch` is the one seam every wrapper launches a kernel through: the
device and its current stream, the C entry, the span `launch.<key>` while
a profiler session is active, the error of a nonzero code and the count
in `trace.launches[key]`. `use_kernel`, `same_device` and `kernel_dtype` are
the decisions the wrappers make before a launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
from torch.autograd import profiler

from .. import trace

__all__ = ["library", "build_info", "use_kernel", "same_device", "kernel_dtype", "launch"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "watfft_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Filled by `library()`: the library's path and the compiler's report
# (ptxas -v: registers, shared memory and spills per kernel), kept beside
# the library so a build that is loaded, not compiled, still has it.
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


def _compile(sources: list[Path], out: Path) -> str:
    """One nvcc per source, all started together, then one link; returns
    the compilers' output. Raises if any step fails."""
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.stem}.{src.stem}.o") for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    log, failed = "", []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    if failed:
        raise RuntimeError("\n".join(failed))
    cmd = [nvcc, "-shared", "-o", str(out), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink()
    return log


@functools.cache
def library() -> ctypes.CDLL:
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):  # the sources and the shared .cuh headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = _BUILD_DIR / f"libwatfft_kernels-{digest.hexdigest()[:16]}.so"
    report = out.with_suffix(".ptxas.txt")
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        report.write_text(_compile(sources, tmp))
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    log = report.read_text() if report.exists() else ""
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    # each of these three in float32 and, under the _f64 name, float64
    # the c2c kernel's last arguments: the column tile C (0: none), its
    # threads, the walk, pairs_x and pairs_y
    for suffix in ("", "_f64"):
        c2c = getattr(lib, "watfft_stockham_c2c" + suffix)
        c2c.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i64, p, p, ip, ip, i32, i32, p,
                        i32, i32, i32, i32, i32]
        c2c.restype = i32
        # (x, x_sn, x_sb, yre, yim, y_sn, y_sb, n, batch, twre, twim, radices,
        #  offsets, nstages, wre, wim, stream, walk, pairs_x, pairs_y) and the
        #  c2r mirror of it, the walk and pairs in f32 only
        r2c = getattr(lib, "watfft_rfft_r2c" + suffix)
        r2c.argtypes = [p, i64, i64, p, p, i64, i64, i32, i64, p, p, ip, ip, i32, p, p, p,
                        i32, i32, i32]
        r2c.restype = i32
        c2r = getattr(lib, "watfft_irfft_c2r" + suffix)
        c2r.argtypes = [p, p, i64, i64, p, i64, i64, i32, i64, p, p, ip, ip, i32, p, p, p,
                        *([] if suffix else [i32, i32, i32])]
        c2r.restype = i32
    # the c2c kernel's bf16 instances: interop (f32 tables) and compute (bf16)
    for suffix in ("_bf16", "_bf16c"):
        c2c = getattr(lib, "watfft_stockham_c2c" + suffix)
        c2c.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i64, p, p, ip, ip, i32, i32, p,
                        i32, i32]
        c2c.restype = i32
    # (xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, W^T, stream, the
    #  fragments of W, kernel, pairs_x, pairs_y)
    lib.watfft_dft_matmul.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i64, p, p,
                                      p, i32, i32, i32]
    lib.watfft_dft_matmul.restype = i32
    # (xre, xim, yre, yim, x_sn, x_sa, x_sb, y_sn, y_sa, y_sb, pmre, pmim,
    #  m_sn, m_sa, m_sb, mul, n, inner, batch, twre, twim, radices, offsets,
    #  nstages, inverse, stream, cols, threads, pairs)
    lib.watfft_strided_c2c.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, p, p,
                                       i64, i64, i64, i32, i32, i64, i64,
                                       p, p, ip, ip, i32, i32, p, i32, i32, i32]
    lib.watfft_strided_c2c.restype = i32
    # (xre, xim, yre, yim, x_sn, x_sa, x_sb, y_sn, y_sa, y_sb, n, inner, batch,
    #  pmre, pmim, the 256-point twre, twim, radices, offsets, nstages,
    #  inverse, stream, cluster, pairs_x, pairs_y)
    lib.watfft_strided_cluster.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, i32, i64,
                                           i64, p, p, p, p, ip, ip, i32, i32, p, i32, i32, i32]
    lib.watfft_strided_cluster.restype = i32
    # (xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n1, n2, batch, pmre, pmim,
    #  the n2-point twre, twim, radices, offsets, nstages, the n1-point ones,
    #  inverse, stream, threads, pairs_x, pairs_y)
    lib.watfft_large_cube.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i32, i64, p, p,
                                      p, p, ip, ip, i32, p, p, ip, ip, i32, i32, p, i32, i32,
                                      i32]
    lib.watfft_large_cube.restype = i32
    # (xre, xim, yre, yim, x_sh, x_sw, x_sb, y_sh, y_sw, y_sb, h, w, batch,
    #  the h-point twre, twim, radices, offsets, nstages, the w-point ones,
    #  inverse, stream, walk, pairs_x, pairs_y, direct)
    lib.watfft_fft2_cube.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, i32, i32, i64,
                                     p, p, ip, ip, i32, p, p, ip, ip, i32, i32, p,
                                     i32, i32, i32, i32]
    lib.watfft_fft2_cube.restype = i32
    # (xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, m, batch, cre, cim, bre, bim,
    #  the m-point twre, twim, radices, offsets, nstages, stream); the inverse
    # without bre, bim
    lib.watfft_bluestein_fwd.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i32, i64,
                                         p, p, p, p, p, p, ip, ip, i32, p]
    lib.watfft_bluestein_fwd.restype = i32
    lib.watfft_bluestein_inv.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i32, i64,
                                         p, p, p, p, ip, ip, i32, p]
    lib.watfft_bluestein_inv.restype = i32
    # (xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, m, batch, cre, cim, bre, bim,
    #  fre, fim, the m-point forward plan, the m-point inverse plan, stream)
    lib.watfft_bluestein_onepass.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i32, i64,
                                             p, p, p, p, p, p, p, p, ip, ip, i32,
                                             p, p, ip, ip, i32, p]
    lib.watfft_bluestein_onepass.restype = i32
    # (frames, w, out, batch, num, n_fft, hop, len, vec, stream)
    lib.watfft_istft_ola.argtypes = [p, p, p, i64, i64, i32, i64, i64, i32, p]
    lib.watfft_istft_ola.restype = i32
    # (x, row, chans, streams, nfft, row_stride, vec, stream)
    lib.watfft_spec_detect.argtypes = [p, p, i64, i64, i64, i64, i32, p]
    lib.watfft_spec_detect.restype = i32
    # (planes, image, w, taper, layers, n, pixel_scale, first, last, vec, stream)
    lib.watfft_wstack_accum.argtypes = [p, p, p, p, i64, i64, ctypes.c_double, i32, i32, i32, p]
    lib.watfft_wstack_accum.restype = i32
    # the difference map's passes: (psi, obj, probe, pos, t, frames, m, obj_w,
    # stream); (f, amp, err, frames, m, stream); (psi, back, obj, probe, pos,
    # out, sums, frames, m, obj_w, stream); (psi, obj, pos, sums, frames, m,
    # obj_w, stream)
    lib.watfft_ptycho_exit.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, p]
    lib.watfft_ptycho_fourier.argtypes = [p, p, p, i64, i64, p]
    lib.watfft_ptycho_update.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i64, i64, p]
    lib.watfft_ptycho_probe.argtypes = [p, p, p, p, p, i64, i64, i64, i64, p]
    for name in ("exit", "fourier", "update", "probe"):
        getattr(lib, "watfft_ptycho_" + name).restype = i32
    lib.watfft_error_string.argtypes = [i32]
    lib.watfft_error_string.restype = ctypes.c_char_p
    build_info.update(path=str(out), log=log)
    return lib


def use_kernel(t: torch.Tensor, plain: bool = False) -> bool:
    """CUDA tensors launch the kernels; CPU tensors (or plain=True) take the
    plain versions."""
    return t.device.type == "cuda" and not plain


def same_device(tables: torch.device, data: torch.device) -> None:
    """Raises unless the tables are on the data's device."""
    if tables != data:
        raise ValueError(f"tables on {tables}, data on {data}")


def kernel_dtype(t: torch.Tensor, want: torch.dtype) -> None:
    """Raises unless t is of the dtype the kernel takes."""
    if t.dtype != want:
        raise TypeError(f"the CUDA kernel takes {want}, got {t.dtype}")


def launch(key: str, device, entry: str, args: tuple, tail: tuple, what) -> None:
    """One kernel launch: err = lib.<entry>(*args, stream, *tail) on the
    library and the current stream of `device` (every C entry takes the
    stream after its operands and tables, its launch's options after it),
    inside the span `launch.<key>` while a profiler session is active. A
    nonzero err raises RuntimeError with what() (the launch's fields) and
    the library's message, and counts nothing; a launch that succeeds adds
    1 to `trace.launches[key]`. The arguments come as tuples, not as a
    closure: a closure over a wrapper's locals cost the H100's host ~1 µs a
    launch (PERF.md)."""
    lib = library()
    fn = getattr(lib, entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if profiler._is_profiler_enabled:
            span = trace.begin("launch." + key)
            err = fn(*args, stream, *tail)
            trace.end(span)
        else:
            err = fn(*args, stream, *tail)
    if err:
        raise RuntimeError(f"{key} kernel launch failed ({what()}): "
                           f"{lib.watfft_error_string(err).decode()}")
    trace.launches[key] += 1
