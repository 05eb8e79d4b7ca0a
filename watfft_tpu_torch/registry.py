"""Surface registry: every implementation of the port, for the tests, the
tools and `chip_smoke.py` to enumerate.

The port's counterpart of `watfft_tpu/registry.py` (itself a port of
benchmarks/shared/wat-surfaces.mjs of wat-fft, which exists because a stale
benchmark once mis-reported results for two generations): every kernel
surface is registered here, and the tests spot-check every entry against
the f64 oracle and its JAX counterpart (`JAX_NAME`), so no kernel escapes
validation. Each public surface has exactly one flagship, the
planner-dispatched entry points.

Surfaces: complex-forward, complex-inverse, real-forward, real-inverse,
each in float32 and float64 (bfloat16 for the bf16 tier).

`make(n, device="cuda")` returns a transform of a host array [..., n]
(complex for the complex surfaces and the real inverse, whose input is the
n//2+1 bins; real for the real forward) that returns a torch tensor on
`device`: complex [..., n] or [..., n//2+1], or real [..., n] for the real
inverse. On "cuda" every non-baseline entry launches the Hopper kernels its
name says (or, for `fourstep-matmul`, cuBLAS matmuls, as the JAX package
runs that surface in XLA); "cpu" runs the kernels' plain versions. The
ranges are what each function takes on the card. The JAX adapters' padding
of the batch to 128 lanes is a TPU workaround and is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import api, planner, trace
from .ops import bluestein, large, mxu_dft, rfft, stockham
from .ops.stockham import check_device

__all__ = ["SurfaceEntry", "REGISTRY", "SURFACES", "JAX_NAME", "COUNTERS", "entries",
           "flagship", "launches", "launch_counts"]

SURFACES = ("complex-forward", "complex-inverse", "real-forward", "real-inverse")

# The port's entry names and the JAX registry's names of the same surfaces.
JAX_NAME = {
    "stockham-cuda": "stockham-pallas",
    "stockham-bf16": "stockham-bf16",
    "rfft-hybrid": "rfft-pallas",
    "fp64-cuda": "doublefloat-pallas",
    "fp64-rfft": "doublefloat-rfft",
    "rfft-fused": "rfft-pallas-fused",
    "bluestein": "bluestein",
    "rfft-large": "rfft-large",
    "dft-mma": "mxu-dft",
    "large-nb": "large-nb",
    "dispatch": "dispatch",
    "fourstep-matmul": "fourstep-mxu",
    "torch-fft": "jnp-fft",
}

# The launch counters each entry's kernels raise on the card, by their
# names in `trace.launches`. `dispatch` may take any route; the matmul
# surface and the baseline launch no kernel of the port.
_C2C = ("stockham_c2c",)
_BF16 = ("stockham_c2c_bf16", "stockham_c2c_bf16c")
_F64 = ("stockham_c2c_f64",)
_HYBRID = ("real_core_fwd", "real_core_inv")
_FUSED = ("rfft_r2c_fused", "irfft_c2r_fused")
_FUSED_F64 = ("rfft_r2c_fused_f64", "irfft_c2r_fused_f64")
_LARGE = ("large_stage1", "large_stage2", "large_cube", "large_postmul", "large_outer")
_BLUESTEIN = ("bluestein_fwd", "bluestein_inv", "bluestein_onepass") + _LARGE
_DFT = ("mxu_dft",)
COUNTERS = {
    "stockham-cuda": _C2C, "stockham-bf16": _BF16, "rfft-hybrid": _HYBRID, "fp64-cuda": _F64,
    "fp64-rfft": _FUSED_F64, "rfft-fused": _FUSED, "bluestein": _BLUESTEIN,
    "rfft-large": _LARGE, "dft-mma": _DFT, "large-nb": _LARGE,
    "dispatch": _C2C + _BF16 + _F64 + _HYBRID + _FUSED + _FUSED_F64 + _BLUESTEIN + _DFT
    + ("fft2_cube", "fft2_cols", "fft2_k2", "fft2_rows"),
    "fourstep-matmul": (), "torch-fft": (),
}


def launches(name: str) -> int:
    """The launches so far of the counters of entry `name` (`COUNTERS`):
    read before and after a call, their difference is what the call
    launched."""
    return sum(trace.launches[k] for k in COUNTERS[name])


def launch_counts() -> dict:
    """Every kernel launch counter of the port by name ("stockham_c2c",
    "rfft_r2c_fused", "large_cube", "fft2_cols", ...; `trace.launches`):
    read before and after a call, the differences say which kernels it
    launched."""
    return dict(trace.launches)


@dataclass(frozen=True)
class SurfaceEntry:
    name: str          # implementation name
    surface: str       # one of SURFACES
    dtype: str         # float32 | float64 | bfloat16
    min_size: int
    max_size: int
    flagship: bool     # the implementation dispatched by the public API
    baseline: bool     # the library baseline (torch.fft), never flagship
    make: Callable[..., Callable[[np.ndarray], torch.Tensor]]
    # make(n, device="cuda") -> transform: host array [..., n-ish] -> tensor


_REAL = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def _planes_nb(x, dtype: torch.dtype, device):
    """Host [..., k] -> time-major (re, im) planes [k, b] of `dtype` on
    `device`, and the input's leading shape."""
    x = np.asarray(x)
    x2 = np.atleast_2d(x)
    x2 = x2.reshape(-1, x2.shape[-1])
    re = torch.as_tensor(np.ascontiguousarray(x2.real.T), device=device).to(dtype)
    im = torch.as_tensor(np.ascontiguousarray(np.imag(x2).T), device=device).to(dtype)
    return re, im, x.shape[:-1]


def _real_nb(x, dtype: torch.dtype, device):
    x = np.asarray(x)
    x2 = np.atleast_2d(np.real(x))
    x2 = x2.reshape(-1, x2.shape[-1])
    return torch.as_tensor(np.ascontiguousarray(x2.T), device=device).to(dtype), x.shape[:-1]


def _from_nb(re, im, lead) -> torch.Tensor:
    """Time-major output planes [k, b] (im None for a real output) ->
    [*lead, k]; bfloat16 widened to float32 (no bf16 complex dtype)."""
    if re.dtype == torch.bfloat16:
        re, im = re.float(), None if im is None else im.float()
    out = re if im is None else torch.complex(re, im)
    return out.T.reshape(*lead, out.shape[0])


def _nb_c2c(fn, dtype: str, inverse: bool):
    """A c2c function on time-major planes: fn(xre, xim, inverse)."""
    def make(n: int, device="cuda"):
        dev = check_device(device)

        def run(x):
            re, im, lead = _planes_nb(x, _REAL[dtype], dev)
            return _from_nb(*fn(re, im, inverse), lead)
        return run
    return make


def _nb_real(fwd, inv, dtype: str, direction: str):
    """A real pair on time-major planes: fwd(x) -> (re, im), inv(re, im) -> x."""
    def make(n: int, device="cuda"):
        dev = check_device(device)

        def run(x):
            if direction == "forward":
                xt, lead = _real_nb(x, _REAL[dtype], dev)
                return _from_nb(*fwd(xt), lead)
            re, im, lead = _planes_nb(x, _REAL[dtype], dev)
            return _from_nb(inv(re, im), None, lead)
        return run
    return make


_contexts: dict = {}


def _context(kind: str, n: int, dtype: str, device):
    key = (kind, n, dtype, str(device))
    if key not in _contexts:
        cls = api.FFTContext if kind == "c2c" else api.RFFTContext
        _contexts[key] = cls(n, dtype, device)
    return _contexts[key]


def _mk(kind: str, direction: str, dtype: str, dispatched: bool):
    """The context API on batch-major planes (`forward_planes` /
    `inverse_planes`): the planner's route where `dispatched`, else the
    matmul surface (`forward_planes_fourstep` / `inverse_planes_fourstep`)."""
    def make(n: int, device="cuda"):
        ctx = _context(kind, n, dtype, device)
        suffix = "_planes" if dispatched else "_planes_fourstep"
        fn = getattr(ctx, ("forward" if direction == "forward" else "inverse") + suffix)
        rdt = _REAL[dtype]

        def run(x):
            x = np.asarray(x)
            re = torch.as_tensor(np.ascontiguousarray(np.real(x)), device=ctx.device).to(rdt)
            if kind == "r2c" and direction == "forward":
                return torch.complex(*fn(re))
            im = torch.as_tensor(np.ascontiguousarray(np.imag(x)), device=ctx.device).to(rdt)
            out = fn(re, im)
            return out if kind == "r2c" else torch.complex(*out)
        return run
    return make


def _mk_torch_fft(surface: str, dtype: str):
    """torch.fft, the library baseline: the whole transform on the device
    from the host array, as the port's surfaces are charged."""
    def make(n: int, device="cuda"):
        dev = check_device(device)
        cdt = _REAL[dtype].to_complex()

        def run(x):
            x = np.asarray(x)
            if surface == "real-forward":
                return torch.fft.rfft(torch.as_tensor(np.real(x), device=dev).to(_REAL[dtype]))
            z = torch.as_tensor(x, device=dev).to(cdt)
            if surface == "complex-forward":
                return torch.fft.fft(z)
            if surface == "complex-inverse":
                return torch.fft.ifft(z)
            return torch.fft.irfft(z, n=n)
        return run
    return make


def _pair(surface: str):
    return {"complex-forward": ("forward", False), "complex-inverse": ("inverse", True),
            "real-forward": ("forward", False), "real-inverse": ("inverse", True)}[surface]


def _build_registry() -> list[SurfaceEntry]:
    out: list[SurfaceEntry] = []
    c2c = ("complex-forward", "complex-inverse")
    real = ("real-forward", "real-inverse")
    top, rtop = planner.STOCKHAM_MAX_N, planner.RFFT_MAX_N

    def add(name, surfaces, dtype, lo, hi, make_of, flag=False, base=False):
        for surface in surfaces:
            out.append(SurfaceEntry(name=name, surface=surface, dtype=dtype, min_size=lo,
                                    max_size=hi, flagship=flag, baseline=base,
                                    make=make_of(surface)))

    # the c2c kernel (#1/#2) on time-major planes, and its bf16 tier (the
    # interop instance; the compute instance under config.BF16_COMPUTE)
    add("stockham-cuda", c2c, "float32", 2, top,
        lambda s: _nb_c2c(stockham.stockham_fft_nb, "float32", _pair(s)[1]))
    add("stockham-bf16", c2c, "bfloat16", 2, top,
        lambda s: _nb_c2c(stockham.stockham_fft_nb, "bfloat16", _pair(s)[1]))
    # the hybrid real FFT: the c2c kernel through strides on the m-point core
    add("rfft-hybrid", real, "float32", 4, rtop,
        lambda s: _nb_real(rfft.rfft_nb, rfft.irfft_nb, "float32", _pair(s)[0]))
    # the FP64 instances of the c2c kernel (#19) and of the fused real kernels
    add("fp64-cuda", c2c, "float64", 2, top,
        lambda s: _nb_c2c(stockham.stockham_fft_nb, "float64", _pair(s)[1]))
    add("fp64-rfft", real, "float64", 4, rtop,
        lambda s: _nb_real(rfft.rfft_nb_fused, rfft.irfft_nb_fused, "float64", _pair(s)[0]))
    # the fused real kernels (#9 / #10)
    add("rfft-fused", real, "float32", 4, rtop,
        lambda s: _nb_real(rfft.rfft_nb_fused, rfft.irfft_nb_fused, "float32", _pair(s)[0]))
    # any n by the chirp-z transform: the one-pass kernel to n = 2048, the
    # four-step kernels on the m-point convolution past it (pow2 sizes here)
    add("bluestein", c2c, "float32", 1, 1 << 20,
        lambda s: _nb_c2c(bluestein.bluestein_fft_nb, "float32", _pair(s)[1]))
    # the large real path: the m = n/2 core on the four-step kernels
    add("rfft-large", real, "float32", 2 * planner.LARGE_MIN_N, planner.RFFT_LARGE_MAX_N,
        lambda s: _nb_real(large.rfft_large_nb, large.irfft_large_nb, "float32", _pair(s)[0]))
    # the small-n DFT as one matrix product (#20); no route reaches it
    add("dft-mma", c2c, "float32", 1, 128,
        lambda s: _nb_c2c(mxu_dft.dft_matmul_nb, "float32", _pair(s)[1]))
    # the batched four-step on the large kernels (#11 and #13, or the cube #12)
    add("large-nb", c2c, "float32", planner.LARGE_MIN_N, planner.LARGE_MAX_N,
        lambda s: _nb_c2c(large.fft_large_nb, "float32", _pair(s)[1]))
    for dtype in ("float32", "float64"):
        for surface in SURFACES:
            kind = "c2c" if surface.startswith("complex") else "r2c"
            lo, direction = (2 if kind == "c2c" else 4), _pair(surface)[0]
            add("dispatch", (surface,), dtype, lo, 1 << 20,
                lambda s, k=kind, d=direction, t=dtype: _mk(k, d, t, True), flag=True)
            add("fourstep-matmul", (surface,), dtype, lo, 1 << 20,
                lambda s, k=kind, d=direction, t=dtype: _mk(k, d, t, False))
            add("torch-fft", (surface,), dtype, lo, 1 << 20,
                lambda s, t=dtype: _mk_torch_fft(s, t), base=True)
    return out


REGISTRY: list[SurfaceEntry] = _build_registry()


def entries(surface: Optional[str] = None, dtype: Optional[str] = None,
            include_baselines: bool = False) -> list[SurfaceEntry]:
    return [e for e in REGISTRY
            if (surface is None or e.surface == surface)
            and (dtype is None or e.dtype == dtype)
            and (include_baselines or not e.baseline)]


def flagship(surface: str, dtype: str) -> SurfaceEntry:
    f = [e for e in entries(surface, dtype) if e.flagship]
    if len(f) != 1:
        raise RuntimeError(f"expected exactly one flagship for {surface}/{dtype}, got {len(f)}")
    return f[0]
