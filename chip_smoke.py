"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

Run from the repository root with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. Device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions. Without a CUDA device it stops here with exit code 1.
2. Build: nvcc compiles the Stockham kernel from `watfft_tpu_torch/ops/csrc`.
3. Kernel against its plain torch version on the card, every power-of-two
   n = 2..4096, forward and inverse, at batch 3 and at 2^22/n (limit 1e-6
   of the largest output); at batch 3 also against the f64 numpy oracle
   (MAX_REL 5e-6), and per-bin and roundtrip checks at n = 64, 1024, 4096.
4. Main path at full size: `create_fft_f32(1024, device="cuda")` on a
   [4096, 1024] complex64 tensor (BASELINE config 4) — forward, inverse,
   roundtrip, the plane entry points and a backward — against cuFFT in
   complex128, with the kernel's launch count for that run.
   A conjugated view (`x.conj()`, whose storage holds x) goes through too.
5. Times at 2^22 points per n: the kernel in three layouts, its plain
   version, torch.fft (cuFFT) and a device copy of the same bytes — device
   time (CUDA events, median of 25 after warm-up) and the host's time per
   call.
6. Host time per call at a small batch (8 x 1024, where the host, not the
   card, bounds back-to-back calls): the wrapper without and with autograd,
   `FFTContext.forward` and cuFFT, each over 200 calls.

The line before the last is a JSON object naming each kernel of the path
with its launch count, error and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from watfft_tpu_torch import create_fft_f32
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, PER_BIN, ROUNDTRIP

KERNEL_LIMIT = 1e-6      # kernel vs plain version: max |diff| / max |plain|
POINTS = 1 << 22         # 32 MiB of complex64 per buffer at every n
MAIN_N, MAIN_B = 1024, 4096
SIZES = [1 << k for k in range(1, 13)]


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def card() -> tuple[str, str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(out, flush=True)
    name, limit = (s.strip() for s in out.split(",", 1))
    return name, limit


def rand_complex(shape, gen, dev) -> torch.Tensor:
    re = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    im = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    return torch.complex(re, im)


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def time_ms(fn, reps: int = 25, warmup: int = 3) -> tuple[float, float]:
    """(device_ms, call_ms) of one call. device_ms: median over `reps` CUDA
    event pairs, recorded while the stream is held behind a sleep kernel
    that outlasts the enqueueing, so the host's time to issue a call does
    not show. call_ms: host wall time per call of `reps` back-to-back calls
    ending in a synchronize (what a caller waits, Python included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    call_s = (time.perf_counter() - t0) / reps
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(int(min(reps * call_s * 4e9, 4e10)))  # cycles; > 2x the enqueue time
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev), call_s * 1e3


def phase_kernel_vs_plain(dev, gen) -> None:
    for n in SIZES:
        worst = 0.0
        for batch in (3, POINTS // n):
            x = rand_complex((batch, n), gen, dev)
            xt_re, xt_im = x.real.T.contiguous(), x.imag.T.contiguous()
            for inverse in (False, True):
                y = st.stockham_fft(x, inverse)
                p = st.plain_fft(x, inverse)
                d = rel_diff(y, p)
                tre, tim = st.stockham_fft_nb(xt_re, xt_im, inverse)
                d_nb = rel_diff(torch.complex(tre, tim).T, p)
                worst = max(worst, d, d_nb)
                check(d <= KERNEL_LIMIT and d_nb <= KERNEL_LIMIT,
                      f"n={n} batch={batch} inverse={inverse}: kernel vs plain "
                      f"{d:.3e} (complex) {d_nb:.3e} (time-major)")
                if batch == 3:
                    xs = x.cpu().numpy()
                    exp = ref.idft(xs) if inverse else ref.dft(xs)
                    e = rel_errors(y.cpu().numpy(), exp)[0]
                    check(e <= MAX_REL["float32"],
                          f"n={n} inverse={inverse}: max rel {e:.3e} vs oracle")
        line = {"phase": "kernel_vs_plain", "n": n, "max_rel_diff": worst}
        if n in (64, 1024, 4096):
            t = torch.arange(n, device=dev, dtype=torch.float64)
            basis = torch.exp(2j * torch.pi * torch.outer(t, t) / n).to(torch.complex64)
            eye = n * torch.eye(n, device=dev, dtype=torch.complex64)
            per_bin = (st.stockham_fft(basis) - eye).abs().max().item()
            x = rand_complex((3, n), gen, dev)
            rt = (st.stockham_fft(st.stockham_fft(x), True) - x).abs().max().item()
            check(per_bin < PER_BIN["float32"](n), f"n={n}: per-bin error {per_bin:.3e}")
            check(rt < ROUNDTRIP["float32"], f"n={n}: roundtrip error {rt:.3e}")
            line.update(per_bin_err=per_bin, roundtrip_err=rt)
        print(json.dumps(line), flush=True)


def phase_main_path(dev, gen) -> tuple[int, float]:
    ctx = create_fft_f32(MAIN_N, device="cuda")
    x = rand_complex((MAIN_B, MAIN_N), gen, dev)
    g = rand_complex((MAIN_B, MAIN_N), gen, dev)
    re, im = x.real.contiguous(), x.imag.contiguous()
    re_t, im_t = re.T.contiguous(), im.T.contiguous()
    xg = x.clone().requires_grad_()
    torch.cuda.synchronize()

    st.launches = 0
    y = ctx.forward(x)
    xi = ctx.inverse(x)
    back = ctx.inverse(y)
    pre, pim = ctx.forward_planes(re, im)
    nre, nim = ctx.forward_planes_nb(re_t, im_t)
    ctx.forward(xg).backward(g)
    torch.cuda.synchronize()
    launches = st.launches
    check(launches == 7, f"main path: {launches} kernel launches for 7 calls")

    x128 = x.to(torch.complex128)
    fwd_err = rel_errors(y.cpu().numpy(), torch.fft.fft(x128).cpu().numpy())[0]
    inv_err = rel_errors(xi.cpu().numpy(), torch.fft.ifft(x128).cpu().numpy())[0]
    rt_err = (back - x).abs().max().item()
    planes_diff = max(rel_diff(torch.complex(pre, pim), y),
                      rel_diff(torch.complex(nre, nim).T, y))
    grad_exact = (xg.grad - ctx.inverse(g) * MAIN_N).abs().max().item()
    grad_err = rel_errors(xg.grad.cpu().numpy(),
                          (torch.fft.ifft(g.to(torch.complex128)) * MAIN_N).cpu().numpy())[0]
    max_abs_err = (y - st.plain_fft(x)).abs().max().item()
    conj_err = rel_errors(ctx.forward(x.conj()).cpu().numpy(),
                          torch.fft.fft(x128.conj()).cpu().numpy())[0]
    print(json.dumps({"phase": "main_path", "n": MAIN_N, "batch": MAIN_B,
                      "launches": launches, "fwd_max_rel_vs_cufft_c128": fwd_err,
                      "inv_max_rel_vs_cufft_c128": inv_err, "roundtrip_err": rt_err,
                      "planes_vs_complex": planes_diff, "grad_vs_conj_transform": grad_exact,
                      "grad_max_rel_vs_cufft_c128": grad_err,
                      "kernel_vs_plain_max_abs": max_abs_err,
                      "conj_view_max_rel_vs_cufft_c128": conj_err}), flush=True)
    check(fwd_err <= MAX_REL["float32"], f"main path forward: max rel {fwd_err:.3e}")
    check(inv_err <= MAX_REL["float32"], f"main path inverse: max rel {inv_err:.3e}")
    check(conj_err <= MAX_REL["float32"], f"main path on x.conj(): max rel {conj_err:.3e}")
    check(rt_err < ROUNDTRIP["float32"], f"main path roundtrip: {rt_err:.3e}")
    check(planes_diff <= KERNEL_LIMIT, f"plane entry points vs forward: {planes_diff:.3e}")
    check(grad_exact == 0.0, f"backward vs n * inverse: {grad_exact:.3e}")
    check(grad_err <= MAX_REL["float32"], f"backward vs cuFFT: max rel {grad_err:.3e}")
    check(bool(torch.isfinite(y).all()) and y.shape == x.shape, "main path output")
    return launches, max_abs_err


def phase_times(dev, gen, name: str, limit: str) -> dict:
    times = {}
    for n in SIZES:
        batch = POINTS // n
        x = rand_complex((batch, n), gen, dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        re_t, im_t = re.T.contiguous(), im.T.contiguous()
        out = torch.empty_like(x)
        fns = {
            "kernel_fwd": lambda: st.stockham_fft(x),
            "kernel_inv": lambda: st.stockham_fft(x, True),
            "kernel_planes_bm_fwd": lambda: st.stockham_fft_bm(re, im),
            "kernel_planes_nb_fwd": lambda: st.stockham_fft_nb(re_t, im_t),
            "plain_fwd": lambda: st.plain_fft(x),
            "plain_inv": lambda: st.plain_fft(x, True),
            "cufft_fwd": lambda: torch.fft.fft(x),
            "cufft_inv": lambda: torch.fft.ifft(x),
            "copy": lambda: out.copy_(x),  # the same 16 B per point, no FFT
        }
        row = {}
        for key, fn in fns.items():
            dev_ms, call_ms = time_ms(fn)
            row[key + "_ms"] = dev_ms
            row[key + "_call_ms"] = call_ms
            row[key + "_GBps"] = 16 * POINTS / (dev_ms * 1e-3) / 1e9
        times[n] = row
        print(json.dumps({"phase": "times", "n": n, "batch": batch, **row,
                          "card": name, "power_limit": limit}), flush=True)
    return times


def phase_host(dev, gen, name: str, limit: str) -> None:
    n, batch = MAIN_N, 8
    ctx = create_fft_f32(n, device="cuda")
    x = rand_complex((batch, n), gen, dev)
    xg = x.clone().requires_grad_()
    fns = {
        "wrapper": lambda: st.stockham_fft(x),
        "wrapper_autograd": lambda: st.stockham_fft(xg),
        "ctx_forward": lambda: ctx.forward(x),
        "cufft": lambda: torch.fft.fft(x),
    }
    row = {}
    for key, fn in fns.items():
        dev_ms, call_ms = time_ms(fn, reps=200)
        row[key + "_ms"] = dev_ms
        row[key + "_call_ms"] = call_ms
    print(json.dumps({"phase": "host", "n": n, "batch": batch, **row,
                      "card": name, "power_limit": limit}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name, limit = card()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {nvcc}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"build: {time.perf_counter() - t0:.1f} s -> {info['path']}", flush=True)
    for ln in info["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("  ptxas:", ln.strip(), flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    try:
        phase_kernel_vs_plain(dev, gen)
        launches, max_abs_err = phase_main_path(dev, gen)
        times = phase_times(dev, gen, name, limit)
        phase_host(dev, gen, name, limit)
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    main_t = times[MAIN_N]
    print(json.dumps({"kernels": [{
        "name": "stockham_c2c", "route": "cuda",
        "source": "watfft_tpu_torch/ops/csrc/stockham.cu",
        "replaces": "watfft_tpu/ops/pallas_stockham.py:260",
        "also_replaces": "watfft_tpu/ops/pallas_stockham.py:355",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": main_t["kernel_fwd_ms"], "plain_ms": main_t["plain_fwd_ms"],
        "card": name, "power_limit": limit}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
