"""Check that the c2c and real CUDA kernels of two checkouts agree bit for bit.

Builds the port's CUDA library from this checkout and from another one (for
example the parent commit, unpacked with `git archive` into a directory
that .gitignore lists) and runs both libraries on the same inputs through
their C entry points:

* `watfft_stockham_c2c` at every n = 2..4096, forward and inverse, in the
  interleaved complex64 and time-major planes layouts;
* `watfft_rfft_r2c` and `watfft_irfft_c2r` at every n = 4..8192, in the
  batch-major layout,

at batch 3 and at 2^20/n transforms, with this checkout's tables for both.
The outputs are compared with torch.equal. Needs one CUDA device:

    python3 scripts/compare_kernel_builds.py OTHER_CHECKOUT

Prints one JSON line and exits 1 if any output differs.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from watfft_tpu_torch.ops import _build  # noqa: E402
from watfft_tpu_torch.ops import rfft as rf  # noqa: E402
from watfft_tpu_torch.ops import stockham as st  # noqa: E402

POINTS = 1 << 20


def other_library(checkout: Path):
    spec = importlib.util.spec_from_file_location(
        "other_build", checkout / "watfft_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def c2c(lib, x, inverse, time_major):
    batch, n = x.shape
    t = st.device_tables(n, inverse, x.device)
    stream = torch.cuda.current_stream().cuda_stream
    if time_major:
        re, im = x.real.T.contiguous(), x.imag.T.contiguous()
        ore, oim = torch.empty_like(re), torch.empty_like(im)
        args = (re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), batch, 1, batch, 1)
        out = (ore, oim)
    else:
        y = torch.empty_like(x)
        xp, yp = x.data_ptr(), y.data_ptr()
        args = (xp, xp + 4, yp, yp + 4, 2, 2 * n, 2, 2 * n)
        out = (y,)
    err = lib.watfft_stockham_c2c(*args, n, batch, t.twre.data_ptr(), t.twim.data_ptr(),
                                  t.c_radices, t.c_offsets, len(t.stages), int(inverse), stream)
    assert err == 0, err
    return out


def r2c(lib, x):
    batch, n = x.shape
    rt = rf.device_rtables(n, False, x.device)
    c = rt.core
    yre = x.new_empty(batch, n // 2 + 1)
    yim = torch.empty_like(yre)
    err = lib.watfft_rfft_r2c(x.data_ptr(), 1, n, yre.data_ptr(), yim.data_ptr(), 1, n // 2 + 1,
                              n, batch, c.twre.data_ptr(), c.twim.data_ptr(), c.c_radices,
                              c.c_offsets, len(c.stages), rt.wre.data_ptr(), rt.wim.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return yre, yim


def c2r(lib, sre, sim):
    batch, m1 = sre.shape
    n = 2 * (m1 - 1)
    rt = rf.device_rtables(n, True, sre.device)
    c = rt.core
    y = sre.new_empty(batch, n)
    err = lib.watfft_irfft_c2r(sre.data_ptr(), sim.data_ptr(), 1, m1, y.data_ptr(), 1, n, n,
                               batch, c.twre.data_ptr(), c.twim.data_ptr(), c.c_radices,
                               c.c_offsets, len(c.stages), rt.wre.data_ptr(), rt.wim.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return (y,)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernel_builds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = (_build.library(), other_library(Path(sys.argv[1]).resolve()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    cases, differ = {"c2c": 0, "r2c": 0, "c2r": 0}, []

    def same(kind, what, outs):
        cases[kind] += 1
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            differ.append(f"{kind} {what}")

    for n in (1 << k for k in range(1, 13)):
        for batch in (3, POINTS // n):
            x = torch.complex(rand((batch, n)), rand((batch, n)))
            for inverse in (False, True):
                for tm in (False, True):
                    same("c2c", (n, batch, inverse, tm), [c2c(lib, x, inverse, tm) for lib in libs])
    for n in (1 << k for k in range(2, 14)):
        for batch in (3, POINTS // n):
            x = rand((batch, n))
            sre, sim = rand((batch, n // 2 + 1)), rand((batch, n // 2 + 1))
            same("r2c", (n, batch), [r2c(lib, x) for lib in libs])
            same("c2r", (n, batch), [c2r(lib, sre, sim) for lib in libs])
    torch.cuda.synchronize()
    print(json.dumps({"bit_identical": not differ, "cases": cases, "differ": differ[:20],
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
