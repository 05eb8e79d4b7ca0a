"""Isolated butterfly / single-stage tester for the port's Stockham math.

The port's counterpart of `tools/butterfly_tester.py` (an analog of
tools/butterfly_tester.js of wat-fft: the radix butterflies checked apart
from the algorithm's structure, including the w = 1 and w = -+i special
cases). Here the butterfly is `ops.stockham._small_dft`, the recursive
radix-2 network over R part tensors with constant twiddles, and a stage is
`ops.stockham._stage` (twiddle scaling, small DFT, Stockham interleave):
the plain torch versions the CUDA kernels are held against. Both are
checked alone against O(R^2) numpy oracles in f64, for every radix 2..64
(the port's plans take 2..16, `run_stages` the JAX package's 32 and 64
too) and every (R, l) stage of the port's plans `stage_plan(n)`, forward
and inverse, with the folded 1/n of the last inverse stage. The CUDA stage
templates are held against these plain versions by `chip_smoke.py`.

    python -m watfft_tpu_torch.tools.butterfly_tester [--device cpu|cuda]
        [--radices 2,4,...] [--sizes 2,4,...] [--seed 7] [--batch 16] [--cases 5]

Exit code 0 iff every check passes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.stockham import _small_dft, _stage, make_twiddle_pack, stage_plan
from . import device_or_exit

PROG = "python -m watfft_tpu_torch.tools.butterfly_tester"

TOL = 5e-6  # f32 butterflies vs the f64 oracle, scaled by the radix below


def oracle_dft(parts: np.ndarray, inverse: bool) -> np.ndarray:
    """O(R^2) matrix DFT across the part axis (axis 0), f64."""
    r = parts.shape[0]
    sign = +1.0 if inverse else -1.0
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    return np.tensordot(w, parts, axes=(1, 0))


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def test_small_dft(radices, rng, batch: int, cases: int, device) -> tuple[int, int]:
    """_small_dft against the matrix oracle on random parts and the w = 1
    (all-equal parts) and pure-imaginary patterns; (cases run, failures)."""
    runs = fails = 0
    for r in radices:
        for inverse in (False, True):
            specials = [np.ones((r, batch)) + 0j, np.eye(r, batch) * 1j]
            randoms = [rng.uniform(-1, 1, (r, batch)) + 1j * rng.uniform(-1, 1, (r, batch))
                       for _ in range(cases)]
            for ci, z in enumerate(specials + randoms):
                ore, oim = _small_dft([_f32(z[p].real, device) for p in range(r)],
                                      [_f32(z[p].imag, device) for p in range(r)], inverse)
                got = np.stack([ore[q].cpu().numpy() + 1j * oim[q].cpu().numpy()
                                for q in range(r)])
                err = _rel(got, oracle_dft(z, inverse))
                runs += 1
                if err > TOL * r:
                    print(f"FAIL small_dft R={r} inverse={inverse} case={ci}: err={err:.3e}")
                    fails += 1
    return runs, fails


def oracle_stage(z: np.ndarray, n: int, r: int, l: int, inverse: bool,
                 final_scale: bool) -> np.ndarray:
    """One Stockham stage in f64: part p scaled by w_{R*l}^{p*(row mod l)},
    the R-point DFT across parts, output part p' at rows j*R*l + p'*l + k."""
    sign = +1.0 if inverse else -1.0
    q, g = n // r, n // (r * l)
    parts = z.reshape(r, q, -1).copy()
    k = np.arange(q) % l
    for p in range(1, r):
        parts[p] *= np.exp(1j * sign * 2.0 * np.pi * (p * k) / (r * l))[:, None]
    out = oracle_dft(parts, inverse) / (n if final_scale else 1)
    # [R, g*l, b] -> [g, R, l, b] -> rows j*R*l + p*l + k
    return out.reshape(r, g, l, -1).transpose(1, 0, 2, 3).reshape(n, -1)


def test_stage(sizes, rng, batch: int, device) -> tuple[int, int]:
    """_stage against the f64 oracle for every (R, l) stage of every plan,
    forward and inverse, the last inverse stage with its folded 1/n."""
    runs = fails = 0
    for n in sizes:
        stages = stage_plan(n)
        for inverse in (False, True):
            twre, twim, offsets = make_twiddle_pack(n, inverse)
            z = rng.uniform(-1, 1, (n, batch)) + 1j * rng.uniform(-1, 1, (n, batch))
            for idx, (r, l) in enumerate(stages):
                final = inverse and idx == len(stages) - 1
                tw = None
                if offsets[idx] >= 0:
                    o, rows = offsets[idx], (r - 1) * (n // r)
                    tw = (_f32(twre[o:o + rows, 0], device), _f32(twim[o:o + rows, 0], device))
                ore, oim = _stage(_f32(z.real, device), _f32(z.imag, device), n, r, l, tw,
                                  inverse, 1.0 / n if final else None)
                got = ore.cpu().numpy() + 1j * oim.cpu().numpy()
                err = _rel(got, oracle_stage(z, n, r, l, inverse, final))
                runs += 1
                if err > TOL * r:
                    print(f"FAIL stage n={n} idx={idx} (R={r}, l={l}) inverse={inverse}: "
                          f"err={err:.3e}")
                    fails += 1
    return runs, fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--radices", default="2,4,8,16,32,64")
    ap.add_argument("--sizes", default=",".join(str(1 << k) for k in range(1, 14)))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--cases", type=int, default=5)
    args = ap.parse_args(argv)
    device = device_or_exit(args.device == "cpu", PROG)
    radices = [int(s) for s in args.radices.split(",")]
    sizes = [int(s) for s in args.sizes.split(",")]
    rng = np.random.default_rng(args.seed)
    n_dft, f_dft = test_small_dft(radices, rng, args.batch, args.cases, device)
    n_stage, f_stage = test_stage(sizes, rng, args.batch, device)
    if f_dft or f_stage:
        print(f"{f_dft + f_stage} of {n_dft + n_stage} cases FAILED")
        return 1
    print(f"OK on {device}: {n_dft} isolated small-DFT cases (radices {radices}, w=1/+-j "
          f"specials included) and {n_stage} isolated stage cases (fwd+inv, folded 1/n "
          f"finals) all match the f64 oracle")
    return 0


if __name__ == "__main__":
    sys.exit(main())
