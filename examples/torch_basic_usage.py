"""Minimal tour of the PyTorch/CUDA port's surfaces (`watfft_tpu_torch`).

The port's counterpart of examples/basic_usage.py: the complex context on
batch-major and time-major planes, the real context, one large FFT and a
spectrogram, each checked against numpy's FFT, then the kernels launched.
Runs on the CUDA device (the Hopper kernels, built with nvcc at first use);
`--cpu` runs the kernels' plain torch versions. Without a CUDA device and
without `--cpu` it exits 2.

Usage: python examples/torch_basic_usage.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _rel(got, want) -> float:
    """max |got - want| / max |want| of a device tensor and a host array."""
    return float(np.max(np.abs(got.cpu().numpy() - want)) / np.max(np.abs(want)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch

    import watfft_tpu_torch as wt
    from watfft_tpu_torch import stft, trace
    from watfft_tpu_torch.ops.large import fft_large
    from watfft_tpu_torch.tools import device_or_exit

    dev = device_or_exit("--cpu" in argv, "torch_basic_usage")
    before = dict(trace.launches)
    rng = np.random.default_rng(0)

    # 1. context API, complex f32, batch-major planes [batch, n]
    ctx = wt.create_fft_f32(1024, device=dev)
    xre = torch.as_tensor(rng.uniform(-1, 1, (4, 1024)).astype(np.float32), device=dev)
    xim = torch.as_tensor(rng.uniform(-1, 1, (4, 1024)).astype(np.float32), device=dev)
    re, im = ctx.forward_planes(xre, xim)
    want = np.fft.fft(xre.cpu().numpy() + 1j * xim.cpu().numpy())
    print(f"complex forward rel err: {_rel(torch.complex(re, im), want):.3e}")
    rre, rim = ctx.inverse_planes(re, im)
    err = float(torch.max(torch.maximum((rre - xre).abs(), (rim - xim).abs())))
    print(f"complex roundtrip err: {err:.3e}")

    # 2. time-major planes [n, batch]: the kernel walks down columns
    re, im = ctx.forward_planes_nb(xre.T.contiguous(), xim.T.contiguous())
    print(f"time-major output: {tuple(re.shape)} on {re.device}, "
          f"rel err {_rel(torch.complex(re, im).T, want):.3e}")

    # 3. real FFT
    rctx = wt.create_rfft_f32(1024, device=dev)
    sig = torch.as_tensor(rng.uniform(-1, 1, (4, 1024)).astype(np.float32), device=dev)
    sre, sim = rctx.forward_planes(sig)
    print(f"real forward rel err: {_rel(torch.complex(sre, sim), np.fft.rfft(sig.cpu().numpy())):.3e}")
    back = rctx.inverse_planes(sre, sim)
    print(f"real roundtrip err: {float(torch.max((back - sig).abs())):.3e}")

    # 4. large N: one sequence of 2^16 points on flat planes
    big = torch.as_tensor(rng.uniform(-1, 1, 1 << 16).astype(np.float32), device=dev)
    lre, lim = fft_large(big, torch.zeros_like(big))
    print(f"large-N output: {tuple(lre.shape)}, "
          f"rel err {_rel(torch.complex(lre, lim), np.fft.fft(big.cpu().numpy())):.3e}")

    # 5. STFT
    p = stft.spectrogram(sig[0], n_fft=256, hop=64, device=dev)
    print(f"spectrogram: {tuple(p.shape)}")

    if dev == "cuda":
        torch.cuda.synchronize()
    after = dict(trace.launches)
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    print("kernels launched: "
          + (", ".join(f"{k} {v}" for k, v in launched.items()) or "none (the plain versions)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
