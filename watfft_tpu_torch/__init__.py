"""watfft_tpu_torch — the PyTorch and CUDA port of watfft_tpu.

The batched f32 complex FFT over power-of-two n = 2..4096 and the f32 real
FFT (rfft / irfft) over n = 4..8192, forward and inverse, behind the JAX
package's plan-once context API, and the STFT pipeline on the real FFT
(`watfft_tpu_torch.stft`). Contexts run on the CUDA device by default,
where every call launches kernels written for Hopper (`ops/csrc/*.cu`,
built with nvcc at first use); with `device="cpu"` they run the kernels'
plain torch versions. Needs torch and numpy, never JAX.
"""

from . import stft
from .api import (FFTContext, RFFTContext, create_fft_f32, create_rfft_f32, fft,
                  ifft, irfft, rfft)

__all__ = ["FFTContext", "RFFTContext", "create_fft_f32", "create_rfft_f32",
           "fft", "ifft", "rfft", "irfft", "stft"]
