"""watfft_tpu_torch — the PyTorch and CUDA port of watfft_tpu.

The batched f32 complex FFT, forward and inverse, over power-of-two
n = 2..4096, behind the JAX package's plan-once context API. CUDA tensors
run a Stockham kernel written for Hopper (`ops/csrc/stockham.cu`, built
with nvcc at first use); CPU tensors run its plain torch version. Needs
torch and numpy, never JAX.
"""

from .api import FFTContext, create_fft_f32, fft, ifft

__all__ = ["FFTContext", "create_fft_f32", "fft", "ifft"]
