"""watfft_tpu_torch — the PyTorch and CUDA port of watfft_tpu.

The batched f32 complex FFT over power-of-two n >= 2 (the Stockham kernel
to n = 4096, the four-step kernels to 2^24, matmuls past that) and the f32
real FFT (rfft / irfft) over n >= 4, forward and inverse, their f64 tier
(`create_fft`, `create_rfft`, `dtype="float64"`: the FP64 kernels to
n = 4096 and 8192, matmuls past that), behind the JAX package's plan-once
context API, the large-N functions of
`watfft_tpu/ops/large.py` (`fft_large`, `fft_large_nb`, `rfft_large_nb`,
`irfft_large_nb`, `large_split`), the 2D FFT over the trailing [h, w] axes
(`fft2`, `ifft2`, `rfft2`, `irfft2`, `fft2_nb`), the complex FFT of any
length n by the Bluestein chirp-z transform (`bluestein_fft_nb`), the
numpy.fft-style namespace on all of these (`watfft_tpu_torch.fftlib`: any
n, `axis`/`axes`/`s`/`n`/`norm`), the STFT pipeline on the real FFT
(`watfft_tpu_torch.stft`), the small-n FFT as one DFT matrix product
(`dft_matmul_nb`, n <= 128) and the bf16 tiers of the plane transforms
(`ops.stockham.stockham_fft_nb` / `stockham_fft_bm` on bfloat16 planes;
`config.BF16_COMPUTE`, `config.MXU_PRECISION`). Entry points run on the
CUDA device by default, where every call launches kernels written for
Hopper (`ops/csrc/*.cu`,
built with nvcc at first use); with `device="cpu"` they run the kernels'
plain torch versions. Needs torch and numpy, never JAX.
"""

from . import stft
from .api import (FFTContext, RFFTContext, create_fft, create_fft_f32, create_rfft,
                  create_rfft_f32, fft, fft2, ifft, ifft2, irfft, irfft2, rfft, rfft2)
from . import fftlib
from .ops.bluestein import bluestein_fft_nb
from .ops.fft2 import fft2_nb
from .ops.large import fft_large, fft_large_nb, irfft_large_nb, large_split, rfft_large_nb
from .ops.mxu_dft import dft_matmul_nb

__all__ = ["FFTContext", "RFFTContext", "create_fft", "create_fft_f32", "create_rfft",
           "create_rfft_f32",
           "fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2", "fft2_nb",
           "fft_large", "fft_large_nb", "rfft_large_nb", "irfft_large_nb", "large_split",
           "bluestein_fft_nb", "dft_matmul_nb", "fftlib", "stft"]
