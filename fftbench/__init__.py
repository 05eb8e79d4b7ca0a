"""fftbench: the benchmark of watfft_tpu_torch (see README.md)."""
