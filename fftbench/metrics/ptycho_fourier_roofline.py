"""The share of its roofline that the Fourier projection (`csrc/ptycho.cu`):
the transforms read and written, the magnitudes read, reaches in the
difference-map cell's traced slice: `fourier_least_bytes` of the
configuration at the HBM peak over the device time under
`launch.ptycho_fourier` (`fftbench/ptycho_share.py`). None without that
span."""

from fftbench import ptycho_share


def read(run):
    return ptycho_share.share(run, "launch.ptycho_fourier", "fourier_least_bytes")
