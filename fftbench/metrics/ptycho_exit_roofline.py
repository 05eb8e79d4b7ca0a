"""The share of its roofline that the exit-wave pass (`csrc/ptycho.cu`): the
frames read, the waves written, the object and the probe read once, reaches
in the difference-map cell's traced slice: `exit_least_bytes` of the
configuration at the HBM peak over the device time under
`launch.ptycho_exit` (`fftbench/ptycho_share.py`). None without that span."""

from fftbench import ptycho_share


def read(run):
    return ptycho_share.share(run, "launch.ptycho_exit", "exit_least_bytes")
