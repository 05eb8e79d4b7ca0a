"""The share of its roofline that the probe's sums (`csrc/ptycho.cu`): the new
frames read, the object read and the probe's sums written once, reaches in
the difference-map cell's traced slice: `probe_least_bytes` of the
configuration at the HBM peak over the device time under
`launch.ptycho_probe` (`fftbench/ptycho_share.py`). None without that span."""

from fftbench import ptycho_share


def read(run):
    return ptycho_share.share(run, "launch.ptycho_probe", "probe_least_bytes")
