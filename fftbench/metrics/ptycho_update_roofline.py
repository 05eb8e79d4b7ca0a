"""The share of its roofline that the update with the object's sums
(`csrc/ptycho.cu`): the frames and the inverse transforms read, the new
frames written, the object and the probe read and the object's sums written
once, reaches in the difference-map cell's traced slice:
`update_least_bytes` of the configuration at the HBM peak over the device
time under `launch.ptycho_update` (`fftbench/ptycho_share.py`). None without
that span."""

from fftbench import ptycho_share


def read(run):
    return ptycho_share.share(run, "launch.ptycho_update", "update_least_bytes")
