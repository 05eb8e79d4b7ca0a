"""The share of the device's work in the traced slice that ran outside the
port's kernels (named by the `__global__` functions of its CUDA sources):
torch's elementwise, indexing and copy kernels and the host's copies."""


def read(run):
    t = run.trace
    if not t or t["device_s"] <= 0:
        return None
    return 100.0 * (t["device_s"] - t["port_s"]) / t["device_s"]
