"""The w-stacking accumulation kernel's least bytes in the traced slice
(each plane's complex64 read once, the image's float32 written once a
request: the configuration's `wstack_least_bytes` of the planes and side of
the port's `imaging.wstack` calls there) at the card's HBM peak
(`peaks.json`), as a share of the device time of the ops launched under the
port's `launch.wstack_accum` span. None without that span, as in a port or
a cell without it."""

from fftbench import spans

KERNEL = "launch.wstack_accum"
ROOT = "imaging.wstack"


def read(run):
    s = spans.port(run)
    least = getattr(run.cell.adapter, "wstack_least_bytes", None)
    bw = run.peaks.get("hbm_bytes_per_s")
    n = run.cell.config.get("n")
    if s is None or least is None or not bw or not n:
        return None
    by = s["by_span"]
    device = by[KERNEL]["device_s"] if KERNEL in by else 0.0
    calls = by[ROOT]["count"] if ROOT in by else 0
    if device <= 0 or not calls:
        return None
    planes = run.points_per_request // (n * n)
    return 100.0 * calls * least(planes, n) / bw / device
