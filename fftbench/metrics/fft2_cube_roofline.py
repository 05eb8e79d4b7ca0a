"""The share of its roofline that the 2D cube (#15, `csrc/fft2.cu`), forward
and inverse, reaches in the traced slice: the cube's least bytes over the
points of the requests there (the configuration's
`cube_least_bytes(points)`; each point's complex64 read and written once a
transform; its `ROOT_SPAN` the port's span of one request) at the card's
HBM peak (`peaks.json`), as a share of the device time of the ops launched
under the port's `launch.fft2_cube` span. None without that span, or for a
configuration that names no `cube_least_bytes` or `ROOT_SPAN`."""

from fftbench import spans

KERNEL = "launch.fft2_cube"


def read(run):
    s = spans.port(run)
    least = getattr(run.cell.adapter, "cube_least_bytes", None)
    root = getattr(run.cell.adapter, "ROOT_SPAN", None)
    bw = run.peaks.get("hbm_bytes_per_s")
    if s is None or least is None or root is None or not bw:
        return None
    by = s["by_span"]
    device = by[KERNEL]["device_s"] if KERNEL in by else 0.0
    calls = by[root]["count"] if root in by else 0
    if device <= 0 or not calls:
        return None
    return 100.0 * least(calls * run.points_per_request) / bw / device
