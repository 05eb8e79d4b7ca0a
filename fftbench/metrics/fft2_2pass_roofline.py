"""The 2D two-pass route's least bytes in the traced slice (each of its
passes reads and writes every image point's complex64 once: the
configuration's `fft2_least_bytes` of the points of the port's
`imaging.wstack` calls there) at the card's HBM peak (`peaks.json`), as a
share of the device time of the ops launched under the port's
`launch.fft2_cols` span (the column pass, #11) and `launch.stockham_c2c`
span (the row pass, #16: the c2c kernel's launch, which the launch table
also counts as `fft2_rows`; in the imager's cell nothing else launches
it). None without those spans, as in a port or a cell without them."""

from fftbench import spans

PASSES = ("launch.fft2_cols", "launch.stockham_c2c")
ROOT = "imaging.wstack"


def read(run):
    s = spans.port(run)
    least = getattr(run.cell.adapter, "fft2_least_bytes", None)
    bw = run.peaks.get("hbm_bytes_per_s")
    if s is None or least is None or not bw:
        return None
    by = s["by_span"]
    device = sum(by[k]["device_s"] for k in PASSES if k in by)
    calls = by[ROOT]["count"] if ROOT in by else 0
    if device <= 0 or not calls:
        return None
    return 100.0 * least(calls * run.points_per_request) / bw / device
