"""The four-step pipe2 route's least bytes in the traced slice (each of its
two passes reads and writes every transform point's complex64 once: the
configuration's `pipe2_least_bytes` of the points of the port's
`spectrometer.integrate` calls there) at the card's HBM peak (`peaks.json`),
as a share of the device time of the ops launched under the port's
`launch.large_stage1` and `launch.large_stage2` spans (#11 and #13). None
without those spans, as in a port or a cell without them."""

from fftbench import spans

STAGES = ("launch.large_stage1", "launch.large_stage2")
ROOT = "spectrometer.integrate"


def read(run):
    s = spans.port(run)
    least = getattr(run.cell.adapter, "pipe2_least_bytes", None)
    bw = run.peaks.get("hbm_bytes_per_s")
    if s is None or least is None or not bw:
        return None
    by = s["by_span"]
    device = sum(by[k]["device_s"] for k in STAGES if k in by)
    calls = by[ROOT]["count"] if ROOT in by else 0
    if device <= 0 or not calls:
        return None
    return 100.0 * least(calls * run.points_per_request) / bw / device
