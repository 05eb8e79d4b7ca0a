"""The share of its roofline that one kernel of the difference-map cell
reaches in the traced slice: the kernel's least bytes over the port's
`ptycho.dm` calls there (the configuration's `<kernel>_least_bytes(frames,
m, side)`, at the cell's frames, frame side and object side) at the card's
HBM peak (`peaks.json`), as a share of the device time of the ops launched
under the kernel's `launch.<key>` span. None without that span or without
`ptycho.dm` calls, as in a port or a cell without them."""

from fftbench import spans

ROOT = "ptycho.dm"


def share(run, launch: str, least_name: str):
    s = spans.port(run)
    least = getattr(run.cell.adapter, least_name, None)
    bw = run.peaks.get("hbm_bytes_per_s")
    m, side = run.cell.config.get("m"), run.cell.config.get("object_side")
    if s is None or least is None or not bw or not m or not side:
        return None
    by = s["by_span"]
    device = by[launch]["device_s"] if launch in by else 0.0
    calls = by[ROOT]["count"] if ROOT in by else 0
    if device <= 0 or not calls:
        return None
    frames = run.points_per_request // (2 * m * m)
    return 100.0 * calls * least(frames, m, side) / bw / device
