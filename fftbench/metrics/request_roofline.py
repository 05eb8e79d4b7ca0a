"""The request's least bytes (inputs read once, outputs written once) at the
card's HBM peak (`peaks.json`), as a share of the device's busy time per
request in the traced slice, every kernel counted: the port's and torch's."""


def read(run):
    t = run.trace
    bw = run.peaks.get("hbm_bytes_per_s")
    if not t or not bw or t["busy_s"] <= 0 or not t["requests"]:
        return None
    return 100.0 * t["requests"] * run.least_bytes_per_request / bw / t["busy_s"]
