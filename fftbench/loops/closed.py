"""The closed loop: one caller, who waits on each request. A synchronize
ends every request, and its latency runs from the issue of its first call to
that synchronize. A kept request's copies are waited for outside any
latency."""

import time

from fftbench import harness


def drive(calls, pool, seconds, device, kept=None, span=harness.nospan, first=0):
    latencies, host = [], []
    perf = time.perf_counter
    i = 0
    t_start = now = perf()
    deadline = t_start + seconds
    while now < deadline:
        k, x = harness.pick(pool, first + i, span)
        t_issue = perf()
        outs = harness.issue(calls, x, span, host)
        with span("sync"):
            harness.sync(device)
        now = perf()
        latencies.append(now - t_issue)
        if kept is not None and kept.offer(i, k, outs):
            harness.sync(device)
        del outs  # the caller holds no output into the next request
        i += 1
    with span("sync"):
        harness.sync(device)
    return {"requests": i, "window_s": perf() - t_start, "latencies_s": latencies,
            "host_call_s": host}
