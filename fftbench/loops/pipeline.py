"""The pipeline: requests enqueued back to back, none waited on, as a
pipeline hands its stages fresh data. One synchronize ends the window, so
the window holds all the work it issued."""

import time

from fftbench import harness


def drive(calls, pool, seconds, device, kept=None, span=harness.nospan, first=0):
    host = []
    perf = time.perf_counter
    i = 0
    t_start = now = perf()
    deadline = t_start + seconds
    while now < deadline:
        k, x = harness.pick(pool, first + i, span)
        outs = harness.issue(calls, x, span, host)
        now = perf()
        if kept is not None:
            kept.offer(i, k, outs)
        del outs  # the caller holds no output into the next request
        i += 1
    with span("sync"):
        harness.sync(device)
    return {"requests": i, "window_s": perf() - t_start, "latencies_s": [],
            "host_call_s": host}
