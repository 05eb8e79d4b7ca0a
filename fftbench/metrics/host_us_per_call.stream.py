"""The median host time of one call of the port in the window, from
entering it to its return, with no synchronize (the benchmark's span)."""

import statistics


def read(run):
    if not run.host_call_s:
        return None
    return statistics.median(run.host_call_s) * 1e6
