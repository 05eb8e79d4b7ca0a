"""The share of the traced slice in which no work ran on the device."""

from fftbench.traces import idle_pct


def read(run):
    return idle_pct(run.trace)
