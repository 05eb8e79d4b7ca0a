"""Transform points completed over the whole window, in billions a second
(a point is one of the n samples of one transform, in either direction)."""


def read(run):
    return run.requests * run.points_per_request / run.window_s / 1e9
