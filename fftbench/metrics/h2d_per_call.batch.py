"""The port's copies from host memory to the card in the traced slice (its
`h2d` spans) over its calls there (its root spans): an exact count, 0.0
where it made none."""

from fftbench import spans


def read(run):
    s = spans.port(run)
    if s is None or not s["roots"]:
        return None
    return s["h2d_count"] / s["roots"]
