"""The share of the traced slice the host spent inside the port's `h2d`
spans: copies from host memory to the card, which wait for the stream's
queue to drain when the memory is pageable. 0.0 where the port made none."""

from fftbench import spans


def read(run):
    s = spans.port(run)
    if s is None or not s["roots"]:
        return None
    return 100.0 * s["h2d_s"] / run.trace["window_s"]
