"""The share of the traced slice in which the device was idle while the host
was inside one of the port's spans (`watfft_tpu_torch.trace`), each gap put
down to the innermost span the host was in."""

from fftbench import spans


def read(run):
    s = spans.port(run)
    if s is None or not s["roots"] or s["device_s"] <= 0:
        return None
    return 100.0 * s["idle_in_span_s"] / run.trace["window_s"]
