"""Process start to the window's start: imports, the CUDA context, the
kernels' library (built on the checkout's first run), the pool, the warm-up."""


def read(run):
    return run.setup_s
