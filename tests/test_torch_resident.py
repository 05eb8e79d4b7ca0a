"""The host side of the redesigned kernels: the cube (#12, ops/large.py
`cube_threads`, `complex_pairs`, `cube_launch`) and the fused f32 r2c
kernel (#9, ops/rfft.py `r2c_launch`). The host picks each launch's block,
walk and 8-byte accesses and passes them; the kernels refuse what they do
not take. Here: the rules, and the arguments each wrapper passes, recorded
by a stand-in library, on the CPU. No JAX is needed: the helpers are host
arithmetic. The kernels themselves, and their refusals, run on the card
(tests/test_torch_cuda.py, chip_smoke.py, scripts/compare_kernel_builds.py).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from watfft_tpu_torch import planner
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import large as lg
from watfft_tpu_torch.ops import rfft as rf


# -- the cube's block and copies -----------------------------------------------------

def test_cube_threads_rule():
    """Two blocks of 256 threads an SM where two sequences fit its shared
    memory (68 KB each at n = 8192), else one of 512 (136 KB at 16384)."""
    assert lg.cube_threads(1 << 13) == 256
    assert lg.cube_threads(1 << 14) == 512

    def block(n):
        return (n + n // 16) * 8 + lg.SMEM_BLOCK_RESERVED
    assert 2 * block(1 << 13) <= lg.SMEM_SM_BYTES < 2 * block(1 << 14)


@pytest.mark.parametrize("x,pairs", [
    ((0, 4, 2, 2 * 8192), True),          # interleaved complex64
    ((8, 12, 2, 2 * 8192), True),
    ((4, 8, 2, 2 * 8192), False),         # re 4 bytes off 8-byte alignment
    ((0, 4, 2, 8193), False),             # an odd batch stride
    ((0, 4, 1, 8192), False),             # planes that happen to sit 4 bytes apart
    ((0, 65536, 1, 8192), False),         # split planes
    ((0, 65536, 5, 1), False),            # time-major planes
    ((0, 4, 3, 2 * 8192), False),         # an odd point stride
])
def test_cube_copies_pairs_only_when_aligned(x, pairs):
    assert lg.complex_pairs(*x) is pairs
    assert lg.cube_launch(8192, x, x) == (256, int(pairs), int(pairs))


# -- the arguments the wrappers pass, through a stand-in library ---------------------

class _Recorder:
    """A stand-in for the kernels' library: records each launch's arguments
    by entry point and returns 0 (the outputs are left as allocated)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(lg, "_use_kernel", lambda t, plain: not plain)
    monkeypatch.setattr(rf, "_use_kernel", lambda t: True)
    return lib


def _f32(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, shape)
                            .astype(np.float32))


def _cube_args(lib):
    """(x side, y side, batch, (threads, pairs_x, pairs_y)) of the last cube
    launch; a side is (re address, im address, point stride, batch
    stride)."""
    (name, a), = [c for c in lib.calls if c[0] == "watfft_large_cube"][-1:]
    xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb = a[:8]
    return (xre, xim, x_sn, x_sb), (yre, yim, y_sn, y_sb), a[10], a[-3:]


@pytest.mark.parametrize("n", [1 << 13, 1 << 14])
@pytest.mark.parametrize("layout", ["complex", "bm", "nb"])
def test_cube_launch_arguments(n, layout, recorder):
    """The block by n; 8-byte copies and stores on interleaved complex64
    only."""
    batch = 3
    x = torch.complex(_f32((batch, n), 1), _f32((batch, n), 2))
    if layout == "complex":
        lg.fft_large_complex(x, mode="cube")
    elif layout == "bm":
        lg.fft_large_bm(x.real.contiguous(), x.imag.contiguous(), mode="cube")
    else:
        lg.fft_large_nb(x.real.T.contiguous(), x.imag.T.contiguous(), mode="cube")
    xs, ys, b, launch = _cube_args(recorder)
    pairs = int(layout == "complex")
    assert b == batch and launch == (lg.cube_threads(n), pairs, pairs)
    strides = {"complex": (2, 2 * n), "bm": (1, n), "nb": (batch, 1)}[layout]
    assert xs[2:] == ys[2:] == strides


def test_cube_launch_on_misaligned_views(recorder):
    n, batch = 1 << 13, 7
    flat, out = _f32(2 * n * batch + 3), torch.zeros(2 * n * batch + 3)
    views = [torch.as_strided(t, (n, batch), (2, 2 * n), o)
             for t, o in ((flat, 1), (flat, 2), (out, 0), (out, 1))]
    lg.fft_large_views(*views, mode="cube")
    _, _, b, launch = _cube_args(recorder)
    assert (b, launch) == (batch, (256, 0, 1))   # the input 4 bytes off, the output not


def test_real_large_route_runs_the_cube_on_pairs(recorder):
    """The large real route's m = 8192 core reads the signal's even and odd
    rows: re and im 4 bytes apart, 8 bytes a point."""
    x = _f32((5, 1 << 14))
    lg.rfft_large(x)
    xs, _, b, launch = _cube_args(recorder)
    assert b == 5 and xs[1] == xs[0] + 4 and xs[2:] == (2, 1 << 14)
    assert launch[:2] == (256, 1)


# -- the r2c kernel's walk and accesses ----------------------------------------------

@pytest.mark.parametrize("layout,pairs", [
    ("complex", (1, 1)), ("bm", (1, 0)), ("nb", (0, 0)), ("misaligned", (0, 1))])
@pytest.mark.parametrize("n", [4, 8, 16, 32, 1024, 8192])
def test_r2c_launch_arguments(n, layout, pairs, recorder):
    """The engine's walk up to R2C_ENGINE_MAX_N with no 8-byte accesses;
    the resident kernel past it, with 8-byte copies of contiguous aligned
    rows and 8-byte stores into interleaved complex64."""
    batch = 6
    flat = _f32(batch * n + 1)
    x = flat[:-1].view(batch, n)
    if layout == "complex":
        rf.rfft(x)
    elif layout == "bm":
        rf.rfft_bm(x)
    elif layout == "nb":
        rf.rfft_nb_fused(x.T.contiguous())
    else:
        rf.rfft(flat[1:].view(batch, n))           # rows 4 bytes off 8-byte alignment
    (name, a), = recorder.calls[-1:]
    assert name == "watfft_rfft_r2c"
    assert a[7:9] == (n, batch)
    if n <= rf.R2C_ENGINE_MAX_N:
        assert a[-3:] == (rf.WALK_ENGINE, 0, 0)
    else:
        assert a[-3:] == (rf.WALK_RESIDENT, *pairs)


def test_r2c_f64_takes_no_walk(recorder):
    rf.rfft(_f32((3, 1024)).double())
    (name, a), = recorder.calls[-1:]
    assert name == "watfft_rfft_r2c_f64" and len(a) == 17


@pytest.mark.parametrize("x,pairs", [
    ((0, 1, 1024), 1),         # contiguous rows, 8-byte aligned
    ((4, 1, 1024), 0),         # 4 bytes off
    ((0, 1, 1023), 0),         # an odd row stride
    ((0, 2, 1), 0),            # time-major
    ((0, 6, 1), 0),
])
def test_r2c_copies_pairs_only_from_contiguous_aligned_rows(x, pairs):
    assert rf.r2c_launch(1024, x, (0, 4, 2, 1026)) == (rf.WALK_RESIDENT, pairs, 1)


# -- the planner ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << 13, 1 << 14])
def test_planner_sends_the_cube_what_it_won(n):
    """planner.large_mode at the crossovers the card measured: the cube at
    every batch on interleaved or batch-major data, and on time-major
    planes up to CUBE_NB_MAX_BATCH sequences."""
    most_nb = planner.CUBE_NB_MAX_BATCH[n]
    for batch in (1, 2, 4, 1024, None):
        assert planner.large_mode(n, batch) == "cube"
    for batch in range(1, most_nb + 1):
        assert planner.large_mode(n, batch, time_major=True) == "cube"
    assert planner.large_mode(n, most_nb + 1, time_major=True) == "pipe2"
    assert planner.large_mode(n, None, time_major=True) == "cube"
    assert planner.large_mode(2 * planner.CUBE_MAX_N, 1024) == "pipe2"
