"""The host side of the redesigned kernels: the cube (#12, ops/large.py
`cube_threads`, `cube_launch`), the fused r2c kernel in f32 (#9) and FP64
(ops/rfft.py `r2c_launch`) and the batch-major walk of the c2c kernel
(ops/stockham.py `c2c_launch`, `complex_pairs`). The host picks each
launch's block, walk and one-point accesses and passes them; the kernels
refuse what they do not take. Here: the rules, and the arguments each
wrapper passes, recorded by a stand-in library, on the CPU. No JAX is
needed: the helpers are host arithmetic. The kernels themselves, and their
refusals, run on the card (tests/test_torch_cuda.py, chip_smoke.py,
scripts/compare_kernel_builds.py).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from watfft_tpu_torch import planner
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import fft2 as f2
from watfft_tpu_torch.ops import large as lg
from watfft_tpu_torch.ops import rfft as rf
from watfft_tpu_torch.ops import stockham as st


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
    monkeypatch.setattr(st, "_use_kernel", lambda t, plain=False: not plain)
    monkeypatch.setattr(f2, "_use_kernel", lambda t, plain: not plain)
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


@pytest.mark.parametrize("layout,pairs", [
    ("complex", (1, 1)), ("bm", (1, 0)), ("nb", (0, 0)), ("misaligned", (0, 1))])
@pytest.mark.parametrize("n", [4, 8, 16, 1024, 8192])
def test_r2c_f64_launch_arguments(n, layout, pairs, recorder):
    """The FP64 r2c takes a block a tile at every n, with one 16-byte copy
    of each pair of contiguous rows aligned to 16 bytes and one 16-byte
    store a bin into interleaved complex128."""
    batch = 6
    flat = _f32(batch * n + 1).double()
    x = flat[:-1].view(batch, n)
    if layout == "complex":
        rf.rfft(x)
    elif layout == "bm":
        rf.rfft_bm(x)
    elif layout == "nb":
        rf.rfft_nb_fused(x.T.contiguous())
    else:
        rf.rfft(flat[1:].view(batch, n))           # rows 8 bytes off 16-byte alignment
    (name, a), = recorder.calls[-1:]
    assert name == "watfft_rfft_r2c_f64" and len(a) == 20
    assert a[7:9] == (n, batch)
    assert a[-3:] == (rf.WALK_BLOCK, *pairs)


@pytest.mark.parametrize("x,pairs", [
    ((0, 1, 1024), 1),         # contiguous rows, 8-byte aligned
    ((4, 1, 1024), 0),         # 4 bytes off
    ((0, 1, 1023), 0),         # an odd row stride
    ((0, 2, 1), 0),            # time-major
    ((0, 6, 1), 0),
])
def test_r2c_copies_pairs_only_from_contiguous_aligned_rows(x, pairs):
    assert rf.r2c_launch(1024, x, (0, 4, 2, 1026)) == (rf.WALK_RESIDENT, pairs, 1)
    xd = (2 * x[0], *x[1:])                    # the same rows of float64
    assert rf.r2c_launch(1024, xd, (0, 8, 2, 1026), 8) == (rf.WALK_BLOCK, pairs, 1)


# -- the c2c kernel's batch-major walk -----------------------------------------------

@pytest.mark.parametrize("size,side,pairs", [
    (4, (0, 4, 2, 2048), True),            # interleaved complex64
    (4, (8, 12, 2, 2048), True),
    (4, (4, 8, 2, 2048), False),           # 4 bytes off 8-byte alignment
    (4, (0, 4, 2, 2049), False),           # an odd batch stride
    (4, (0, 4, 1, 1024), False),           # planes that happen to sit 4 bytes apart
    (8, (0, 8, 2, 2048), True),            # interleaved complex128
    (8, (16, 24, 2, 2048), True),
    (8, (8, 16, 2, 2048), False),          # 8 bytes off 16-byte alignment
    (8, (0, 4, 2, 2048), False),           # im 4 bytes on: not a float64 pair
    (8, (0, 8, 3, 2048), False),           # an odd point stride
    (8, (0, 8 * 1024, 1, 1024), False),    # split planes
])
def test_complex_pairs_of_each_precision(size, side, pairs):
    """re and im one scalar apart in points aligned to the whole point (8
    bytes of float32, 16 of float64), with even strides."""
    assert st.complex_pairs(*side, size) is pairs
    dtype = torch.float32 if size == 4 else torch.float64
    walk = st.c2c_launch(1024, dtype, (0, 0), side, side)
    assert walk == (st.c2c_walk(1024, dtype), int(pairs), int(pairs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c2c_walk_rule(dtype):
    """Where both sides walk along their rows and no column tile is taken:
    resident blocks on f32 past C2C_BLOCK_MAX_N, a block a tile on f32 up
    to it and on FP64 at every n. The engine's walk, without pairs, where a
    column tile is taken or a side walks down columns; none for bf16 planes
    (their entries take no walk)."""
    size = dtype.itemsize
    pair = (0, size, 2, 2048)
    assert st.C2C_BLOCK_MAX_N == 4
    for n in (2, 4, 8, 16, 1024, 4096):
        f32_resident = dtype == torch.float32 and n > 4
        walk = st.WALK_RESIDENT if f32_resident else st.WALK_BLOCK
        assert st.c2c_walk(n, dtype) == walk
        assert st.c2c_launch(n, dtype, (0, 0), pair, pair) == (walk, 1, 1)
    walk = st.c2c_walk(1024, dtype)
    assert st.c2c_launch(1024, dtype, (16, 256), pair, pair) == (st.WALK_ENGINE, 0, 0)
    down = (0, 1 << 20, 4096, 1)                       # time-major planes
    assert st.c2c_launch(1024, dtype, (0, 0), down, pair) == (st.WALK_ENGINE, 0, 0)
    assert st.c2c_launch(1024, dtype, (0, 0), pair, down) == (st.WALK_ENGINE, 0, 0)
    one = (0, 1 << 20, 1, 1)                           # batch 1 of a time-major plane
    assert st.c2c_launch(1024, dtype, (0, 0), one, one) == (walk, 0, 0)
    assert st.c2c_launch(1024, torch.bfloat16, (0, 0), pair, pair) == ()


def _c2c_args(lib):
    """(entry, n, batch, strides (x_sn, x_sb, y_sn, y_sb), (xre, xim, yre,
    yim), last five (cols, threads, walk, pairs_x, pairs_y)) of the last
    c2c launch."""
    (name, a), = [c for c in lib.calls if c[0].startswith("watfft_stockham_c2c")][-1:]
    return name, a[8], a[9], a[4:8], a[:4], a[17:]


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [2, 16, 1024, 4096])
def test_c2c_complex_and_planes_arguments(n, cdtype, recorder):
    """Interleaved complex: one copy and one store a point; batch-major
    split planes: one a plane; both on `c2c_walk`'s walk. Time-major
    planes with few columns take no tile and the engine's walk."""
    batch = 5
    dtype = cdtype.to_real()
    entry = "watfft_stockham_c2c" + ("_f64" if dtype == torch.float64 else "")
    walk = (st.c2c_walk(n, dtype),)
    x = torch.complex(_f32((batch, n), 1), _f32((batch, n), 2)).to(cdtype)
    st.stockham_fft(x, True)
    name, got_n, got_b, strides, ptrs, last = _c2c_args(recorder)
    assert (name, got_n, got_b, strides) == (entry, n, batch, (2, 2 * n, 2, 2 * n))
    assert ptrs[1] == ptrs[0] + dtype.itemsize and ptrs[3] == ptrs[2] + dtype.itemsize
    assert last == (0, 0, *walk, 1, 1)
    re, im = x.real.contiguous(), x.imag.contiguous()
    st.stockham_fft_bm(re, im)
    name, _, _, strides, _, last = _c2c_args(recorder)
    assert (name, strides, last) == (entry, (1, n, 1, n), (0, 0, *walk, 0, 0))
    st.stockham_fft_nb(re.T.contiguous(), im.T.contiguous())
    name, _, _, strides, _, last = _c2c_args(recorder)
    assert (name, strides, last) == (entry, (batch, 1, batch, 1), (0, 0, st.WALK_ENGINE, 0, 0))


def test_c2c_time_major_tile_keeps_the_engine_walk(recorder):
    n, batch = 1024, 1024
    st.stockham_fft_nb(_f32((n, batch), 1), _f32((n, batch), 2))
    _, _, _, strides, _, last = _c2c_args(recorder)
    assert strides == (batch, 1, batch, 1)
    assert last[:2] == st.tile_shape(n, 4, 8, batch=batch) and last[2:] == (st.WALK_ENGINE, 0, 0)


def test_c2c_bf16_planes_take_no_walk(recorder):
    re, im = _f32((4, 1024), 1).bfloat16(), _f32((4, 1024), 2).bfloat16()
    st.stockham_fft_bm(re, im)
    (name, a), = recorder.calls[-1:]
    assert name == "watfft_stockham_c2c_bf16" and len(a) == 19


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c2c_views_one_scalar_off_alignment(dtype, recorder):
    """fft_views on interleaved views whose re is one scalar off the
    point's alignment: the input plane by plane, the aligned output by
    points."""
    n, batch, size = 1024, 3, dtype.itemsize
    flat = _f32(2 * n * batch + 1).to(dtype)
    out = torch.zeros(batch, n, 2, dtype=dtype)
    views = [torch.as_strided(flat, (n, batch), (2, 2 * n), 1 + k) for k in (0, 1)]
    tabs = st.device_tables(n, False, "cpu", dtype)
    st.fft_views(*views, out[..., 0].T, out[..., 1].T, False, tabs)
    _, _, _, strides, ptrs, last = _c2c_args(recorder)
    assert strides == (2, 2 * n, 2, 2 * n) and ptrs[0] % (2 * size) == size
    assert last == (0, 0, st.c2c_walk(n, dtype), 0, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c2c_real_core_arguments(dtype, recorder):
    """The hybrid real route's core on batch-major signals: the even and
    odd rows of the signal are re and im one scalar apart, one copy a
    point; its inverse stores z[j] into rows 2j and 2j + 1, one store a
    point."""
    n, batch, size = 2048, 4, dtype.itemsize
    x = _f32((batch, n)).to(dtype)
    rf.rfft_bm(x, fused=False)
    _, m, b, strides, ptrs, last = _c2c_args(recorder)
    assert (m, b, strides) == (n // 2, batch, (2, n, 1, n // 2))
    walk = st.c2c_walk(n // 2, dtype)
    assert ptrs[1] == ptrs[0] + size and last == (0, 0, walk, 1, 0)
    spec = _f32((batch, n // 2 + 1)).to(dtype)
    rf.irfft_bm(spec, spec, fused=False)
    _, m, b, strides, ptrs, last = _c2c_args(recorder)
    assert (m, b, strides[2:]) == (n // 2, batch, (2, n))
    assert ptrs[3] == ptrs[2] + size and last[2:] == (walk, 0, 1)


def test_c2c_fft2_rows_arguments(recorder):
    """The 2-pass route's row pass (#16): batch-major planes in, the
    interleaved image out, one store a point."""
    h = w = 64
    x = torch.complex(_f32((2, h, w), 1), _f32((2, h, w), 2))
    f2._complex_route(x, False, "fft2-2pass")
    name, got_n, batch, strides, ptrs, last = _c2c_args(recorder)
    assert (name, got_n, batch) == ("watfft_stockham_c2c", w, 2 * h)
    assert strides == (1, w, 2, 2 * w) and ptrs[3] == ptrs[2] + 4
    assert last == (0, 0, st.WALK_RESIDENT, 0, 1)


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
