"""The host side of the redesigned kernels: the cube (#12, ops/large.py
`cube_threads`, `cube_launch`), the strided kernel's 8-byte stores (#13,
ops/large.py `store_pairs`), the fused r2c kernel in f32 (#9) and FP64
(ops/rfft.py `r2c_launch`), the batch-major walk of the c2c kernel
(ops/stockham.py `c2c_launch`, `complex_pairs`), the fused c2r kernel in
f32 (#10, ops/rfft.py `c2r_launch`), the 2D cube (#15, ops/fft2.py
`cube2_launch`) and the small-n DFT matmul (#20, ops/mxu_dft.py
`dft_launch`). The host picks each
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
from watfft_tpu_torch.ops import mxu_dft as md
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
    monkeypatch.setattr(_build, "use_kernel", lambda t, plain=False: not plain)
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


# -- the strided kernel's 8-byte stores (#13 and the passes that share it) ------------

N20, N1_20 = 1 << 20, 1 << 10      # pipe2 at 2^20: n1 = n2 = 1024


@pytest.mark.parametrize("cols,y,outer,pairs", [
    ((8, 256), (0, 4, 2 * N1_20, 2, 2 * N20), 128, 1),   # pipe2's stage 2 into complex64
    ((8, 256), (8, 12, 2 * N1_20, 2, 2 * N20), 3, 1),
    ((8, 256), (0, 4, 2 * 1024, 2, 2 * 1024 * 1024), 3, 1),  # the 2D column pass, 1024^2
    ((16, 256), (0, 4, 2 * 2048, 2, 2 * 512 * 2048), 5, 1),  # the same, 512 x 2048
    ((8, 256), (4, 8, 2 * N1_20, 2, 2 * N20), 3, 0),     # one scalar off 8-byte alignment
    ((8, 256), (0, 4, 2 * N1_20, 2, 2 * N20 + 1), 3, 0),  # an odd outer stride
    ((8, 256), (0, 4, 2 * N1_20, 2, 2 * N20 + 1), 1, 1),  # ... of one outer entry
    ((8, 256), (0, 4, 2 * N1_20 + 1, 2, 2 * N20), 3, 0),  # an odd point stride
    ((8, 256), (0, 4 * N20 * 3, N1_20, 1, N20), 3, 0),   # f32 planes, batch-major
    ((8, 256), (0, 4 * N20 * 3, N1_20 * 3, 1, 3), N1_20, 0),  # time-major planes
    ((0, 0), (0, 4, 2 * N1_20, 2, 2 * N20), 3, 0),       # no column tile
    ((4, 512), (0, 4, 2 * 4096, 2, 2 << 24), 3, 0),      # a tile of 512 threads (n = 4096)
    ((8, 256), (0, 4, 2, 2 * N1_20, 2 * N20), 3, 0),     # the store walks along rows
])
def test_store_pairs_rule(cols, y, outer, pairs):
    """8-byte stores where a column tile of 256 threads stores down
    columns into re and im adjacent in aligned points."""
    assert lg.store_pairs(cols, y, outer) == pairs


def _strided_args(lib):
    """(y side, (cols, threads, pairs)) of each strided launch; a side is
    (re address, im address, point stride, inner stride, outer stride)."""
    out = []
    for name, a in lib.calls:
        if name == "watfft_strided_c2c":
            out.append(((*a[2:4], *a[7:10]), a[-3:]))
    return out


@pytest.mark.parametrize("layout", ["complex", "bm", "nb", "misaligned"])
def test_pipe2_stage2_stores_pairs_into_complex64(layout, recorder):
    """pipe2 at 2^20: stage 1 stores planes (no pairs); stage 2 stores 8
    bytes a point into interleaved complex64 only, and counts the launch in
    `strided.pairs_store`."""
    from watfft_tpu_torch import trace
    batch = 2
    x = torch.complex(_f32((batch, N20), 1), _f32((batch, N20), 2))
    before = trace.counts["strided.pairs_store"]
    if layout == "complex":
        lg.fft_large_complex(x, mode="pipe2")
    elif layout == "bm":
        lg.fft_large_bm(x.real.contiguous(), x.imag.contiguous(), mode="pipe2")
    elif layout == "nb":
        lg.fft_large_nb(x.real.T.contiguous(), x.imag.T.contiguous(), mode="pipe2")
    else:
        flat, out = _f32(2 * N20 * batch + 3), torch.zeros(2 * N20 * batch + 3)
        views = [torch.as_strided(t, (N20, batch), (2, 2 * N20), o)
                 for t, o in ((flat, 0), (flat, 1), (out, 1), (out, 2))]
        lg.fft_large_views(*views, mode="pipe2")
    (y1, l1), (y2, l2) = _strided_args(recorder)
    pairs = int(layout == "complex")
    assert l1[-1] == 0 and l2[-1] == pairs
    assert trace.counts["strided.pairs_store"] - before == pairs
    if pairs:
        assert l2[:2] == (8, 256)
        assert y2[1] == y2[0] + 4 and y2[2:] == (2 * N1_20, 2, 2 * N20)


def test_2d_outer_pass_stores_pairs(recorder):
    """The "2d" mode's outer pass into complex64 takes the 8-byte stores;
    its post-multiplying pass stores planes."""
    x = torch.complex(_f32((2, N20), 3), _f32((2, N20), 4))
    lg.fft_large_complex(x, mode="2d")
    (_, l1), (_, l2) = _strided_args(recorder)
    assert l1[-1] == 0 and l2 == (8, 256, 1)


@pytest.mark.parametrize("out", ["complex", "planes"])
def test_2d_column_pass_stores_pairs_into_complex64(out, recorder):
    """The 2D column pass (#11 as fft2's column pass) launched into
    interleaved complex64 takes the 8-byte stores; into planes it does not."""
    b, h, w = 3, 1024, 1024
    x = torch.complex(_f32((b, h, w), 5), _f32((b, h, w), 6))
    fx = torch.view_as_real(x).reshape(-1)
    strides = (2 * w, 2, 2 * h * w)
    if out == "complex":
        fy = torch.empty(2 * b * h * w)
        y, ys = (fy, fy[1:]), strides
    else:
        y, ys = (torch.empty(b * h * w), torch.empty(b * h * w)), (w, 1, h * w)
    f2._cols((fx, fx[1:]), strides, y, ys, h, w, b, False, st.device_tables(h, False, "cpu"),
             False)
    (ya, launch), = _strided_args(recorder)
    assert launch == (8, 256, int(out == "complex"))


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


# -- the c2r kernel's walk and accesses ----------------------------------------------

def _c2r_call(layout, n, batch, dtype):
    """The c2r launch of `layout` on a spectrum of `batch` rows: interleaved
    complex, batch-major planes, time-major planes, or the interleaved
    spectrum one scalar off its point's alignment (misaligned_x) or the
    signal's rows one scalar off (misaligned_y), through `_launch_c2r`."""
    m1 = n // 2 + 1
    size = dtype.itemsize
    spec = torch.complex(_f32((batch, m1), 1), _f32((batch, m1), 2)).to(dtype.to_complex())
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    if layout == "complex":
        rf.irfft(spec)
    elif layout == "bm":
        rf.irfft_bm(re, im)
    elif layout == "nb":
        rf.irfft_nb_fused(re.T.contiguous(), im.T.contiguous())
    else:
        flat = torch.zeros(2 * batch * m1 + 1, dtype=dtype)
        out = torch.zeros(batch * n + 1, dtype=dtype)
        xo, yo = (1, 0) if layout == "misaligned_x" else (0, 1)
        p = flat.data_ptr() + xo * size
        rt = rf.device_rtables(n, True, "cpu", dtype)
        rf._launch_c2r(flat, p, p + size, 2, 2 * m1, out[yo:], 1, n, n, batch, rt)


@pytest.mark.parametrize("layout,pairs", [
    ("complex", (1, 1)), ("bm", (0, 1)), ("nb", (0, 0)), ("misaligned_x", (0, 1)),
    ("misaligned_y", (1, 0))])
@pytest.mark.parametrize("n", [4, 8, 16, 32, 1024, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c2r_launch_arguments(dtype, n, layout, pairs, recorder):
    """f32: the engine's walk up to C2R_ENGINE_MAX_N with no pairs,
    resident blocks past it, with one copy a bin of an interleaved spectrum
    aligned to its point and one store a point into contiguous aligned
    signal rows; FP64: the engine's walk at every n, its entry taking no
    walk."""
    batch = 6
    f64 = dtype == torch.float64
    _c2r_call(layout, n, batch, dtype)
    (name, a), = recorder.calls[-1:]
    assert name == "watfft_irfft_c2r" + ("_f64" if f64 else "") and len(a) == 17 + 3 * (not f64)
    assert a[7:9] == (n, batch)
    m1 = n // 2 + 1
    strides = {"complex": (2, 2 * m1, 1, n), "bm": (1, m1, 1, n), "nb": (batch, 1, batch, 1)}
    assert (a[2], a[3], a[5], a[6]) == strides.get(layout, (2, 2 * m1, 1, n))
    if f64:
        return
    if n <= rf.C2R_ENGINE_MAX_N:
        assert a[-3:] == (rf.WALK_ENGINE, 0, 0)
    else:
        assert a[-3:] == (rf.WALK_RESIDENT, *pairs)


@pytest.mark.parametrize("y,pairs", [
    ((0, 1, 1024), 1),         # contiguous rows, aligned to a point
    ((4, 1, 1024), 0),         # one f32 scalar off
    ((0, 1, 1023), 0),         # an odd row stride
    ((0, 6, 1), 0),            # time-major
    ((0, 2, 1), 0),
])
def test_c2r_stores_pairs_only_into_contiguous_aligned_rows(y, pairs):
    x = (0, 4, 2, 1026)
    for n in (32, 1024, 8192):
        assert rf.c2r_launch(n, x, y) == (rf.WALK_RESIDENT, 1, pairs)
        assert rf.c2r_launch(n, (4, 8, 2, 1026), y) == (rf.WALK_RESIDENT, 0, pairs)
    for n in (4, 8, 16):
        assert rf.c2r_launch(n, x, y) == (rf.WALK_ENGINE, 0, 0)


# -- the 2D cube's walk, block and accesses ------------------------------------------

@pytest.mark.parametrize("h,w", [(2, 2), (64, 64), (128, 128), (2, 1024), (1024, 2)])
def test_cube2_small_radix_plans_take_the_engine_walk(h, w):
    """Plans with no radix-16 axis (a caller's own tables) take the engine's
    walk from CUBE2_SMALL_RADIX_POINTS, where they may need a 512-thread
    block that the redesigned walk builds only with a radix-16 axis; the
    port's own plans have one wherever that many points are."""
    cx = (0, 4, 2 * w, 2, 2 * h * w)
    small = h * w < f2.CUBE2_SMALL_RADIX_POINTS
    for radix in ((2, 2), (8, 4), (4, 8)):
        walk = f2.cube2_launch(h, w, cx, cx, radix)[0]
        assert walk == (st.WALK_BLOCK if small else st.WALK_ENGINE), radix
    assert f2.cube2_launch(h, w, cx, cx, (16, 2))[0] == st.WALK_BLOCK
    own = max(r for n in (h, w) for r, _ in st.stage_plan(n))
    assert small or own == st.MAX_RADIX


@pytest.mark.parametrize("h,w", [(2, 2), (4, 64), (64, 64), (64, 128), (128, 128)])
def test_cube2_walk_rule(h, w):
    """A block a tile, save native planes whose images fill a block (the
    engine's walk); one copy and one store a point on interleaved complex64
    aligned to its point with even strides; the row pass's last stage
    stores where y's point stride is the smaller and a row's threads span a
    sector."""
    hw = h * w
    rtpt = w // max(r for r, _ in st.stage_plan(w))
    cx = (0, 4, 2 * w, 2, 2 * hw)
    assert f2.cube2_launch(h, w, cx, cx) == (st.WALK_BLOCK, 1, 1, int(rtpt >= 4))
    planes = (0, 4 * hw * 8, w, 1, hw)
    assert f2.cube2_launch(h, w, planes, planes) == (st.WALK_BLOCK, 0, 0, int(rtpt >= 8))
    native = (0, 4 * hw * 8, 8 * w, 8, 1)
    if hw >= 4096:      # one image a block: the engine's walk
        assert f2.cube2_launch(h, w, native, native) == (st.WALK_ENGINE, 0, 0, 0)
    else:
        assert f2.cube2_launch(h, w, native, native) == (st.WALK_BLOCK, 0, 0, 0)
    for bad in ((4, 8, 2 * w, 2, 2 * hw),           # 4 bytes off 8-byte alignment
                (0, 4, 2 * w, 2, 2 * hw + 1),       # an odd image stride
                (0, 4, 2 * w + 1, 2, 2 * hw)):      # an odd row stride
        assert f2.cube2_launch(h, w, bad, cx)[1:3] == (0, 1), bad
        assert f2.cube2_launch(h, w, cx, bad)[1:3] == (1, 0), bad


def _cube2_args(lib):
    """(x side, y side, h, w, batch, (walk, pairs_x, pairs_y, direct)) of
    the last 2D cube launch; a side is (re address, im address, row, point
    and image strides)."""
    (name, a), = [c for c in lib.calls if c[0] == "watfft_fft2_cube"][-1:]
    return ((a[0], a[1], *a[4:7]), (a[2], a[3], *a[7:10]), a[10], a[11], a[12], a[-4:])


@pytest.mark.parametrize("layout", ["complex", "bm", "nb", "rfft2", "irfft2", "misaligned"])
@pytest.mark.parametrize("h,w", [(2, 2), (16, 16), (64, 64), (128, 128), (2, 8192),
                                 (8192, 2), (16, 1024)])
def test_cube2_launch_arguments(h, w, layout, recorder):
    """The arguments each form passes the cube: batch-major planes,
    interleaved complex64, native [h, w, B] planes, rfft2's packed real
    input and irfft2's packed real output (re and im 4 bytes apart in
    8-byte aligned points), and interleaved views one float off alignment;
    each with the walk, pairs and store `cube2_launch` gives."""
    batch, hw = 3, h * w
    x = torch.complex(_f32((batch, h, w), 1), _f32((batch, h, w), 2))
    re, im = x.real.contiguous(), x.imag.contiguous()
    if layout == "complex":
        f2._complex_route(x, False, "fft2-cube")
    elif layout == "bm":
        f2._planes_route(re, im, False, "fft2-cube")
    elif layout == "nb":
        f2._nb_route(re.permute(1, 2, 0).contiguous(), im.permute(1, 2, 0).contiguous(),
                     False, "fft2-cube")
    elif layout == "rfft2":
        f2._transform(_f32((batch, h, 2 * w)), None, False, "real", "bm", "fft2-cube", None)
    elif layout == "irfft2":
        f2._transform(re, im, True, "bm", "real", "fft2-cube", None)
    else:
        flat = _f32(2 * batch * hw + 1)
        out = torch.zeros(2 * batch * hw)
        s = (2 * w, 2, 2 * hw)
        f2._run((flat[1:], flat[2:]), s, (out, out[1:]), s, h, w, batch, False, "fft2-cube",
                None)
    xs, ys, gh, gw, b, launch = _cube2_args(recorder)
    assert (gh, gw, b) == (h, w, batch)
    strides = {"bm": (w, 1, hw), "nb": (w * batch, batch, 1), "pairs": (2 * w, 2, 2 * hw)}
    sides = {"complex": ("pairs", "pairs"), "bm": ("bm", "bm"), "nb": ("nb", "nb"),
             "rfft2": ("pairs", "bm"), "irfft2": ("bm", "pairs"),
             "misaligned": ("pairs", "pairs")}[layout]
    pairs_x = int(layout in ("complex", "rfft2"))
    pairs_y = int(layout in ("complex", "irfft2", "misaligned"))
    assert (xs[2:], ys[2:]) == tuple(strides[k] for k in sides)
    if layout == "nb" and h * w >= 4096:        # one image a block: the engine's walk
        assert launch == (st.WALK_ENGINE, 0, 0, 0)
    else:
        assert launch[:3] == (st.WALK_BLOCK, pairs_x, pairs_y)
    assert launch == f2.cube2_launch(h, w, xs, ys)


# -- #20: the kernel and its one-point accesses ---------------------------------------

def test_dft_launch_rule():
    """The FP32-core kernel at n <= SIMT_MAX_N, with no pairs; past it the
    tensor cores, with pairs where re and im are adjacent in aligned points
    (the grid is the C side's, from the device)."""
    cplx, planes, odd = (0, 4, 2, 2 * 100), (0, 1 << 20, 1, 100), (4, 8, 2, 2 * 100)
    for n in range(1, md.SIMT_MAX_N + 1):
        assert md.dft_launch(n, cplx, cplx) == (md.KERNEL_SIMT, 0, 0)
    for n in (md.SIMT_MAX_N + 1, 16, 17, 32, 33, 64, 65, 100, 128):
        assert md.dft_launch(n, cplx, planes) == (md.KERNEL_MMA, 1, 0)
        assert md.dft_launch(n, planes, cplx) == (md.KERNEL_MMA, 0, 1)
        assert md.dft_launch(n, odd, cplx) == (md.KERNEL_MMA, 0, 1)


def _dft_args(lib):
    (name, a), = [c for c in lib.calls if c[0] == "watfft_dft_matmul"][-1:]
    return a


@pytest.mark.parametrize("n", [2, 3, 100])
@pytest.mark.parametrize("layout", ["complex", "bm", "nb"])
def test_dft_launch_arguments(n, layout, recorder):
    """W^T stays in its old place before the stream (a build without the
    tensor-core kernel reads it); the fragments, the kernel and pairs follow
    it."""
    batch = 5
    x = torch.complex(_f32((batch, n), 1), _f32((batch, n), 2))
    if layout == "complex":
        md.dft_matmul(x, inverse=True)
    elif layout == "bm":
        md.dft_matmul_bm(x.real.contiguous(), x.imag.contiguous(), True)
    else:
        md.dft_matmul_nb(x.real.T.contiguous(), x.imag.T.contiguous(), True)
    a = _dft_args(recorder)
    strides = {"complex": (2, 2 * n), "bm": (1, n), "nb": (batch, 1)}[layout]
    assert a[4:6] == a[6:8] == strides and a[8:10] == (n, batch)
    assert a[10] == md.device_matrix(n, True, "cpu").data_ptr() and a[11] == 0
    assert a[12].value == md.device_fragments(n, True, "cpu").data_ptr()
    pairs = int(layout == "complex" and n > md.SIMT_MAX_N)
    kernel = md.KERNEL_SIMT if n <= md.SIMT_MAX_N else md.KERNEL_MMA
    assert a[13:] == (kernel, pairs, pairs)


def test_dft_launch_on_misaligned_views(recorder):
    n, batch = 100, 7
    flat, out = _f32(2 * n * batch + 3), torch.zeros(2 * n * batch + 3)
    md._launch((flat[1:], flat[2:]), (2, 2 * n), (out, out[1:]), (2, 2 * n), n, batch, False)
    assert _dft_args(recorder)[13:] == (md.KERNEL_MMA, 0, 1)  # the input 4 bytes off
