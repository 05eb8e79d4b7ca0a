"""The column tile of the c2c and strided c2c kernels (ops/stockham.py
`tile_shape`, `check_tile`, `column_tile` and `config.COLUMN_TILE`): the
shapes the helper gives, the tile each wrapper asks the kernel for, and the
refusals, on the CPU. No JAX is needed: the helper is host arithmetic, and
the launches are recorded by a stand-in library. The kernels themselves run
at every tile on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from watfft_tpu_torch import config
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import fft2 as f2
from watfft_tpu_torch.ops import large as lg
from watfft_tpu_torch.ops import stockham as st

ALL_N = [1 << k for k in range(1, 13)]
# (name, bytes per element of the planes, bytes per point in shared memory):
# f32, FP64, bf16 interop (f32 stages) and bf16 compute
DTYPES = [("f32", 4, 8), ("f64", 8, 16), ("bf16", 2, 8), ("bf16c", 2, 4)]
INNERS = [None, 1, 2, 3, 16, 4096]


@pytest.fixture(autouse=True)
def _default_switch(monkeypatch):
    monkeypatch.setattr(config, "COLUMN_TILE", None)


@pytest.mark.parametrize("name,elem,point", DTYPES)
@pytest.mark.parametrize("n", ALL_N)
def test_tile_shapes_hold_the_kernels_rules(n, name, elem, point):
    radix = max(r for r, _ in st.stage_plan(n))
    T = st.engine_transforms(n, radix)
    assert T == max(1, 256 * radix // n)
    assert st.tile_shape(n, None, point, radix=radix) == (T, 256)   # batch-major
    for inner in INNERS:
        for batch in (None, 6, 1000, 1 << 22):
            C, threads = st.tile_shape(n, elem, point, inner, radix, batch)
            assert C >= T and C & (C - 1) == 0
            assert C * st.smem_stride(n) * point <= st.SMEM_OPTIN_BYTES
            if n < 16:                                # the plan's largest radix is n
                assert (C, threads) == (T, 256)
            if C > T:
                assert threads * 16 // n <= C <= threads and threads in (256, 512)
                if inner is not None:
                    assert C <= inner
                if batch is not None:
                    assert C <= 2 * batch // st.SMS
            # the helper never gives a tile the kernel refuses
            st.check_tile(C, n, point, radix, threads)


def test_tile_reach():
    """The tiles on time-major planes at 2^22 points, n = 16..4096: three
    blocks an SM in 256 threads where that fills a sector, else one block
    as wide as shared memory holds, in 512 threads."""
    def reach(elem, point):
        return [st.tile_shape(n, elem, point, batch=(1 << 22) // n)
                for n in (16, 256, 512, 1024, 2048, 4096)]
    # f32 planes: 139 KB at n = 2048, 4096
    assert reach(4, 8) == [(512, 512), (32, 256), (16, 256), (8, 256), (8, 512), (4, 512)]
    # FP64: T already takes 69.6 KB, so one block an SM everywhere
    assert reach(8, 16) == [(512, 512), (32, 512), (16, 512), (8, 512), (4, 512), (2, 512)]
    # bf16 interop (f32 stages): 16 columns fill a sector of bf16
    assert reach(2, 8) == [(512, 512), (32, 256), (16, 256), (16, 512), (8, 512), (4, 512)]
    # bf16 compute: 4 bytes a point in shared memory
    assert reach(2, 4) == [(512, 512), (64, 256), (32, 256), (16, 256), (16, 512), (8, 512)]
    # a batch over two axes: at most the inner axis's 2 columns
    assert [st.tile_shape(n, 4, 8, 2) for n in (1024, 2048, 4096)] == [
        (4, 256), (2, 256), (2, 512)]
    # few columns keep a block on every two SMs: C <= 2 * batch / 132
    assert [st.tile_shape(4096, 4, 8, batch=b)[0] for b in (6, 131, 132, 264, 1024)] == [
        1, 1, 2, 4, 4]
    assert st.tile_shape(1024, 4, 8, batch=527) == (4, 256)
    assert st.tile_shape(1024, 4, 8, batch=528) == (8, 256)
    # a plan whose largest radix is 8 keeps the engine's walk
    assert st.tile_shape(1024, 4, 8, radix=8) == (st.engine_transforms(1024, 8), 256) == (2, 256)


@pytest.mark.parametrize("cols,n,point,radix", [
    (3, 1024, 8, 16),        # not a power of two
    (2, 1024, 8, 16),        # below T = 4
    (32, 4096, 8, 16),       # 1.1 MB of shared memory
    (4, 4096, 16, 16),       # FP64: 278 KB
    (8, 1024, 8, 8),         # above T on a plan of largest radix 8
    (512, 16, 8, 16),        # more columns than the block's 256 threads
])
def test_check_tile_refuses(cols, n, point, radix):
    with pytest.raises(ValueError, match="column tile"):
        st.check_tile(cols, n, point, radix)
    with pytest.raises(ValueError, match="column tile"):
        st.check_tile(8, 4096, 8, threads=384)     # blocks are 256 or 512 threads
    st.check_tile(512, 32, 8, threads=512)


def _planes(shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dtype)
                 for _ in range(2))


@pytest.mark.parametrize("cols", [3, 2, 1 << 10])
def test_wrappers_raise_on_a_tile_the_kernel_refuses(cols, monkeypatch):
    monkeypatch.setattr(config, "COLUMN_TILE", cols)
    re, im = _planes((1024, 5))
    with pytest.raises(ValueError, match="column tile"):
        st.stockham_fft_nb(re, im)
    nre, nim = _planes((1024, 4, 3))
    with pytest.raises(ValueError, match="column tile"):
        f2.fft2_cols(nre, nim)
    bre, bim = _planes((1024, 1024, 2))
    with pytest.raises(ValueError, match="column tile"):
        lg.stage1(bre, bim)


def test_forced_tile_leaves_batch_major_walks_alone(monkeypatch):
    re, im = _planes((5, 1024))
    want = st.stockham_fft_bm(re, im)
    monkeypatch.setattr(config, "COLUMN_TILE", 3)   # refused on a column walk only
    got = st.stockham_fft_bm(re, im)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


class _Recorder:
    """A stand-in for the kernels' library: records each launch's column
    tile C and its block's threads, and returns 0 (the outputs are left as
    allocated). They are the last two arguments, but for the f32 and FP64
    c2c entries, which take the batch-major walk and its pairs after
    them."""

    def __init__(self):
        self.cols = []
        self.threads = []

    def __getattr__(self, name):
        def entry(*args):
            at = 17 if name in ("watfft_stockham_c2c", "watfft_stockham_c2c_f64") else -2
            self.cols.append((name, args[at]))
            self.threads.append(args[at + 1])
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
    return lib


def _c2c_tile(dtype, tables_dtype, n, time_major=True, batch=1 << 16):
    lib = _build.library()
    lib.cols.clear()
    tables = st.device_tables(n, False, "cpu", tables_dtype)
    sn, sb = (batch, 1) if time_major else (1, n)
    # the stand-in reads no memory: the addresses need no planes behind them
    st._launch(torch.device("cpu"), dtype, 0, 0, 0, 0, sn, sb, sn, sb, n, batch, False, tables)
    return lib.cols[-1][1], lib.threads[-1]


@pytest.mark.parametrize("dtype,tables_dtype,want", [
    (torch.float32, torch.float32, {8: 0, 256: (32, 256), 1024: (8, 256), 4096: (4, 512)}),
    (torch.float64, torch.float64, {8: 0, 256: (32, 512), 1024: (8, 512), 4096: (2, 512)}),
    (torch.bfloat16, torch.float32, {8: 0, 256: (32, 256), 1024: (16, 512), 4096: (4, 512)}),
    (torch.bfloat16, torch.bfloat16, {8: 0, 256: (64, 256), 1024: (16, 256), 4096: (8, 512)}),
])
def test_c2c_launches_ask_for_the_tile(dtype, tables_dtype, want, recorder, monkeypatch):
    for n, tile in want.items():
        assert _c2c_tile(dtype, tables_dtype, n) == (tile or (0, 0))
        assert _c2c_tile(dtype, tables_dtype, n, time_major=False) == (0, 0)
    assert _c2c_tile(dtype, tables_dtype, 4096, batch=3) == (0, 0)   # blocks on the SMs first
    monkeypatch.setattr(config, "COLUMN_TILE", (8, 512))
    assert _c2c_tile(dtype, tables_dtype, 1024) == (8, 512)
    monkeypatch.setattr(config, "COLUMN_TILE", 0)
    assert _c2c_tile(dtype, tables_dtype, 4096) == (0, 0)


def test_strided_launches_ask_for_the_tile(recorder):
    def last(fn, *args):
        recorder.cols.clear()
        recorder.threads.clear()
        fn(*args)
        return [(c, t) if c else 0 for (_, c), t in zip(recorder.cols, recorder.threads)]

    # native [h, w, B]: the w and B axes run on as one run of w * B columns
    assert last(f2.fft2_cols, *_planes((4096, 2, 264))) == [(4, 512)]
    assert last(f2.fft2_cols, *_planes((1024, 2, 528))) == [(8, 256)]
    assert last(f2.fft2_cols, *_planes((4096, 2, 3))) == [0]      # 6 columns
    assert last(f2.fft2_k2, *_planes((2, 4096, 264))) == [(4, 512)]
    # batch-major [B, h, w] at w = 2: the tile stays within the 2 columns;
    # the row pass (contiguous rows) keeps the engine's walk
    assert last(f2.fft2_planes, *_planes((264, 4096, 2))) == [(2, 512), 0]
    assert last(f2.fft2_planes, *_planes((528, 1024, 2))) == [0, 0]
    # the pipe2 stages on time-major [n2, n1, b] blocks
    assert last(lg.stage1, *_planes((1024, 16, 66))) == [(8, 256)]
    assert last(lg.stage2, *_planes((1024, 4096, 1))) == [(4, 512)]    # the transposed store
    # pipe2 on complex64 [132, 2^13]: stage 1 reads 8-byte runs, writes f32
    # planes; the 8 columns of the inner axis bound it
    x = torch.complex(*_planes((132, 1 << 13)))
    assert last(lambda: lg.fft_large_complex(x, mode="pipe2", split=(8, 1024))) == [
        (8, 256), 0]
