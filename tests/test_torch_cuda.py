"""The Hopper kernels on the card (the Stockham c2c kernel, the fused r2c
and c2r real kernels, the hybrid real path that drives the c2c kernel
through strides, the FP64 instances of these three, the four-step kernels
of the large-N path, the 2D path's cube and passes, the Bluestein pair and
one-pass kernel, the small-n DFT matmul (#20: its FP32-core and 3xTF32
tensor-core kernels), the c2c kernel's two bf16
instances, the redesigned batch-major walk of the c2c kernel and the FP64
r2c, and the redesigned f32 c2r and 2D cube), against their plain torch
versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a GPU host that has none; tests/conftest.py imports
JAX, so run it there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import watfft_tpu_torch as wtt
from watfft_tpu_torch import convert
from watfft_tpu_torch.ops import fft2 as f2
from watfft_tpu_torch.ops import large as lg
from watfft_tpu_torch.ops import rfft as rf
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch import stft
from watfft_tpu_torch.utils.tolerances import MAX_REL

pytestmark = pytest.mark.cuda

# max |kernel - plain| / max |plain| on the same inputs and plan: both are
# f32; the kernel contracts multiply-adds into FMAs, the plain version
# rounds op by op
KERNEL_LIMIT = 1e-6
# the same for the FP64 instances against the plain version in float64
F64_KERNEL_LIMIT = 1e-12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _x(shape, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1 << k for k in range(1, 13)])
def test_kernel_matches_plain_all_layouts(n, inverse, dev):
    for batch in (1, 3, 257):  # ragged: not a multiple of a block's transforms
        x = _x((batch, n), seed=n + batch, dev=dev)
        want = st.plain_fft(x, inverse)
        assert _rel(st.stockham_fft(x, inverse), want) <= KERNEL_LIMIT
        re, im = x.real.contiguous(), x.imag.contiguous()
        bre, bim = st.stockham_fft_bm(re, im, inverse)
        assert _rel(torch.complex(bre, bim), want) <= KERNEL_LIMIT
        tre, tim = st.stockham_fft_nb(re.T.contiguous(), im.T.contiguous(), inverse)
        assert _rel(torch.complex(tre, tim).T, want) <= KERNEL_LIMIT


def test_each_call_launches_once(dev):
    ctx = wtt.create_fft_f32(64, device=dev)
    x = _x((5, 64), seed=1, dev=dev)
    before = st.launches
    ctx.forward(x)
    ctx.inverse_planes(x.real, x.imag)
    ctx.forward_planes_nb(x.real.T, x.imag.T)  # strided inputs: made contiguous once
    assert st.launches == before + 3


def test_non_contiguous_input(dev):
    x = _x((64, 6), seed=2, dev=dev).T  # [6, 64] view with strides (1, 6)
    assert not x.is_contiguous()
    assert _rel(wtt.fft(x), st.plain_fft(x)) <= KERNEL_LIMIT


def test_backward_is_conjugate_transform(dev):
    x = _x((4, 256), seed=3, dev=dev).requires_grad_()
    g = _x((4, 256), seed=4, dev=dev)
    wtt.fft(x).backward(g)
    assert torch.equal(x.grad, wtt.ifft(g) * 256)


def test_lazy_conj_and_neg_views(dev):
    """The kernel reads raw storage: a conj or neg view (x.conj(), its
    .imag, the lazy conj autograd hands backward for fft(x).conj()) must be
    resolved first, or the unconjugated values are transformed."""
    n = 256
    x = _x((4, n), seed=5, dev=dev)
    g = _x((4, n), seed=6, dev=dev)
    xc = x.conj()
    assert xc.is_conj() and xc.imag.is_neg()
    want = torch.fft.fft(xc.resolve_conj().to(torch.complex128))
    ctx = wtt.create_fft_f32(n, device=dev)
    assert _rel(ctx.forward(xc).to(torch.complex128), want) <= MAX_REL["float32"]
    re, im = ctx.forward_planes(xc.real, xc.imag)
    assert _rel(torch.complex(re, im).to(torch.complex128), want) <= MAX_REL["float32"]
    re, im = ctx.forward_planes_nb(xc.real.T, xc.imag.T)
    assert _rel(torch.complex(re, im).T.to(torch.complex128), want) <= MAX_REL["float32"]
    xg = x.clone().requires_grad_()
    wtt.fft(xg).conj().backward(g)
    want_grad = torch.fft.ifft(g.conj().resolve_conj().to(torch.complex128)) * n
    assert _rel(xg.grad.to(torch.complex128), want_grad) <= MAX_REL["float32"]


def test_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1024, 4, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32/float64"):
        st.stockham_fft_nb(x, x)
    x = torch.zeros(1024, 4, device=dev, dtype=torch.float64)  # f32 tables on f64 planes
    with pytest.raises(TypeError, match="precision"):
        st.stockham_fft_nb(x, x, tables=st.device_tables(1024, False, dev))
    big = st.make_tables([(64, 1), (16, 64)], [-1, 0], np.ones(63 * 16), np.zeros(63 * 16), dev)
    y = torch.zeros(1024, 4, device=dev)
    with pytest.raises(RuntimeError, match="radix outside"):
        st.stockham_fft_nb(y, y, tables=big)
    cpu_tables = convert.tables_from_jax([(16, 1)], [-1], [[1.0]], [[0.0]], "cpu")
    with pytest.raises(ValueError, match="tables on cpu"):
        st.stockham_fft_nb(torch.zeros(16, 2, device=dev), torch.zeros(16, 2, device=dev),
                           tables=cpu_tables)


# -- the real path ----------------------------------------------------------------

def _r(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("n", [1 << k for k in range(2, 14)])
def test_real_kernels_match_plain_all_layouts(n, dev):
    """Fused (r2c/c2r) and hybrid, forward and inverse, in every layout,
    on ragged batches; the inverse on spectra with nonzero imaginary DC and
    Nyquist parts."""
    m = n // 2
    for batch in (1, 3, 257):
        x = _r((batch, n), seed=n + batch, dev=dev)
        want = rf.plain_rfft(x)
        spec = torch.complex(_r((batch, m + 1), 1, dev), _r((batch, m + 1), 2, dev))
        want_inv = rf.plain_irfft(spec)
        sre, sim = spec.real.contiguous(), spec.imag.contiguous()
        for fused in (True, False):
            fwd_nb = rf.rfft_nb_fused if fused else rf.rfft_nb
            inv_nb = rf.irfft_nb_fused if fused else rf.irfft_nb
            assert _rel(rf.rfft(x, fused), want) <= KERNEL_LIMIT
            assert _rel(torch.complex(*rf.rfft_bm(x, fused)), want) <= KERNEL_LIMIT
            assert _rel(torch.complex(*fwd_nb(x.T.contiguous())).T, want) <= KERNEL_LIMIT
            assert _rel(rf.irfft(spec, fused), want_inv) <= KERNEL_LIMIT
            assert _rel(rf.irfft_bm(sre, sim, fused), want_inv) <= KERNEL_LIMIT
            assert _rel(inv_nb(sre.T.contiguous(), sim.T.contiguous()).T, want_inv) <= KERNEL_LIMIT


def test_real_calls_launch_their_kernels(dev):
    ctx = wtt.create_rfft_f32(256, device=dev)
    x = _r((64, 256), seed=3, dev=dev)
    before, c2c = dict(rf.launches), st.launches
    spec = ctx.forward(x)
    ctx.inverse(spec)
    re, im = ctx.forward_planes_nb(x.T.reshape(256, 8, 8))  # the folded view: hybrid
    ctx.inverse_planes_nb(re, im)
    assert rf.launches["rfft_r2c_fused"] == before["rfft_r2c_fused"] + 1
    assert rf.launches["irfft_c2r_fused"] == before["irfft_c2r_fused"] + 1
    assert rf.launches["real_core_fwd"] == before["real_core_fwd"] + 1
    assert rf.launches["real_core_inv"] == before["real_core_inv"] + 1
    assert st.launches == c2c + 2


def test_real_backward_runs_the_other_direction(dev):
    n = 512
    x = _r((6, n), seed=4, dev=dev).requires_grad_()
    g = torch.complex(_r((6, n // 2 + 1), 5, dev), _r((6, n // 2 + 1), 6, dev))
    wtt.rfft(x).backward(g)
    xc = x.detach().cpu().requires_grad_()
    rf.rfft(xc).backward(g.cpu())
    assert _rel(x.grad.cpu(), xc.grad) <= KERNEL_LIMIT
    s = g.clone().requires_grad_()
    y = _r((6, n), seed=7, dev=dev)
    wtt.irfft(s).backward(y)
    sc = g.cpu().requires_grad_()
    rf.irfft(sc).backward(y.cpu())
    assert _rel(s.grad.cpu(), sc.grad) <= KERNEL_LIMIT


def test_stft_on_the_card(dev):
    x = _r((2, 63 * 64 + 256), seed=8, dev=dev)
    re, im = stft.stft(x, n_fft=256, hop=64)
    w = torch.as_tensor(stft.get_window("hann", 256), device=dev, dtype=torch.float64)
    want = torch.fft.rfft(x.double().unfold(-1, 256, 64) * w)
    assert re.shape == (2, 64, 129)
    assert _rel(torch.complex(re, im).to(torch.complex128), want) <= MAX_REL["float32"]
    back = stft.istft(re, im, n_fft=256, hop=64)
    assert (back[..., 256:-256] - x[..., 256:-256]).abs().max().item() < 1e-5


def test_real_kernels_refuse_what_they_do_not_take(dev):
    with pytest.raises(TypeError, match="float32/float64"):
        rf.rfft(torch.zeros(2, 64, device=dev, dtype=torch.float16))
    with pytest.raises(TypeError, match="precision"):
        rf.rfft(torch.zeros(2, 64, device=dev, dtype=torch.float64),
                tables=rf.device_rtables(64, False, dev))
    big = rf.make_rtables([(64, 1), (16, 64)], [-1, 0], np.ones(63 * 16), np.zeros(63 * 16),
                          np.ones(1025), np.zeros(1025), False, dev)
    with pytest.raises(RuntimeError, match="radix outside"):
        rf.rfft_nb_fused(torch.zeros(2048, 4, device=dev), tables=big)


# -- the FP64 instances (the f64 tier) ---------------------------------------------

def _x64(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).to(dev)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1 << k for k in range(1, 13)])
def test_f64_kernel_matches_plain_all_layouts(n, inverse, dev):
    for batch in (1, 3, 257):
        x = _x64((batch, n), seed=n + batch, dev=dev)
        want = st.plain_fft(x, inverse)
        before = st.launches_f64
        assert _rel(st.stockham_fft(x, inverse), want) <= F64_KERNEL_LIMIT
        re, im = x.real.contiguous(), x.imag.contiguous()
        assert re.dtype == torch.float64
        assert _rel(torch.complex(*st.stockham_fft_bm(re, im, inverse)), want) <= F64_KERNEL_LIMIT
        tre, tim = st.stockham_fft_nb(re.T.contiguous(), im.T.contiguous(), inverse)
        assert _rel(torch.complex(tre, tim).T, want) <= F64_KERNEL_LIMIT
        assert st.launches_f64 == before + 3
        ref64 = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
        assert _rel(want, ref64) <= MAX_REL["float64"]


def test_f64_radix4_plan_runs_on_the_kernel(dev):
    """The JAX df plan off the TPU (radix 4 and a remainder of 2) through
    the FP64 kernel, up to n = 1024 (n/4 threads a transform)."""
    for k in range(1, 11):
        n = 1 << k
        radices = [4] * (k // 2)
        if k % 2:
            radices.insert(1, 2)
        stages, l = [], 1
        for r in radices:
            stages.append((r, l))
            l *= r
        re, im, off = st.make_twiddle_pack(n, False, np.float64, stages)
        t = st.make_tables(stages, off, re, im, dev, torch.float64)
        x = _x64((5, n), seed=k, dev=dev)
        assert _rel(st.stockham_fft(x, tables=t), torch.fft.fft(x)) <= MAX_REL["float64"]


@pytest.mark.parametrize("n", [1 << k for k in range(2, 14)])
def test_f64_real_kernels_match_plain_all_layouts(n, dev):
    m = n // 2
    rng = np.random.default_rng(n)
    for batch in (1, 3, 257):
        x = torch.from_numpy(rng.uniform(-1, 1, (batch, n))).to(dev)
        spec = _x64((batch, m + 1), seed=n + 1, dev=dev)
        want, want_inv = rf.plain_rfft(x), rf.plain_irfft(spec)
        sre, sim = spec.real.contiguous(), spec.imag.contiguous()
        before = rf.launches["rfft_r2c_fused_f64"]
        for fused in (True, False):
            fwd_nb = rf.rfft_nb_fused if fused else rf.rfft_nb
            inv_nb = rf.irfft_nb_fused if fused else rf.irfft_nb
            assert _rel(rf.rfft(x, fused), want) <= F64_KERNEL_LIMIT
            assert _rel(torch.complex(*rf.rfft_bm(x, fused)), want) <= F64_KERNEL_LIMIT
            assert _rel(torch.complex(*fwd_nb(x.T.contiguous())).T, want) <= F64_KERNEL_LIMIT
            assert _rel(rf.irfft(spec, fused), want_inv) <= F64_KERNEL_LIMIT
            assert _rel(rf.irfft_bm(sre, sim, fused), want_inv) <= F64_KERNEL_LIMIT
            assert _rel(inv_nb(sre.T.contiguous(), sim.T.contiguous()).T,
                        want_inv) <= F64_KERNEL_LIMIT
        assert rf.launches["rfft_r2c_fused_f64"] == before + 3
        assert _rel(want, torch.fft.rfft(x)) <= MAX_REL["float64"]


def test_f64_contexts_launch_the_fp64_kernels(dev):
    ctx, rctx = wtt.create_fft(1024, device=dev), wtt.create_rfft(1024, device=dev)
    x = _x64((8, 1024), seed=9, dev=dev)
    c2c, c2c32, real = st.launches_f64, st.launches, dict(rf.launches)
    y = ctx.forward(x)
    assert y.dtype == torch.complex128
    assert _rel(y, torch.fft.fft(x)) <= MAX_REL["float64"]
    assert (ctx.inverse(y) - x).abs().max().item() < 1.5e-10
    s = rctx.forward(x.real)
    assert _rel(s, torch.fft.rfft(x.real)) <= MAX_REL["float64"]
    assert (rctx.inverse(s) - x.real).abs().max().item() < 1.5e-10
    assert st.launches_f64 == c2c + 2 and st.launches == c2c32
    assert rf.launches["rfft_r2c_fused_f64"] == real["rfft_r2c_fused_f64"] + 1
    assert rf.launches["irfft_c2r_fused_f64"] == real["irfft_c2r_fused_f64"] + 1
    # past the kernels: the float64 matmul surface, no FFT kernel
    big = wtt.create_fft(8192, device=dev)
    xb = _x64((2, 8192), seed=10, dev=dev)
    before = (st.launches_f64, dict(rf.launches))
    assert _rel(big.forward(xb), torch.fft.fft(xb)) <= MAX_REL["float64"]
    assert (st.launches_f64, rf.launches) == before


def test_f64_gradcheck_on_the_card(dev):
    ctx, rctx = wtt.create_fft(16, device=dev), wtt.create_rfft(16, device=dev)
    x = _x64((2, 16), seed=11, dev=dev).requires_grad_()
    xr = x.real.detach().clone().requires_grad_()
    spec = torch.fft.rfft(xr.detach() * 2).requires_grad_()
    assert torch.autograd.gradcheck(ctx.forward, (x,))
    assert torch.autograd.gradcheck(ctx.inverse, (x,))
    assert torch.autograd.gradcheck(rctx.forward, (xr,))
    assert torch.autograd.gradcheck(rctx.inverse, (spec,))


# -- the large-N four-step path -----------------------------------------------------

@pytest.mark.parametrize("n", [1 << 13, 1 << 14, 1 << 16])
def test_large_modes_match_plain_all_layouts(n, dev):
    """Every mode in three layouts, on ragged batches (the cube only where
    it holds a transform), forward and inverse."""
    for batch in (1, 3, 257):
        x = _x((batch, n), seed=n + batch, dev=dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        for inverse in (False, True):
            want = lg.plain_fft_large(x, inverse)
            for mode in lg.MODES:
                if mode == "cube" and n > 1 << 14:
                    continue
                assert _rel(lg.fft_large_complex(x, inverse, mode=mode), want) <= KERNEL_LIMIT
                bre, bim = lg.fft_large_bm(re, im, inverse, mode=mode)
                assert _rel(torch.complex(bre, bim), want) <= KERNEL_LIMIT
                tre, tim = lg.fft_large_nb(re.T.contiguous(), im.T.contiguous(), inverse,
                                           mode=mode)
                assert _rel(torch.complex(tre, tim).T, want) <= KERNEL_LIMIT


def test_large_kernels_match_plain_one_by_one(dev):
    """Stage 1 (#11), stage 2 (#13), the cube (#12, 68 KB and 136 KB of
    shared memory: over the 48 KB a launch gets without opting in) and the
    post-multiply (#3) against their plain versions."""
    for n1, n2, b in ((128, 64, 5), (128, 128, 3), (1024, 1024, 2)):
        xre, xim = _r((n2, n1, b), 1, dev), _r((n2, n1, b), 2, dev)
        for inverse in (False, True):
            p1 = lg.plain_stage1(xre, xim, inverse)
            assert _rel(torch.complex(*lg.stage1(xre, xim, inverse)), torch.complex(*p1)) \
                <= KERNEL_LIMIT
            p2 = torch.complex(*lg.plain_stage2(*p1, inverse))
            assert _rel(torch.complex(*lg.stage2(*p1, inverse)), p2) <= KERNEL_LIMIT
            if n1 * n2 <= 1 << 14:
                assert _rel(torch.complex(*lg.cube(xre, xim, inverse)), p2) <= KERNEL_LIMIT
    xre, xim, pre, pim = (_r((4096, 33), s, dev) for s in range(4))
    for inverse in (False, True):
        got = st.stockham_fft_nb_postmul(xre, xim, pre, pim, inverse)
        want = st.plain_postmul(xre, xim, pre, pim, inverse)
        assert _rel(torch.complex(*got), torch.complex(*want)) <= KERNEL_LIMIT


def test_large_context_launches_and_oracle(dev):
    """The planner's routes (planner.large_mode): the cube for complex64 at
    every batch, pipe2 for time-major planes of more than
    CUBE_NB_MAX_BATCH[2^14] = 2 sequences."""
    n = 1 << 14
    ctx = wtt.create_fft_f32(n, device=dev)
    for batch, layout, kernel in ((200, "complex", "cube"), (4, "complex", "cube"),
                                  (4, "nb", "stage1")):
        x = _x((batch, n), seed=batch, dev=dev)
        before = dict(lg.launches)
        if layout == "complex":
            y = ctx.forward(x)
            back = ctx.inverse(y)
        else:
            y = torch.complex(*ctx.forward_planes_nb(x.real.T.contiguous(),
                                                      x.imag.T.contiguous())).T
            back = torch.complex(*ctx.inverse_planes_nb(y.real.T.contiguous(),
                                                        y.imag.T.contiguous())).T
        assert lg.launches[kernel] == before[kernel] + 2
        want = torch.fft.fft(x.to(torch.complex128))
        assert _rel(y.to(torch.complex128), want) <= MAX_REL["float32"]
        assert (back - x).abs().max().item() < 1e-4


def test_large_conj_view_and_backward(dev):
    n = 1 << 15
    x = _x((3, n), seed=9, dev=dev)
    want = torch.fft.fft(x.conj().to(torch.complex128))
    assert _rel(wtt.fft(x.conj()).to(torch.complex128), want) <= MAX_REL["float32"]
    g = _x((3, n), seed=10, dev=dev)
    xg = x.clone().requires_grad_()
    wtt.fft(xg).backward(g)
    want_grad = torch.fft.ifft(g.to(torch.complex128)) * n
    assert _rel(xg.grad.to(torch.complex128), want_grad) <= MAX_REL["float32"]


def test_large_real_path_on_the_card(dev):
    n = 1 << 16
    ctx = wtt.create_rfft_f32(n, device=dev)
    x = _r((5, n), seed=11, dev=dev)
    before = dict(lg.launches)
    y = ctx.forward(x)
    assert lg.launches["stage2"] == before["stage2"] + 1
    want = torch.fft.rfft(x.double())
    assert _rel(y.to(torch.complex128), want) <= MAX_REL["float32"]
    assert _rel(y.cpu(), lg.rfft_large(x.cpu())) <= KERNEL_LIMIT
    assert (ctx.inverse(y) - x).abs().max().item() < 1e-4


def test_large_kernels_refuse_what_they_do_not_take(dev):
    with pytest.raises(TypeError, match="float32"):
        lg.fft_large_nb(*(torch.zeros(8192, 2, device=dev, dtype=torch.float64),) * 2)
    x = torch.zeros(64, 64, 2, device=dev)
    with pytest.raises(RuntimeError, match="cube kernel's range"):
        lg.cube(x, x)  # n = 4096: under the cube's 8192 points
    cpu_tables = lg.device_large_tables(8192, False, "cpu")
    with pytest.raises(ValueError, match="tables on cpu"):
        lg.fft_large_nb(*(torch.zeros(8192, 2, device=dev),) * 2, tables=cpu_tables)


# -- the 2D path ----------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(2, 2), (4, 64), (32, 8), (128, 128), (8192, 2), (2, 8192)])
def test_fft2_cube_matches_plain_all_layouts(h, w, dev):
    """#15: the cube in three layouts, on ragged batches (images per block:
    128 at 2x2), forward and inverse."""
    for batch in (1, 3, 257):
        x = _x((batch, h, w), seed=h + w + batch, dev=dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        xn = x.permute(1, 2, 0)
        nre, nim = xn.real.contiguous(), xn.imag.contiguous()
        for inverse in (False, True):
            want = f2.plain_fft2(x, inverse)
            before = f2.launches["fft2_cube"]
            assert _rel(f2._complex_route(x, inverse, "fft2-cube"), want) <= KERNEL_LIMIT
            bre, bim = f2._planes_route(re, im, inverse, "fft2-cube")
            assert _rel(torch.complex(bre, bim), want) <= KERNEL_LIMIT
            yre, yim = f2._nb_route(nre, nim, inverse, "fft2-cube")
            assert _rel(torch.complex(yre, yim).permute(2, 0, 1), want) <= KERNEL_LIMIT
            assert f2.launches["fft2_cube"] == before + 3


@pytest.mark.parametrize("h,w", [(16, 256), (256, 16), (4096, 16), (16, 4096)])
def test_fft2_passes_match_plain(h, w, dev):
    """The column pass, #14 (native row pass) and #16 (row pass on the c2c
    kernel), alone and as the 2-pass route."""
    b = 3
    xre, xim = _r((h, w, b), 1, dev), _r((h, w, b), 2, dev)
    for inverse in (False, True):
        for f, p in ((f2.fft2_cols, f2.plain_fft2_cols), (f2.fft2_k2, f2.plain_fft2_k2)):
            assert _rel(torch.complex(*f(xre, xim, inverse)),
                        torch.complex(*p(xre, xim, inverse))) <= KERNEL_LIMIT
        rre, rim = xre.view(-1, w), xim.view(-1, w)
        assert _rel(torch.complex(*f2.fft2_rows(rre, rim, inverse)),
                    torch.complex(*f2.plain_fft2_rows(rre, rim, inverse))) <= KERNEL_LIMIT
        x = _x((b, h, w), seed=h * w, dev=dev)
        before = dict(f2.launches)
        y = f2._complex_route(x, inverse, "fft2-2pass")
        assert _rel(y, f2.plain_fft2(x, inverse)) <= KERNEL_LIMIT
        assert f2.launches["fft2_cols"] == before["fft2_cols"] + 1
        assert f2.launches["fft2_rows"] == before["fft2_rows"] + 1


def test_fft2_api_on_the_card(dev):
    """fft2 / ifft2 / rfft2 / irfft2 against torch.fft in double precision,
    a backward, and the axes route (an axis over 4096)."""
    x = _x((2, 64, 128), seed=5, dev=dev)
    want = torch.fft.fft2(x.to(torch.complex128))
    assert _rel(wtt.fft2(x).to(torch.complex128), want) <= MAX_REL["float32"]
    assert (wtt.ifft2(wtt.fft2(x)) - x).abs().max().item() < 1e-4
    r = _r((2, 64, 128), 6, dev)
    assert _rel(wtt.rfft2(r).to(torch.complex128), torch.fft.rfft2(r.double())) <= MAX_REL["float32"]
    assert (wtt.irfft2(wtt.rfft2(r)) - r).abs().max().item() < 1e-4
    xg = x.clone().requires_grad_()
    g = _x((2, 64, 128), seed=7, dev=dev)
    wtt.fft2(xg).backward(g)
    assert _rel(xg.grad.to(torch.complex128),
                torch.fft.ifft2(g.to(torch.complex128)) * 64 * 128) <= MAX_REL["float32"]
    xa = _x((8192, 4), seed=8, dev=dev)
    assert _rel(wtt.fft2(xa).to(torch.complex128),
                torch.fft.fft2(xa.to(torch.complex128))) <= MAX_REL["float32"]


def _radix_tables(n, radix, inverse, dev):
    """Tables for n with every stage of one radix (a plan of the caller's
    own), packed by the rule of `stockham.make_twiddle_pack`."""
    stages, l = [], 1
    while l < n:
        stages.append((radix, l))
        l *= radix
    sign = 1.0 if inverse else -1.0
    res, ims, offsets = [], [], []
    for idx, (r, l) in enumerate(stages):
        if l == 1:
            offsets.append(-1)
            continue
        offsets.append(sum(len(a) for a in res))
        k = np.arange(n // r) % l
        scale = 1.0 / n if inverse and idx == len(stages) - 1 else 1.0
        for p in range(1, r):
            ang = sign * 2.0 * np.pi * ((p * k) % (r * l)) / (r * l)
            res.append(scale * np.cos(ang))
            ims.append(scale * np.sin(ang))
    return st.make_tables(stages, offsets, np.concatenate(res), np.concatenate(ims), dev)


@pytest.mark.parametrize("h,w", [(4096, 2), (2, 4096)])
def test_fft2_cube_takes_plans_of_small_radix(h, w, dev):
    """A 4096-point plan of radix 8 takes 512 threads a transform, more than
    the cube's usual 256 under 2^14 points: the block widens to them."""
    for inverse in (False, True):
        tables = tuple(_radix_tables(n, 8, inverse, dev) if n == 4096
                       else st.device_tables(n, inverse, dev) for n in (h, w))
        x = _x((3, h, w), seed=h, dev=dev)
        before = f2.launches["fft2_cube"]
        y = f2._complex_route(x, inverse, "fft2-cube", tables)
        assert f2.launches["fft2_cube"] == before + 1
        assert _rel(y, f2.plain_fft2(x, inverse, tables)) <= KERNEL_LIMIT
        want = (torch.fft.ifft2 if inverse else torch.fft.fft2)(x.to(torch.complex128))
        assert _rel(y.to(torch.complex128), want) <= MAX_REL["float32"]


def test_fft2_kernels_refuse_what_they_do_not_take(dev):
    with pytest.raises(TypeError, match="float32"):
        f2.fft2_planes(*(torch.zeros(4, 8, 8, device=dev, dtype=torch.float64),) * 2)
    big = st.make_tables([(64, 1)], [-1], np.ones(1), np.zeros(1), dev)
    small = st.device_tables(8, False, dev)
    with pytest.raises(RuntimeError, match="radix outside"):
        f2._complex_route(torch.zeros(64, 8, device=dev, dtype=torch.complex64), False,
                          "fft2-cube", (big, small))


# -- the any-n path ---------------------------------------------------------------------

BLUESTEIN_SIZES = [2, 3, 5, 7, 12, 17, 97, 360, 1000, 1009, 2047, 2048]


@pytest.mark.parametrize("n", BLUESTEIN_SIZES)
def test_bluestein_kernels_match_plain_all_layouts(n, dev):
    """#17 and #18 alone (time-major [n, b] -> [m, b] -> [n, b]) and the
    fused transform (the one-pass kernel) in three layouts, on ragged
    batches, both directions."""
    from watfft_tpu_torch.ops import bluestein as bl
    for batch in (1, 3, 257):
        x = _x((batch, n), seed=n + batch, dev=dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        tre, tim = re.T.contiguous(), im.T.contiguous()
        for inverse in (False, True):
            f = bl.bluestein_fwd(tre, tim, inverse)
            pf = bl.plain_bluestein_fwd(tre, tim, inverse)
            assert _rel(torch.complex(*f), torch.complex(*pf)) <= KERNEL_LIMIT
            g = torch.complex(*bl.bluestein_inv(*pf, n, inverse))
            assert _rel(g, torch.complex(*bl.plain_bluestein_inv(*pf, n, inverse))) <= KERNEL_LIMIT
            want = bl.plain_bluestein_fft(x, inverse)
            before = dict(bl.launches)
            assert _rel(bl.bluestein_fft(x, inverse), want) <= KERNEL_LIMIT
            assert _rel(torch.complex(*bl.bluestein_fft_bm(re, im, inverse)), want) <= KERNEL_LIMIT
            assert _rel(torch.complex(*bl.bluestein_fft_nb(tre, tim, inverse)).T, want) \
                <= KERNEL_LIMIT
            assert bl.launches == {**before,
                                   "bluestein_onepass": before["bluestein_onepass"] + 3}
            ref = (torch.fft.ifft if inverse else torch.fft.fft)(x.to(torch.complex128))
            got = bl.bluestein_fft(x, inverse).to(torch.complex128)
            assert _rel(got, ref) <= MAX_REL["float32"]


@pytest.mark.parametrize("n", BLUESTEIN_SIZES)
def test_bluestein_onepass_matches_plain_and_pair(n, dev):
    """The one-pass kernel on time-major planes (the fused route of
    bluestein_fft_nb) against its plain version (within KERNEL_LIMIT) and
    against #17 then #18 on the card (bit for bit: the same operations in
    the same order), both directions."""
    from watfft_tpu_torch.ops import bluestein as bl
    for batch in (1, 3, 257):
        x = _x((batch, n), seed=2 * n + batch, dev=dev)
        tre, tim = x.real.T.contiguous(), x.imag.T.contiguous()
        for inverse in (False, True):
            got = torch.complex(*bl.bluestein_fft_nb(tre, tim, inverse))
            want = torch.complex(*bl.plain_bluestein_onepass(tre, tim, inverse))
            assert _rel(got, want) <= KERNEL_LIMIT
            pair = torch.complex(*bl.bluestein_inv(*bl.bluestein_fwd(tre, tim, inverse), n,
                                                   inverse))
            assert torch.equal(got, pair)


def test_fftlib_any_n_on_the_card(dev):
    """The namespace's any-n routes: fused Bluestein (launch counts), the
    unfused route past n = 2048 on the four-step kernels, rfft / irfft of
    both parities, a padded call on the Stockham kernel, a backward."""
    from watfft_tpu_torch import fftlib
    from watfft_tpu_torch.ops import bluestein as bl
    x = _x((4, 1000), seed=11, dev=dev)
    want = torch.fft.fft(x.to(torch.complex128))
    before, c2c = dict(bl.launches), st.launches
    y = fftlib.fft(x)
    onepass = before["bluestein_onepass"]
    assert bl.launches == {**before, "bluestein_onepass": onepass + 1} and st.launches == c2c
    assert _rel(y.to(torch.complex128), want) <= MAX_REL["float32"]
    assert (fftlib.ifft(y) - x).abs().max().item() < 1e-4
    fftlib.fft(x, n=1024)
    assert st.launches == c2c + 1
    assert bl.launches == {**before, "bluestein_onepass": onepass + 2}
    xu = _x((2, 4099), seed=12, dev=dev)
    stage1 = lg.launches["stage1"] + lg.launches["cube"]
    yu = fftlib.fft(xu)
    assert lg.launches["stage1"] + lg.launches["cube"] == stage1 + 2
    want = torch.fft.fft(xu.to(torch.complex128))
    assert _rel(yu.to(torch.complex128), want) <= MAX_REL["float32"]
    for n in (400, 401):
        r = _r((3, n), n, dev)
        assert _rel(fftlib.rfft(r).to(torch.complex128), torch.fft.rfft(r.double())) \
            <= MAX_REL["float32"]
        assert (fftlib.irfft(fftlib.rfft(r), n=n) - r).abs().max().item() < 1e-4
    xg = x.clone().requires_grad_()
    g = _x((4, 1000), seed=13, dev=dev)
    fftlib.fft(xg).backward(g)
    assert _rel(xg.grad.to(torch.complex128),
                torch.fft.ifft(g.to(torch.complex128)) * 1000) <= MAX_REL["float32"]


def test_bluestein_kernels_refuse_what_they_do_not_take(dev):
    from watfft_tpu_torch.ops import bluestein as bl
    for n in (12, 4099):  # the fused and the unfused route
        with pytest.raises(TypeError, match="float32"):
            bl.bluestein_fft_nb(*(torch.zeros(n, 2, device=dev, dtype=torch.float64),) * 2)
    bt = bl.device_bluestein_tables(12, False, dev)
    x = torch.zeros(2 * bt.m, device=dev)
    for key in ("bluestein_fwd", "bluestein_onepass"):
        with pytest.raises(RuntimeError, match="out of range"):  # n > m: kErrArgs
            bl._launch(key, (x, x), (1, bt.m), (x, x), (1, bt.m), bt.m + 1, 1, bt)


# -- #20, the small-n DFT matmul ---------------------------------------------------------

def _dft_batches(n):
    """Batch 1, 3, one tile plus one and past the resident grid by a tail. A
    tile of the tensor-core kernel holds 256 transforms over its m-tiles,
    ceil(n / 16) rounded up to a power of two (csrc/mxu_dft.cu `MmaTile`);
    its grid is two blocks an SM at most."""
    t = 256 // (1 << (-(-n // 16) - 1).bit_length())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (1, 3, t + 1, 2 * sms * t + t // 2 + 3)


@pytest.mark.parametrize("n", range(1, 129))
def test_dft_matmul_matches_plain_all_layouts(n, dev):
    """Either kernel (the FP32 cores at n <= SIMT_MAX_N, the tensor cores in
    3xTF32 past it) against the plain version, three layouts, both
    directions."""
    from watfft_tpu_torch.ops import mxu_dft as md
    for batch in _dft_batches(n):
        x = _x((batch, n), seed=n + batch, dev=dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        for inverse in (False, True):
            before = md.launches
            want = md.plain_dft_matmul(x, None, inverse, layout="complex")
            assert md.launches == before
            assert _rel(md.dft_matmul(x, inverse), want) <= KERNEL_LIMIT
            assert _rel(torch.complex(*md.dft_matmul_bm(re, im, inverse)), want) <= KERNEL_LIMIT
            tre, tim = md.dft_matmul_nb(re.T.contiguous(), im.T.contiguous(), inverse)
            assert _rel(torch.complex(tre, tim).T, want) <= KERNEL_LIMIT
            assert md.launches == before + 3
            ref = (torch.fft.ifft if inverse else torch.fft.fft)(x.to(torch.complex128))
            assert _rel(md.dft_matmul(x, inverse).to(torch.complex128), ref) \
                <= MAX_REL["float32"]


@pytest.mark.parametrize("n", [3, 16, 17, 64, 100, 128])
def test_dft_matmul_on_views_one_float_off(n, dev):
    """Interleaved points whose re sits one float off 8-byte alignment: the
    copies (or the stores) take a plane at a time, the other side pairs."""
    from watfft_tpu_torch.ops import mxu_dft as md
    for batch in _dft_batches(n)[1:3]:
        flat = torch.rand(2 * n * batch + 3, device=dev) * 2 - 1
        for off in (0, 1):
            got, want = torch.zeros_like(flat), torch.zeros_like(flat)
            for run, y in ((md._launch, got), (md._plain, want)):
                run((flat[off:], flat[off + 1:]), (2, 2 * n), (y[1 - off:], y[2 - off:]),
                    (2, 2 * n), n, batch, False)
            assert _rel(got, want) <= KERNEL_LIMIT
            assert md.dft_launch(n, (flat[off:].data_ptr(), flat[off + 1:].data_ptr(), 2, 2 * n),
                                 (got[1 - off:].data_ptr(), got[2 - off:].data_ptr(), 2, 2 * n)
                                 )[1:] == (1 - off, off)


def test_dft_matmul_refuses_what_it_does_not_take(dev):
    import ctypes
    from watfft_tpu_torch.ops import _build
    from watfft_tpu_torch.ops import mxu_dft as md
    x = torch.zeros(129, 4, device=dev)
    with pytest.raises(ValueError, match="DIRECT_MAX"):
        md.dft_matmul_nb(x, x)
    with pytest.raises(TypeError, match="float32"):
        md.dft_matmul_nb(x[:8].double(), x[:8].double())
    with pytest.raises(RuntimeError, match="no gradient"):
        md.dft_matmul_nb(x[:8].requires_grad_(), x[:8])
    wt = md.device_matrix(128, False, dev)
    frag = ctypes.c_void_p(md.device_fragments(128, False, dev).data_ptr())
    lib = _build.library()
    y = torch.zeros(2 * 128 * 4, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def entry(xre, xim, sn, sb, n, kernel, pairs_x, pairs_y):
        err = lib.watfft_dft_matmul(xre, xim, y.data_ptr(), y.data_ptr() + 4, sn, sb, 2,
                                    2 * 128, n, 4, wt.data_ptr(), stream, frag, kernel,
                                    pairs_x, pairs_y)
        return lib.watfft_error_string(err).decode() if err else ""
    p = x.data_ptr()
    for n in (0, 129):  # the kernel's own refusal, before any launch
        for kernel in (md.KERNEL_SIMT, md.KERNEL_MMA):
            assert "1..128" in entry(p, p, 4, 1, n, kernel, 0, 0)
    assert "pairs refused" in entry(p, p + 4 * 129 * 4, 1, 128, 128, md.KERNEL_MMA, 1, 0)
    assert "pairs refused" in entry(p + 4, p + 8, 2, 256, 128, md.KERNEL_MMA, 1, 0)
    assert "pairs refused" in entry(p, p + 4, 2, 256, 128, md.KERNEL_SIMT, 1, 1)
    for kernel in (3, md.KERNEL_SIMT):  # an unknown kernel; no FP32-core one at n = 128
        assert "out of range" in entry(p, p + 4, 2, 256, 128, kernel, 0, 0)
    xs = torch.zeros(2 * 128 * 4, device=dev)
    assert entry(xs.data_ptr(), xs.data_ptr() + 4, 2, 256, 128, md.KERNEL_MMA, 1, 1) == ""
    torch.cuda.synchronize()


# -- #1's bf16 tiers -------------------------------------------------------------------------

# kernel against plain version, both in bf16: at most one bf16 ulp (2^-7
# relative) at the largest output; the interop tier's f32 stages contract
# into FMAs where the plain version rounds op by op, which may flip a
# rounding of the bf16 store
BF16_KERNEL_LIMIT = 2.0 ** -7


def _bf16(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev)
                 .to(torch.bfloat16) for _ in range(2))


def _rel_bf16(got, want):
    got = [g.float().cpu() for g in got]
    want = [w.float().cpu() for w in want]
    return max((g - w).abs().max().item() for g, w in zip(got, want)) / max(
        w.abs().max().item() for w in want)


@pytest.mark.parametrize("n", [1 << k for k in range(1, 13)])
def test_bf16_tiers_match_plain(n, dev, monkeypatch):
    from watfft_tpu_torch import config
    for batch in (1, 3, 257):
        re, im = _bf16((n, batch), seed=n + batch, dev=dev)
        cpu = (re.cpu(), im.cpu())
        for inverse in (False, True):
            for compute in (False, True):
                monkeypatch.setattr(config, "BF16_COMPUTE", compute)
                counts = (st.launches, st.launches_bf16, st.launches_bf16c)
                got = st.stockham_fft_nb(re, im, inverse)
                assert got[0].dtype == torch.bfloat16
                want = st.stockham_fft_nb(*cpu, inverse)  # the plain version, on the CPU
                assert _rel_bf16(got, want) <= BF16_KERNEL_LIMIT
                assert (st.launches, st.launches_bf16, st.launches_bf16c) == (
                    counts[0], counts[1] + (not compute), counts[2] + compute)
            # batch-major planes take the interop tier whatever the switch says
            bre, bim = st.stockham_fft_bm(re.T.contiguous(), im.T.contiguous(), inverse)
            want = st.stockham_fft_bm(cpu[0].T.contiguous(), cpu[1].T.contiguous(), inverse)
            assert _rel_bf16((bre, bim), want) <= BF16_KERNEL_LIMIT


def test_bf16_folded_view_and_backward(dev, monkeypatch):
    from watfft_tpu_torch import config
    monkeypatch.setattr(config, "BF16_COMPUTE", True)
    n, b = 64, 1024
    re, im = _bf16((n, b), seed=5, dev=dev)
    before = (st.launches_bf16, st.launches_bf16c)
    f3 = st.stockham_fft_nb(re.view(n, 8, b // 8), im.view(n, 8, b // 8))  # interop
    f2 = st.stockham_fft_nb(re, im)                                          # compute
    assert (st.launches_bf16, st.launches_bf16c) == (before[0] + 1, before[1] + 1)
    assert f3[0].shape == (n, 8, b // 8) and f3[0].dtype == torch.bfloat16
    x = torch.complex(re.double(), im.double())
    ref = torch.fft.fft(x, dim=0)
    for out, lim in ((f3, 3e-2), (f2, 5e-2)):
        got = torch.complex(out[0].reshape(n, b).double(), out[1].reshape(n, b).double())
        assert _rel(got, ref) < lim
    rg, ig = re.clone().requires_grad_(), im.clone().requires_grad_()
    yre, yim = st.stockham_fft_nb(rg, ig)
    (yre.float().sum() + 2 * yim.float().sum()).backward()
    assert rg.grad.dtype == torch.bfloat16
    rf, imf = (t.float().cpu().requires_grad_() for t in (re, im))  # f32, the plain version
    yre, yim = st.stockham_fft_nb(rf, imf)
    (yre.sum() + 2 * yim.sum()).backward()
    want = torch.complex(rf.grad.double(), imf.grad.double())
    assert _rel(torch.complex(rg.grad.double().cpu(), ig.grad.double().cpu()), want) < 5e-2


# -- the column tile (walks down columns) -----------------------------------------------------

# (planes, tables, limit against the plain version): f32, FP64, bf16 interop, bf16 compute
TILE_TIERS = [(torch.float32, torch.float32, KERNEL_LIMIT),
              (torch.float64, torch.float64, F64_KERNEL_LIMIT),
              (torch.bfloat16, torch.float32, BF16_KERNEL_LIMIT),
              (torch.bfloat16, torch.bfloat16, BF16_KERNEL_LIMIT)]


def _planes_on(shape, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev)
                 .to(dtype) for _ in range(2))


def _rel_planes(got, want):
    return max((g.double() - w.double()).abs().max().item() for g, w in zip(got, want)) / max(
        w.double().abs().max().item() for w in want)


def _at_t(fn, monkeypatch):
    from watfft_tpu_torch import config
    monkeypatch.setattr(config, "COLUMN_TILE", 0)
    out = fn()
    monkeypatch.setattr(config, "COLUMN_TILE", None)
    return out


@pytest.mark.parametrize("dtype,tdtype,limit", TILE_TIERS)
@pytest.mark.parametrize("n", [16, 256, 1024, 2048, 4096])
def test_column_tile_c2c_matches_plain_and_the_engine(n, dtype, tdtype, limit, dev,
                                                      monkeypatch):
    C, threads = st.tile_shape(n, dtype.itemsize, 2 * tdtype.itemsize, batch=1 << 16)
    assert C > st.engine_transforms(n)
    for batch in (C * st.SMS + 3, C * st.SMS // 2 + 1):   # tails: a partial last tile
        re, im = _planes_on((n, batch), dtype, n + batch, dev)
        for inverse in (False, True):
            tabs = st.device_tables(n, inverse, dev, tdtype)
            got = st.stockham_fft_nb(re, im, inverse, tabs)
            same = _at_t(lambda: st.stockham_fft_nb(re, im, inverse, tabs), monkeypatch)
            assert all(torch.equal(a, b) for a, b in zip(got, same))
            assert _rel_planes(got, st.plain_fft_nb(re, im, inverse, tabs)) <= limit


def test_column_tile_blocks_of_either_size_agree(dev, monkeypatch):
    from watfft_tpu_torch import config
    n, batch = 1024, 8 * st.SMS + 5
    re, im = _planes_on((n, batch), torch.float32, 3, dev)
    outs = []
    for tile in (0, (8, 256), (8, 512), (16, 256), (16, 512)):
        monkeypatch.setattr(config, "COLUMN_TILE", tile)
        outs.append(st.stockham_fft_nb(re, im))
    assert all(torch.equal(a, b) for out in outs[1:] for a, b in zip(out, outs[0]))


@pytest.mark.parametrize("shape", [(4096, 2, 265), (1024, 2, 529), (2048, 16, 33),
                                   (1024, 4096, 1)])
def test_column_tile_fft2_cols_matches(shape, dev, monkeypatch):
    re, im = _planes_on(shape, torch.float32, sum(shape), dev)
    for inverse in (False, True):
        got = f2.fft2_cols(re, im, inverse)
        same = _at_t(lambda: f2.fft2_cols(re, im, inverse), monkeypatch)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
        assert _rel_planes(got, f2.plain_fft2_cols(re, im, inverse)) <= KERNEL_LIMIT
    # batch-major [B, h, w] at w = 2: a tile of the 2 columns of each image
    b, h, w = 265, 4096, 2
    x = _x((b, h, w), seed=9, dev=dev)
    got = f2.fft2_complex(x)
    assert torch.equal(got, _at_t(lambda: f2.fft2_complex(x), monkeypatch))
    assert _rel(got, f2.plain_fft2(x)) <= KERNEL_LIMIT


@pytest.mark.parametrize("n2,n1,b", [(1024, 1024, 3), (4096, 64, 9), (1024, 16, 67)])
def test_column_tile_pipe2_stages_match(n2, n1, b, dev, monkeypatch):
    re, im = _planes_on((n2, n1, b), torch.float32, n2 + b, dev)
    for inverse in (False, True):
        for fn, plain in ((lg.stage1, lg.plain_stage1), (lg.stage2, lg.plain_stage2)):
            got = fn(re, im, inverse)
            same = _at_t(lambda: fn(re, im, inverse), monkeypatch)
            assert all(torch.equal(a, c) for a, c in zip(got, same))
            assert _rel_planes(got, plain(re, im, inverse)) <= KERNEL_LIMIT
    re2, im2 = _planes_on((2, 4096, 265), torch.float32, 11, dev)
    got = f2.fft2_k2(re2, im2)
    assert all(torch.equal(a, c) for a, c in
               zip(got, _at_t(lambda: f2.fft2_k2(re2, im2), monkeypatch)))


def test_column_tile_refusals(dev, monkeypatch):
    from watfft_tpu_torch import config
    from watfft_tpu_torch.ops import _build
    re, im = _planes_on((1024, 40), torch.float32, 1, dev)
    for tile in (3, 2, 1 << 10, (8, 384)):
        monkeypatch.setattr(config, "COLUMN_TILE", tile)
        with pytest.raises(ValueError, match="column tile"):
            st.stockham_fft_nb(re, im)
    monkeypatch.setattr(config, "COLUMN_TILE", None)
    # the kernels' own refusals, before any launch (kErrTile = -6)
    lib = _build.library()
    tabs = st.device_tables(1024, False, dev)
    x = torch.zeros(1024 * 8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for cols, threads in ((3, 0), (2, 0), (64, 0), (1 << 20, 0), (8, 384), (16, 256)):
        if (cols, threads) == (16, 256):
            cols, n, t16 = 512, 16, st.device_tables(16, False, dev)  # more columns than threads
            err = lib.watfft_stockham_c2c(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                          8, 1, 8, 1, n, 8, t16.twre.data_ptr(),
                                          t16.twim.data_ptr(), t16.c_radices, t16.c_offsets,
                                          len(t16.stages), 0, stream, cols, threads,
                                          st.WALK_ENGINE, 0, 0)
        else:
            err = lib.watfft_stockham_c2c(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                          8, 1, 8, 1, 1024, 8, tabs.twre.data_ptr(),
                                          tabs.twim.data_ptr(), tabs.c_radices, tabs.c_offsets,
                                          len(tabs.stages), 0, stream, cols, threads,
                                          st.WALK_ENGINE, 0, 0)
        assert err == -6, (cols, threads, err)
    assert "column tile" in lib.watfft_error_string(-6).decode()


# -- the redesigned kernels: the cube (#12) and the fused f32 r2c (#9) -------------------

@pytest.mark.parametrize("n", [1 << 13, 1 << 14])
def test_resident_cube_matches_plain_and_pipe2(n, dev):
    """Three layouts, batch 1, a few sequences, and more than the SMs hold
    at once by a tail, both directions: within KERNEL_LIMIT of the plain
    version and equal to pipe2's kernels (the same operations in two
    passes)."""
    for batch in (1, 5, 2 * st.SMS + 7):
        x = _x((batch, n), seed=n + batch, dev=dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        calls = {"complex": lambda inv, mode: (lg.fft_large_complex(x, inv, mode=mode),),
                 "bm": lambda inv, mode: lg.fft_large_bm(re, im, inv, mode=mode)}
        if batch <= 5:
            calls["nb"] = lambda inv, mode: tuple(t.T for t in lg.fft_large_nb(
                re.T.contiguous(), im.T.contiguous(), inv, mode=mode))
        for inverse in (False, True):
            want = lg.plain_fft_large(x, inverse)
            for layout, call in calls.items():
                got, two_pass = call(inverse, "cube"), call(inverse, "pipe2")
                assert all(torch.equal(a, b) for a, b in zip(got, two_pass)), (
                    layout, batch, inverse)
                y = got[0] if layout == "complex" else torch.complex(*got)
                assert _rel(y, want) <= KERNEL_LIMIT


@pytest.mark.parametrize("n", [1 << 13, 1 << 14])
def test_resident_cube_on_misaligned_views(n, dev):
    """Interleaved points 4 bytes off 8-byte alignment take the 4-byte
    copies (input) and stores (output)."""
    batch = 6
    flat = _r((2 * n * batch + 3,), 12, dev)
    for off in (0, 1):
        out = torch.zeros_like(flat)
        views = [torch.as_strided(t, (n, batch), (2, 2 * n), o)
                 for t, o in ((flat, off), (flat, off + 1), (out, 1 - off), (out, 2 - off))]
        for inverse in (False, True):
            lg.fft_large_views(*views, inverse, mode="cube")
            got = torch.complex(views[2], views[3])
            x = torch.complex(views[0], views[1]).T.contiguous()
            want = lg.plain_fft_large(x, inverse).T
            assert _rel(got, want) <= KERNEL_LIMIT


def test_resident_cube_refusals(dev):
    """The kernel refuses, before any launch, a block other than 256 or 512
    threads (kErrCube = -7) and 8-byte pairs where re and im are not
    adjacent in 8-byte aligned points (kErrPairs = -8)."""
    from watfft_tpu_torch.ops import _build
    lib = _build.library()
    n = 1 << 13
    lt = lg.device_large_tables(n, False, dev)
    t1, t2 = lt.t1, lt.t2
    buf = torch.zeros(2 * n * 3 + 2, device=dev)
    p = buf.data_ptr()

    def cube(x, y, threads, pairs_x, pairs_y):
        return lib.watfft_large_cube(
            *x[:2], *y[:2], *x[2:], *y[2:], lt.n1, lt.n2, 3, lt.pmre.data_ptr(),
            lt.pmim.data_ptr(), t1.twre.data_ptr(), t1.twim.data_ptr(), t1.c_radices,
            t1.c_offsets, len(t1.stages), t2.twre.data_ptr(), t2.twim.data_ptr(),
            t2.c_radices, t2.c_offsets, len(t2.stages), 0,
            torch.cuda.current_stream().cuda_stream, threads, pairs_x, pairs_y)
    pairs = (p, p + 4, 2, 2 * n)
    for threads in (384, 1024, 0):
        assert cube(pairs, pairs, threads, 1, 1) == -7, threads
    for x in ((p + 4, p + 8, 2, 2 * n), (p, p + 4, 2, 2 * n + 1), (p, p + 8 * n, 1, n)):
        assert cube(x, pairs, 256, 1, 0) == -8, x
        assert cube(pairs, x, 256, 0, 1) == -8, x
    assert "cube block" in lib.watfft_error_string(-7).decode()
    assert "8-byte pairs" in lib.watfft_error_string(-8).decode()


@pytest.mark.parametrize("n", [1 << k for k in range(2, 14)])
def test_resident_r2c_matches_plain_and_the_engine(n, dev, monkeypatch):
    """Three layouts and rows 4 bytes off 8-byte alignment (4-byte copies),
    batch 1, a few tiles, and more than the resident grid by a tail that is
    not a multiple of T: within KERNEL_LIMIT of the plain version and equal
    to the engine's walk (the parent's kernel), both kernels forced at
    every n."""
    m = n // 2
    T = st.engine_transforms(m, max(r for r, _ in st.stage_plan(m)))
    for batch in (1, 3, 2 * st.SMS * T + T // 2 + 1):
        flat = _r((batch * n + 1,), n + batch, dev)
        x, xm = flat[:-1].view(batch, n), flat[1:].view(batch, n)
        want = rf.plain_rfft(x)
        calls = {"complex": lambda: (rf.rfft(x),), "bm": lambda: rf.rfft_bm(x),
                 "nb": lambda: tuple(t.T for t in rf.rfft_nb_fused(x.T.contiguous())),
                 "misaligned": lambda: (rf.rfft(xm),)}
        for layout, call in calls.items():
            _walk(monkeypatch, rf.WALK_RESIDENT)
            got = call()
            monkeypatch.undo()
            _walk(monkeypatch, rf.WALK_ENGINE)
            engine = call()
            monkeypatch.undo()
            assert all(torch.equal(a, b) for a, b in zip(got, engine)), (layout, batch)
            y = got[0] if len(got) == 1 else torch.complex(*got)
            ref = rf.plain_rfft(xm) if layout == "misaligned" else want
            assert _rel(y, ref) <= KERNEL_LIMIT, (layout, batch)


def test_resident_r2c_refusals(dev):
    """The f32 entry refuses a walk other than 1 or 2 (kErrArgs = -1) and
    8-byte pairs on the engine's walk or where the layout does not allow
    them (kErrPairs = -8)."""
    n, batch = 1024, 3
    rt = rf.device_rtables(n, False, dev)
    x = torch.zeros(batch * n + 2, device=dev)
    y = torch.zeros(2 * batch * (n // 2 + 1) + 2, device=dev)
    lib, targs = rf._kernel_args(rt, x, "rfft_r2c_fused")
    stream = torch.cuda.current_stream().cuda_stream
    xp, yp = x.data_ptr(), y.data_ptr()
    m1 = n // 2 + 1

    def r2c(xa, x_sb, ya, walk, px, py):
        return lib.watfft_rfft_r2c(xa, 1, x_sb, ya, ya + 4, 2, 2 * m1, n, batch, *targs,
                                   stream, walk, px, py)
    for walk in (0, 3):
        assert r2c(xp, n, yp, walk, 0, 0) == -1, walk
    assert r2c(xp, n, yp, rf.WALK_ENGINE, 1, 0) == -8
    assert r2c(xp, n, yp, rf.WALK_ENGINE, 0, 1) == -8
    assert r2c(xp + 4, n, yp, rf.WALK_RESIDENT, 1, 1) == -8      # rows 4 bytes off
    assert r2c(xp, n + 1, yp, rf.WALK_RESIDENT, 1, 1) == -8      # an odd row stride
    assert r2c(xp, n, yp + 4, rf.WALK_RESIDENT, 1, 1) == -8      # bins 4 bytes off
    torch.cuda.synchronize()


# -- the redesigned batch-major walk: the c2c kernel (f32, FP64) and the FP64 r2c ----------

_C2C_LAUNCH, _R2C_LAUNCH = st.c2c_launch, rf.r2c_launch
_WALKS = (st.WALK_ENGINE, st.WALK_RESIDENT, st.WALK_BLOCK)


def _walk(monkeypatch, walk):
    """The c2c and r2c wrappers forced to one batch-major walk at every n
    (st.WALK_ENGINE: the kernels before the redesign, no pairs), with the
    pairs the rules give; launches that take a column tile or walk down
    columns keep what the rule gives, and the r2c takes its precision's
    one redesigned walk for either."""
    def c2c(n, dtype, cols, x, y):
        got = _C2C_LAUNCH(n, dtype, cols, x, y)
        if not got or cols != (0, 0) or x[2] > x[3] or y[2] > y[3]:
            return got
        if walk == st.WALK_ENGINE:
            return walk, 0, 0
        return walk, *(int(st.complex_pairs(*s, dtype.itemsize)) for s in (x, y))

    def r2c(n, x, y, size=4):
        return (walk, 0, 0) if walk == st.WALK_ENGINE else _R2C_LAUNCH(1 << 13, x, y, size)
    monkeypatch.setattr(st, "c2c_launch", c2c)
    monkeypatch.setattr(rf, "r2c_launch", r2c)


def _in_walks(monkeypatch, call):
    """call()'s outputs in each walk: the two redesigned walks equal to the
    engine's; returns the resident walk's."""
    outs = []
    for walk in _WALKS:
        _walk(monkeypatch, walk)
        outs.append(call())
        monkeypatch.undo()
    engine, *redesigned = outs
    for got in redesigned:
        assert all(torch.equal(a, b) for a, b in zip(got, engine))
    return outs[1]


def _c2c_layouts(x, inverse):
    """The batch-major layouts of the complex [batch, n] x, each holding x:
    interleaved complex, split planes, views one scalar off alignment, and
    the even and odd rows of a contiguous signal (the real core's views)."""
    batch, n = x.shape
    real = x.real.dtype
    tabs = st.device_tables(n, inverse, x.device, real)
    re, im = x.real.contiguous(), x.imag.contiguous()
    flat = torch.empty(2 * batch * n + 1, dtype=real, device=x.device)
    flat[1:].view(batch, n, 2).copy_(torch.view_as_real(x))
    xv = torch.view_as_real(x).reshape(batch, 2 * n).T

    def misaligned():
        out = torch.empty(batch, n, 2, dtype=real, device=x.device)
        views = [torch.as_strided(flat, (n, batch), (2, 2 * n), 1 + k) for k in (0, 1)]
        st.fft_views(*views, out[..., 0].T, out[..., 1].T, inverse, tabs)
        return (torch.view_as_complex(out),)

    def real_core():
        zre, zim = (torch.empty(batch, n, dtype=real, device=x.device) for _ in range(2))
        st.fft_views(xv[0::2], xv[1::2], zre.T, zim.T, inverse, tabs)
        return zre, zim
    return {"complex": lambda: (st.stockham_fft(x, inverse),),
            "bm": lambda: st.stockham_fft_bm(re, im, inverse),
            "misaligned": misaligned, "real_core": real_core}


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [1 << k for k in range(1, 13)])
def test_c2c_walk_matches_plain_and_the_engine(n, cdtype, dev, monkeypatch):
    """Four layouts, batch 1, a tail under one tile, and more tiles than
    the resident grid by a tail, both directions: the resident blocks and
    the block a tile equal to the engine's walk (the kernel before the
    redesign) and within the precision's limit of the plain version."""
    limit = KERNEL_LIMIT if cdtype == torch.complex64 else F64_KERNEL_LIMIT
    T = st.engine_transforms(n, max(r for r, _ in st.stage_plan(n)))
    for batch in (1, T // 2 + 1, 2 * st.SMS * T + T // 2 + 1):
        x = _x((batch, n), seed=n + batch, dev=dev).to(cdtype)
        for inverse in (False, True):
            want = st.plain_fft(x, inverse)
            for layout, call in _c2c_layouts(x, inverse).items():
                got = _in_walks(monkeypatch, call)
                y = got[0] if len(got) == 1 else torch.complex(*got)
                assert _rel(y, want) <= limit, (layout, batch, inverse)


def test_c2c_walk_rows_pass(dev, monkeypatch):
    """The 2-pass route's rows pass (#16) of a 1024^2 image in each walk."""
    x = _x((1, 1024, 1024), seed=5, dev=dev)
    for inverse in (False, True):
        got = _in_walks(monkeypatch, lambda: (f2._complex_route(x, inverse, "fft2-2pass"),))
        assert _rel(got[0], f2.plain_fft2(x, inverse)) <= KERNEL_LIMIT


@pytest.mark.parametrize("n", [1 << k for k in range(2, 14)])
def test_r2c_f64_walk_matches_plain_and_the_engine(n, dev, monkeypatch):
    """Four layouts (rows 8 bytes off 16-byte alignment among them), batch
    1, 3 and past the resident grid by a tail: each walk equal to the
    engine's and within F64_KERNEL_LIMIT of the plain version."""
    m = n // 2
    T = st.engine_transforms(m, max(r for r, _ in st.stage_plan(m)))
    for batch in (1, 3, 2 * st.SMS * T + T // 2 + 1):
        flat = _r((batch * n + 1,), n + batch, dev).double()
        x, xm = flat[:-1].view(batch, n), flat[1:].view(batch, n)
        calls = {"complex": (lambda: (rf.rfft(x),), x), "bm": (lambda: rf.rfft_bm(x), x),
                 "nb": (lambda: tuple(t.T for t in rf.rfft_nb_fused(x.T.contiguous())), x),
                 "misaligned": (lambda: (rf.rfft(xm),), xm)}
        for layout, (call, src) in calls.items():
            got = _in_walks(monkeypatch, call)
            y = got[0] if len(got) == 1 else torch.complex(*got)
            assert _rel(y, rf.plain_rfft(src)) <= F64_KERNEL_LIMIT, (layout, batch)


def test_c2c_walk_refusals(dev):
    """The f32 and FP64 c2c entries refuse a walk other than 1..3, and a
    redesigned walk with a column tile (kErrArgs = -1); pairs on the
    engine's walk, or where re and im are not adjacent in points aligned to
    a whole point (kErrPairs = -8)."""
    from watfft_tpu_torch.ops import _build
    lib = _build.library()
    n, batch = 1024, 3
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, entry in ((torch.float32, lib.watfft_stockham_c2c),
                         (torch.float64, lib.watfft_stockham_c2c_f64)):
        size = dtype.itemsize
        tabs = st.device_tables(n, False, dev, dtype)
        buf = torch.zeros(2 * n * batch + 2, dtype=dtype, device=dev)
        out = torch.zeros_like(buf)
        p, q = buf.data_ptr(), out.data_ptr()

        def c2c(x, y, walk, px, py, cols=0, threads=0):
            return entry(*x[:2], *y[:2], *x[2:], *y[2:], n, batch, tabs.twre.data_ptr(),
                         tabs.twim.data_ptr(), tabs.c_radices, tabs.c_offsets,
                         len(tabs.stages), 0, stream, cols, threads, walk, px, py)
        xs, ys = (p, p + size, 2, 2 * n), (q, q + size, 2, 2 * n)
        for walk in (0, 4):
            assert c2c(xs, ys, walk, 0, 0) == -1, (dtype, walk)
        assert c2c(xs, ys, st.WALK_RESIDENT, 0, 0, cols=8, threads=256) == -1
        assert c2c(xs, ys, st.WALK_ENGINE, 1, 0) == -8
        assert c2c(xs, ys, st.WALK_ENGINE, 0, 1) == -8
        for walk in (st.WALK_RESIDENT, st.WALK_BLOCK):
            for bad in ((p + size, p + 2 * size, 2, 2 * n),     # one scalar off
                        (p, p + size, 2, 2 * n + 1),            # an odd batch stride
                        (p, p + 2 * size, 2, 2 * n),            # not adjacent
                        (p, p + 4 * n * size, 1, n)):           # split planes
                assert c2c(bad, ys, walk, 1, 0) == -8, (dtype, walk, bad)
                assert c2c(xs, bad, walk, 0, 1) == -8, (dtype, walk, bad)
    assert "pairs" in lib.watfft_error_string(-8).decode()
    torch.cuda.synchronize()


def test_r2c_f64_walk_refusals(dev):
    """The FP64 r2c entry refuses a walk other than 1 and 3 (kErrArgs =
    -1), and pairs on the engine's walk or where the layout does not allow
    them (kErrPairs = -8)."""
    n, batch = 1024, 3
    rt = rf.device_rtables(n, False, dev, torch.float64)
    x = torch.zeros(batch * n + 2, dtype=torch.float64, device=dev)
    y = torch.zeros(2 * batch * (n // 2 + 1) + 2, dtype=torch.float64, device=dev)
    lib, targs = rf._kernel_args(rt, x, "rfft_r2c_fused")
    stream = torch.cuda.current_stream().cuda_stream
    xp, yp = x.data_ptr(), y.data_ptr()
    m1 = n // 2 + 1

    def r2c(xa, x_sb, ya, walk, px, py):
        return lib.watfft_rfft_r2c_f64(xa, 1, x_sb, ya, ya + 8, 2, 2 * m1, n, batch, *targs,
                                       stream, walk, px, py)
    for walk in (0, rf.WALK_RESIDENT, 4):
        assert r2c(xp, n, yp, walk, 0, 0) == -1, walk
    assert r2c(xp, n, yp, rf.WALK_ENGINE, 1, 0) == -8
    assert r2c(xp, n, yp, rf.WALK_ENGINE, 0, 1) == -8
    assert r2c(xp + 8, n, yp, rf.WALK_BLOCK, 1, 1) == -8      # rows 8 bytes off
    assert r2c(xp, n + 1, yp, rf.WALK_BLOCK, 1, 1) == -8      # an odd row stride
    assert r2c(xp, n, yp + 8, rf.WALK_BLOCK, 1, 1) == -8      # bins 8 bytes off
    torch.cuda.synchronize()


# -- the redesigned f32 c2r and 2D cube ---------------------------------------------------

def _c2r_walk(monkeypatch, walk):
    """The f32 c2r wrapper forced to one walk at every n (rf.WALK_ENGINE:
    the kernel before the redesign, no pairs), with its pairs
    (`c2r_pairs`)."""
    def c2r(n, x, y):
        return (walk, 0, 0) if walk == rf.WALK_ENGINE else (walk, *rf.c2r_pairs(x, y))
    monkeypatch.setattr(rf, "c2r_launch", c2r)


def _cube2_walk(monkeypatch, walk, direct=None):
    """The 2D cube's wrapper forced to one walk (st.WALK_ENGINE: the kernel
    before the redesign; st.WALK_BLOCK the redesigned one), with the pairs
    the rule gives; `direct` forces where the row pass stores."""
    def cube(h, w, x, y, radix=None):
        if walk == st.WALK_ENGINE:
            return walk, 0, 0, 0
        got = f2.cube2_block(h, w, x, y, radix)
        return (*got[:3], got[3] if direct is None else direct)
    monkeypatch.setattr(f2, "cube2_launch", cube)


def _c2r_layouts(spec, dev):
    """The c2r's layouts of the complex [batch, m+1] spectrum, each a
    function returning the [batch, n] signal: interleaved complex, split
    planes, time-major planes, and through `_launch_c2r` the interleaved
    spectrum one scalar off its point's alignment into signal rows one
    scalar off theirs (pairs refused on both sides)."""
    batch, m1 = spec.shape
    n, real = 2 * (m1 - 1), spec.real.dtype
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    flat = torch.zeros(2 * batch * m1 + 1, dtype=real, device=dev)
    flat[1:].view(batch, m1, 2).copy_(torch.view_as_real(spec))
    rt = rf.device_rtables(n, True, dev, real)

    def misaligned():
        out = torch.zeros(batch * n + 1, dtype=real, device=dev)
        p, size = flat.data_ptr() + real.itemsize, real.itemsize
        rf._launch_c2r(flat, p, p + size, 2, 2 * m1, out[1:], 1, n, n, batch, rt)
        return out[1:].view(batch, n)
    return {"complex": lambda: rf.irfft(spec), "bm": lambda: rf.irfft_bm(re, im),
            "nb": lambda: rf.irfft_nb_fused(re.T.contiguous(), im.T.contiguous()).T,
            "misaligned": misaligned}


@pytest.mark.parametrize("n", [1 << k for k in range(2, 14)])
def test_c2r_walks_match_plain_and_the_engine(n, dev, monkeypatch):
    """Four layouts, batch 1, 5 and 271: the f32 c2r's resident blocks
    torch.equal to the engine's walk (the kernel before the redesign), and
    within KERNEL_LIMIT of the plain version; the inverse on spectra whose
    DC and Nyquist bins have nonzero imaginary parts."""
    for batch in (1, 5, 271):
        m1 = n // 2 + 1
        spec = torch.complex(_r((batch, m1), n + batch, dev), _r((batch, m1), 2 * n + batch, dev))
        want = rf.plain_irfft(spec)
        for layout, call in _c2r_layouts(spec, dev).items():
            outs = []
            for walk in (rf.WALK_ENGINE, rf.WALK_RESIDENT):
                _c2r_walk(monkeypatch, walk)
                outs.append(call())
                monkeypatch.undo()
            assert torch.equal(outs[1], outs[0]), (layout, batch)
            assert _rel(outs[1], want) <= KERNEL_LIMIT, (layout, batch)


def test_c2r_walk_refusals(dev):
    """The f32 c2r entry refuses a walk other than 1 and 2 (kErrArgs = -1),
    and pairs on the engine's walk or where the layout does not allow them
    (kErrPairs = -8)."""
    n, batch = 1024, 3
    m1 = n // 2 + 1
    stream = torch.cuda.current_stream().cuda_stream
    rt = rf.device_rtables(n, True, dev)
    x = torch.zeros(2 * batch * m1 + 2, device=dev)
    y = torch.zeros(batch * n + 2, device=dev)
    lib, targs = rf._kernel_args(rt, x, "irfft_c2r_fused")
    xp, yp = x.data_ptr(), y.data_ptr()

    def c2r(xa, x_sb, ya, y_sn, y_sb, walk, px, py):
        return lib.watfft_irfft_c2r(xa, xa + 4, 2, x_sb, ya, y_sn, y_sb, n, batch, *targs,
                                    stream, walk, px, py)
    for walk in (0, rf.WALK_BLOCK, 4):
        assert c2r(xp, 2 * m1, yp, 1, n, walk, 0, 0) == -1, walk
    assert c2r(xp, 2 * m1, yp, 1, n, rf.WALK_ENGINE, 1, 0) == -8
    assert c2r(xp, 2 * m1, yp, 1, n, rf.WALK_ENGINE, 0, 1) == -8
    walk = rf.WALK_RESIDENT
    assert c2r(xp + 4, 2 * m1, yp, 1, n, walk, 1, 1) == -8     # bins off
    assert c2r(xp, 2 * m1 + 1, yp, 1, n, walk, 1, 1) == -8     # an odd batch stride
    assert c2r(xp, 2 * m1, yp + 4, 1, n, walk, 1, 1) == -8     # rows off
    assert c2r(xp, 2 * m1, yp, 1, n + 1, walk, 1, 1) == -8     # an odd row stride
    assert c2r(xp, 2 * m1, yp, 2, 2 * n, walk, 1, 1) == -8     # rows not contiguous
    torch.cuda.synchronize()


def _cube2_layouts(x, inverse):
    """The 2D cube's layouts of the complex [batch, h, w] x, each a function
    returning its output as complex [batch, h, w]: interleaved complex64,
    batch-major planes, native [h, w, B] planes, and the packed real layout
    (rfft2's input read as complex, irfft2's output written as real)."""
    re, im = x.real.contiguous(), x.imag.contiguous()
    nre, nim = re.permute(1, 2, 0).contiguous(), im.permute(1, 2, 0).contiguous()
    packed = torch.view_as_real(x).reshape(*x.shape[:-1], 2 * x.shape[-1])

    def real():
        if inverse:
            y = f2._transform(re, im, True, "bm", "real", "fft2-cube", None)
            return torch.view_as_complex(y.view(*x.shape, 2))
        return torch.complex(*f2._transform(packed, None, False, "real", "bm", "fft2-cube",
                                            None))
    return {"complex": lambda: f2._complex_route(x, inverse, "fft2-cube"),
            "bm": lambda: torch.complex(*f2._planes_route(re, im, inverse, "fft2-cube")),
            "nb": lambda: torch.complex(*f2._nb_route(nre, nim, inverse,
                                                      "fft2-cube")).permute(2, 0, 1),
            "real": real}


_CUBE2_PAIRS = [(1 << a, 1 << b) for a in range(1, 14) for b in range(1, 15 - a)]


@pytest.mark.parametrize("h,w", _CUBE2_PAIRS)
def test_cube2_walks_match_plain_and_the_engine(h, w, dev, monkeypatch):
    """Every h, w with h*w <= 2^14, four layouts, batch 1, 5 and 271, both
    directions: a block a tile, storing from the row pass's last stage and
    after it, torch.equal to the engine's walk (the kernel before the
    redesign), and within KERNEL_LIMIT of the plain version."""
    for batch in (1, 5, 271):
        x = _x((batch, h, w), seed=h + 3 * w + batch, dev=dev)
        for inverse in (False, True):
            want = f2.plain_fft2(x, inverse)
            for layout, call in _cube2_layouts(x, inverse).items():
                _cube2_walk(monkeypatch, st.WALK_ENGINE)
                engine = call()
                monkeypatch.undo()
                for direct in (0, 1):
                    _cube2_walk(monkeypatch, st.WALK_BLOCK, direct)
                    got = call()
                    monkeypatch.undo()
                    assert torch.equal(got, engine), (layout, batch, inverse, direct)
                assert _rel(engine, want) <= KERNEL_LIMIT, (layout, batch, inverse)


def _radix8_tables(n, inverse, dev):
    """Tables of an n-point plan of radix 8 and 4 stages, no radix 16."""
    stages, l, m = [], 1, n
    while m > 1:
        r = 8 if m % 8 == 0 else 4 if m % 4 == 0 else 2
        stages.append((r, l))
        l, m = l * r, m // r
    twre, twim, offsets = st.make_twiddle_pack(n, inverse, stages=stages)
    return st.make_tables(stages, offsets, twre, twim, dev)


def test_cube2_small_radix_plans(dev):
    """Plans with no radix-16 axis take the engine's walk where they may
    need a 512-thread block (`cube2_launch`), and match the plain version
    on them; the redesigned walk below that point."""
    for h, w in ((8, 16), (128, 128), (2, 1024)):
        x = _x((3, h, w), seed=h + w, dev=dev)
        for inverse in (False, True):
            tables = tuple(_radix8_tables(n, inverse, dev) for n in (h, w))
            got = f2._complex_route(x, inverse, "fft2-cube", tables)
            assert _rel(got, f2.plain_fft2(x, inverse)) <= KERNEL_LIMIT, (h, w, inverse)


def test_cube2_walk_refusals(dev):
    """The 2D cube's entry refuses a walk other than 1 and 3, and the
    redesigned walk on a 512-thread block without a radix-16 axis (kErrArgs
    = -1), and pairs or a store choice on the engine's walk or pairs the
    layout does not allow (kErrPairs = -8)."""
    from watfft_tpu_torch.ops import _build
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    buf = torch.zeros(2 * 8192 * 2 * 3 + 2, device=dev)
    out = torch.zeros_like(buf)
    p, q = buf.data_ptr(), out.data_ptr()

    def cube(h, w, x, y, walk, px, py, direct=0, tables=None):
        th, tw = tables or (st.device_tables(h, False, dev), st.device_tables(w, False, dev))
        return lib.watfft_fft2_cube(
            *x[:2], *y[:2], *x[2:], *y[2:], h, w, 3, th.twre.data_ptr(), th.twim.data_ptr(),
            th.c_radices, th.c_offsets, len(th.stages), tw.twre.data_ptr(),
            tw.twim.data_ptr(), tw.c_radices, tw.c_offsets, len(tw.stages), 0, stream, walk,
            px, py, direct)
    h = w = 64
    xs, ys = (p, p + 4, 2 * w, 2, 2 * h * w), (q, q + 4, 2 * w, 2, 2 * h * w)
    for walk in (0, st.WALK_RESIDENT, 4):
        assert cube(h, w, xs, ys, walk, 0, 0) == -1, walk
    small = tuple(_radix8_tables(128, False, dev) for _ in range(2))
    s128 = (2 * 128, 2, 2 * 128 * 128)
    assert cube(128, 128, (p, p + 4, *s128), (q, q + 4, *s128), st.WALK_BLOCK, 0, 0,
                tables=small) == -1
    for args in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        assert cube(h, w, xs, ys, st.WALK_ENGINE, *args) == -8, args
    for bad in ((p + 4, p + 8, 2 * w, 2, 2 * h * w),        # 4 bytes off
                (p, p + 4, 2 * w + 1, 2, 2 * h * w),        # an odd row stride
                (p, p + 4, 2 * w, 2, 2 * h * w + 1),        # an odd image stride
                (p, p + 4 * h * w * 3, w, 1, h * w)):       # split planes
        assert cube(h, w, bad, ys, st.WALK_BLOCK, 1, 0) == -8, bad
        assert cube(h, w, xs, bad, st.WALK_BLOCK, 0, 1) == -8, bad
    torch.cuda.synchronize()


# -- the sharded faces (watfft_tpu_torch/parallel) on a world-1 NCCL group ---------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A 1-D mesh over a world-size-1 NCCL group (an in-memory store)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from watfft_tpu_torch.parallel import sharded as psh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield psh.make_mesh(1)
    finally:
        dist.destroy_process_group()


def _sharded_faces():
    """(name, sharded call, single-device call) on one input each."""
    from watfft_tpu_torch.parallel import large_sharded as pls
    from watfft_tpu_torch.parallel import real_sharded as prs
    from watfft_tpu_torch.parallel import sharded as psh

    def c(x):
        return x.real.contiguous(), x.imag.contiguous()

    n1, n2 = lg.large_split(1 << 20)
    m1, m2 = lg.large_split(1 << 20)
    return [
        ("fft_batch", lambda m, x: psh.fft_batch_sharded(*c(x), m), lambda x: wtt.fft(x),
         (256, 1024), True),
        ("fft2", lambda m, x: psh.fft2_sharded(*c(x), m), lambda x: wtt.fft2(x), (1024, 1024),
         True),
        ("ifft2", lambda m, x: psh.fft2_sharded(*c(x), m, inverse=True), lambda x: wtt.ifft2(x),
         (2, 512, 256), True),
        ("rfft2", lambda m, x: prs.rfft2_sharded(x, m), lambda x: wtt.rfft2(x), (1024, 512),
         False),
        ("fft_large", lambda m, x: pls.fft_large_sharded(*(t.view(n2, n1) for t in c(x)), m),
         lambda x: lg.fft_large(*c(x)), (1 << 20,), True),
        ("rfft_large", lambda m, x: prs.rfft_large_sharded(x.view(m2, 2 * m1), m),
         lambda x: wtt.rfft_large_nb(x[:, None]), (1 << 21,), False),
        ("stft", lambda m, x: prs.stft_sharded(x, m, n_fft=512, hop=128),
         lambda x: stft.stft(x, n_fft=512, hop=128), (4, 127 * 128 + 512), False),
    ]


@pytest.mark.parametrize("case", range(7))
def test_sharded_world1_matches_single_device(case, nccl_mesh, dev):
    """Each sharded face at world 1 on NCCL equals the port's single-device
    function within KERNEL_LIMIT of its largest output (the same kernels:
    the 2D faces run rows then columns, the large faces the "2d" mode)."""
    name, sharded, single, shape, cplx = _sharded_faces()[case]
    x = _x(shape, case, dev) if cplx else _x(shape, case, dev).real.contiguous()
    got, want = sharded(nccl_mesh, x), single(x)
    got, want = (torch.complex(*o) if isinstance(o, tuple) else o for o in (got, want))
    assert _rel(got.reshape(-1), want.reshape(-1)) <= KERNEL_LIMIT, name


def test_sharded_roundtrips_on_the_card(nccl_mesh, dev):
    """The large real face and the 2D real face give the signal back."""
    from watfft_tpu_torch.parallel import real_sharded as prs

    x = _x((1 << 21,), 11, dev).real.contiguous()
    m1, m2 = lg.large_split(1 << 20)
    spec = prs.rfft_large_sharded(x.view(m2, 2 * m1), nccl_mesh)
    assert (prs.irfft_large_sharded(*spec, nccl_mesh).reshape(-1) - x).abs().max() < 1e-4
    img = _x((512, 1024), 12, dev).real.contiguous()
    back = prs.irfft2_sharded(*prs.rfft2_sharded(img, nccl_mesh), nccl_mesh)
    assert (back - img).abs().max() < 1e-5


def test_sharded_refuses_a_shard_off_the_mesh(nccl_mesh, dev):
    """A CPU shard on a CUDA mesh raises; nothing is moved."""
    from watfft_tpu_torch.parallel import sharded as psh

    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="move no tensor"):
        psh.fft_batch_sharded(x, x, nccl_mesh)
