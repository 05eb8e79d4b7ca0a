"""The Hopper Stockham kernel on the card, against its plain torch version.

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
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.utils.tolerances import MAX_REL

pytestmark = pytest.mark.cuda

# max |kernel - plain| / max |plain| on the same inputs and plan: both are
# f32; the kernel contracts multiply-adds into FMAs, the plain version
# rounds op by op
KERNEL_LIMIT = 1e-6


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
    x = torch.zeros(1024, 4, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        st.stockham_fft_nb(x, x)
    big = st.make_tables([(64, 1), (16, 64)], [-1, 0], np.ones(63 * 16), np.zeros(63 * 16), dev)
    y = torch.zeros(1024, 4, device=dev)
    with pytest.raises(RuntimeError, match="radix outside"):
        st.stockham_fft_nb(y, y, tables=big)
    cpu_tables = convert.tables_from_jax([(16, 1)], [-1], [[1.0]], [[0.0]], "cpu")
    with pytest.raises(ValueError, match="tables on cpu"):
        st.stockham_fft_nb(torch.zeros(16, 2, device=dev), torch.zeros(16, 2, device=dev),
                           tables=cpu_tables)
