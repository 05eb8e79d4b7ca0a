"""The port's Stockham module (watfft_tpu_torch/ops/stockham.py) against the
JAX package's (watfft_tpu/ops/pallas_stockham.py) and the f64 oracle.

On the CPU the port's wrappers run the kernel's plain torch version; the
JAX kernel runs in Pallas interpret mode, as the JAX package's own tests run
it. Inputs are made with numpy from a seed and handed to both as float32.
The CUDA kernel itself is checked on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watfft_tpu.ops import pallas_rfft as jpr
from watfft_tpu.ops import pallas_stockham as jst
from watfft_tpu.ops import rfft as jrfft
from watfft_tpu_torch import convert
from watfft_tpu_torch.ops import rfft as rf
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, PER_BIN, ROUNDTRIP, RMS_REL

ALL_N = [1 << k for k in range(1, 13)]          # the port's range, 2..4096
# max |port - jax| / max |jax|: ulp-level, not bitwise (FMA contraction and
# XLA's fusion differ from torch's op-by-op rounding)
JAX_LIMIT = 1e-6


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _rel_to_max(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- host tables ----------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << k for k in range(1, 14)])
def test_tables_bit_equal_to_jax(n, monkeypatch):
    """The Stockham plan and twiddle pack, and for n >= 4 the real FFT's
    post twiddles (watfft_tpu/ops/rfft.py and pallas_rfft.py's _Cache)."""
    monkeypatch.setattr(jst, "_PLAN_OVERRIDES", {})
    assert st.stage_plan(n) == jst.stage_plan(n)
    for inverse in (False, True):
        pre, pim, poff = st.make_twiddle_pack(n, inverse)
        jre, jim, joff = jst.make_twiddle_pack(n, inverse)
        assert poff == joff
        assert pre.dtype == jre.dtype == np.float32
        assert np.array_equal(pre, jre) and np.array_equal(pim, jim)
        if n >= 4:
            pw = rf.rfft_post_twiddles(n, inverse)
            for jw in (jrfft.rfft_post_twiddles(n, inverse), jpr._Cache.get(n, inverse)):
                assert pw[0].dtype == jw[0].dtype == np.float32
                assert np.array_equal(pw[0], jw[0].reshape(-1))
                assert np.array_equal(pw[1], jw[1].reshape(-1))


def test_default_plan_caps_radix_at_16():
    for n in ALL_N + [8192]:
        stages = st.stage_plan(n)
        assert max(r for r, _ in stages) <= st.MAX_RADIX
        assert int(np.prod([r for r, _ in stages])) == n


# -- module against the JAX kernel ---------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_plain_matches_jax_kernel(n, inverse):
    """The port on exactly the JAX plan (overrides included, e.g. (64, 16) at
    n=1024) carried across by convert.tables_from_jax."""
    xre, xim = _planes((n, 128), seed=n)
    jre, jim, joff = jst.make_twiddle_pack(n, inverse)
    tables = convert.tables_from_jax(jst.stage_plan(n), joff, jre, jim, "cpu")
    assert tables.stages == tuple(jst.stage_plan(n))
    pre, pim = st.stockham_fft_nb(torch.from_numpy(xre), torch.from_numpy(xim),
                                  inverse, tables)
    ore, oim = jst.stockham_fft_nb(jnp.asarray(xre), jnp.asarray(xim), inverse)
    want = np.asarray(ore) + 1j * np.asarray(oim)
    assert _rel_to_max(pre.numpy() + 1j * pim.numpy(), want) <= JAX_LIMIT


def test_plain_matches_jax_kernel_3d_view():
    """JAX's sublane-folded [16, 8, 128] kernel (_kernel_dma3d) against the
    port on the [16, 1024] view of the same data."""
    n = 16
    xre, xim = _planes((n, 8, 128), seed=3)
    ore, oim = jst.stockham_fft_nb(jnp.asarray(xre), jnp.asarray(xim), False)
    pre, pim = st.stockham_fft_nb(torch.from_numpy(xre.reshape(n, -1)),
                                  torch.from_numpy(xim.reshape(n, -1)))
    want = (np.asarray(ore) + 1j * np.asarray(oim)).reshape(n, -1)
    assert _rel_to_max(pre.numpy() + 1j * pim.numpy(), want) <= JAX_LIMIT
    # and the port takes the 3D view itself
    qre, qim = st.stockham_fft_nb(torch.from_numpy(xre), torch.from_numpy(xim))
    assert torch.equal(qre.reshape(n, -1), pre) and torch.equal(qim.reshape(n, -1), pim)


# -- module against the oracle -------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ALL_N)
def test_plain_meets_max_rel(n, inverse):
    xre, xim = _planes((3, n), seed=100 + n)
    x = xre + 1j * xim
    want = ref.idft(x) if inverse else ref.dft(x)
    got = st.stockham_fft(torch.from_numpy(x.astype(np.complex64)), inverse).numpy()
    max_rel, rms_rel = rel_errors(got, want)
    assert max_rel <= MAX_REL["float32"] and rms_rel <= RMS_REL["float32"]
    bre, bim = st.stockham_fft_bm(torch.from_numpy(xre), torch.from_numpy(xim), inverse)
    assert rel_errors(bre.numpy() + 1j * bim.numpy(), want)[0] <= MAX_REL["float32"]
    tre, tim = st.stockham_fft_nb(torch.from_numpy(xre.T.copy()),
                                  torch.from_numpy(xim.T.copy()), inverse)
    assert rel_errors((tre.numpy() + 1j * tim.numpy()).T, want)[0] <= MAX_REL["float32"]


@pytest.mark.parametrize("n", [64, 4096])
def test_plain_per_bin_and_roundtrip(n):
    t = np.arange(n)
    basis = np.exp(2j * np.pi * np.outer(t, t) / n).astype(np.complex64)  # [bin, time]
    spec = st.stockham_fft(torch.from_numpy(basis)).numpy()
    assert np.max(np.abs(spec - n * np.eye(n))) < PER_BIN["float32"](n)
    xre, xim = _planes((4, n), seed=7)
    x = torch.from_numpy((xre + 1j * xim).astype(np.complex64))
    back = st.stockham_fft(st.stockham_fft(x), inverse=True)
    assert torch.max(torch.abs(back - x)).item() < ROUNDTRIP["float32"]


@pytest.mark.parametrize("batch", [0, 1, 5])
def test_plain_odd_batches(batch):
    """No padding: any batch, including an empty one, keeps its shape."""
    n = 32
    xre, xim = _planes((batch, n), seed=batch)
    x = torch.from_numpy((xre + 1j * xim).astype(np.complex64))
    y = st.stockham_fft(x)
    assert y.shape == x.shape and y.dtype == torch.complex64
    if batch:
        assert rel_errors(y.numpy(), ref.dft(xre + 1j * xim))[0] <= MAX_REL["float32"]


# -- gradient ------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_grad_matches_jax(inverse):
    n, b = 64, 128
    xre, xim = _planes((n, b), seed=11)
    wre, wim = _planes((n, b), seed=12)

    def loss(re, im):
        ore, oim = jst.stockham_fft_nb(re, im, inverse)
        return jnp.sum(wre * ore + wim * oim)
    jre, jim = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xre), jnp.asarray(xim))

    re = torch.from_numpy(xre).requires_grad_()
    im = torch.from_numpy(xim).requires_grad_()
    ore, oim = st.stockham_fft_nb(re, im, inverse)
    (torch.from_numpy(wre) * ore + torch.from_numpy(wim) * oim).sum().backward()
    got = re.grad.numpy() + 1j * im.grad.numpy()
    want = np.asarray(jre) + 1j * np.asarray(jim)
    assert _rel_to_max(got, want) <= JAX_LIMIT


def test_gradcheck_float64():
    n = 16
    xre, xim = _planes((n, 3), seed=5)
    re = torch.from_numpy(xre.astype(np.float64)).requires_grad_()
    im = torch.from_numpy(xim.astype(np.float64)).requires_grad_()
    for inverse in (False, True):
        assert torch.autograd.gradcheck(
            lambda a, b: st.stockham_fft_nb(a, b, inverse), (re, im))
    z = torch.complex(re.detach(), im.detach()).T.contiguous().requires_grad_()
    assert torch.autograd.gradcheck(lambda a: st.stockham_fft(a), (z,))


def test_complex_grad_matches_torch_fft():
    """torch's own complex convention: VJP(fft) = n * ifft."""
    n = 256
    xre, xim = _planes((3, n), seed=9)
    gre, gim = _planes((3, n), seed=10)
    x = torch.from_numpy((xre + 1j * xim).astype(np.complex64))
    g = torch.from_numpy((gre + 1j * gim).astype(np.complex64))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    st.stockham_fft(a).backward(g)
    torch.fft.fft(b).backward(g)
    assert _rel_to_max(a.grad.numpy(), b.grad.numpy()) <= JAX_LIMIT


def test_lazy_conj_and_neg_views():
    """x.conj() and its .imag are views whose storage still holds the
    unconjugated values (conj and neg bits); autograd hands backward such a
    view for fft(x).conj(). The wrappers transform what the views show."""
    n = 64
    xre, xim = _planes((3, n), seed=11)
    gre, gim = _planes((3, n), seed=12)
    x = torch.from_numpy((xre + 1j * xim).astype(np.complex64))
    g = torch.from_numpy((gre + 1j * gim).astype(np.complex64))
    xc = x.conj()
    assert xc.is_conj() and xc.imag.is_neg()
    want = torch.fft.fft(xc.resolve_conj()).numpy()
    assert _rel_to_max(st.stockham_fft(xc).numpy(), want) <= JAX_LIMIT
    re, im = st.stockham_fft_bm(xc.real, xc.imag)
    assert _rel_to_max((re + 1j * im).numpy(), want) <= JAX_LIMIT
    re, im = st.stockham_fft_nb(xc.real.T, xc.imag.T)
    assert _rel_to_max((re + 1j * im).T.numpy(), want) <= JAX_LIMIT
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    st.stockham_fft(a).conj().backward(g)
    torch.fft.fft(b).conj().backward(g)
    assert _rel_to_max(a.grad.numpy(), b.grad.numpy()) <= JAX_LIMIT


# -- wrapper contract ----------------------------------------------------------

def test_cpu_runs_plain_version_without_launch():
    before = st.launches
    st.stockham_fft(torch.zeros(2, 8, dtype=torch.complex64))
    assert st.launches == before


def test_other_device_raises():
    x = torch.zeros(16, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        st.stockham_fft_nb(x, x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        st.stockham_fft_nb(x, x, tables=st.device_tables(16, False, "cpu"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        st.stockham_fft(torch.zeros(4, 16, dtype=torch.complex64, device="meta"))


def test_tables_for_wrong_n_raise():
    x = torch.zeros(16, 4)
    with pytest.raises(ValueError, match="n=32"):
        st.stockham_fft_nb(x, x, tables=st.device_tables(32, False, "cpu"))
