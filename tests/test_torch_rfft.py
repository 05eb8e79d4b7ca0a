"""The port's real FFT (watfft_tpu_torch/ops/rfft.py, RFFTContext, rfft /
irfft) against the JAX package's (watfft_tpu/ops/pallas_rfft.py,
create_rfft_f32) and the f64 oracle.

On the CPU the port's wrappers run the kernels' plain torch versions: the
fused path runs `plain_rfft`'s arithmetic, the hybrid the c2c Stockham
plain version through the same strided views the kernel gets. The JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them off the TPU. Inputs are made with numpy from a seed and handed to both
as float32. The CUDA kernels are checked on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import watfft_tpu
import watfft_tpu_torch as wtt
from watfft_tpu import config
from watfft_tpu.ops import pallas_rfft as jpr
from watfft_tpu.ops import pallas_stockham as jst
from watfft_tpu_torch import convert, planner
from watfft_tpu_torch.ops import rfft as rf
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, RMS_REL, ROUNDTRIP

ALL_N = [1 << k for k in range(2, 14)]          # the real path's range, 4..8192
# max |port - jax| / max |jax|: ulp-level, not bitwise (FMA contraction and
# XLA's fusion differ from torch's op-by-op rounding)
JAX_LIMIT = 1e-6


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(config, "FORCE_INTERPRET", True)


def _real(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _rel_to_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the kernels' modules against the JAX kernels --------------------------------

@pytest.mark.parametrize("n", [16, 256, 1024])
def test_forward_matches_jax_kernels(n):
    """Hybrid (#5 `_rfft_core_kernel` + XLA post) and fused (#9
    `_rfft_fused_kernel`) on time-major [n, 128]."""
    x = _real((n, 128), seed=n)
    want_h = _c(*jpr.rfft_nb(jnp.asarray(x)))
    want_f = _c(*jpr.rfft_nb_fused(jnp.asarray(x)))
    assert _rel_to_max(_c(*rf.rfft_nb(_t(x))), want_h) <= JAX_LIMIT
    assert _rel_to_max(_c(*rf.rfft_nb_fused(_t(x))), want_f) <= JAX_LIMIT


@pytest.mark.parametrize("n", [16, 256, 1024])
def test_inverse_matches_jax_kernels(n):
    """Hybrid (XLA pre + #6 `_irfft_core_kernel`) and fused (#10
    `_irfft_fused_kernel`) on random planes [m+1, 128]: not Hermitian-valid,
    so the imaginary parts of the DC and Nyquist rows are nonzero and both
    packages read them."""
    xre, xim = _real((n // 2 + 1, 128), seed=n + 1), _real((n // 2 + 1, 128), seed=n + 2)
    assert np.all(xim[0] != 0) and np.all(xim[-1] != 0)
    want_h = np.asarray(jpr.irfft_nb(jnp.asarray(xre), jnp.asarray(xim)))
    want_f = np.asarray(jpr.irfft_nb_fused(jnp.asarray(xre), jnp.asarray(xim)))
    assert _rel_to_max(rf.irfft_nb(_t(xre), _t(xim)).numpy(), want_h) <= JAX_LIMIT
    assert _rel_to_max(rf.irfft_nb_fused(_t(xre), _t(xim)).numpy(), want_f) <= JAX_LIMIT


def test_matches_jax_kernels_3d_view():
    """JAX's sublane-folded [16, 8, 128] kernels (#7 `_rfft_core_kernel_dma3d`,
    #8 `_irfft_core_kernel_dma3d`) against the port on the same 3D tensor."""
    n = 16
    x = _real((n, 8, 128), seed=3)
    jre, jim = jpr.rfft_nb(jnp.asarray(x))
    pre, pim = rf.rfft_nb(_t(x))
    assert pre.shape == (n // 2 + 1, 8, 128)
    assert _rel_to_max(_c(pre, pim), _c(jre, jim)) <= JAX_LIMIT
    sre, sim = _real((n // 2 + 1, 8, 128), seed=4), _real((n // 2 + 1, 8, 128), seed=5)
    want = np.asarray(jpr.irfft_nb(jnp.asarray(sre), jnp.asarray(sim)))
    got = rf.irfft_nb(_t(sre), _t(sim))
    assert got.shape == (n, 8, 128)
    assert _rel_to_max(got.numpy(), want) <= JAX_LIMIT


@pytest.mark.parametrize("n", [16, 1024])
def test_plain_on_the_jax_plan(n):
    """The port on exactly the JAX m-point plan (its TPU overrides
    included) and post twiddles, carried across by convert."""
    m = n // 2
    x = _real((n, 128), seed=n + 7)
    fwd = convert.rfft_tables_from_jax(jst.stage_plan(m), *_pack(m, False),
                                       *jpr._Cache.get(n, False), False, "cpu")
    inv = convert.rfft_tables_from_jax(jst.stage_plan(m), *_pack(m, True),
                                       *jpr._Cache.get(n, True), True, "cpu")
    assert fwd.core.stages == tuple(jst.stage_plan(m))
    want = rf.rfft_nb_fused(_t(x))
    got = rf.rfft_nb_fused(_t(x), fwd)
    assert _rel_to_max(_c(*got), _c(*want)) <= JAX_LIMIT
    back = rf.irfft_nb(*got, inv)
    assert np.max(np.abs(back.numpy() - x)) < ROUNDTRIP["float32"]


def _pack(m, inverse):
    re, im, offsets = jst.make_twiddle_pack(m, inverse)
    return offsets, re, im


# -- the context against the JAX context -----------------------------------------

@pytest.mark.parametrize("n", [16, 256])
def test_context_matches_jax_api(n, interpret_mode):
    """RFFTContext against watfft_tpu.create_rfft_f32 on (3, 5) leading axes
    (the JAX API pads the batch to 128 and runs its Pallas real path)."""
    lead = (3, 5)
    x = _real(lead + (n,), seed=n + 11)
    sre, sim = _real(lead + (n // 2 + 1,), seed=n + 12), _real(lead + (n // 2 + 1,), seed=n + 13)
    jctx = watfft_tpu.create_rfft_f32(n)
    pctx = wtt.create_rfft_f32(n, device="cpu")

    spec = pctx.forward(_t(x))
    assert spec.dtype == torch.complex64 and spec.shape == lead + (n // 2 + 1,)
    assert _rel_to_max(spec.numpy(), _c(*jctx.forward_planes(x))) <= JAX_LIMIT
    assert _rel_to_max(_c(*pctx.forward_planes(_t(x))), spec.numpy()) == 0.0
    want = np.asarray(jctx.inverse_planes(sre, sim))
    assert _rel_to_max(pctx.inverse_planes(_t(sre), _t(sim)).numpy(), want) <= JAX_LIMIT
    assert _rel_to_max(pctx.inverse(_t(sre + 1j * sim)).numpy(), want) <= JAX_LIMIT
    if n == 16:  # the one-shots plan their own contexts in both packages
        assert _rel_to_max(wtt.rfft(_t(x), device="cpu").numpy(),
                           np.asarray(watfft_tpu.rfft(x))) <= JAX_LIMIT
        assert _rel_to_max(wtt.irfft(_t(sre + 1j * sim), device="cpu").numpy(),
                           np.asarray(watfft_tpu.irfft(sre + 1j * sim))) <= JAX_LIMIT


def test_context_time_major_forms():
    """forward_planes_nb: the fused kernel on [n, b], the hybrid on the
    folded [n, 8, W] view, as the JAX API dispatches them; both agree with
    the batch-major form."""
    n = 64
    ctx = wtt.create_rfft_f32(n, device="cpu")
    x = _real((8 * 16, n), seed=21)
    want = ctx.forward(_t(x)).numpy()
    re, im = ctx.forward_planes_nb(_t(x.T))
    assert _rel_to_max(_c(re, im).T, want) == 0.0
    re3, im3 = ctx.forward_planes_nb(_t(x.T.reshape(n, 8, 16)))
    assert re3.shape == (n // 2 + 1, 8, 16)
    assert _rel_to_max(_c(re3, im3).reshape(n // 2 + 1, -1).T, want) <= JAX_LIMIT
    back = ctx.inverse_planes_nb(re3, im3)
    assert back.shape == (n, 8, 16)
    assert np.max(np.abs(back.numpy().reshape(n, -1).T - x)) < ROUNDTRIP["float32"]
    assert np.max(np.abs(ctx.inverse_planes_nb(re, im).numpy().T - x)) < ROUNDTRIP["float32"]


# -- gradients ---------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_grads_match_jax_vjp(fused):
    """VJP(rfft) = m irfft(g') and VJP(irfft) = rfft(y)/m with the end-row
    corrections (pallas_rfft.py:866-988), against jax.vjp of the JAX
    functions (their custom VJPs) on the same inputs and cotangents."""
    n, b = 32, 128
    m = n // 2
    x = _real((n, b), seed=31)
    gre, gim = _real((m + 1, b), seed=32), _real((m + 1, b), seed=33)
    sre, sim = _real((m + 1, b), seed=34), _real((m + 1, b), seed=35)
    ybar = _real((n, b), seed=36)
    jfwd, jinv = (jpr.rfft_nb_fused, jpr.irfft_nb_fused) if fused else (jpr.rfft_nb, jpr.irfft_nb)
    pfwd, pinv = (rf.rfft_nb_fused, rf.irfft_nb_fused) if fused else (rf.rfft_nb, rf.irfft_nb)

    _, vjp = jax.vjp(jfwd, jnp.asarray(x))
    (want,) = vjp((jnp.asarray(gre), jnp.asarray(gim)))
    xt = _t(x).requires_grad_()
    ore, oim = pfwd(xt)
    torch.autograd.backward((ore, oim), (_t(gre), _t(gim)))
    assert _rel_to_max(xt.grad.numpy(), np.asarray(want)) <= JAX_LIMIT

    _, vjp = jax.vjp(jinv, jnp.asarray(sre), jnp.asarray(sim))
    wre, wim = vjp(jnp.asarray(ybar))
    a, c = _t(sre).requires_grad_(), _t(sim).requires_grad_()
    pinv(a, c).backward(_t(ybar))
    assert _rel_to_max(_c(a.grad, c.grad), _c(wre, wim)) <= JAX_LIMIT
    assert np.any(np.asarray(wim)[[0, m]] != 0)  # the imag end rows are read


@pytest.mark.parametrize("fused", [False, True])
def test_gradcheck_float64(fused):
    """Every form, batch-major, time-major and complex, in float64 on the
    plain version: the adjoint identities against finite differences."""
    n = 8
    x = torch.from_numpy(_real((3, n), seed=41).astype(np.float64)).requires_grad_()
    s = torch.from_numpy(_real((3, n // 2 + 1), seed=42).astype(np.float64))
    t = (s * 0.5).flip(-1)
    xt = x.detach().T.contiguous().requires_grad_()
    checks = [
        (lambda a: rf.rfft_bm(a, fused), (x,)),
        (lambda a: rf.rfft(a, fused), (x,)),
        (lambda a, b: rf.irfft_bm(a, b, fused), (s.clone().requires_grad_(),
                                                 t.clone().requires_grad_())),
        (lambda a: rf.irfft(a, fused), (torch.complex(s, t).requires_grad_(),)),
        ((rf.rfft_nb_fused if fused else rf.rfft_nb), (xt,)),
        ((rf.irfft_nb_fused if fused else rf.irfft_nb),
         (s.T.contiguous().requires_grad_(), t.T.contiguous().requires_grad_())),
    ]
    for fn, args in checks:
        assert torch.autograd.gradcheck(fn, args)


def test_complex_grad_matches_torch_fft():
    """torch's own convention for a real -> complex map: the gradient of
    rfft equals torch.fft.rfft's (the imaginary end rows are constants in
    both)."""
    n = 64
    x = _t(_real((3, n), seed=51))
    g = _t(_real((3, n // 2 + 1), seed=52) + 1j * _real((3, n // 2 + 1), seed=53))
    g = g.to(torch.complex64)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    rf.rfft(a).backward(g)
    torch.fft.rfft(b).backward(g)
    assert _rel_to_max(a.grad.numpy(), b.grad.numpy()) <= JAX_LIMIT


# -- against the oracle ------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n", ALL_N)
def test_meets_oracle(n, fused):
    """Forward against the f64 real DFT and inverse against the real
    inverse DFT of a Hermitian-valid spectrum (zero imaginary end rows), in
    all three layouts, and the roundtrip."""
    x = _real((3, n), seed=60 + n).astype(np.float64)
    want = ref.real_dft(x)
    got = rf.rfft(_t(x.astype(np.float32)), fused).numpy()
    max_rel, rms_rel = rel_errors(got, want)
    assert max_rel <= MAX_REL["float32"] and rms_rel <= RMS_REL["float32"]
    re, im = rf.rfft_bm(_t(x.astype(np.float32)), fused)
    assert rel_errors(_c(re, im), want)[0] <= MAX_REL["float32"]
    fwd_nb = rf.rfft_nb_fused if fused else rf.rfft_nb
    re, im = fwd_nb(_t(x.T.astype(np.float32)))
    assert rel_errors(_c(re, im).T, want)[0] <= MAX_REL["float32"]

    spec = want.copy()
    spec[:, 0] = spec[:, 0].real
    spec[:, -1] = spec[:, -1].real
    wx = ref.real_idft(spec, n)
    spec32 = spec.astype(np.complex64)
    y = rf.irfft(_t(spec32), fused).numpy()
    assert rel_errors(y, wx)[0] <= MAX_REL["float32"]
    y = rf.irfft_bm(_t(spec32.real), _t(spec32.imag), fused).numpy()
    assert rel_errors(y, wx)[0] <= MAX_REL["float32"]
    inv_nb = rf.irfft_nb_fused if fused else rf.irfft_nb
    y = inv_nb(_t(spec32.real.T), _t(spec32.imag.T)).numpy().T
    assert rel_errors(y, wx)[0] <= MAX_REL["float32"]

    back = rf.irfft(torch.from_numpy(got), fused).numpy()
    assert np.max(np.abs(back - x)) < ROUNDTRIP["float32"]


def test_inverse_reads_imaginary_end_rows():
    """On a spectrum that is not Hermitian-valid the port follows the JAX
    package's definition: the pre-process of pallas_rfft.py:802-823 in f64,
    the normalized m-point inverse DFT, the re-interleave."""
    n, m = 64, 32
    rng = np.random.default_rng(71)
    spec = (rng.uniform(-1, 1, (3, m + 1)) + 1j * rng.uniform(-1, 1, (3, m + 1)))
    k = np.arange(m)
    w = np.exp(2j * np.pi * k / n)
    a = spec[:, :m]
    b = np.conj(np.concatenate([spec[:, m:], spec[:, 1:m][:, ::-1]], axis=1))
    z = ref.idft(0.5 * (a + b) + 0.5j * w * (a - b))
    want = np.stack([z.real, z.imag], axis=-1).reshape(3, n)
    for fused in (False, True):
        got = rf.irfft(_t(spec.astype(np.complex64)), fused).numpy()
        assert _rel_to_max(got, want) <= JAX_LIMIT
    hermitian = spec.copy()
    hermitian[:, [0, m]] = hermitian[:, [0, m]].real
    assert _rel_to_max(rf.irfft(_t(hermitian.astype(np.complex64))).numpy(), want) > 1e-3


# -- wrapper contract --------------------------------------------------------------

@pytest.mark.parametrize("batch", [0, 1, 3, 257])
def test_any_batch(batch):
    """No padding: any batch, an empty one included, keeps its shape."""
    n = 32
    x = _t(_real((batch, n), seed=batch))
    for fused in (False, True):
        spec = rf.rfft(x, fused)
        assert spec.shape == (batch, n // 2 + 1) and spec.dtype == torch.complex64
        back = rf.irfft(spec, fused)
        assert back.shape == (batch, n) and back.dtype == torch.float32
        if batch:
            assert rel_errors(spec.numpy(), ref.real_dft(x.numpy()))[0] <= MAX_REL["float32"]
            assert torch.max(torch.abs(back - x)).item() < ROUNDTRIP["float32"]


def test_lazy_conj_and_neg_views():
    """irfft of x.conj() and the planes of its .imag transform what the
    views show, not their storage."""
    n = 64
    s = _real((3, n // 2 + 1), seed=81) + 1j * _real((3, n // 2 + 1), seed=82)
    x = _t(s.astype(np.complex64))
    xc = x.conj()
    assert xc.is_conj() and xc.imag.is_neg()
    want = rf.irfft(xc.resolve_conj()).numpy()
    assert _rel_to_max(rf.irfft(xc).numpy(), want) == 0.0
    assert _rel_to_max(rf.irfft_bm(xc.real, xc.imag).numpy(), want) == 0.0
    assert _rel_to_max(rf.irfft_nb(xc.real.T, xc.imag.T).numpy().T, want) <= JAX_LIMIT


def test_cpu_runs_plain_version_without_launch():
    before = dict(rf.launches)
    rf.rfft(torch.zeros(2, 8))
    rf.irfft_nb(torch.zeros(5, 2), torch.zeros(5, 2))
    assert rf.launches == before


def test_refusals():
    x = torch.zeros(4, 16)
    with pytest.raises(TypeError, match="real signal"):
        rf.rfft(torch.zeros(4, 16, dtype=torch.complex64))
    with pytest.raises(ValueError, match="power-of-two n >= 4"):
        rf.rfft(torch.zeros(4, 12))
    with pytest.raises(ValueError, match="n=32"):
        rf.rfft(x, tables=rf.device_rtables(32, False, "cpu"))
    with pytest.raises(ValueError, match="inverse"):
        rf.rfft(x, tables=rf.device_rtables(16, True, "cpu"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rf.rfft(torch.zeros(4, 16, device="meta"))
    with pytest.raises(ValueError, match="take 9 values"):
        rf.make_rtables([(8, 1)], [-1], [[1.0]], [[0.0]], np.ones(8), np.ones(8), False, "cpu")
    ctx = wtt.create_rfft_f32(16, device="cpu")
    with pytest.raises(ValueError, match="planned for size 16"):
        ctx.inverse(torch.zeros(4, 16, dtype=torch.complex64))
    with pytest.raises(TypeError, match="real input"):
        ctx.forward(torch.zeros(4, 16, dtype=torch.complex64))


def test_planner_routes_the_real_path_to_the_fused_kernel():
    for n in ALL_N:
        for direction in ("forward", "inverse"):
            assert planner.r2c_kernel(n, "float32", direction) == "rfft-fused"
    assert planner.r2c_kernel(16384, "float32") == "rfft-large"
    assert wtt.create_rfft_f32(16384, device="cpu").bins == 8193
    assert planner.r2c_kernel(1 << 26, "float32") == "fourstep"  # the real matmul surface
    assert wtt.RFFTContext(64, dtype="float64", device="cpu").forward(
        torch.zeros(2, 64, dtype=torch.float64)).dtype == torch.complex128
    for n in (0, 2, 3, 12):
        with pytest.raises(ValueError, match="power of two"):
            wtt.create_rfft_f32(n, device="cpu")
