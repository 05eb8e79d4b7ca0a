"""The port's complex slice (watfft_tpu_torch: create_fft_f32, FFTContext,
fft, ifft) against the JAX package's public API, on the CPU
(`device="cpu"`: the kernels' plain versions).

The JAX API is forced onto its Pallas Stockham kernel in interpret mode
(config.FORCE_INTERPRET, as tests/test_planner.py does); otherwise it would
dispatch to jnp.fft on the CPU. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import watfft_tpu
import watfft_tpu_torch as wtt
from watfft_tpu import config
from watfft_tpu_torch import planner
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, ROUNDTRIP

# max |port - jax| / max |jax|, as in test_torch_stockham.py
JAX_LIMIT = 1e-6


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(config, "FORCE_INTERPRET", True)


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= JAX_LIMIT


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


@pytest.mark.parametrize("n,lead", [(16, (3, 5)), (256, (3, 5)), (1024, (3, 5)),
                                    (16, (1024,))])
def test_slice_matches_jax_api(n, lead, interpret_mode):
    """(16, (1024,)) pads to a batch of 1024 in the JAX API and so takes its
    3D [n, 8, W] dispatch (api.py:263, _kernel_dma3d)."""
    x = _signal(lead + (n,), seed=n + len(lead))
    jctx = watfft_tpu.create_fft_f32(n)
    pctx = wtt.create_fft_f32(n, device="cpu")
    xt = torch.from_numpy(x)

    _close(pctx.forward(xt).numpy(), jctx.forward(x))
    _close(pctx.inverse(xt).numpy(), jctx.inverse(x))

    re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    pre, pim = pctx.forward_planes(torch.from_numpy(re), torch.from_numpy(im))
    _close(_c(pre, pim), _c(*jctx.forward_planes(re, im)))

    ret, imt = re.reshape(-1, n).T.copy(), im.reshape(-1, n).T.copy()
    pre, pim = pctx.forward_planes_nb(torch.from_numpy(ret), torch.from_numpy(imt))
    _close(_c(pre, pim), _c(*jctx.forward_planes_nb(ret, imt)))

    _close(wtt.fft(xt, device="cpu").numpy(), watfft_tpu.fft(x))
    _close(wtt.ifft(xt, device="cpu").numpy(), watfft_tpu.ifft(x))


@pytest.mark.parametrize("n", [2, 32, 512, 4096])
def test_slice_entry_points_meet_oracle(n):
    x = _signal((2, 3, n), seed=n)
    ctx = wtt.create_fft_f32(n, device="cpu")
    fwd, inv = ref.dft(x), ref.idft(x)
    assert rel_errors(ctx.forward(torch.from_numpy(x)).numpy(), fwd)[0] <= MAX_REL["float32"]
    assert rel_errors(ctx.inverse(x).numpy(), inv)[0] <= MAX_REL["float32"]
    re, im = ctx.inverse_planes(x.real, x.imag)
    assert rel_errors(_c(re, im), inv)[0] <= MAX_REL["float32"]
    re, im = ctx.inverse_planes_nb(np.moveaxis(x.real, -1, 0), np.moveaxis(x.imag, -1, 0))
    assert rel_errors(np.moveaxis(_c(re, im), 0, -1), inv)[0] <= MAX_REL["float32"]


@pytest.mark.parametrize("name", sorted(ref.SIGNALS))
def test_reference_signals_meet_oracle(name):
    """The reference suite's deterministic signals (impulse, constant,
    single frequency, ...) through forward and inverse at n = 256."""
    n = 256
    x = ref.make_signal(name, n)
    ctx = wtt.create_fft_f32(n, device="cpu")
    X = ctx.forward(x.astype(np.complex64))
    assert rel_errors(X.numpy(), ref.dft(x))[0] <= MAX_REL["float32"]
    back = ctx.inverse(X).numpy()
    assert np.max(np.abs(back - x)) < ROUNDTRIP["float32"]


def test_planner_routes_the_slice_to_the_kernel():
    for k in range(1, 13):
        assert planner.c2c_kernel(1 << k, "float32") == "stockham"


@pytest.mark.parametrize("n", [0, 1, 3, 12, 1000, 16.0])
def test_non_power_of_two_raises(n):
    with pytest.raises(ValueError, match="power of two"):
        wtt.create_fft_f32(n)


def test_large_n_raises_not_implemented():
    """Large N is ported (tests/test_torch_large.py), and the real FFT past
    2^25 now runs the real matmul surface (tests/test_torch_f64.py checks
    its numbers); a bf16 context still raises, naming the bf16 tiers'
    surface, the plane entry points on bfloat16 planes."""
    assert planner.c2c_kernel(8192, "float32") == "large-cube"
    assert wtt.fft(torch.zeros(8192, dtype=torch.complex64), device="cpu").shape == (8192,)
    assert planner.r2c_kernel(1 << 26, "float32") == "fourstep"
    assert wtt.create_rfft_f32(1 << 26, device="cpu").bins == (1 << 25) + 1
    with pytest.raises(NotImplementedError, match="stockham_fft_nb"):
        wtt.RFFTContext(16, dtype="bfloat16", device="cpu")


def test_float64_raises_not_implemented():
    """float64 is ported (ROADMAP A10): a float64 context runs complex128,
    and a bf16 context still raises, naming the bf16 planes' entry points."""
    ctx = wtt.FFTContext(64, dtype="float64", device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 64)) + 0j)
    y = ctx.forward(x)
    assert y.dtype == torch.complex128
    assert (y - torch.fft.fft(x)).abs().max().item() < 1e-12
    with pytest.raises(NotImplementedError, match="stockham_fft_nb"):
        wtt.FFTContext(64, dtype="bfloat16", device="cpu")


def test_other_device_raises():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wtt.create_fft_f32(16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wtt.fft(torch.zeros(16, dtype=torch.complex64), device="meta")


def test_wrong_length_raises():
    ctx = wtt.create_fft_f32(16, device="cpu")
    with pytest.raises(ValueError, match="planned for size 16"):
        ctx.forward(torch.zeros(3, 32, dtype=torch.complex64))
    with pytest.raises(ValueError, match="planned for size 16"):
        ctx.forward_planes_nb(torch.zeros(32, 16), torch.zeros(32, 16))


def test_context_device_moves_inputs():
    ctx = wtt.create_fft_f32(8, device="cpu")
    y = ctx.forward(np.ones((2, 8), np.complex128))
    assert y.device.type == "cpu" and y.dtype == torch.complex64
    assert torch.allclose(y[:, 0], torch.full((2,), 8.0 + 0j))


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    """The entry points run on the card by default: without a CUDA device
    they raise, naming CUDA, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    x = torch.zeros(2, 16, dtype=torch.complex64)
    for make in (lambda: wtt.create_fft_f32(16), lambda: wtt.FFTContext(16),
                 lambda: wtt.create_rfft_f32(16), lambda: wtt.RFFTContext(16),
                 lambda: wtt.fft(x), lambda: wtt.ifft(x), lambda: wtt.rfft(x.real),
                 lambda: wtt.irfft(x[..., :9]), lambda: wtt.fft2(x), lambda: wtt.ifft2(x),
                 lambda: wtt.rfft2(x.real.reshape(2, 4, 4)),
                 lambda: wtt.irfft2(x.reshape(2, 4, 4)[..., :3])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert wtt.fft(x, device="cpu").device.type == "cpu"
    assert wtt.fft2(x, device="cpu").device.type == "cpu"
    assert wtt.rfft2(x.real.reshape(2, 4, 4), device="cpu").shape == (2, 4, 3)
    assert wtt.irfft2(x.reshape(2, 4, 4)[..., :3], device="cpu").shape == (2, 4, 4)
