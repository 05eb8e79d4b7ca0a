"""The port's slice (watfft_tpu_torch: create_fft_f32, FFTContext, fft, ifft)
against the JAX package's public API.

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
    pctx = wtt.create_fft_f32(n)
    xt = torch.from_numpy(x)

    _close(pctx.forward(xt).numpy(), jctx.forward(x))
    _close(pctx.inverse(xt).numpy(), jctx.inverse(x))

    re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    pre, pim = pctx.forward_planes(torch.from_numpy(re), torch.from_numpy(im))
    _close(_c(pre, pim), _c(*jctx.forward_planes(re, im)))

    ret, imt = re.reshape(-1, n).T.copy(), im.reshape(-1, n).T.copy()
    pre, pim = pctx.forward_planes_nb(torch.from_numpy(ret), torch.from_numpy(imt))
    _close(_c(pre, pim), _c(*jctx.forward_planes_nb(ret, imt)))

    _close(wtt.fft(xt).numpy(), watfft_tpu.fft(x))
    _close(wtt.ifft(xt).numpy(), watfft_tpu.ifft(x))


@pytest.mark.parametrize("n", [2, 32, 512, 4096])
def test_slice_entry_points_meet_oracle(n):
    x = _signal((2, 3, n), seed=n)
    ctx = wtt.create_fft_f32(n)
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
    ctx = wtt.create_fft_f32(n)
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
    with pytest.raises(NotImplementedError, match="A7"):
        wtt.create_fft_f32(8192)
    with pytest.raises(NotImplementedError, match="A7"):
        wtt.fft(torch.zeros(8192, dtype=torch.complex64))


def test_float64_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="A10"):
        wtt.FFTContext(64, dtype="float64")


def test_other_device_raises():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wtt.create_fft_f32(16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wtt.fft(torch.zeros(16, dtype=torch.complex64, device="meta"))


def test_wrong_length_raises():
    ctx = wtt.create_fft_f32(16)
    with pytest.raises(ValueError, match="planned for size 16"):
        ctx.forward(torch.zeros(3, 32, dtype=torch.complex64))
    with pytest.raises(ValueError, match="planned for size 16"):
        ctx.forward_planes_nb(torch.zeros(32, 16), torch.zeros(32, 16))


def test_context_device_moves_inputs():
    ctx = wtt.create_fft_f32(8, device="cpu")
    y = ctx.forward(np.ones((2, 8), np.complex128))
    assert y.device.type == "cpu" and y.dtype == torch.complex64
    assert torch.allclose(y[:, 0], torch.full((2,), 8.0 + 0j))
