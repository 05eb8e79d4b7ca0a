"""The port's numpy.fft-style namespace (watfft_tpu_torch/fftlib.py) against
numpy and the JAX package's namespace (watfft_tpu/fftlib.py).

Every case of tests/test_fftlib.py: the port is held to numpy at the same
tolerance and, where the JAX
namespace returns a result, to it too (off the TPU the JAX namespace sends
other lengths to jnp.fft, so it is the semantics that are compared there:
norm, axes, n, shapes). The port runs with device="cpu", its kernels'
plain versions. Then what the port adds or must keep: size-1 axes and real
transforms of 2 points as numpy has them, the ValueError cases, no call of
a torch.fft transform, and the CUDA default.
"""

import numpy as np
import pytest
import torch

from watfft_tpu import fftlib as jfft
from watfft_tpu_torch import fftlib
from watfft_tpu_torch.ops import bluestein as bl
from watfft_tpu_torch.ops import stockham as st

CPU = {"device": "cpu"}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _port_and_jax(name, *args, **kw):
    """The port's result and the JAX namespace's, as numpy arrays."""
    got = _np(getattr(fftlib, name)(*args, **kw, **CPU))
    want = np.asarray(getattr(jfft, name)(*args, **kw))
    assert got.shape == want.shape
    return got, want


def _close(name, args, expected, atol, **kw):
    """fftlib.<name> against numpy's `expected` and the JAX namespace, both
    within atol; returns the port's result."""
    got, jax_got = _port_and_jax(name, *args, **kw)
    np.testing.assert_allclose(got, expected, atol=atol)
    np.testing.assert_allclose(got, jax_got, atol=atol)
    return got


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


# -- the cases of tests/test_fftlib.py ----------------------------------------------

@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_fft_norms_match_numpy(norm):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 256)) + 1j * rng.uniform(-1, 1, (3, 256))
    got = _close("fft", (x,), np.fft.fft(x, norm=norm), 2e-4, norm=norm)
    _close("ifft", (got,), x, 2e-4, norm=norm)


def test_axis_argument():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (64, 5)).astype(np.complex64)
    _close("fft", (x,), np.fft.fft(x, axis=0), 64 * 5e-6, axis=0)


def test_n_pad_and_truncate():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, 100).astype(np.complex64)
    _close("fft", (x,), np.fft.fft(x, n=128), 1e-3, n=128)
    _close("fft", (x,), np.fft.fft(x, n=64), 1e-3, n=64)


def test_rfft_irfft_roundtrip_with_norm():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 512)).astype(np.float32)
    S = _close("rfft", (x,), np.fft.rfft(x, norm="ortho"), 2e-4, norm="ortho")
    _close("irfft", (S,), x, 2e-4, norm="ortho")


def test_fft2_matches_numpy():
    rng = np.random.default_rng(4)
    x = (rng.uniform(-1, 1, (128, 128))
         + 1j * rng.uniform(-1, 1, (128, 128))).astype(np.complex64)
    got = _close("fft2", (x,), np.fft.fft2(x), 2e-2)
    _close("ifft2", (got,), x, 1e-4)


@pytest.mark.parametrize("shape,axes", [((12, 10), (-2, -1)),
                                        ((3, 6, 15), (-2, -1)),
                                        ((10, 8), (0, 1))])
def test_fft2_nonpow2_matches_numpy(shape, axes):
    """Arbitrary 2D sizes go axis by axis; non-pow2 axes run Bluestein."""
    rng = np.random.default_rng(10)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    for norm in (None, "ortho"):
        got, jax_got = _port_and_jax("fft2", z, axes=axes, norm=norm)
        ref = np.fft.fft2(z, axes=axes, norm=norm)
        assert _rel(got, ref) < 1e-5 and _rel(got, jax_got) < 1e-5
        back = _np(fftlib.ifft2(got, axes=axes, norm=norm, **CPU))
        assert np.max(np.abs(back - z)) < 1e-5


def test_helpers_delegate():
    np.testing.assert_allclose(_np(fftlib.fftfreq(8, **CPU)), np.fft.fftfreq(8))
    x = np.arange(8.0)
    np.testing.assert_allclose(_np(fftlib.fftshift(x, **CPU)), np.fft.fftshift(x))


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_fftn_matches_numpy(norm):
    rng = np.random.default_rng(5)
    x = (rng.uniform(-1, 1, (8, 16, 32))
         + 1j * rng.uniform(-1, 1, (8, 16, 32))).astype(np.complex64)
    got = _close("fftn", (x,), np.fft.fftn(x, norm=norm), 2e-3, norm=norm)
    _close("ifftn", (got,), x, 2e-4, norm=norm)


def test_fftn_axes_and_s():
    rng = np.random.default_rng(6)
    x = (rng.uniform(-1, 1, (4, 16, 32))
         + 1j * rng.uniform(-1, 1, (4, 16, 32))).astype(np.complex64)
    _close("fftn", (x,), np.fft.fftn(x, s=(8, 16), axes=(1, 2)), 2e-3, s=(8, 16), axes=(1, 2))


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_rfft2_matches_numpy(norm):
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (32, 64)).astype(np.float32)
    got = _close("rfft2", (x,), np.fft.rfft2(x, norm=norm), 2e-3, norm=norm)
    _close("irfft2", (got,), x, 2e-4, norm=norm)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hfft_ihfft_match_numpy(norm):
    rng = np.random.default_rng(8)
    m = 33  # spectrum length for n=64
    x = (rng.uniform(-1, 1, m) + 1j * rng.uniform(-1, 1, m)).astype(np.complex64)
    _close("hfft", (x,), np.fft.hfft(x, norm=norm), 2e-3, norm=norm)
    y = rng.uniform(-1, 1, 64).astype(np.float32)
    _close("ihfft", (y,), np.fft.ihfft(y, norm=norm), 2e-5, norm=norm)


@pytest.mark.parametrize("n", [12, 97, 100, 1000])
def test_arbitrary_size_fft_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = (rng.uniform(-1, 1, (3, n)) + 1j * rng.uniform(-1, 1, (3, n)))
    got, jax_got = _port_and_jax("fft", x.astype(np.complex64))
    ref = np.fft.fft(x)
    assert _rel(got, ref) < 5e-6 and _rel(got, jax_got) < 5e-6
    got, jax_got = _port_and_jax("ifft", x.astype(np.complex64), norm="ortho")
    ref = np.fft.ifft(x, norm="ortho")
    assert _rel(got, ref) < 5e-6 and _rel(got, jax_got) < 5e-6


@pytest.mark.parametrize("n", [12, 97, 1000])
def test_arbitrary_size_rfft_matches_numpy(n):
    rng = np.random.default_rng(n + 1)
    x = rng.uniform(-1, 1, (3, n))
    got, jax_got = _port_and_jax("rfft", x.astype(np.float32))
    ref = np.fft.rfft(x)
    assert _rel(got, ref) < 5e-6 and _rel(got, jax_got) < 5e-6


@pytest.mark.parametrize("n", [12, 13, 97, 98, 101])
def test_arbitrary_size_irfft_matches_numpy(n):
    """Both parities: odd n uses the last bin's imaginary part (no Nyquist
    bin), even n drops it, as numpy does."""
    rng = np.random.default_rng(n + 2)
    m = n // 2 + 1
    spec = (rng.uniform(-1, 1, (3, m))
            + 1j * rng.uniform(-1, 1, (3, m))).astype(np.complex64)
    got, jax_got = _port_and_jax("irfft", spec, n=n)
    ref = np.fft.irfft(spec, n=n)
    assert np.max(np.abs(got - ref)) < 1e-5 and np.max(np.abs(got - jax_got)) < 1e-5


# -- what the port adds or must keep --------------------------------------------------

def test_size_one_axes_follow_numpy():
    """numpy's identity on a size-1 axis; the JAX namespace raises there
    (`_is_pow2(1)` sends it to its power-of-two kernels; ROADMAP C)."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (1, 6)) + 1j * rng.uniform(-1, 1, (1, 6))
    r = rng.uniform(-1, 1, (5, 1))
    atol = 1e-5
    np.testing.assert_allclose(_np(fftlib.fft(x, axis=0, **CPU)), np.fft.fft(x, axis=0), atol=atol)
    np.testing.assert_allclose(_np(fftlib.ifft(x, axis=0, **CPU)), np.fft.ifft(x, axis=0),
                               atol=atol)
    np.testing.assert_allclose(_np(fftlib.fft(x, n=1, **CPU)), np.fft.fft(x, n=1), atol=atol)
    np.testing.assert_allclose(_np(fftlib.rfft(r, **CPU)), np.fft.rfft(r), atol=atol)
    np.testing.assert_allclose(_np(fftlib.irfft(x[:, :1], n=1, **CPU)),
                               np.fft.irfft(x[:, :1], n=1), atol=atol)
    np.testing.assert_allclose(_np(fftlib.fft2(x, **CPU)), np.fft.fft2(x), atol=atol)
    np.testing.assert_allclose(_np(fftlib.fftn(x[..., None], **CPU)), np.fft.fftn(x[..., None]),
                               atol=atol)
    np.testing.assert_allclose(_np(fftlib.rfft2(r, **CPU)), np.fft.rfft2(r), atol=atol)
    with pytest.raises(ValueError):
        jfft.fft(x, axis=0)


def test_value_errors_match_the_jax_namespace():
    """The JAX namespace's ValueError cases raise here too, but for the real
    transforms of 2 points, which the JAX contexts refuse and numpy (and
    the port) computes (test_real_transforms_of_two_points_follow_numpy)."""
    x = np.ones((4, 8), np.complex64)
    cases = [("fft", (x,), {"norm": "unitary"}),
             ("fftn", (x,), {"s": (4, 8), "axes": (0,)}),
             ("ifftn", (x,), {"s": (4,), "axes": (0, 1)}),
             ("rfft2", (x.real,), {"norm": "backwards"})]
    for name, args, kw in cases:
        with pytest.raises(ValueError):
            getattr(jfft, name)(*args, **kw)
        with pytest.raises(ValueError):
            getattr(fftlib, name)(*args, **kw, **CPU)
    for name, args in (("rfft", (x.real[:, :2],)), ("irfft", (x[:, :2],))):
        with pytest.raises(ValueError):
            getattr(jfft, name)(*args)
        np.testing.assert_allclose(_np(getattr(fftlib, name)(*args, **CPU)),
                                   getattr(np.fft, name)(*args), atol=1e-6)


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_real_transforms_of_two_points_follow_numpy(norm):
    """rfft / ihfft at n = 2, irfft / hfft to n = 2 and the 2D real forms
    with a last axis of 2: numpy's bins, within 1e-6 (the JAX namespace
    raises; ROADMAP C)."""
    rng = np.random.default_rng(21)
    r = rng.uniform(-1, 1, (3, 2))
    z = rng.uniform(-1, 1, (3, 2)) + 1j * rng.uniform(-1, 1, (3, 2))
    r5 = rng.uniform(-1, 1, (3, 5))
    for name, arg, kw in (("rfft", r, {}), ("ihfft", r, {}), ("irfft", z, {}),
                          ("hfft", z, {}), ("rfft", r[:, :1], {"n": 2}),
                          ("rfft", r5, {"n": 2}), ("irfft", z[:, :1], {"n": 2})):
        np.testing.assert_allclose(_np(getattr(fftlib, name)(arg, norm=norm, **kw, **CPU)),
                                   getattr(np.fft, name)(arg, norm=norm, **kw), atol=1e-6)
    r3 = rng.uniform(-1, 1, (2, 4, 2))
    np.testing.assert_allclose(_np(fftlib.rfft2(r3, norm=norm, **CPU)),
                               np.fft.rfft2(r3, norm=norm), atol=1e-6)
    s3 = np.fft.rfft2(r3)
    np.testing.assert_allclose(_np(fftlib.irfft2(s3, norm=norm, **CPU)),
                               np.fft.irfft2(s3, norm=norm), atol=1e-6)


def test_mxu_precision_ladder(monkeypatch):
    """tests/test_fftlib.py's ladder case on the port: config.MXU_PRECISION
    = "default" (one TF32 pass on the card; the CPU's matmuls stay f32)
    keeps the matmul surface within 1e-2, beside the JAX package on the
    same input."""
    from watfft_tpu import config as jconfig
    from watfft_tpu.api import FFTContext as JFFTContext
    from watfft_tpu_torch import config
    from watfft_tpu_torch.api import FFTContext
    monkeypatch.setattr(jconfig, "MXU_PRECISION", "default")
    monkeypatch.setattr(config, "MXU_PRECISION", "default")
    rng = np.random.default_rng(9)
    xre = rng.uniform(-1, 1, (4, 256)).astype(np.float32)
    xim = rng.uniform(-1, 1, (4, 256)).astype(np.float32)
    ref = np.fft.fft(xre.astype(np.float64) + 1j * xim.astype(np.float64))
    re, im = FFTContext(256, "float32", **CPU).forward_planes_fourstep(torch.from_numpy(xre),
                                                                       torch.from_numpy(xim))
    got = _np(re) + 1j * _np(im)
    jre, jim = JFFTContext(256, "float32").forward_planes_fourstep(xre, xim)
    jgot = np.asarray(jre) + 1j * np.asarray(jim)
    assert _rel(got, ref) < 1e-2 and _rel(jgot, ref) < 1e-2
    assert _rel(got, jgot) < 1e-2


def test_helpers_match_numpy():
    for n in (1, 2, 7, 8, 1000):
        for d in (1.0, 0.1):
            np.testing.assert_allclose(_np(fftlib.fftfreq(n, d, **CPU)), np.fft.fftfreq(n, d),
                                       rtol=1e-7)
            np.testing.assert_allclose(_np(fftlib.rfftfreq(n, d, **CPU)), np.fft.rfftfreq(n, d),
                                       rtol=1e-7)
    x = np.arange(35.0).reshape(5, 7)
    for axes in (None, 0, 1, (0, 1), (-1,)):
        assert np.array_equal(_np(fftlib.fftshift(x, axes, **CPU)), np.fft.fftshift(x, axes))
        assert np.array_equal(_np(fftlib.ifftshift(x, axes, **CPU)), np.fft.ifftshift(x, axes))


def test_no_library_fft_is_called(monkeypatch):
    """Every torch.fft transform raises; the namespace runs through all the
    same, on the port's kernels' plain versions."""
    def refuse(*args, **kwargs):
        raise AssertionError("a torch.fft transform was called")
    for name in ("fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2", "fftn",
                 "ifftn", "rfftn", "irfftn", "hfft", "ihfft", "hfft2", "ihfft2", "hfftn",
                 "ihfftn", "fftfreq", "rfftfreq", "fftshift", "ifftshift"):
        monkeypatch.setattr(torch.fft, name, refuse)
    rng = np.random.default_rng(12)
    z = rng.uniform(-1, 1, (3, 12, 10)) + 1j * rng.uniform(-1, 1, (3, 12, 10))
    r = z.real
    for n in (None, 7, 16, 33):
        np.testing.assert_allclose(_np(fftlib.fft(z, n=n, **CPU)), np.fft.fft(z, n=n), atol=1e-4)
        np.testing.assert_allclose(_np(fftlib.ifft(z, n=n, **CPU)), np.fft.ifft(z, n=n),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(fftlib.rfft(r, n=n, **CPU)), np.fft.rfft(r, n=n), atol=1e-4)
        np.testing.assert_allclose(_np(fftlib.irfft(z, n=n, **CPU)), np.fft.irfft(z, n=n),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(fftlib.hfft(z, n=n, **CPU)), np.fft.hfft(z, n=n),
                                   atol=1e-3)
        np.testing.assert_allclose(_np(fftlib.ihfft(r, n=n, **CPU)), np.fft.ihfft(r, n=n),
                                   atol=1e-5)
    for f in ("fft2", "ifft2", "fftn", "ifftn"):
        np.testing.assert_allclose(_np(getattr(fftlib, f)(z, **CPU)), getattr(np.fft, f)(z),
                                   atol=1e-3)
    z16 = rng.uniform(-1, 1, (2, 16, 8)) + 1j * rng.uniform(-1, 1, (2, 16, 8))
    np.testing.assert_allclose(_np(fftlib.fft2(z16, **CPU)), np.fft.fft2(z16), atol=1e-3)
    np.testing.assert_allclose(_np(fftlib.rfft2(z16.real, **CPU)), np.fft.rfft2(z16.real),
                               atol=1e-3)
    np.testing.assert_allclose(_np(fftlib.irfft2(z16, **CPU)), np.fft.irfft2(z16), atol=1e-5)
    np.testing.assert_allclose(_np(fftlib.rfft2(r, **CPU)), np.fft.rfft2(r), atol=1e-3)
    np.testing.assert_allclose(_np(fftlib.irfft2(z, s=(12, 9), **CPU)),
                               np.fft.irfft2(z, s=(12, 9)), atol=1e-5)
    np.testing.assert_allclose(_np(fftlib.fftshift(r, **CPU)), np.fft.fftshift(r))


@pytest.mark.parametrize("shape", [(3, 16, 17), (2, 64, 33), (1, 8, 5)])
def test_irfft2_follows_numpy_on_non_hermitian_end_columns(shape):
    """At a power-of-two output width irfft2 runs the 2D route, whose
    kernels read all of columns 0 and w/2; numpy keeps only their Hermitian
    part along h. Random spectra: those columns are not Hermitian."""
    rng = np.random.default_rng(sum(shape))
    z = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    np.testing.assert_allclose(_np(fftlib.irfft2(z, **CPU)), np.fft.irfft2(z), atol=1e-5)


def test_routes_power_of_two_to_the_api_and_the_rest_to_bluestein(monkeypatch):
    """fft(x, n=1024) runs the Stockham path and no Bluestein; n = 1000 the
    reverse. Seen through the plain versions each route calls on the CPU."""
    calls = []
    for mod, name in ((st, "plain_fft"), (bl, "_plain_fwd")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    x = np.ones((2, 1000), np.complex64)
    fftlib.fft(x, n=1024, **CPU)
    assert calls == ["plain_fft"]
    calls.clear()
    fftlib.fft(x, **CPU)
    assert calls == ["_plain_fwd"]


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    x = np.ones((2, 12), np.complex64)
    for name, arg in (("fft", x), ("ifft", x), ("rfft", x.real), ("irfft", x), ("fft2", x),
                      ("ifft2", x), ("fftn", x), ("ifftn", x), ("rfft2", x.real), ("irfft2", x),
                      ("hfft", x), ("ihfft", x.real), ("fftshift", x), ("ifftshift", x)):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(fftlib, name)(arg)
    for name in ("fftfreq", "rfftfreq"):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(fftlib, name)(8)
    assert fftlib.fft(x, **CPU).device.type == "cpu"


def test_namespace_has_every_jax_name():
    assert set(jfft.__all__) <= set(fftlib.__all__)
    assert all(callable(getattr(fftlib, name)) for name in jfft.__all__)
