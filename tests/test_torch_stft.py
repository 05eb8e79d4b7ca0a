"""The port's STFT pipeline (watfft_tpu_torch/stft.py) against the JAX
package's (watfft_tpu/stft.py) and numpy.

The JAX pipeline is forced onto its Pallas real path in interpret mode
(config.FORCE_INTERPRET); the port runs with device="cpu", i.e. the real
kernels' plain versions. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from watfft_tpu import config
from watfft_tpu import stft as jstft
from watfft_tpu_torch import stft
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL

JAX_LIMIT = 1e-6  # max |port - jax| / max |jax|
N_FFT, HOP = 64, 16
WINDOWS = ["rect", "hann", "hamming", "blackman", "blackman-harris"]


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(config, "FORCE_INTERPRET", True)


def _signal(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _rel_to_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", WINDOWS)
def test_windows_and_frames_equal_jax(name):
    assert np.array_equal(stft.get_window(name, N_FFT), jstft.get_window(name, N_FFT))
    x = _signal((2, 300), seed=1)
    assert np.array_equal(stft.frame(torch.from_numpy(x), N_FFT, HOP).numpy(),
                          np.asarray(jstft.frame(x, N_FFT, HOP)))


def test_stft_istft_spectrogram_match_jax(interpret_mode):
    x = _signal((2, 1000), seed=2)
    jre, jim = jstft.stft(x, n_fft=N_FFT, hop=HOP)
    re, im = stft.stft(torch.from_numpy(x), n_fft=N_FFT, hop=HOP, device="cpu")
    assert re.shape == (2, (1000 - N_FFT) // HOP + 1, N_FFT // 2 + 1)
    want = np.asarray(jre) + 1j * np.asarray(jim)
    assert _rel_to_max(re.numpy() + 1j * im.numpy(), want) <= JAX_LIMIT

    # istft divides the overlap-add by the summed window power, which is
    # ~1e-5 at the ends of a hann window and there magnifies the ulp-level
    # differences of the frames; so the sum itself is compared everywhere,
    # the quotient where the window power is not small
    want = np.asarray(jstft.istft(jre, jim, n_fft=N_FFT, hop=HOP, length=990))
    got = stft.istft(torch.tensor(np.asarray(jre)), torch.tensor(np.asarray(jim)),
                     n_fft=N_FFT, hop=HOP, length=990, device="cpu").numpy()
    w2 = stft.get_window("hann", N_FFT, np.float64) ** 2
    power = np.zeros(1000)
    for start in range(0, 1000 - N_FFT + 1, HOP):
        power[start:start + N_FFT] += w2
    power = power[:990]
    assert _rel_to_max(got * power, want * power) <= JAX_LIMIT
    well = power >= 1e-2 * power.max()
    assert well.sum() > 950 and _rel_to_max(got[:, well], want[:, well]) <= JAX_LIMIT

    want = np.asarray(jstft.spectrogram(x, n_fft=N_FFT, hop=HOP, log=False))
    p = stft.spectrogram(x, n_fft=N_FFT, hop=HOP, log=False, device="cpu")
    assert _rel_to_max(p.numpy(), want) <= JAX_LIMIT
    logp = stft.spectrogram(x, n_fft=N_FFT, hop=HOP, device="cpu")
    assert torch.equal(logp, torch.log(p + 1e-10))


@pytest.mark.parametrize("window", ["hann", "blackman"])
def test_stft_meets_numpy_oracle_and_istft_roundtrips(window):
    """Against a windowed np.fft.rfft in f64 of the same frames; istft
    reconstructs the signal wherever the window overlap is not ~0."""
    x = _signal((3, 2048), seed=3)
    re, im = stft.stft(x, n_fft=N_FFT, hop=HOP, window=window, device="cpu")
    idx = np.arange((2048 - N_FFT) // HOP + 1)[:, None] * HOP + np.arange(N_FFT)
    want = np.fft.rfft(x.astype(np.float64)[..., idx] * stft.get_window(window, N_FFT, np.float64))
    assert rel_errors(re.numpy() + 1j * im.numpy(), want)[0] <= MAX_REL["float32"]
    back = stft.istft(re, im, n_fft=N_FFT, hop=HOP, window=window, device="cpu").numpy()
    assert back.shape == (3, 2048)
    assert np.max(np.abs(back[..., N_FFT:-N_FFT] - x[..., N_FFT:-N_FFT])) < 1e-5


def test_mel_filterbank_equals_jax():
    for n_mels, n_fft, sr, fmin, fmax in [(40, 512, 16000, 0.0, None),
                                          (80, 1024, 22050, 20.0, 8000.0)]:
        want = jstft.mel_filterbank(n_mels, n_fft, sr, fmin, fmax)
        got = stft.mel_filterbank(n_mels, n_fft, sr, fmin, fmax)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_matches_jax_and_numpy(mode, interpret_mode):
    """Broadcast leading axes ([2, 3, t] with [k]) through the port's real
    FFT, against the JAX pipeline and np.convolve per row."""
    x, h = _signal((2, 3, 100), seed=4), _signal((29,), seed=5)
    got = stft.fftconvolve(torch.from_numpy(x), h, mode=mode, device="cpu").numpy()
    assert _rel_to_max(got, np.asarray(jstft.fftconvolve(x, h, mode=mode))) <= JAX_LIMIT
    want = np.stack([np.convolve(r, h.astype(np.float64), mode=mode)
                     for r in x.reshape(-1, 100).astype(np.float64)]).reshape(2, 3, -1)
    assert _rel_to_max(got, want) <= 1e-6


def test_refusals():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="power of two"):
        stft.stft(x, n_fft=48, hop=8, device="cpu")
    with pytest.raises(ValueError, match="hop"):
        stft.stft(x, n_fft=32, hop=0, device="cpu")
    with pytest.raises(ValueError, match="shorter than n_fft"):
        stft.stft(x, n_fft=128, hop=8, device="cpu")
    with pytest.raises(ValueError, match="valid"):
        stft.fftconvolve(np.ones(3), np.ones(5), mode="valid", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        stft.fftconvolve(np.ones(3), np.ones(5), mode="circular", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            stft.stft(x, n_fft=32, hop=8)
