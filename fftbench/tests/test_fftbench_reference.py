"""The plain references agree with numpy.fft at small sizes, and the
lower-precision reference (the control) is as far off as bfloat16 is."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fftbench.reference import fft as cref
from fftbench.reference import stft as sref


def np_hann(n):
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


@pytest.mark.parametrize("n", [2, 16, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_c2c_matches_numpy(n, inverse):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))
    got = cref.c2c(torch.as_tensor(x), inverse).numpy()
    want = np.fft.ifft(x) if inverse else np.fft.fft(x)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_max_rel_is_per_row():
    ref = torch.tensor([[1.0, 2.0], [100.0, 0.0]], dtype=torch.float64)
    got = ref + torch.tensor([[0.0, 0.2], [1.0, 0.0]], dtype=torch.float64)
    assert cref.max_rel(got, ref) == pytest.approx(0.1)


@pytest.mark.parametrize("t,n_fft,hop", [(5120, 1024, 256), (1000, 64, 16), (70, 16, 5)])
def test_stft_matches_numpy(t, n_fft, hop):
    x = np.random.default_rng(t).uniform(-1, 1, (2, t))
    m = 1 + (t - n_fft) // hop
    frames = np.stack([x[:, f * hop:f * hop + n_fft] for f in range(m)], axis=1)
    want = np.fft.rfft(frames * np_hann(n_fft), axis=-1)
    re, im = sref.stft(torch.as_tensor(x), n_fft, hop)
    assert re.shape == (2, m, n_fft // 2 + 1)
    got = re.numpy() + 1j * im.numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("t,n_fft,hop", [(5120, 1024, 256), (16000, 1024, 256), (1000, 64, 16)])
def test_istft_matches_numpy_overlap_add(t, n_fft, hop):
    x = np.random.default_rng(t).uniform(-1, 1, (2, t))
    re, im = sref.stft(torch.as_tensor(x), n_fft, hop)
    spec = re.numpy() + 1j * im.numpy()
    w = np_hann(n_fft)
    frames = np.fft.irfft(spec, n=n_fft, axis=-1) * w
    m = frames.shape[1]
    span = (m - 1) * hop + n_fft
    out, norm = np.zeros((2, span)), np.zeros(span)
    for f in range(m):
        out[:, f * hop:f * hop + n_fft] += frames[:, f]
        norm[f * hop:f * hop + n_fft] += w * w
    want = (out / np.maximum(norm, 1e-8))[:, :t]
    got = sref.istft(re, im, n_fft, hop, length=t).numpy()
    assert got.shape == want.shape == (2, min(t, span))
    assert np.abs(got - want).max() <= 1e-9
    # away from the ends the overlap-add gives the signal back
    inner = norm[:want.shape[1]] >= 0.5 * norm.max()
    assert np.abs(got[:, inner] - x[:, :span][:, inner]).max() <= 1e-12


def test_overlap_is_cola_inside():
    norm = sref.overlap(10, 1024, 256, "cpu").numpy()
    assert np.allclose(norm[768:-768], 1.5)


@pytest.mark.parametrize("n", [16, 1024])
def test_dft_products_in_float64_agree_and_in_bfloat16_do_not(n):
    x = torch.as_tensor(np.random.default_rng(n).uniform(-1, 1, (3, n)))
    want = torch.fft.rfft(x, dim=-1)
    exact = sref.rdft(x, torch.float32)
    assert float((exact - want).abs().max() / want.abs().max()) < 1e-5
    low = sref.rdft(x, torch.bfloat16)
    err = float((low - want).abs().max() / want.abs().max())
    assert 1e-4 < err < 5e-2
    back = sref.irdft(want.real, want.imag, n, torch.float32)
    assert float((back - x).abs().max()) < 1e-5
