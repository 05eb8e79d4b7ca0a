"""The plain spectrometer (rawspec's product 0000): int8 voltages in GUPPI
RAW order [chans, t, pols, 2] to integrated total-power spectra, in
float64, and the error of a spectrometer's output against it.

Imports torch alone: nothing of the port and nothing of JAX. A block at a
time, one integration of one coarse channel a block (at nfft = 2^20, 51
spectra and two polarisations, 1.7 GB of complex128), so it runs on the
card at the cell's size.
"""

from __future__ import annotations

import torch


def integrate(volts: torch.Tensor, nfft: int, nint: int,
              spectrum_dtype: torch.dtype | None = None) -> torch.Tensor:
    """float64 [chans, t // (nfft * nint), nfft]: for each channel and each
    run of nint spectra of nfft samples, |X|^2 summed over the
    polarisations and the spectra, fftshifted. With `spectrum_dtype`, each
    spectrum's real and imaginary parts are rounded to it before detection
    (the control: bfloat16)."""
    chans, t, pols, _ = volts.shape
    span = nfft * nint
    out = torch.empty((chans, t // span, nfft), dtype=torch.float64, device=volts.device)
    for c in range(chans):
        for k in range(t // span):
            out[c, k] = _block(volts[c, k * span:(k + 1) * span], nfft, nint, spectrum_dtype)
    return out


def _block(v: torch.Tensor, nfft: int, nint: int, spectrum_dtype) -> torch.Tensor:
    """One integration of one channel: int8 [nint * nfft, pols, 2] -> [nfft]."""
    v = v.to(torch.float64)
    x = torch.complex(v[..., 0], v[..., 1]).T.reshape(v.shape[1], nint, nfft)
    spec = torch.view_as_real(torch.fft.fft(x, dim=-1))
    if spectrum_dtype is not None:
        spec = spec.to(spectrum_dtype).to(torch.float64)
    return torch.fft.fftshift(spec.square().sum(dim=(0, 1, 3)))


def power_err(got: torch.Tensor, volts: torch.Tensor, nfft: int, nint: int) -> float:
    """The worst over the integrated spectra (a channel's integration is one
    row of `got` [chans, nout, nfft]) of the row's largest error against
    the reference, as a share of the reference row's largest bin. NaN
    anywhere reads NaN."""
    span = nfft * nint
    worst = []
    for c in range(volts.shape[0]):
        for k in range(volts.shape[1] // span):
            want = _block(volts[c, k * span:(k + 1) * span], nfft, nint, None)
            err = (got[c, k].to(torch.float64) - want).abs().max() / want.abs().max()
            worst.append(err)
    return float(torch.stack(worst).max())
