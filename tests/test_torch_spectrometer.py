"""The spectrometer (`watfft_tpu_torch.spectrometer.integrate`) against the
same mathematics in numpy float64 on seeded int8 voltages in GUPPI RAW
order: on the route the planner picks at each nfft (pipe2 at 2^15, the
Stockham kernel at 1024 and 8), two integrations in one call, chunks of
part of an integration; the shift puts the DC bin at nfft / 2; the
refusals; no call of `torch.fft`; the span tree and the `spec.spectra`
counter under a profiler, the launches through a stand-in for the kernels'
library. No JAX is needed. The tests marked cuda run the kernels on the
card at nfft = 2^20, against the same mathematics in torch float64 there:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_spectrometer.py
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from watfft_tpu_torch import registry, spectrometer, trace
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.utils.tolerances import MAX_REL

# max |P - P_ref| / max P_ref of each integrated spectrum (a channel's
# integration): the port's f32 limit of a transform's largest output, which
# the power keeps: its transforms are f32 and its sums of up to 2 * nint
# terms float32 (readings 5e-8 .. 3.2e-7 here; a spectrum rounded to
# bfloat16 reads ~4e-3)
LIMIT = MAX_REL["float32"]


def _volts(chans, t, pols=2, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, (chans, t, pols, 2), generator=g,
                         dtype=torch.int8).to(device)


def _err(got, want):
    """The worst over the integrated spectra of the largest error, as a
    share of the reference spectrum's largest bin."""
    return float(((got.double() - want).abs().amax(-1) / want.abs().amax(-1)).max())


def _numpy_model(volts, nfft, nint):
    """The spectrometer written out in numpy, float64."""
    chans, t, pols, _ = volts.shape
    v = volts.numpy().astype(np.float64)
    z = (v[..., 0] + 1j * v[..., 1]).reshape(chans, t // (nfft * nint), nint, nfft, pols)
    power = (np.abs(np.fft.fft(z, axis=3)) ** 2).sum(axis=(2, 4))
    return torch.from_numpy(np.fft.fftshift(power, axes=-1))


def _card_model(volts, nfft, nint):
    """The same in torch float64 on the card, one integration of one
    channel at a time (at nfft = 2^20 and nint = 3, 100 MB of complex128)."""
    chans, t, pols, _ = volts.shape
    span = nfft * nint
    out = torch.empty((chans, t // span, nfft), dtype=torch.float64, device=volts.device)
    for c in range(chans):
        for k in range(t // span):
            v = volts[c, k * span:(k + 1) * span].double()  # [span, pols, 2]
            x = torch.complex(v[..., 0], v[..., 1]).T.reshape(pols, nint, nfft)
            spec = torch.fft.fft(x, dim=-1)
            power = (spec.real.square() + spec.imag.square()).sum(dim=(0, 1))
            out[c, k] = torch.fft.fftshift(power)
    return out


# -- against numpy ---------------------------------------------------------------------

@pytest.mark.parametrize("nfft,route", [(1 << 15, "large-pipe2"), (1024, "stockham"),
                                        (8, "stockham")])
def test_matches_the_reference(nfft, route):
    nint, nout = 3, 2
    volts = _volts(2, nfft * nint * nout, seed=nfft)
    before = dict(trace.routes)
    got = spectrometer.integrate(volts, nfft, nint, device="cpu")
    assert trace.routes[route] == before[route] + nout  # a chunk an integration, one call each
    assert got.shape == (2, nout, nfft) and got.dtype == torch.float32
    assert _err(got, _numpy_model(volts, nfft, nint)) <= LIMIT


@pytest.mark.parametrize("points,per", [(4096 * 2, 2), (4096 * 4, 3), (4096 * 5, 3),
                                        (4096 * 12, 6)])
def test_chunks_inside_an_integration(points, per, monkeypatch):
    """4 streams of 1024: a budget of 2 spectra takes 2 of nint = 6 a chunk,
    4 and 5 take 3 (the largest divisor), 12 one whole integration."""
    nfft, nint = 1024, 6
    volts = _volts(2, nfft * nint * 2, seed=3)
    monkeypatch.setattr(spectrometer, "CHUNK_POINTS", points)
    assert spectrometer.spectra_per_chunk(4, nfft, nint) == per
    before = trace.routes["stockham"]
    got = spectrometer.integrate(volts, nfft, nint, device="cpu")
    assert trace.routes["stockham"] - before == 12 // per
    assert _err(got, _numpy_model(volts, nfft, nint)) <= LIMIT


@pytest.mark.parametrize("streams,nfft,nint,per", [
    (128, 1 << 20, 51, 1),       # the rawspec cell: one spectrum of every stream
    (256, 1 << 20, 51, 1),       # more than the budget: still one spectrum
    (128, 1 << 15, 51, 17),      # 32 spectra fit: the largest divisor of 51
    (128, 1 << 13, 51, 51),      # 128 fit: one whole integration, no more
    (128, 1 << 15, 7, 7),        # a prime nint that fits whole
    (128, 1 << 18, 7, 1)])       # a prime nint past the budget of 4: one spectrum
def test_spectra_per_chunk(streams, nfft, nint, per):
    assert spectrometer.spectra_per_chunk(streams, nfft, nint) == per


@pytest.mark.parametrize("nfft", [1024, 1 << 15])
def test_shift_puts_dc_at_the_middle(nfft):
    """A constant voltage is all DC: at nfft / 2. A tone k bins above DC
    lands k above the middle, one below it k under."""
    k = 5
    t = np.arange(2 * nfft)
    volts = torch.zeros(3, 2 * nfft, 2, 2, dtype=torch.int8)
    volts[0, :, :, 0] = 100
    for ch, sign in ((1, 1), (2, -1)):
        tone = 100 * np.exp(2j * np.pi * sign * k * t / nfft)
        volts[ch, :, 0, 0] = torch.from_numpy(np.round(tone.real).astype(np.int8))
        volts[ch, :, 0, 1] = torch.from_numpy(np.round(tone.imag).astype(np.int8))
    got = spectrometer.integrate(volts, nfft, 2, device="cpu")[:, 0]
    assert got.argmax(-1).tolist() == [nfft // 2, nfft // 2 + k, nfft // 2 - k]
    dc = got[0].clone()
    assert dc[nfft // 2] == pytest.approx(2 * 2 * (100.0 * nfft) ** 2, rel=1e-6)
    dc[nfft // 2] = 0
    assert float(dc.abs().max()) <= 1e-6 * float(got[0].max())


def test_refusals():
    ok = _volts(1, 64)
    with pytest.raises(TypeError, match="int8"):
        spectrometer.integrate(ok.float(), 16, 2, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        spectrometer.integrate(ok, 12, 2, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        spectrometer.integrate(ok, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="nint"):
        spectrometer.integrate(ok, 16, 0, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        spectrometer.integrate(ok, 16, 3, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        spectrometer.integrate(_volts(1, 0), 16, 1, device="cpu")
    with pytest.raises(ValueError, match=r"\[chans, t, pols, 2\]"):
        spectrometer.integrate(ok[..., :1], 16, 2, device="cpu")
    with pytest.raises(ValueError, match=r"\[chans, t, pols, 2\]"):
        spectrometer.integrate(ok[0], 16, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spectrometer.integrate(ok, 16, 2)


@pytest.mark.parametrize("nfft", [1024, 1 << 15])
def test_no_call_of_torch_fft(nfft, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.fft was called")
    for name in ("fft", "ifft", "fftshift", "ifftshift", "rfft"):
        monkeypatch.setattr(torch.fft, name, refuse)
    volts = _volts(2, nfft * 2)
    assert spectrometer.integrate(volts, nfft, 2, device="cpu").shape == (2, 1, nfft)


def test_counter_counts_every_spectrum_once(monkeypatch):
    volts = _volts(3, 256 * 4 * 2, pols=2)
    monkeypatch.setattr(spectrometer, "CHUNK_POINTS", 6 * 256 * 2)  # 2 spectra a chunk
    before = trace.counters()["spec.spectra"]
    spectrometer.integrate(volts, 256, 4, device="cpu")
    assert trace.counters()["spec.spectra"] - before == 3 * 2 * 4 * 2


# -- spans -----------------------------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch):
    """The four-step wrappers launch on CPU tensors into a library that does
    nothing and returns 0 (the outputs stay as allocated)."""
    lib = types.SimpleNamespace(watfft_strided_c2c=lambda *a: 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "use_kernel", lambda t, plain=False: not plain)


def test_span_tree_and_counter(stand_in, monkeypatch):
    nfft, nint = 1 << 15, 3
    volts = _volts(1, nfft * nint)
    monkeypatch.setattr(spectrometer, "CHUNK_POINTS", 2 * nfft)  # one spectrum a chunk
    launches = registry.launch_counts()
    spectra = trace.counts["spec.spectra"]
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        spectrometer.integrate(volts, nfft, nint, device="cpu")
    recorded = trace.spans()
    trace.clear()
    by_id = {s.id: s for s in recorded}
    kids = {}
    for s in recorded:
        if s.parent:
            kids.setdefault(by_id[s.parent].name, []).append(s.name)
    assert [s.name for s in recorded if s.parent == 0] == ["spectrometer.integrate"]
    assert kids["spectrometer.integrate"] == (
        ["spec.detect"] + ["spec.unpack", "api.forward", "spec.detect"] * nint + ["spec.shift"])
    assert kids["api.forward"] == ["launch.large_stage1", "launch.large_stage2"] * nint
    assert set(kids) == {"spectrometer.integrate", "api.forward"}
    assert len({s.call for s in recorded}) == 1
    after = registry.launch_counts()
    assert after["large_stage1"] - launches["large_stage1"] == nint
    assert after["large_stage2"] - launches["large_stage2"] == nint
    assert trace.counts["spec.spectra"] - spectra == 2 * nint


def test_pairs_store_counts_a_launch_a_chunk(stand_in, monkeypatch):
    """At nfft = 2^20 each chunk's stage 2 (#13) stores 8 bytes a point
    into the transform's complex64 output: one `strided.pairs_store` a
    chunk, none for stage 1."""
    nfft, nint = 1 << 20, 2
    volts = _volts(1, nfft * nint)
    monkeypatch.setattr(spectrometer, "CHUNK_POINTS", 2 * nfft)  # one spectrum a chunk
    before = trace.counts["strided.pairs_store"]
    spectrometer.integrate(volts, nfft, nint, device="cpu")
    assert trace.counts["strided.pairs_store"] - before == nint


def test_no_profiler_records_no_span(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was opened with no profiler session")
    monkeypatch.setattr(trace, "begin", refuse)
    monkeypatch.setattr(trace, "call", refuse)
    trace.clear()
    spectrometer.integrate(_volts(2, 64 * 2), 64, 2, device="cpu")
    assert len(trace._buffer) == 0


# -- on the card, at nfft = 2^20 ---------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("on_host", [False, True])
def test_matches_the_reference_on_the_card(on_host, dev):
    """Two integrations of nint = 3 of two channels in one call; voltages
    on the host move to the card a chunk at a time."""
    nfft, nint = 1 << 20, 3
    volts = _volts(2, nfft * nint * 2, seed=11)
    spectrometer.integrate(volts[:1, :nfft * nint].to(dev), nfft, nint)  # the tables built
    copies, sent = trace.counts["h2d_copies"], trace.counts["h2d_bytes"]
    got = spectrometer.integrate(volts if on_host else volts.to(dev), nfft, nint)
    assert got.device.type == "cuda" and got.shape == (2, 2, nfft)
    assert trace.counts["h2d_copies"] - copies == (2 if on_host else 0)  # a chunk each
    assert trace.counts["h2d_bytes"] - sent == (volts.nbytes if on_host else 0)
    assert _err(got.cpu(), _card_model(volts.to(dev), nfft, nint).cpu()) <= LIMIT


@pytest.mark.cuda
def test_cell_shape_takes_pipe2_on_the_card(dev):
    """64 channels of 2 polarisations: one chunk of 128 streams of 2^20 a
    spectrum, through pipe2's two kernels."""
    nfft = 1 << 20
    volts = _volts(64, nfft, seed=12, device=dev)
    routes, launches = dict(trace.routes), registry.launch_counts()
    got = spectrometer.integrate(volts, nfft, 1)
    after = registry.launch_counts()
    assert trace.routes["large-pipe2"] - routes["large-pipe2"] == 1
    assert sum(trace.routes.values()) - sum(routes.values()) == 1
    assert after["large_stage1"] - launches["large_stage1"] == 1
    assert after["large_stage2"] - launches["large_stage2"] == 1
    assert _err(got, _card_model(volts, nfft, 1)) <= LIMIT
