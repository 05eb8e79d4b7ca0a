"""The spectrometer (`watfft_tpu_torch.spectrometer.integrate`) against the
same mathematics in numpy float64 on seeded int8 voltages in GUPPI RAW
order: on the route the planner picks at each nfft (pipe2 at 2^15, the
Stockham kernel at 1024 and 8), two integrations in one call, chunks of
part of an integration; the shift puts the DC bin at nfft / 2; the
refusals; no call of `torch.fft`; the span tree and the `spec.spectra`
counter under a profiler, the launches through a stand-in for the kernels'
library; the detection (`ops/detect.py`): its launch's sizes, its plain
version against a float64 model, its refusals. No JAX is needed. The tests
marked cuda run the kernels on the card at nfft = 2^20, against the same
mathematics in torch float64 there, and the detection kernel against its
plain version on the same spectra:

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
from watfft_tpu_torch.ops import detect as dt
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


# -- the detection ------------------------------------------------------------------------

def _spectra(shape, seed, device="cpu"):
    """complex64 spectra of the magnitudes a transform of int8 voltages
    gives (~127 sqrt(nfft))."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(shape + (2,), generator=g) * (127.0 * shape[-1] ** 0.5)
    return torch.view_as_complex(z).to(device)


def _detect_model(x, row):
    """row + the power of x summed over its streams, in float64."""
    x = x.cpu().to(torch.complex128)
    return row.cpu().double() + (x.real.square() + x.imag.square()).sum(dim=(1, 2))


def _row_err(got, want):
    """The worst over the channels of the largest error, as a share of the
    channel's largest bin."""
    got, want = got.cpu().double(), want.cpu().double()
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


@pytest.mark.parametrize("shape,stride,x_addr,row_addr,want", [
    ((64, 2, 1, 1 << 20), 51 << 20, 0, 4096, (64, 2, 1 << 20, 51 << 20, 4)),  # the cell
    ((64, 2, 2, 1024), 3072, 16, 32, (64, 4, 1024, 3072, 4)),    # two spectra a chunk
    ((2, 1, 3, 16), 16, 0, 0, (2, 3, 16, 16, 4)),                # an odd count of streams
    ((3, 2, 1, 2), 4, 0, 0, (3, 2, 2, 4, 1)),                    # nfft 2: one bin a thread
    ((3, 2, 1, 8), 8, 0, 0, (3, 2, 8, 8, 4)),                    # the smallest vector case
    ((3, 2, 1, 8), 8, 0, 4, (3, 2, 8, 8, 1)),                    # the row one float off
    ((3, 2, 1, 8), 8, 8, 0, (3, 2, 8, 8, 1)),                    # the spectra one point off
    ((3, 2, 1, 8), 10, 0, 0, (3, 2, 8, 10, 1))])                 # a stride off the vector
def test_detect_launch(shape, stride, x_addr, row_addr, want):
    """(chans, streams, nfft, row stride, vec) of the C entry: 16-byte
    vectors only where nfft, the stride and both addresses allow them."""
    assert dt.detect_launch(shape, stride, x_addr, row_addr) == want


@pytest.mark.parametrize("shape", [(3, 2, 1, 16), (3, 2, 2, 16), (2, 1, 3, 8), (4, 2, 1, 2)])
def test_plain_detect_adds_into_the_row_alone(shape):
    """The plain version adds the power into its integration's row, within
    1e-6 of each channel's largest bin of the float64 sum, and leaves the
    accumulator's other rows as they were."""
    chans, nfft = shape[0], shape[-1]
    x = _spectra(shape, seed=sum(shape))
    acc = torch.rand((chans, 3, nfft), generator=torch.Generator().manual_seed(1)) * 1e6
    before = acc.clone()
    want = _detect_model(x, acc[:, 1])
    dt.detect(x, acc[:, 1])
    assert _row_err(acc[:, 1], want) <= 1e-6
    assert torch.equal(acc[:, 0], before[:, 0]) and torch.equal(acc[:, 2], before[:, 2])


def test_cpu_spectra_take_the_plain_version():
    x, row = _spectra((2, 2, 1, 16), seed=4), torch.ones(2, 16)
    want = row.clone()
    dt.plain_detect(x, want)
    before = trace.launches["spec_detect"]
    dt.detect(x, row)
    assert trace.launches["spec_detect"] == before and torch.equal(row, want)


def test_power_add_launch_arguments(stand_in):
    """The kernel's wrapper hands the entry the spectra, the row in place and
    `detect_launch`'s sizes, and counts one launch."""
    x = _spectra((3, 2, 2, 16), seed=5)
    acc = torch.zeros(3, 4, 16)
    row = acc[:, 1]
    before = trace.launches["spec_detect"]
    dt.power_add(x, row)
    sizes = dt.detect_launch(x.shape, 64, x.data_ptr(), row.data_ptr())
    assert stand_in == [(x.data_ptr(), row.data_ptr(), *sizes, 0)]
    assert sizes[:4] == (3, 4, 16, 64)
    assert trace.launches["spec_detect"] == before + 1


def test_integrate_detects_each_chunk_into_its_row(stand_in, monkeypatch):
    """Two integrations of two chunks each: the detection's launches take
    each chunk's streams and the row of its integration, the accumulator's
    channel stride apart."""
    nfft, nint, chans = 1 << 15, 4, 2
    monkeypatch.setattr(spectrometer, "CHUNK_POINTS", 2 * 2 * 2 * nfft)  # 2 spectra a chunk
    spectrometer.integrate(_volts(chans, nfft * nint * 2), nfft, nint, device="cpu")
    assert [a[2:6] for a in stand_in] == [(chans, 4, nfft, 2 * nfft)] * 4
    rows = [a[1] - stand_in[0][1] for a in stand_in]
    assert rows == [0, 0, 4 * nfft, 4 * nfft]  # bytes into the accumulator


def test_power_add_refusals():
    x, row = _spectra((2, 2, 1, 8), seed=6), torch.zeros(2, 8)
    with pytest.raises(TypeError, match="complex64"):
        dt.power_add(x.to(torch.complex128), row)
    with pytest.raises(TypeError, match="float32 row"):
        dt.power_add(x, row.double())
    with pytest.raises(ValueError, match=r"\[chans, pols, per, nfft\]"):
        dt.power_add(x[0], row)
    with pytest.raises(ValueError, match="want \\[2, 8\\]"):
        dt.power_add(x, torch.zeros(2, 9))
    with pytest.raises(ValueError, match="bins contiguous"):
        dt.power_add(x, torch.zeros(2, 16)[:, ::2])
    with pytest.raises(ValueError, match="row on meta"):
        dt.power_add(x, torch.zeros(2, 8, device="meta"))


def test_detection_kernel_is_one_of_the_port_s():
    """The benchmark counts the detection as the port's kernel time, not as
    torch's (`torch_ops_pct.batch`), by the `__global__` names of the port's
    sources."""
    from fftbench import traces

    assert "spec_detect_kernel" in trace.kernel_names()
    assert "spec_detect_kernel" in traces.port_kernels()


# -- spans -----------------------------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch):
    """The four-step wrappers and the detection launch on CPU tensors into a
    library that does nothing and returns 0 (the outputs stay as allocated);
    its detection records its arguments, returned here."""
    calls = []

    def spec_detect(*args):
        calls.append(args)
        return 0
    lib = types.SimpleNamespace(watfft_strided_c2c=lambda *a: 0, watfft_spec_detect=spec_detect)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "use_kernel", lambda t, plain=False: not plain)
    return calls


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
    assert kids["spec.detect"] == ["launch.spec_detect"] * nint  # one a chunk, not the zeroing
    assert set(kids) == {"spectrometer.integrate", "api.forward", "spec.detect"}
    assert len({s.call for s in recorded}) == 1
    after = registry.launch_counts()
    assert after["large_stage1"] - launches["large_stage1"] == nint
    assert after["large_stage2"] - launches["large_stage2"] == nint
    assert after["spec_detect"] - launches["spec_detect"] == nint
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
    assert after["spec_detect"] - launches["spec_detect"] == 1
    assert _err(got, _card_model(volts, nfft, 1)) <= LIMIT


# each case: the spectra's shape, the accumulator's integrations, the row's
# integration, the row one float off its 16 bytes, the vector width
DETECT_CASES = {
    "cell": ((64, 2, 1, 1 << 20), 2, 1, False, 4),        # [64, 2, 2^20] into acc[:, 1]
    "two_spectra": ((16, 2, 2, 1 << 16), 3, 2, False, 4),  # S = 4
    "odd_streams": ((5, 1, 3, 4096), 1, 0, False, 4),      # S = 3: the clamped load
    "scalar": ((7, 2, 1, 2), 2, 1, False, 1),              # nfft 2
    "smallest_vector": ((7, 2, 1, 8), 2, 0, False, 4),     # nfft 8
    "unaligned": ((4, 2, 1, 1024), 2, 1, True, 1),         # the row one float off
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_power_add_matches_plain_on_the_card(case, dev):
    """The kernel against the plain version on the same spectra and row:
    each channel within 1e-6 of its largest bin, the accumulator's other
    bins untouched, one launch, two runs the same bits."""
    shape, nout, j, off, vec = DETECT_CASES[case]
    chans, nfft = shape[0], shape[-1]
    x = _spectra(shape, seed=sum(shape), device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    acc = torch.rand((chans, nout, nfft + 4 * off), generator=g, device=dev) * 1e6
    row = acc[:, j, off:off + nfft]
    assert dt.detect_launch(shape, row.stride(0), x.data_ptr(), row.data_ptr())[-1] == vec
    want = acc.clone()
    dt.plain_detect(x, want[:, j, off:off + nfft])
    again = acc.clone()
    before = trace.launches["spec_detect"]
    dt.power_add(x, row)
    torch.cuda.synchronize()
    assert trace.launches["spec_detect"] == before + 1
    assert _row_err(row, want[:, j, off:off + nfft]) <= 1e-6
    rest = torch.ones_like(acc, dtype=torch.bool)
    rest[:, j, off:off + nfft] = False
    assert torch.equal(acc[rest], want[rest])
    dt.power_add(x, again[:, j, off:off + nfft])
    assert torch.equal(again, acc)


@pytest.mark.cuda
def test_power_add_refuses_on_the_card(dev):
    x, row = _spectra((2, 2, 1, 8), seed=8, device=dev), torch.zeros(2, 8, device=dev)
    with pytest.raises(TypeError, match="complex64"):
        dt.power_add(x.to(torch.complex128), row)
    with pytest.raises(TypeError, match="float32 row"):
        dt.power_add(x, row.double())
    with pytest.raises(ValueError, match=r"\[chans, pols, per, nfft\]"):
        dt.power_add(x[:, 0], row)
    with pytest.raises(ValueError, match="want"):
        dt.power_add(x, torch.zeros(3, 8, device=dev))
    with pytest.raises(ValueError, match="row on cpu"):
        dt.power_add(x, torch.zeros(2, 8))
