"""The inverse STFT's overlap-add (`watfft_tpu_torch/ops/ola.py`,
`csrc/ola.cu`): the launch helper and the covering frames against a numpy
model, the plain version against a sequential float32 model, which path
`stft.istft` takes and the kernel's backward (through a stand-in library on
the CPU), and, on the card, the kernel and its gradient against the plain
version on the same c2r frames.

Imports no JAX. The tests marked `cuda` skip without a card; run them there
with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_ola.py
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from watfft_tpu_torch import registry, stft, trace
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import ola

# max |kernel - plain| / max |plain| where the window power is not small, and
# of the same products by the window power everywhere: the plain version on
# the card adds with atomics in any order
KERNEL_LIMIT = 1e-6

N_FFTS = [64, 1024, 4096]
HOPS = ["quarter", 250, "gap"]  # n_fft / 4; not a multiple of 4; n_fft + n_fft / 2
LENGTHS = ["below", "equal", "above", None]


def _hop(n_fft: int, hop) -> int:
    return {"quarter": n_fft // 4, "gap": n_fft + n_fft // 2}.get(hop, hop)


def _length(t: int, length):
    return {"below": t - 37, "equal": t, "above": t + 100}.get(length, length)


def _covering(s: int, n_fft: int, hop: int, num: int) -> list:
    """The frames j < num with 0 <= s - j * hop < n_fft, by search."""
    return [j for j in range(num) if 0 <= s - j * hop < n_fft]


def _sequential(frames: np.ndarray, w: np.ndarray, hop: int) -> np.ndarray:
    """The overlap-add in float32 as the kernel takes it: the rounded
    products added from 0 in ascending j, the sum of the rounded squares of
    w likewise, an IEEE division by it clamped at 1e-8."""
    num, n_fft = frames.shape[-2:]
    t = (num - 1) * hop + n_fft
    acc = np.zeros(frames.shape[:-2] + (t,), np.float32)
    norm = np.zeros(t, np.float32)
    for j in range(num):
        acc[..., j * hop:j * hop + n_fft] += frames[..., j, :] * w
        norm[j * hop:j * hop + n_fft] += w * w
    return acc / np.maximum(norm, np.float32(1e-8))


# -- the launch helper and the covering frames -----------------------------------------

@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("n_fft", N_FFTS)
def test_launch_covers_each_sample_once(n_fft, hop, length):
    hop, num = _hop(n_fft, hop), 7
    t = (num - 1) * hop + n_fft
    want = ola._length(t, _length(t, length))
    assert want == len(np.arange(t)[:_length(t, length)])
    vec, row = ola.ola_launch(want, hop)
    assert vec == (4 if hop % 4 == 0 else 1)
    assert want <= row <= t and row - want < vec and row % vec == 0
    # a thread's vector starts at s0, a multiple of vec, and takes s0 ..
    # s0 + vec - 1: each of the row's samples once; it sums the frames jlo
    # .. jhi (csrc/ola.cu), the covering frames of each of its samples
    starts = np.arange(0, row, vec)
    samples = (starts[:, None] + np.arange(vec)[None, :]).reshape(-1)
    assert np.array_equal(samples, np.arange(row))
    for s0 in starts:
        jhi = min(num - 1, s0 // hop)
        jlo = 0 if s0 < n_fft else (s0 - n_fft) // hop + 1
        for s in range(s0, s0 + vec):
            assert _covering(s, n_fft, hop, num) == list(range(jlo, jhi + 1))


# -- the plain version -------------------------------------------------------------

@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("n_fft", [64, 1024])
def test_plain_ola_equals_the_sequential_model(n_fft, hop):
    hop = _hop(n_fft, hop)
    rng = np.random.default_rng(n_fft + hop)
    frames = rng.uniform(-1, 1, (2, 3, 6, n_fft)).astype(np.float32)
    w = stft.get_window("hann", n_fft)
    got = ola.plain_ola(torch.from_numpy(frames), torch.from_numpy(w), hop)
    want = _sequential(frames, w, hop)
    assert np.array_equal(got.numpy(), want)
    t = want.shape[-1]
    assert torch.equal(ola.plain_ola(torch.from_numpy(frames), torch.from_numpy(w), hop, t - 5),
                       got[..., :t - 5])


def test_istft_ola_refuses_what_it_does_not_take():
    frames, w = torch.zeros(2, 4, 64), torch.zeros(64)
    with pytest.raises(TypeError, match="float32"):
        ola.istft_ola(frames.double(), w, 16)
    with pytest.raises(ValueError, match="window"):
        ola.istft_ola(frames, torch.zeros(32), 16)
    with pytest.raises(ValueError, match="window as a constant"):
        ola.istft_ola(frames, w.requires_grad_(), 16)


# -- which path istft takes ------------------------------------------------------------

N_FFT, HOP, T = 64, 16, 400


def _f32(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, shape)
                            .astype(np.float32))


@pytest.fixture
def stand_in(monkeypatch):
    """The wrappers launch on CPU tensors into a library whose overlap-add
    records its arguments; every entry returns 0 and writes nothing."""
    calls = []

    def istft_ola(*args):
        calls.append(args)
        return 0
    lib = types.SimpleNamespace(watfft_istft_ola=istft_ola, watfft_rfft_r2c=lambda *a: 0,
                                watfft_irfft_c2r=lambda *a: 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "use_kernel", lambda t, plain=False: not plain)
    return calls


def _istft_tree(sre, sim, length):
    """The spans of one traced istft: {name: [children]} and the roots."""
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = stft.istft(sre, sim, N_FFT, HOP, length=length, device="cpu")
        recorded = trace.spans()
    finally:
        trace.clear()
    by_id = {s.id: s for s in recorded}
    kids = {}
    for s in recorded:
        if s.parent:
            kids.setdefault(by_id[s.parent].name, []).append(s.name)
    return out, kids, [s.name for s in recorded if s.parent == 0]


PLAIN = ["istft.window", "api.inverse_planes", "istft.frame_window", "istft.overlap_add",
         "istft.norm", "istft.divide"]


def test_cpu_frames_take_the_plain_version():
    re, im = stft.stft(_f32((2, T)), N_FFT, HOP, device="cpu")
    before = registry.launch_counts()["istft_ola"]
    out, kids, roots = _istft_tree(re, im, T)
    assert roots == ["stft.istft"] and kids["stft.istft"] == PLAIN
    assert registry.launch_counts()["istft_ola"] == before
    assert out.shape == (2, T)


@pytest.mark.parametrize("length", [T - 3, None])
def test_frames_without_grad_take_the_kernel(stand_in, length):
    re, im = stft.stft(_f32((2, 3, T)), N_FFT, HOP, device="cpu")
    before = trace.launches["istft_ola"]
    out, kids, roots = _istft_tree(re, im, length)
    assert roots == ["stft.istft"]
    assert kids["stft.istft"] == ["istft.window", "api.inverse_planes", "launch.istft_ola"]
    assert trace.launches["istft_ola"] == before + 1
    num = re.shape[-2]
    t = (num - 1) * HOP + N_FFT
    want = t if length is None else length
    (fp, wp, op, clips, n, n_fft, hop, row, vec, stream), = stand_in
    assert (clips, n, n_fft, hop, stream) == (6, num, N_FFT, HOP, 0)
    assert ola.ola_launch(want, HOP) == (vec, row)
    assert out.shape == (2, 3, want) and out.data_ptr() == op


def test_frames_that_require_grad_take_the_plain_version():
    re, im = stft.stft(_f32((2, T)), N_FFT, HOP, device="cpu")
    before = trace.launches["istft_ola"]
    sre = re.clone().requires_grad_()
    out, kids, _ = _istft_tree(sre, im, T)  # CPU frames: the plain version
    assert kids["stft.istft"] == PLAIN
    assert trace.launches["istft_ola"] == before
    out.sum().backward()
    assert sre.grad is not None and sre.grad.shape == re.shape


def test_cuda_frames_that_require_grad_take_the_kernel(stand_in):
    re, im = stft.stft(_f32((2, T)), N_FFT, HOP, device="cpu")
    before = trace.launches["istft_ola"]
    sre = re.clone().requires_grad_()
    out, kids, _ = _istft_tree(sre, im, T)
    assert kids["stft.istft"] == ["istft.window", "api.inverse_planes", "launch.istft_ola"]
    assert len(stand_in) == 1 and trace.launches["istft_ola"] == before + 1
    out.sum().backward()
    assert sre.grad is not None and sre.grad.shape == re.shape


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("hop", HOPS)
def test_kernel_backward_equals_the_plain_gradient(stand_in, hop, length):
    """The kernel's backward (torch ops, the overlap-add's adjoint) against
    autograd through the plain version, on the same frames and output
    gradient; the stand-in library leaves the forward's output unwritten,
    which the backward does not read."""
    hop, num = _hop(N_FFT, hop), 6
    t = (num - 1) * hop + N_FFT
    L = _length(t, length)
    frames = _f32((2, 3, num, N_FFT), seed=hop).requires_grad_()
    w = torch.from_numpy(stft.get_window("hann", N_FFT))
    out = ola.istft_ola(frames, w, hop, L)
    g = _f32(out.shape, seed=hop + 1)
    got, = torch.autograd.grad(out, frames, g)
    want, = torch.autograd.grad(ola.plain_ola(frames, w, hop, L), frames, g)
    assert len(stand_in) == 1 and got.shape == frames.shape
    assert torch.equal(got, want)


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _card_frames(n_fft, hop, num, batch, dev, seed):
    """c2r frames [*batch, num, n_fft] of random spectra, on the card."""
    rng = np.random.default_rng(seed)
    shape = tuple(batch) + (num, n_fft // 2 + 1)
    re = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev)
    im = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev)
    return stft._ctx(n_fft, dev).inverse_planes(re, im)


def _power(n_fft, hop, num, length):
    """The overlap-added squared window in float64, over the output."""
    w2 = stft.get_window("hann", n_fft, np.float64) ** 2
    t = (num - 1) * hop + n_fft
    p = np.zeros(t)
    for j in range(num):
        p[j * hop:j * hop + n_fft] += w2
    return torch.from_numpy(p[:length])


def rel_err(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def _held(got, want, power):
    """(err where the window power is >= 1e-2 of its largest, err of the
    products by the power everywhere), each of the largest |want| or product."""
    got, want, power = got.double().cpu(), want.double().cpu(), power
    well = power >= 1e-2 * power.max()
    err = ((got - want)[..., well].abs().max() / want.abs().max()).item()
    gp, wp = got * power, want * power
    return err, ((gp - wp).abs().max() / wp.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("length", LENGTHS[:3])
@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("n_fft", N_FFTS + [16384])
def test_kernel_matches_plain_on_the_card(n_fft, hop, length, dev):
    hop = _hop(n_fft, hop)
    for batch, num in (((2, 3), 9), ((), 1)):
        frames = _card_frames(n_fft, hop, num, batch, dev, seed=n_fft + hop + num)
        t = (num - 1) * hop + n_fft
        L = _length(t, length)
        w = torch.as_tensor(stft.get_window("hann", n_fft), device=dev)
        before = trace.launches["istft_ola"]
        got = ola.istft_ola(frames, w, hop, L)
        again = ola.istft_ola(frames, w, hop, L)
        assert trace.launches["istft_ola"] == before + 2
        want = ola.plain_ola(frames, w, hop, L)
        assert got.shape == want.shape == tuple(batch) + (min(L, t),)
        assert torch.equal(got, again)  # no atomics: the same bits
        err, err_power = _held(got, want, _power(n_fft, hop, num, L))
        assert err <= KERNEL_LIMIT and err_power <= KERNEL_LIMIT
        # the plain version on the CPU adds in the kernel's order
        assert torch.equal(got.cpu(), ola.plain_ola(frames.cpu(), w.cpu(), hop, L))
        if hop > n_fft:  # the gaps: window power 0, output 0
            gap = _power(n_fft, hop, num, L) == 0
            assert gap.any() and not got.cpu()[..., gap].any()


@pytest.mark.cuda
@pytest.mark.parametrize("length", LENGTHS[:3])
@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("n_fft", [64, 1024])
def test_kernel_gradient_matches_plain_on_the_card(n_fft, hop, length, dev):
    hop, num = _hop(n_fft, hop), 9
    t = (num - 1) * hop + n_fft
    L = _length(t, length)
    frames = _card_frames(n_fft, hop, num, (2, 3), dev, seed=n_fft + hop).requires_grad_()
    w = torch.as_tensor(stft.get_window("hann", n_fft), device=dev)
    before = trace.launches["istft_ola"]
    out = ola.istft_ola(frames, w, hop, L)
    assert trace.launches["istft_ola"] == before + 1
    g = _f32(out.shape, seed=n_fft + hop).to(dev)
    got, = torch.autograd.grad(out, frames, g)
    want, = torch.autograd.grad(ola.plain_ola(frames, w, hop, L), frames, g)
    assert got.shape == want.shape == frames.shape
    assert rel_err(got, want) <= KERNEL_LIMIT


@pytest.mark.cuda
def test_istft_on_the_card_launches_once_in_its_span(dev):
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (2, 4096))
                         .astype(np.float32)).to(dev)
    re, im = stft.stft(x, n_fft=256, hop=64)
    before = registry.launch_counts()
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            back = stft.istft(re, im, n_fft=256, hop=64, length=4096)
        recorded = trace.spans()
    finally:
        trace.clear()
    after = registry.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "irfft_c2r_fused": 1, "istft_ola": 1}
    by_id = {s.id: s for s in recorded}
    kids = [s.name for s in recorded if s.parent and by_id[s.parent].name == "stft.istft"]
    assert kids == ["istft.window", "api.inverse_planes", "launch.istft_ola"]
    assert (back[..., 256:-256] - x[..., 256:-256]).abs().max().item() < 1e-5
