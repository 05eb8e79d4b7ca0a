"""The w-stacking imager (`watfft_tpu_torch.imaging.wstack_invert`) against
the plain float64 inversion (`fftbench/reference/wstack.py`) on seeded
grids: on the cube route (N = 64) and on the two-pass route the benchmark's
cell runs (N = 512, over `planner.CUBE_MAX_N`), in chunks; the screen alone
at ~80 turns against float64, and the float32 forms it must not take; n -
1 near the centre; the shift folding against numpy's fftshift and
ifftshift; the accumulation's plain version against a straight float64
sum; the refusals; no call of `torch.fft`; the span tree, the launch and
the `wstack.layers` counter through a stand-in for the kernels' library.
No JAX is needed. The tests marked cuda run the kernel on the card against
its plain version on the same planes, and the imager against the
reference there:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_imaging.py
"""

import contextlib
import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fftbench.reference import wstack as ref
from watfft_tpu_torch import imaging, planner, registry, trace
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import wstack as ws

# max |image - reference| / max |reference|: the port's f32 transforms and
# float32 sums of L terms (readings 1e-7 .. 3e-7 here); a plane rounded to
# bfloat16 reads ~2e-3
LIMIT = 1e-6
ARCSEC = math.pi / (180 * 3600)
# the cell's field: 4096 pixels of 20 arcsec; at N pixels the same field
# takes pixels 4096 / N times as wide
FIELD = 4096 * 20 * ARCSEC
# |x - float64| of the screen's cosine and sine at ~80 turns: the float32
# argument's rounding (3e-8 turns) and the float32 result; a float32 n - 1
# or product loses ~5e-6 turns, ~3e-5 of the value
SCREEN_LIMIT = 2e-6


def _grids(layers, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((layers, n, n, 2), generator=g) * 2 - 1
    return torch.view_as_complex(u)


def _case(layers, n, seed=0):
    """Grids, w over [-2000, 2000] wavelengths, the cell's field and a
    taper falling to 0.5 at the edge."""
    w = torch.linspace(-2000.0, 2000.0, layers, dtype=torch.float64)
    taper = (1 - 2 * ((torch.arange(n) - n // 2) / n) ** 2).float()
    return _grids(layers, n, seed), w, FIELD / n, taper


# -- against the reference --------------------------------------------------------------

@pytest.mark.parametrize("layers,n,route", [(3, 64, "fft2-cube"), (2, 512, "fft2-2pass")])
def test_matches_the_reference(layers, n, route):
    assert planner.fft2_kernel(n, n, layers, "complex") == route
    grids, w, ps, taper = _case(layers, n, seed=n)
    got = imaging.wstack_invert(grids, w, ps, taper, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n, n)
    assert ref.image_err(got, grids, w, ps, taper) <= LIMIT


@pytest.mark.parametrize("per", [1, 2, 4])
def test_chunks_sum_to_the_reference(per, monkeypatch):
    """Five layers in chunks of `per` planes: the first chunk starts the
    image, the last scales it."""
    layers, n = 5, 32
    monkeypatch.setattr(imaging, "CHUNK_POINTS", per * n * n)
    assert imaging.planes_per_chunk(layers, n) == per
    grids, w, ps, taper = _case(layers, n, seed=per)
    got = imaging.wstack_invert(grids, w, ps, taper, device="cpu")
    assert ref.image_err(got, grids, w, ps, taper) <= LIMIT


def test_planes_per_chunk():
    assert imaging.planes_per_chunk(128, 4096) == 8  # the cell's chunk: 2^27 points
    assert imaging.planes_per_chunk(2, 512) == 2
    assert imaging.planes_per_chunk(3, 1 << 14) == 1  # a plane past CHUNK_POINTS


def test_a_wide_field_is_not_a_flat_one():
    """At the cell's field the w-term moves every pixel but the centre: the
    image of w = 0 planes differs from the screened one by far more than
    the limit."""
    grids, w, ps, taper = _case(3, 64, seed=5)
    flat = imaging.wstack_invert(grids, torch.zeros_like(w), ps, taper, device="cpu")
    assert ref.image_err(flat, grids, w, ps, taper) > 1e3 * LIMIT


def test_numpy_inputs():
    grids, w, ps, taper = _case(2, 16)
    a = imaging.wstack_invert(grids, w, ps, taper, device="cpu")
    b = imaging.wstack_invert(grids.numpy(), w.numpy(), ps, taper.numpy(), device="cpu")
    assert torch.equal(a, b)


def test_outside_the_unit_circle_is_zero():
    """Pixels past l^2 + m^2 = 1 are 0: a field wider than the sky."""
    n = 16
    grids, w, _, taper = _case(2, n)
    ps = 1.5 / (n / 2)
    got = imaging.wstack_invert(grids, w, ps, taper, device="cpu")
    lm = (torch.arange(n, dtype=torch.float64) - n // 2) * ps
    outside = lm[:, None] ** 2 + lm[None, :] ** 2 >= 1
    assert outside.any() and (~outside).any()
    assert torch.all(got[outside] == 0) and torch.all(got[~outside] != 0)
    assert ref.image_err(got, grids, w, ps, taper) <= LIMIT


# -- the screen and n - 1 ----------------------------------------------------------------

def _screen_err(c, s, w, nm1):
    phase = 2 * math.pi * w * nm1
    return max((c.double() - torch.cos(phase)).abs().max().item(),
               (s.double() - torch.sin(phase)).abs().max().item())


def _f32_product(w, nm1):
    """A fault: the screen with the product w (n - 1) rounded to float32."""
    p = (nm1 * w).float().double()
    a = (2.0 * (p - torch.round(p))).float().double() * math.pi
    return torch.cos(a).float(), torch.sin(a).float()


@pytest.mark.parametrize("w", [2000.0, -2000.0, 1234.5678])
def test_screen_at_80_turns(w):
    nm1 = ws.n_minus_1(512, FIELD / 512)
    assert abs(w * nm1.min().item()) >= 0.6 * 80  # the corners: ~80 turns at |w| = 2000
    assert _screen_err(*ws.screen(w, nm1), w, nm1) <= SCREEN_LIMIT


@pytest.mark.parametrize("fault", ["n_minus_1_in_float32", "product_in_float32"])
def test_screen_in_float32_fails_the_limit(fault):
    """The planted faults: either factor in float32 loses ~5e-6 turns at 80
    turns, ~3e-5 of the value, past SCREEN_LIMIT."""
    w, nm1 = 2000.0, ws.n_minus_1(512, FIELD / 512)
    if fault == "n_minus_1_in_float32":
        c, s = ws.screen(w, nm1.float())
    else:
        c, s = _f32_product(w, nm1)
    assert _screen_err(c, s, w, nm1) > 5 * SCREEN_LIMIT


def test_n_minus_1_does_not_cancel_near_the_centre():
    """Next to the centre n - 1 ~ -r^2 / 2 - r^4 / 8; the stable form keeps
    it to float64's rounding where sqrt(1 - r^2) - 1 keeps no digit."""
    n, ps = 64, 1e-9
    nm1 = ws.n_minus_1(n, ps)
    lm = (torch.arange(n, dtype=torch.float64) - n // 2) * ps
    r2 = lm[:, None] ** 2 + lm[None, :] ** 2
    series = -r2 / 2 - r2 ** 2 / 8
    mask = r2 > 0
    assert ((nm1 - series)[mask] / series[mask]).abs().max() <= 1e-15
    naive = torch.sqrt(1 - r2) - 1
    assert ((naive - series)[mask] / series[mask]).abs().max() >= 0.1
    assert nm1[n // 2, n // 2] == 0


# -- the shift folding and the plain version ----------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8, 64])
def test_fold_is_fftshift_of_ifft2_of_ifftshift(n):
    g = np.random.default_rng(n)
    grid = g.uniform(-1, 1, (3, n, n)) + 1j * g.uniform(-1, 1, (3, n, n))
    want = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(grid, axes=(-2, -1))), axes=(-2, -1))
    got = ws.fold(torch.fft.ifft2(torch.from_numpy(grid))).numpy()
    assert np.abs(got - want).max() <= 1e-15 * n


def _straight(planes, w, ps, taper):
    """The accumulation written out: float64, numpy's fftshift and the sign
    (-1)^(x + y), the screen by exp, n / taper^2."""
    n = planes.shape[-1]
    lm = (np.arange(n) - n // 2) * ps
    r2 = lm[:, None] ** 2 + lm[None, :] ** 2
    root = np.sqrt(1 - r2)
    idx = np.arange(n)
    sign = (-1.0) ** (idx[:, None] + idx[None, :])
    p = planes.numpy().astype(np.complex128)
    acc = sum((np.exp(2j * np.pi * wk * (root - 1)) * sign * np.fft.fftshift(pk)).real
              for wk, pk in zip(w.numpy(), p))
    t = taper.numpy().astype(np.float64)
    return acc * root / (t[:, None] * t[None, :])


@pytest.mark.parametrize("chunks", [[4], [1, 3], [2, 1, 1]])
def test_plain_accum_against_a_straight_sum(chunks):
    """The plain version over chunks of the planes (the first starts the
    image, the last scales it) against the straight float64 sum, within
    float32's rounding of L terms."""
    layers, n = sum(chunks), 32
    planes, w, ps, taper = _case(layers, n, seed=len(chunks))
    planes = planes * 1e-3
    want = _straight(planes, w, ps, taper)
    image = torch.full((n, n), float("nan"))
    k = 0
    for i, size in enumerate(chunks):
        ws.plain_accum(planes[k:k + size], image, w[k:k + size], ps, taper, i == 0,
                       i == len(chunks) - 1)
        k += size
    assert np.abs(image.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_accumulate_takes_the_plain_version_on_the_host():
    planes, w, ps, taper = _case(2, 16)
    a, b = torch.empty(16, 16), torch.empty(16, 16)
    ws.accumulate(planes, a, w, ps, taper, True, True)
    ws.plain_accum(planes, b, w, ps, taper, True, True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,planes_off,image_off,vec", [
    (4096, 0, 0, 4), (8, 0, 0, 4), (4, 0, 0, 1), (2, 0, 0, 1), (64, 8, 0, 1), (64, 0, 4, 1),
    (64, 32, 16, 4)])
def test_accum_launch_vector_width(n, planes_off, image_off, vec):
    """Four pixels a thread where N / 2 is a multiple of 4 (a thread's pixels
    stay together after the shift) and both addresses are 16-byte aligned."""
    assert ws.accum_launch(n, 1 << 20 | planes_off, 1 << 21 | image_off) == vec


# -- refusals -------------------------------------------------------------------------------

def _bad(**change):
    grids, w, ps, taper = _case(2, 8)
    args = {"grids": grids, "w": w, "pixel_scale": ps, "taper": taper}
    args.update(change)
    return args


REFUSED = {
    "grids_complex128": (TypeError, "grids must be complex64",
                         {"grids": _grids(2, 8).to(torch.complex128)}),
    "grids_real": (TypeError, "grids must be complex64", {"grids": torch.zeros(2, 8, 8)}),
    "w_float32": (TypeError, "w must be float64", {"w": torch.zeros(2)}),
    "taper_float64": (TypeError, "taper must be float32",
                      {"taper": torch.ones(8, dtype=torch.float64)}),
    "grids_2d": (ValueError, r"\[L, N, N\]", {"grids": _grids(1, 8)[0]}),
    "grids_not_square": (ValueError, r"\[L, N, N\]", {"grids": _grids(2, 8)[:, :4]}),
    "no_layers": (ValueError, r"L >= 1", {"grids": _grids(2, 8)[:0], "w": torch.zeros(0,
                                                                          dtype=torch.float64)}),
    "n_not_power_of_two": (ValueError, "power of two", {"grids": _grids(2, 6)[:, :6, :6],
                                                        "taper": torch.ones(6)}),
    "w_length": (ValueError, r"w must be \[L\]", {"w": torch.zeros(3, dtype=torch.float64)}),
    "taper_length": (ValueError, r"taper must be \[N\]", {"taper": torch.ones(4)}),
    "pixel_scale_zero": (ValueError, "pixel_scale", {"pixel_scale": 0.0}),
    "pixel_scale_nan": (ValueError, "pixel_scale", {"pixel_scale": float("nan")}),
    "pixel_scale_tensor": (ValueError, "pixel_scale", {"pixel_scale": torch.tensor(1e-4)}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(case):
    exc, match, change = REFUSED[case]
    with pytest.raises(exc, match=match):
        imaging.wstack_invert(**_bad(**change), device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imaging.wstack_invert(**_bad())


@pytest.mark.parametrize("change,exc", [
    ({"planes": _grids(2, 8).to(torch.complex128)}, TypeError),
    ({"image": torch.zeros(8, 8, dtype=torch.float64)}, TypeError),
    ({"w": torch.zeros(2)}, TypeError),
    ({"image": torch.zeros(8, 4)}, ValueError),
    ({"w": torch.zeros(3, dtype=torch.float64)}, ValueError),
    ({"planes": _grids(2, 8)[:, :4]}, ValueError),
    ({"image": torch.zeros(8, 16)[:, :8]}, ValueError),
    ({"image": torch.zeros(8, 8, device="meta")}, ValueError),
])
def test_kernel_wrapper_refusals(change, exc):
    """The kernel's own checks, before any launch (on CPU tensors here)."""
    planes, w, ps, taper = _case(2, 8)
    args = {"planes": planes, "image": torch.zeros(8, 8), "w": w, "taper": taper}
    args.update(change)
    with pytest.raises(exc):
        ws.accum_kernel(args["planes"], args["image"], args["w"], ps, args["taper"], True, True)


def test_no_torch_fft(monkeypatch):
    """The transforms are the port's own: torch.fft is never called."""
    def refuse(*a, **k):
        raise AssertionError("torch.fft called")
    for name in ("fft", "ifft", "fft2", "ifft2", "fftn", "ifftn"):
        monkeypatch.setattr(torch.fft, name, refuse)
    grids, w, ps, taper = _case(2, 512)
    assert imaging.wstack_invert(grids, w, ps, taper, device="cpu").shape == (512, 512)


# -- spans, launches and the counter --------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch):
    """The 2D passes and the accumulation launch on CPU tensors into a
    library that does nothing and returns 0 (the outputs stay as allocated);
    its accumulation records its arguments, returned here."""
    calls = []

    def wstack_accum(*args):
        calls.append(args)
        return 0
    lib = types.SimpleNamespace(watfft_strided_c2c=lambda *a: 0,
                                watfft_stockham_c2c=lambda *a: 0,
                                watfft_wstack_accum=wstack_accum)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "use_kernel", lambda t, plain=False: not plain)
    return calls


def test_span_tree_launches_and_counter(stand_in, monkeypatch):
    """Three chunks of two planes at N = 256 (the two-pass route): one
    `api.ifft2` and one launch a chunk, the last in `wstack.finalise`."""
    layers, n = 6, 256
    monkeypatch.setattr(imaging, "CHUNK_POINTS", 2 * n * n)
    grids, w, ps, taper = _case(layers, n)
    launches = registry.launch_counts()
    summed = trace.counts["wstack.layers"]
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        imaging.wstack_invert(grids, w, ps, taper, device="cpu")
    recorded = trace.spans()
    trace.clear()
    by_id = {s.id: s for s in recorded}
    kids = {}
    for s in recorded:
        if s.parent:
            kids.setdefault(by_id[s.parent].name, []).append(s.name)
    assert [s.name for s in recorded if s.parent == 0] == ["imaging.wstack"]
    assert kids["imaging.wstack"] == (["api.ifft2", "wstack.accum"] * 2
                                      + ["api.ifft2", "wstack.finalise"])
    assert kids["wstack.accum"] == ["launch.wstack_accum"] * 2  # one a chunk
    assert kids["wstack.finalise"] == ["launch.wstack_accum"]
    assert kids["api.ifft2"] == ["launch.fft2_cols", "launch.stockham_c2c"] * 3
    assert len({s.call for s in recorded}) == 1
    after = registry.launch_counts()
    assert after["wstack_accum"] - launches["wstack_accum"] == 3
    assert after["fft2_cols"] - launches["fft2_cols"] == 3
    assert after["fft2_rows"] - launches["fft2_rows"] == 3
    assert trace.counts["wstack.layers"] - summed == layers
    # each launch's chunk, first and last flags, and the cell's vector width
    assert [(a[4], a[5], a[7], a[8]) for a in stand_in] == [(2, n, 1, 0), (2, n, 0, 0),
                                                            (2, n, 0, 1)]
    assert all(a[6] == ps and a[9] in (1, 4) for a in stand_in)


def test_no_profiler_records_no_span(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was opened with no profiler session")
    monkeypatch.setattr(trace, "begin", refuse)
    monkeypatch.setattr(trace, "call", refuse)
    trace.clear()
    imaging.wstack_invert(*_case(2, 16), device="cpu")
    assert len(trace._buffer) == 0


def test_accumulation_kernel_is_one_of_the_port_s():
    """The benchmark counts the kernel as the port's time (`torch_ops_pct.
    batch`), by the `__global__` names of the port's sources."""
    from fftbench import traces

    assert "wstack_accum_kernel" in trace.kernel_names()
    assert "wstack_accum_kernel" in traces.port_kernels()


# -- on the card ------------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _off_by(got, want, planes, image, ps, taper, first, last):
    """max |got - want| over each pixel's magnitude M = scale (|image| +
    sum_k |re_k| + |im_k|), the folded planes' parts, scale = n / taper^2
    where last (else 1). The kernel's sincospif is within 1 ulp (2^-23 of a
    value under 1) of the plain version's float64 cosine and sine rounded
    to float32, and every other rounding is the same, so each term moves
    at most 2^-22 (|re| + |im|) and the sums a few ulps: 2^-21 M bounds it,
    where a share of the largest pixel does not (the terms cancel)."""
    folded = ws.fold(planes)
    mag = (folded.real.abs() + folded.imag.abs()).sum(0).double()
    if not first:
        mag = mag + image.abs()
    if last:
        n = image.shape[-1]
        lm = (torch.arange(n, dtype=torch.float64, device=image.device) - n // 2) * ps
        t = taper.double()
        mag = mag * (torch.sqrt(1 - lm[:, None] ** 2 - lm[None, :] ** 2)
                     / (t[:, None] * t[None, :]))
    return ((got.double() - want.double()).abs() / mag).max().item()


# each case: planes, N, the image one float off its 16 bytes, the vector width
ACCUM_CASES = {
    "cell_chunk": (8, 4096, False, 4),
    "odd_group": (5, 512, False, 4),    # a group of 4 planes and a tail of 1
    "smallest_vector": (3, 8, False, 4),
    "scalar": (2, 4, False, 1),
    "unaligned": (4, 64, True, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ACCUM_CASES))
@pytest.mark.parametrize("first,last", [(True, False), (False, False), (False, True)])
def test_accum_kernel_matches_plain_on_the_card(case, first, last, dev):
    """The kernel against the plain version on the same planes and image:
    within 2^-21 of each pixel's magnitude (`_off_by`), one launch, two runs
    the same bits."""
    layers, n, off, vec = ACCUM_CASES[case]
    planes, w, ps, taper = (t.to(dev) if torch.is_tensor(t) else t
                            for t in _case(layers, n, seed=n + layers))
    planes = planes * 1e-4
    g = torch.Generator(device=dev).manual_seed(n)
    store = torch.rand(n * n + off, generator=g, device=dev) * 1e-3
    image = store[off:].view(n, n)
    assert ws.accum_launch(n, planes.data_ptr(), image.data_ptr()) == vec
    start, want = image.clone(), image.clone()
    ws.plain_accum(planes, want, w, ps, taper, first, last)
    again = image.clone()
    before = trace.launches["wstack_accum"]
    ws.accum_kernel(planes, image, w, ps, taper, first, last)
    ws.accum_kernel(planes, again, w, ps, taper, first, last)
    torch.cuda.synchronize()
    assert trace.launches["wstack_accum"] == before + 2
    assert _off_by(image, want, planes, start, ps, taper, first, last) <= 2.0 ** -21
    assert torch.equal(image, again)


@pytest.mark.cuda
@pytest.mark.parametrize("on_host", [False, True])
def test_matches_the_reference_on_the_card(on_host, dev):
    """16 planes of 4096^2 at the cell's field: two chunks of 8 through the
    two-pass route and the kernel; grids on the host move to the card a
    chunk at a time."""
    layers, n = 16, 4096
    grids, w, ps, taper = _case(layers, n)
    w, taper = w.to(dev), taper.to(dev)
    imaging.wstack_invert(grids[:1].to(dev), w[:1], ps, taper)  # the tables built
    launches, copies = registry.launch_counts(), trace.counts["h2d_copies"]
    clusters = trace.counts["strided.cluster_tile"]
    got = imaging.wstack_invert(grids if on_host else grids.to(dev), w, ps, taper)
    after = registry.launch_counts()
    assert got.device.type == "cuda"
    assert trace.counts["h2d_copies"] - copies == (2 if on_host else 0)
    assert after["wstack_accum"] - launches["wstack_accum"] == 2
    assert after["fft2_cols"] - launches["fft2_cols"] == 2
    assert trace.counts["strided.cluster_tile"] - clusters == 2  # each column pass
    assert ref.image_err(got, grids.to(dev), w, ps, taper) <= LIMIT


@pytest.mark.cuda
def test_a_request_takes_the_cluster_tile_a_chunk(dev):
    """A request of the wstack_n4096.batch cell's size, 128 layers of
    4096^2 made on the card: 16 chunks of 8 planes, each chunk's column
    pass one launch on the cluster tile (`strided.cluster_tile` 16)."""
    layers, n = 128, 4096
    g = torch.Generator(device=dev).manual_seed(128)
    grids = torch.randn((layers, n, n), generator=g, device=dev, dtype=torch.complex64)
    w = torch.linspace(-2000.0, 2000.0, layers, dtype=torch.float64, device=dev)
    taper = (1 - 2 * ((torch.arange(n, device=dev) - n // 2) / n) ** 2).float()
    launches, clusters = registry.launch_counts(), trace.counts["strided.cluster_tile"]
    image = imaging.wstack_invert(grids, w, FIELD / n, taper)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(image).all())
    assert registry.launch_counts()["fft2_cols"] - launches["fft2_cols"] == 16
    assert trace.counts["strided.cluster_tile"] - clusters == 16
