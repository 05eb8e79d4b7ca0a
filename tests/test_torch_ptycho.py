"""Difference-map ptychography (`watfft_tpu_torch.ptycho.dm_iterate`)
against the plain float64 iteration (`fftbench/reference/ptycho.py`) on
seeded states: a raster and a jittered scan at M = 16 and 32, in one chunk
and in several; the in-place form against the out-of-place one; planted
faults that the limits must catch; each pass's plain version against a
straight float64 loop; the refusals; no call of `torch.fft`; the span tree,
the launches and the `ptycho.frames` counter through a stand-in for the
kernels' library. No JAX is needed. The tests marked cuda run each kernel
on the card against its plain version at the benchmark cell's chunk
[1024, 128, 128], and the iteration against the reference there:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_ptycho.py
"""

import contextlib
import ctypes
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fftbench.reference import ptycho as ref
from watfft_tpu_torch import planner, ptycho, registry, trace
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import ptycho as op

# max |port - reference| over the reference's largest magnitude, for each
# output: the port's f32 transforms (~1e-7 of a frame's largest point) and
# f32 products and sums; the update psi + F^-1(Psi') - phi cancels to a few
# times that. Readings here 1e-7 .. 2e-6; with the transforms rounded to
# bfloat16 (the control) they read 3e-4 .. 3e-3.
LIMIT = 1e-5
# on the card at the cell's size: the cell's own limits (its frames' float32
# transforms at 128^2; calibrated on 15 seeds against a bfloat16 control)
CELL_LIMITS = json.loads((Path(__file__).resolve().parents[1] / "fftbench" / "configs"
                          / "ptycho_dm_n128.json").read_text())["limits"]


def _cplx(g, shape, scale=1.0):
    return torch.view_as_complex((torch.rand((*shape, 2), generator=g) * 2 - 1) * scale)


def _state(m=16, scan=(4, 4), step=4, jitter=0, seed=0):
    """A seeded state: a raster of scan positions `step` apart (each moved
    by up to `jitter` px), the model probe (a disc M/2 across, 4 turns of
    quadratic phase at its edge), the magnitudes of a random object's views
    in float64, the object 1 plus 10% and the exits its views plus 10%."""
    g = torch.Generator().manual_seed(seed)
    h = (scan[0] - 1) * step + m + 2 * jitter
    w = (scan[1] - 1) * step + m + 2 * jitter
    r = torch.arange(scan[0]).repeat_interleave(scan[1]) * step + jitter
    c = torch.arange(scan[1]).repeat(scan[0]) * step + jitter
    pos = torch.stack((r, c), 1)
    if jitter:
        pos = pos + torch.randint(-jitter, jitter + 1, pos.shape, generator=g)
    pos = pos.to(torch.int32)
    y = torch.arange(m, dtype=torch.float64) - m // 2
    r2 = (y[:, None] ** 2 + y[None, :] ** 2) / (m / 4) ** 2
    probe = torch.where(r2 <= 1, torch.polar(torch.ones_like(r2), 8 * math.pi * r2), 0)
    true = torch.polar(0.8 + 0.2 * torch.rand((h, w), generator=g, dtype=torch.float64),
                       math.pi * (torch.rand((h, w), generator=g, dtype=torch.float64) - 0.5))
    fmag = torch.fft.fft2(probe * ref.views(true, pos, m)).abs().float()
    probe = probe.to(torch.complex64)
    obj = (1 + _cplx(g, (h, w), 0.1)).to(torch.complex64)
    exits = probe * ref.views(obj, pos, m) + _cplx(g, (pos.shape[0], m, m), 0.1)
    return exits, obj, probe, fmag, pos


def _errors(got, state):
    return ref.errors(got, *state)


CASES = {"raster_16": dict(m=16, scan=(4, 4), step=4),
         "raster_32": dict(m=32, scan=(8, 8), step=8),
         "jittered_16": dict(m=16, scan=(8, 8), step=4, jitter=2)}


# -- against the reference --------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_reference(case):
    state = _state(**CASES[case], seed=len(case))
    m = state[0].shape[-1]
    assert planner.fft2_kernel(m, m, state[0].shape[0], "complex") == "fft2-cube"
    got = ptycho.dm_iterate(*state, device="cpu")
    assert [t.dtype for t in got] == [torch.complex64] * 3 + [torch.float32]
    assert got[0].shape == state[0].shape and got[1].shape == state[1].shape
    assert got[2].shape == (m, m) and got[3].shape == (state[0].shape[0],)
    errs = _errors(got, state)
    assert max(errs.values()) <= LIMIT, errs


@pytest.mark.parametrize("per", [1, 5, 16])
def test_chunks_match_the_reference(per, monkeypatch):
    """64 frames in chunks of `per`: each chunk's passes, then the object
    and the probe from all of them."""
    state = _state(m=16, scan=(8, 8), step=4, jitter=1, seed=per)
    monkeypatch.setattr(ptycho, "CHUNK_POINTS", per * 16 * 16)
    assert ptycho.frames_per_chunk(64, 16) == per
    errs = _errors(ptycho.dm_iterate(*state, device="cpu"), state)
    assert max(errs.values()) <= LIMIT, errs


def test_the_inertias_are_the_cell_s():
    """PtyPy's object_inertia and probe_inertia, as the cell states them."""
    config = json.loads((Path(__file__).resolve().parents[1] / "fftbench" / "configs"
                         / "ptycho_dm_n128.json").read_text())
    assert ptycho.OBJECT_INERTIA == config["object_inertia"] == 1e-4
    assert ptycho.PROBE_INERTIA == config["probe_inertia"] == 1e-9


def test_frames_per_chunk():
    assert ptycho.frames_per_chunk(16384, 128) == 1024  # the cell's chunk: 2^24 points
    assert ptycho.frames_per_chunk(10, 128) == 10
    assert ptycho.frames_per_chunk(100, 2) == 100


def test_in_place_is_the_out_of_place_result():
    state = _state(m=16, scan=(6, 6), step=4, seed=3)
    copies = [t.clone() for t in state]
    apart = ptycho.dm_iterate(*state, device="cpu")
    for t, c in zip(state, copies):  # the inputs as they were
        assert torch.equal(t, c)
    given = torch.full_like(state[0], float("nan"))
    into = ptycho.dm_iterate(*state, out=given, device="cpu")
    assert into[0] is given
    exits = state[0].clone()
    inplace = ptycho.dm_iterate(exits, *state[1:], out=exits, device="cpu")
    assert inplace[0] is exits
    for a, b, c in zip(apart, into, inplace):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(state[1], copies[1]) and torch.equal(state[2], copies[2])


def test_numpy_inputs():
    state = _state(m=8, scan=(3, 3), step=2)
    a = ptycho.dm_iterate(*state, device="cpu")
    b = ptycho.dm_iterate(*(t.numpy() for t in state), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_the_object_outside_the_views_is_kept():
    """Pixels no view covers (and pixels only the probe's zeros cover) keep
    their value: c O / c."""
    state = _state(m=16, scan=(3, 3), step=4, seed=9)
    h, w = state[1].shape
    obj = torch.full((h + 7, w + 5), 0.5 + 0.25j, dtype=torch.complex64)
    obj[:h, :w] = state[1]
    got = ptycho.dm_iterate(state[0], obj, *state[2:], device="cpu")[1]
    assert torch.allclose(got[-7:], obj[-7:], rtol=1e-6) and torch.allclose(
        got[:, -5:], obj[:, -5:], rtol=1e-6)


# -- faults the limits must catch ----------------------------------------------------------

def _fault(monkeypatch, fault, obj):
    """Plants one fault in the float32 iteration (`obj` is its object)."""
    if fault == "object_from_old_exits":
        real = op.update

        def update(psi, back, obj, probe, pos, out, sums, check=True):
            old = psi.clone()
            real(psi, back, obj, probe, pos, out, torch.zeros_like(sums), check)
            phi = torch.complex(*op._phi(obj, probe, pos))  # (old + phi) - phi: the old frames
            op.plain_update(old, phi, obj, probe, pos, torch.empty_like(old), sums)
        monkeypatch.setattr(op, "update", update)
    elif fault == "probe_from_old_object":
        real = ptycho._probe
        monkeypatch.setattr(ptycho, "_probe",
                            lambda psi, new, pos, probe: real(psi, obj, pos, probe))
    elif fault == "view_one_pixel_off":
        real = op.exit_waves
        monkeypatch.setattr(op, "exit_waves", lambda psi, obj, probe, pos, check=True: real(
            psi, obj, probe, pos + torch.tensor([0, 1], dtype=torch.int32), check))
    elif fault == "object_inertia_tenfold":
        monkeypatch.setattr(ptycho, "OBJECT_INERTIA", 10 * ptycho.OBJECT_INERTIA)


@pytest.mark.parametrize("fault", ["object_from_old_exits", "probe_from_old_object",
                                   "view_one_pixel_off", "object_inertia_tenfold"])
def test_a_planted_fault_fails_the_limits(fault, monkeypatch):
    state = _state(m=16, scan=(6, 6), step=4, jitter=1, seed=11)
    _fault(monkeypatch, fault, state[1])
    errs = _errors(ptycho.dm_iterate(*state, device="cpu"), state)
    assert max(errs.values()) > 10 * LIMIT, errs


# -- each plain pass against a straight float64 loop ---------------------------------------

def _loop_state(seed=4):
    exits, obj, probe, fmag, pos = _state(m=8, scan=(3, 4), step=2, jitter=1, seed=seed)
    return (exits.numpy().astype(np.complex128), obj.numpy().astype(np.complex128),
            probe.numpy().astype(np.complex128), fmag.numpy().astype(np.float64),
            pos.numpy()), (exits, obj, probe, fmag, pos)


def _phi(o, p, pos, j, m):
    r, c = pos[j]
    return p * o[r:r + m, c:c + m]


def test_plain_exit_against_a_loop():
    (e, o, p, _, pos), t = _loop_state()
    m = p.shape[0]
    want = np.stack([2 * _phi(o, p, pos, j, m) - e[j] for j in range(len(e))])
    got = op.plain_exit(t[0], t[1], t[2], t[4]).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_plain_fourier_against_a_loop():
    (e, _, _, a, _), t = _loop_state()
    f = np.fft.fft2(e)
    f[0, 0, 0] = 0  # a zero point takes the magnitude
    want = np.empty_like(f)
    err = np.empty(len(f))
    for j in range(len(f)):
        mag = np.abs(f[j])
        err[j] = np.mean((mag - a[j]) ** 2)
        want[j] = np.where(mag > 0, a[j] * f[j] / np.where(mag > 0, mag, 1), a[j])
    got = torch.from_numpy(f.astype(np.complex64))
    got_err = torch.empty(len(f))
    op.plain_fourier(got, t[3], got_err)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(got_err.numpy() - err).max() <= 1e-6 * err.max()
    assert got[0, 0, 0] == t[3][0, 0, 0]


def test_plain_update_and_probe_against_a_loop():
    (e, o, p, _, pos), t = _loop_state()
    m = p.shape[0]
    back = np.fft.ifft2(e[::-1].copy())
    new = np.stack([e[j] + back[j] - _phi(o, p, pos, j, m) for j in range(len(e))])
    num, den = np.zeros_like(o), np.zeros(o.shape)
    pnum, pden = np.zeros_like(p), np.zeros(p.shape)
    for j in range(len(e)):
        r, c = pos[j]
        num[r:r + m, c:c + m] += np.conj(p) * new[j]
        den[r:r + m, c:c + m] += np.abs(p) ** 2
        pnum += np.conj(o[r:r + m, c:c + m]) * new[j]
        pden += np.abs(o[r:r + m, c:c + m]) ** 2
    out = torch.empty_like(t[0])
    sums = torch.zeros(*o.shape, 4)
    op.plain_update(t[0], torch.from_numpy(back.astype(np.complex64)), t[1], t[2], t[4], out,
                    sums)
    assert np.abs(out.numpy() - new).max() <= 1e-6 * np.abs(new).max()
    assert np.abs(torch.view_as_complex(sums[..., :2].contiguous()).numpy() - num).max() <= (
        1e-6 * np.abs(num).max())
    assert np.abs(sums[..., 2].numpy() - den).max() <= 1e-6 * den.max()
    assert torch.all(sums[..., 3] == 0)
    psums = torch.zeros(m, m, 4)
    op.plain_probe(out, t[1], t[4], psums)
    assert np.abs(torch.view_as_complex(psums[..., :2].contiguous()).numpy() - pnum).max() <= (
        1e-6 * np.abs(pnum).max())
    assert np.abs(psums[..., 2].numpy() - pden).max() <= 1e-6 * pden.max()


def test_passes_take_the_plain_versions_on_the_host():
    exits, obj, probe, fmag, pos = _state(m=8, scan=(2, 2), step=2)
    assert torch.equal(op.exit_waves(exits, obj, probe, pos),
                       op.plain_exit(exits, obj, probe, pos))


# -- refusals --------------------------------------------------------------------------------

def _args(**change):
    exits, obj, probe, fmag, pos = _state(m=8, scan=(2, 2), step=2)
    args = {"exits": exits, "obj": obj, "probe": probe, "fmag": fmag, "positions": pos}
    args.update(change)
    return args


_E, _O, _P, _F, _POS = _state(m=8, scan=(2, 2), step=2).__iter__()
REFUSED = {
    "exits_complex128": (TypeError, "exits must be", {"exits": _E.to(torch.complex128)}),
    "obj_complex128": (TypeError, "obj must be", {"obj": _O.to(torch.complex128)}),
    "probe_real": (TypeError, "probe must be", {"probe": _P.real.contiguous()}),
    "fmag_float64": (TypeError, "fmag must be", {"fmag": _F.double()}),
    "positions_int64": (TypeError, "positions must be", {"positions": _POS.long()}),
    "exits_2d": (ValueError, r"\[J, M, M\]", {"exits": _E[0]}),
    "no_frames": (ValueError, r"J >= 1", {"exits": _E[:0], "fmag": _F[:0],
                                          "positions": _POS[:0]}),
    "not_power_of_two": (ValueError, "power of two", {"exits": _E[:, :6, :6],
                                                      "probe": _P[:6, :6],
                                                      "fmag": _F[:, :6, :6]}),
    "over_the_cube": (ValueError, "power of two", {
        "exits": torch.zeros(4, 256, 256, dtype=torch.complex64),
        "probe": torch.zeros(256, 256, dtype=torch.complex64),
        "fmag": torch.zeros(4, 256, 256), "obj": torch.zeros(300, 300, dtype=torch.complex64)}),
    "probe_shape": (ValueError, "probe must be", {"probe": _P[:4, :4]}),
    "fmag_shape": (ValueError, "fmag must be", {"fmag": _F[:3]}),
    "obj_small": (ValueError, "obj must be", {"obj": _O[:4]}),
    "positions_shape": (ValueError, "positions must be", {"positions": _POS[:3]}),
    "view_below": (ValueError, "inside the object",
                   {"positions": _POS - torch.tensor([1, 0], dtype=torch.int32)}),
    "view_past_the_right": (ValueError, "inside the object",
                            {"positions": _POS + torch.tensor([0, 1], dtype=torch.int32)}),
    "view_past_the_bottom": (ValueError, "inside the object",
                             {"positions": _POS + torch.tensor([1, 0], dtype=torch.int32)}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(case):
    exc, match, change = REFUSED[case]
    with pytest.raises(exc, match=match):
        ptycho.dm_iterate(**_args(**change), device="cpu")


@pytest.mark.parametrize("out", [torch.zeros(4, 8, 8, dtype=torch.complex128),
                                 torch.zeros(3, 8, 8, dtype=torch.complex64),
                                 torch.zeros(4, 8, 16, dtype=torch.complex64)[..., ::2],
                                 torch.zeros(4, 8, 8, dtype=torch.complex64, device="meta")])
def test_out_refusals(out):
    with pytest.raises(ValueError, match="out must be"):
        ptycho.dm_iterate(**_args(), out=out, device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptycho.dm_iterate(**_args())


def test_positions_are_checked_again_after_a_write():
    """Every call checks the positions: a write between two calls is
    refused however it was made, through indexing, a numpy view (which
    leaves the tensor's version counter as it was) or `.data`."""
    args = _args()
    pos = args["positions"].clone()
    ptycho.dm_iterate(**dict(args, positions=pos), device="cpu")
    for write, bumps in ((lambda: pos.__setitem__((0, 0), -1), True),
                         (lambda: pos.numpy().__setitem__((1, 1), 99), False),
                         (lambda: pos.data.__setitem__((2, 0), 99), False)):
        version = pos._version
        write()
        assert (pos._version != version) == bumps
        with pytest.raises(ValueError, match="inside the object"):
            ptycho.dm_iterate(**dict(args, positions=pos), device="cpu")
        pos.copy_(args["positions"])


def test_moved_positions_take_effect():
    """Positions moved between two calls, as a refinement of the scan does,
    through a numpy view: the second call iterates on the new views."""
    state = _state(m=16, scan=(3, 3), step=4, jitter=2, seed=5)
    pos = state[4].clone()
    ptycho.dm_iterate(*state[:4], pos, device="cpu")
    pos.numpy()[:, 1] += 1  # one pixel to the right, still inside the object
    moved = (*state[:4], pos.clone())
    errs = _errors(ptycho.dm_iterate(*state[:4], pos, device="cpu"), moved)
    assert max(errs.values()) <= LIMIT, errs


@pytest.mark.parametrize("call", ["exit", "fourier", "update", "probe"])
def test_kernel_wrapper_refusals(call):
    """The kernels' own checks, before any launch (on CPU tensors here)."""
    exits, obj, probe, fmag, pos = _state(m=8, scan=(2, 2), step=2)
    bad_pos = pos.long()
    with pytest.raises((TypeError, ValueError)):
        if call == "exit":
            op.exit_kernel(exits, obj, probe, bad_pos)
        elif call == "fourier":
            op.fourier_kernel(exits, fmag.double(), torch.empty(4))
        elif call == "update":
            op.update_kernel(exits, exits, obj, probe, pos, exits, torch.zeros(4, 4))
        else:
            op.probe_kernel(exits, obj, pos, torch.zeros(8, 8, 4, device="meta"))


def test_no_torch_fft(monkeypatch):
    """The transforms are the port's own: torch.fft is never called."""
    state = _state(m=16, scan=(3, 3), step=4)

    def refuse(*a, **k):
        raise AssertionError("torch.fft called")
    for name in ("fft", "ifft", "fft2", "ifft2", "fftn", "ifftn"):
        monkeypatch.setattr(torch.fft, name, refuse)
    assert ptycho.dm_iterate(*state, device="cpu")[0].shape == state[0].shape


# -- spans, launches and the counter --------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch):
    """The cube and the four passes launch on CPU tensors into a library
    that does nothing and returns 0 (the outputs stay as allocated); each
    pass records its arguments, returned here by entry."""
    calls = {}

    def entry(name):
        def f(*args):
            calls.setdefault(name, []).append(args)
            return 0
        return f
    lib = types.SimpleNamespace(watfft_fft2_cube=entry("cube"),
                                **{f"watfft_ptycho_{k}": entry(k)
                                   for k in ("exit", "fourier", "update", "probe")})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "use_kernel", lambda t, plain=False: not plain)
    return calls


def test_span_tree_launches_and_counter(stand_in, monkeypatch):
    """36 frames of 16^2 in three chunks of 12 (the cube route): a chunk's
    exit, transform, projection, inverse and update, then the object and
    the probe; one launch a pass a chunk, two of the cube, one of the
    probe's sums."""
    state = _state(m=16, scan=(6, 6), step=4)
    monkeypatch.setattr(ptycho, "CHUNK_POINTS", 12 * 16 * 16)
    launches = registry.launch_counts()
    frames = trace.counts["ptycho.frames"]
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ptycho.dm_iterate(*state, device="cpu")
    recorded = trace.spans()
    trace.clear()
    by_id = {s.id: s for s in recorded}
    kids = {}
    for s in recorded:
        if s.parent:
            kids.setdefault(by_id[s.parent].name, []).append(s.name)
    assert [s.name for s in recorded if s.parent == 0] == ["ptycho.dm"]
    assert kids["ptycho.dm"] == (["ptycho.exit", "api.fft2", "ptycho.fourier", "api.ifft2",
                                  "ptycho.update"] * 3 + ["ptycho.object", "ptycho.probe"])
    for step in ("exit", "fourier", "update", "probe"):
        assert kids[f"ptycho.{step}"] == [f"launch.ptycho_{step}"] * (1 if step == "probe"
                                                                      else 3)
    assert kids["api.fft2"] == kids["api.ifft2"] == ["launch.fft2_cube"] * 3
    assert "ptycho.object" not in kids  # torch ops alone
    after = registry.launch_counts()
    assert {k: after[k] - launches[k] for k in after if after[k] != launches[k]} == {
        "fft2_cube": 6, "ptycho_exit": 3, "ptycho_fourier": 3, "ptycho_update": 3,
        "ptycho_probe": 1}
    assert trace.counts["ptycho.frames"] - frames == 36
    # each chunk's frames and M, the object's width; the probe's over all frames
    # (frames, M, the object's height and width); no flag: the positions
    # were checked on the host
    assert [a[5:10] for a in stand_in["exit"]] == [(0, 12, 16, 36, 36)] * 3
    assert [a[3:5] for a in stand_in["fourier"]] == [(12, 16)] * 3
    assert [a[7:12] for a in stand_in["update"]] == [(0, 12, 16, 36, 36)] * 3
    assert [a[4:9] for a in stand_in["probe"]] == [(0, 36, 16, 36, 36)]
    pos = state[4]
    assert [a[3] for a in stand_in["exit"]] == [pos[j:].data_ptr() for j in (0, 12, 24)]


@pytest.mark.parametrize("call", ["exit", "update", "probe"])
@pytest.mark.parametrize("flagged", [False, True])
def test_kernel_wrappers_raise_on_the_flag(stand_in, monkeypatch, call, flagged):
    """A kernel that met a view outside the object sets its flag; the
    wrapper reads it after the launch and raises. With check=False it
    passes no flag and reads none."""
    exits, obj, probe, fmag, pos = _state(m=8, scan=(2, 2), step=2)
    entry = f"watfft_ptycho_{call}"
    at = {"exit": 5, "update": 7, "probe": 4}[call]
    flags = []

    def launch(*args):
        flags.append(args[at])
        if flagged and args[at]:
            ctypes.c_int32.from_address(args[at]).value = 1
        return 0
    monkeypatch.setattr(_build.library(), entry, launch)
    run = {"exit": lambda c: op.exit_kernel(exits, obj, probe, pos, check=c),
           "update": lambda c: op.update_kernel(exits, exits, obj, probe, pos, exits.clone(),
                                                torch.zeros(*obj.shape, 4), check=c),
           "probe": lambda c: op.probe_kernel(exits, obj, pos, torch.zeros(8, 8, 4),
                                              check=c)}[call]
    if flagged:
        with pytest.raises(ValueError, match="inside the object"):
            run(True)
    else:
        run(True)
    run(False)
    assert flags[0] != 0 and flags[1] == 0


def test_no_profiler_records_no_span(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was opened with no profiler session")
    monkeypatch.setattr(trace, "begin", refuse)
    monkeypatch.setattr(trace, "call", refuse)
    trace.clear()
    ptycho.dm_iterate(*_state(m=8, scan=(2, 2), step=2), device="cpu")
    assert len(trace._buffer) == 0


def test_the_passes_are_kernels_of_the_port():
    """The benchmark counts them as the port's time (`torch_ops_pct.batch`),
    by the `__global__` names of the port's sources."""
    from fftbench import traces

    names = {f"ptycho_{k}_kernel" for k in ("exit", "fourier", "update", "probe")}
    assert names <= trace.kernel_names() and names <= traces.port_kernels()


# -- on the card ------------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _cell_state(dev, rows=8, seed=0):
    """`rows` rows of the cell's raster (128 positions 16 px apart, frames
    of 128^2, the object's 2160 columns), made on the card."""
    m, step, scan = 128, 16, 128
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.arange(scan, dtype=torch.int32, device=dev) * step
    pos = torch.stack((k[:rows].repeat_interleave(scan), k.repeat(rows)), 1)
    h, w = (rows - 1) * step + m, (scan - 1) * step + m
    y = torch.arange(m, dtype=torch.float64, device=dev) - m // 2
    r2 = (y[:, None] ** 2 + y[None, :] ** 2) / 32.0 ** 2
    probe = torch.where(r2 <= 1, torch.polar(torch.ones_like(r2), 8 * math.pi * r2), 0)

    def cplx(shape, scale):
        u = torch.rand((*shape, 2), generator=g, device=dev, dtype=torch.float64)
        return torch.view_as_complex((u * 2 - 1) * scale)
    true = torch.polar(0.8 + 0.2 * torch.rand((h, w), generator=g, device=dev,
                                              dtype=torch.float64),
                       math.pi * (torch.rand((h, w), generator=g, device=dev,
                                             dtype=torch.float64) - 0.5))
    fmag = torch.empty((len(pos), m, m), device=dev)
    for j0 in range(0, len(pos), 256):
        fmag[j0:j0 + 256] = torch.fft.fft2(probe * ref.views(true, pos[j0:j0 + 256], m)).abs()
    probe = probe.to(torch.complex64)
    obj = (1 + cplx((h, w), 0.1)).to(torch.complex64)
    exits = (probe * ref.views(obj, pos, m) + cplx((len(pos), m, m), 0.1)).to(torch.complex64)
    return exits, obj, probe, fmag, pos


def _rel(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


@pytest.mark.cuda
def test_kernels_match_plain_at_the_cell_chunk(dev):
    """Each pass on [1024, 128, 128] against its plain version on the same
    arrays on the card: exit, the projection and the new frames the same
    bits; err and the sums (atomics, in the hardware's order) within float32
    rounding of the sums; one launch a call."""
    exits, obj, probe, fmag, pos = _cell_state(dev)
    before = registry.launch_counts()
    t = op.exit_kernel(exits, obj, probe, pos)
    assert torch.equal(t, op.plain_exit(exits, obj, probe, pos))
    f = torch.fft.fft2(t)
    f1, f2 = f.clone(), f.clone()
    e1, e2 = torch.empty(len(f), device=dev), torch.empty(len(f), device=dev)
    op.fourier_kernel(f1, fmag, e1)
    op.plain_fourier(f2, fmag, e2)
    assert torch.equal(f1, f2) and _rel(e1, e2) <= 1e-6
    back = torch.fft.ifft2(f2)
    o1, o2 = torch.empty_like(exits), torch.empty_like(exits)
    s1, s2 = (torch.zeros(*obj.shape, 4, device=dev) for _ in range(2))
    op.update_kernel(exits, back, obj, probe, pos, o1, s1)
    op.plain_update(exits, back, obj, probe, pos, o2, s2)
    assert torch.equal(o1, o2) and _rel(s1, s2) <= 1e-6 and torch.all(s1[..., 3] == 0)
    inplace = exits.clone()
    s3 = torch.zeros_like(s1)
    op.update_kernel(inplace, back, obj, probe, pos, inplace, s3)
    assert torch.equal(inplace, o1) and _rel(s3, s2) <= 1e-6
    p1, p2 = (torch.zeros(128, 128, 4, device=dev) for _ in range(2))
    op.probe_kernel(o1, obj, pos, p1)
    op.plain_probe(o1, obj, pos, p2)
    torch.cuda.synchronize()
    assert _rel(p1, p2) <= 1e-6
    after = registry.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "ptycho_exit": 1, "ptycho_fourier": 1, "ptycho_update": 2, "ptycho_probe": 1}


@pytest.mark.cuda
def test_kernels_skip_a_view_outside_the_object_on_the_card(dev):
    """Positions past each edge of the object: each kernel skips those
    frames, writes nothing past the object's sums (they are the head of a
    larger buffer whose tail stays 0) and sums the other frames as the
    plain version does; the wrappers raise on the flag, and with
    check=False they do not."""
    exits, obj, probe, fmag, pos = _cell_state(dev, rows=2)
    h, w = obj.shape
    inside = torch.ones(len(pos), dtype=torch.bool, device=dev)
    bad = pos.clone()
    for j, rc in ((0, (-1, 0)), (1, (0, -16)), (130, (h - 127, 0)), (255, (0, w - 127)),
                  (7, (-(2 ** 31), 2 ** 31 - 1))):
        bad[j] = torch.tensor(rc, dtype=torch.int32, device=dev)
        inside[j] = False
    back = torch.fft.ifft2(exits)
    buf = torch.zeros(2 * h * w * 4, device=dev)
    sums = buf[:h * w * 4].view(h, w, 4)
    psums = torch.zeros(128, 128, 4, device=dev)
    out = exits.clone()
    for run in (lambda c: op.exit_kernel(exits, obj, probe, bad, check=c),
                lambda c: op.update_kernel(exits, back, obj, probe, bad, out, sums, check=c),
                lambda c: op.probe_kernel(exits, obj, bad, psums, check=c)):
        with pytest.raises(ValueError, match="inside the object"):
            run(True)
    buf.zero_()
    psums.zero_()
    out = exits.clone()
    t = op.exit_kernel(exits, obj, probe, bad, check=False)
    op.update_kernel(exits, back, obj, probe, bad, out, sums, check=False)
    op.probe_kernel(exits, obj, bad, psums, check=False)
    torch.cuda.synchronize()
    assert torch.all(buf[h * w * 4:] == 0)
    assert torch.equal(out[~inside], exits[~inside])
    good = pos[inside].contiguous()
    assert torch.equal(t[inside], op.plain_exit(exits[inside], obj, probe, good))
    want_out, want = exits[inside].clone(), torch.zeros_like(sums)
    op.plain_update(exits[inside], back[inside], obj, probe, good, want_out, want)
    assert torch.equal(out[inside], want_out) and _rel(sums, want) <= 1e-6
    want = torch.zeros_like(psums)
    op.plain_probe(exits[inside], obj, good, want)
    assert _rel(psums, want) <= 1e-6


@pytest.mark.cuda
def test_a_chunk_matches_the_reference_on_the_card(dev):
    """1024 frames of 128^2 (8 rows of the cell's raster), one chunk: the
    cube both ways and the four passes, within the cell's limits of the
    float64 iteration."""
    state = _cell_state(dev, seed=1)
    before = registry.launch_counts()
    got = ptycho.dm_iterate(*state)
    after = registry.launch_counts()
    assert after["fft2_cube"] - before["fft2_cube"] == 2
    errs = _errors(got, state)
    assert all(errs[k] <= CELL_LIMITS[k] for k in CELL_LIMITS), errs


@pytest.mark.cuda
def test_a_request_of_the_cell(dev):
    """The cell's request, 16,384 frames in 16 chunks: 32 launches of the
    cube, 16 of each chunk's pass, one of the probe's; in place."""
    exits, obj, probe, fmag, pos = _cell_state(dev, rows=128, seed=2)
    before, frames = registry.launch_counts(), trace.counts["ptycho.frames"]
    got = ptycho.dm_iterate(exits, obj, probe, fmag, pos, out=exits)
    torch.cuda.synchronize()
    after = registry.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "fft2_cube": 32, "ptycho_exit": 16, "ptycho_fourier": 16, "ptycho_update": 16,
        "ptycho_probe": 1}
    assert trace.counts["ptycho.frames"] - frames == 16384
    assert got[0] is exits and all(bool(torch.isfinite(t).all()) for t in got)
