"""The port's one launch seam (`ops/_build.launch`) and its counter table
(`trace.launches`), through a stand-in for the kernels' library on the CPU.

A launch that returns 0 counts 1 under its key and, inside a profiler
session alone, records one `launch.<key>` span; a nonzero code raises with
the key, the launch's fields and the library's message, and counts
nothing. The table holds the 24 names `registry.launch_counts()` has
always given, the spectrometer's detection, the imager's accumulation and
the difference map's four passes, and every wrapper launches under a key
of it. No JAX is needed.
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from watfft_tpu_torch import config, registry, trace
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import bluestein as bl
from watfft_tpu_torch.ops import detect as dt
from watfft_tpu_torch.ops import fft2 as f2
from watfft_tpu_torch.ops import large as lg
from watfft_tpu_torch.ops import mxu_dft as md
from watfft_tpu_torch.ops import ola
from watfft_tpu_torch.ops import ptycho as pt
from watfft_tpu_torch.ops import rfft as rf
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.ops import wstack as ws

NAMES = {"bluestein_fwd", "bluestein_inv", "bluestein_onepass", "fft2_cols", "fft2_cube",
         "fft2_k2", "fft2_rows", "irfft_c2r_fused", "irfft_c2r_fused_f64", "istft_ola",
         "large_cube", "large_outer", "large_postmul", "large_stage1", "large_stage2",
         "mxu_dft", "real_core_fwd", "real_core_inv", "rfft_r2c_fused", "rfft_r2c_fused_f64",
         "stockham_c2c", "stockham_c2c_bf16", "stockham_c2c_bf16c", "stockham_c2c_f64",
         "spec_detect", "wstack_accum", "ptycho_exit", "ptycho_fourier", "ptycho_update",
         "ptycho_probe"}
# the routes counted beside the kernels: their launches count as the c2c kernel's
ROUTES = {"real_core_fwd", "real_core_inv", "fft2_rows"}
PTYCHO = ("ptycho_exit", "ptycho_fourier", "ptycho_update", "ptycho_probe")


class _Library:
    """A stand-in for the kernels' library: every entry records its name and
    arguments and returns `code` (the outputs are left as allocated)."""

    def __init__(self):
        self.code = 0
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return self.code
        return entry

    @staticmethod
    def watfft_error_string(err):
        return f"stand-in error {err}".encode()


@pytest.fixture
def lib(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(_build, "use_kernel", lambda t, plain=False: not plain)
    return lib


def _spans(fn):
    """The names of the spans fn records inside a profiler session."""
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
        return [s.name for s in trace.spans()]
    finally:
        trace.clear()


def _launch(lib, key="mxu_dft"):
    """One launch of the stand-in's `watfft_dft_matmul` under `key`; the
    arguments it got."""
    _build.launch(key, torch.device("cpu"), "watfft_dft_matmul", (1, 2), (3,),
                  lambda: "n=4, batch=2")
    return lib.args[-1]


# -- the seam --------------------------------------------------------------------------

def test_a_zero_code_counts_one_under_its_key(lib):
    before = dict(trace.launches)
    trace.clear()
    assert _launch(lib) == (1, 2, 7, 3) and lib.calls == ["watfft_dft_matmul"]
    assert trace.launches == {**before, "mxu_dft": before["mxu_dft"] + 1}
    assert len(trace._buffer) == 0  # no session: no span


def test_a_launch_in_a_session_records_one_span(lib):
    before = trace.launches["istft_ola"]
    assert _spans(lambda: _launch(lib, "istft_ola")) == ["launch.istft_ola"]
    assert trace.launches["istft_ola"] == before + 1


@pytest.mark.parametrize("traced", [False, True])
def test_a_nonzero_code_raises_and_counts_nothing(lib, traced):
    lib.code = 3
    before = dict(trace.launches)
    with pytest.raises(RuntimeError) as err:
        _spans(lambda: _launch(lib)) if traced else _launch(lib)
    assert str(err.value) == "mxu_dft kernel launch failed (n=4, batch=2): stand-in error 3"
    assert trace.launches == before


def test_plain_and_cpu_tensors_take_the_plain_version():
    t = torch.zeros(2)
    assert not _build.use_kernel(t) and not _build.use_kernel(t, plain=True)
    meta = torch.zeros(2, device="meta")
    assert not _build.use_kernel(meta)


def test_the_refusals_before_a_launch():
    _build.same_device(torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(ValueError, match="tables on cpu, data on meta"):
        _build.same_device(torch.device("cpu"), torch.device("meta"))
    _build.kernel_dtype(torch.zeros(1), torch.float32)
    with pytest.raises(TypeError, match="takes torch.float32, got torch.float64"):
        _build.kernel_dtype(torch.zeros(1, dtype=torch.float64), torch.float32)


# -- the table ---------------------------------------------------------------------------

def test_the_table_has_the_24_names():
    """The 24 names the table has always had, the detection's, the
    accumulation's and the difference map's four: 30."""
    assert set(trace.launches) == NAMES and len(trace.launches) == 30
    assert len(NAMES - {"spec_detect", "wstack_accum"} - set(PTYCHO)) == 24
    assert registry.launch_counts() == trace.launches
    assert registry.launch_counts() is not trace.launches  # a copy to diff against
    counters = trace.counters()
    assert {k[len("launch."):] for k in counters if k.startswith("launch.")} == NAMES


def test_registry_counters_name_table_keys():
    named = set()
    for name, keys in registry.COUNTERS.items():
        assert set(keys) <= NAMES, name
        assert registry.launches(name) == sum(trace.launches[k] for k in keys)
        named.update(keys)
    # no FFT surface launches these
    assert named == NAMES - {"istft_ola", "spec_detect", "wstack_accum", *PTYCHO}


def _f(shape, dtype=torch.float32, seed=0):
    a = np.random.default_rng(seed).uniform(-1, 1, shape)
    return torch.from_numpy(a).to(dtype)


def _pair(shape, dtype=torch.float32):
    return _f(shape, dtype, 1), _f(shape, dtype, 2)


def _views():
    """Two 8 x 8 frames, a 10 x 12 object, the probe and two positions in
    it: the difference map's operands."""
    frames, probe = torch.complex(*_pair((2, 8, 8))), torch.complex(*_pair((8, 8)))
    obj = torch.complex(*_pair((10, 12)))
    return frames, obj, probe, torch.tensor([[0, 0], [2, 4]], dtype=torch.int32)


# Each kernel key and a call that launches it (among others).
DRIVES = {
    "stockham_c2c": lambda: st.stockham_fft_nb(*_pair((16, 4))),
    "stockham_c2c_f64": lambda: st.stockham_fft_nb(*_pair((16, 4), torch.float64)),
    "stockham_c2c_bf16": lambda: st.stockham_fft_bm(*_pair((4, 16), torch.bfloat16)),
    "stockham_c2c_bf16c": lambda: st.stockham_fft_nb(*_pair((16, 4), torch.bfloat16)),
    "rfft_r2c_fused": lambda: rf.rfft_nb_fused(_f((16, 4))),
    "irfft_c2r_fused": lambda: rf.irfft_nb_fused(*_pair((9, 4))),
    "rfft_r2c_fused_f64": lambda: rf.rfft_nb_fused(_f((16, 4), torch.float64)),
    "irfft_c2r_fused_f64": lambda: rf.irfft_nb_fused(*_pair((9, 4), torch.float64)),
    "large_stage1": lambda: lg.fft_large_nb(*_pair((1 << 13, 2)), mode="pipe2"),
    "large_stage2": lambda: lg.fft_large_nb(*_pair((1 << 13, 2)), mode="pipe2"),
    "large_cube": lambda: lg.fft_large_nb(*_pair((1 << 13, 2)), mode="cube"),
    "large_postmul": lambda: st.stockham_fft_nb_postmul(*_pair((16, 4)), *_pair((16, 4))),
    "large_outer": lambda: lg.fft_large_nb(*_pair((1 << 13, 2)), mode="2d"),
    "fft2_cube": lambda: f2.fft2_cube(*_pair((8, 16, 3))),
    "fft2_cols": lambda: f2.fft2_cols(*_pair((8, 16, 3))),
    "fft2_k2": lambda: f2.fft2_k2(*_pair((8, 16, 3))),
    "bluestein_fwd": lambda: bl.bluestein_fwd(*_pair((5, 3))),
    "bluestein_inv": lambda: bl.bluestein_inv(*_pair((bl.bluestein_m(5), 3)), 5),
    "bluestein_onepass": lambda: bl.bluestein_fft_nb(*_pair((5, 3))),
    "mxu_dft": lambda: md.dft_matmul_nb(*_pair((8, 3))),
    "istft_ola": lambda: ola.istft_ola(_f((2, 5, 16)), _f(16), 4),
    "spec_detect": lambda: dt.power_add(torch.complex(*_pair((2, 2, 1, 8))), _f((2, 8))),
    "wstack_accum": lambda: ws.accum_kernel(torch.complex(*_pair((2, 8, 8))), _f((8, 8)),
                                            _f(2, torch.float64), 1e-3, _f(8), True, True),
    "ptycho_exit": lambda: pt.exit_kernel(*_views()),
    "ptycho_fourier": lambda: pt.fourier_kernel(_views()[0], _f((2, 8, 8)), _f(2)),
    "ptycho_update": lambda: pt.update_kernel(_views()[0], *_views(), torch.empty(2, 8, 8,
                                              dtype=torch.complex64), torch.zeros(10, 12, 4)),
    "ptycho_probe": lambda: pt.probe_kernel(_views()[0], _views()[1], _views()[3],
                                            torch.zeros(8, 8, 4)),
}


def test_every_kernel_key_has_a_call():
    assert set(DRIVES) == NAMES - ROUTES


@pytest.mark.parametrize("key", sorted(DRIVES))
def test_each_wrapper_launches_under_its_key(key, lib, monkeypatch):
    """The wrapper's launch counts under its key of the table and records
    its span under the same name; every launch the call makes is one of
    the table's kernel keys."""
    monkeypatch.setattr(config, "BF16_COMPUTE", key == "stockham_c2c_bf16c")
    before = dict(trace.launches)
    names = _spans(DRIVES[key])
    launched = {k: v - before[k] for k, v in trace.launches.items() if v != before[k]}
    assert key in launched and set(launched) <= NAMES
    spans = [n[len("launch."):] for n in names if n.startswith("launch.")]
    assert sorted(spans) == sorted(k for k, v in launched.items() if k not in ROUTES
                                   for _ in range(v))
    assert len(lib.calls) == len(spans)
