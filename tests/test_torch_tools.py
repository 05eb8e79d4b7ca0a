"""The port's last tools and its examples on the CPU: the stage-logging
Stockham reference (`watfft_tpu_torch.tools.stockham_reference`), the index
visualizer with the CUDA stage's thread map (`index_visualizer`), the
single-case runner (`single_case`), the dead-surface lint
(`lint_dead_surfaces`) and `examples/torch_basic_usage.py` /
`examples/torch_spectrogram_demo.py`.

The JAX package's tools (`tools/*.py`, loaded by file path) and its
registry entry `stockham-pallas` (Pallas interpret mode on the CPU) are the
references where a counterpart exists. Every command runs with `--cpu`
(the kernels' plain versions); without CUDA and without `--cpu` each exits
2. The card runs the same tools in chip_smoke.py phase 36.
"""

import importlib.util
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from watfft_tpu import registry as jreg
from watfft_tpu.ops import pallas_stockham as jst
from watfft_tpu_torch import registry
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.tools import index_visualizer as iv
from watfft_tpu_torch.tools import lint_dead_surfaces as lint
from watfft_tpu_torch.tools import single_case as sc
from watfft_tpu_torch.tools import stockham_reference as sref

ROOT = Path(__file__).resolve().parents[1]
KERNEL_N = [1 << k for k in range(1, 13)]       # the c2c kernel's range, 2..4096
INDEX_N = [1 << k for k in range(1, 14)]        # 2..8192
# the port against the JAX tools and np.fft, of the largest output
LIMIT = 1e-6


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_reference():
    return _jax_tool("stockham_reference")


@pytest.fixture(scope="module")
def jax_visualizer():
    return _jax_tool("index_visualizer")


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want)))


def _signal(n: int, b: int = 3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + n)
    return rng.uniform(-1, 1, (n, b)) + 1j * rng.uniform(-1, 1, (n, b))


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# -- the stage-logging reference ----------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", KERNEL_N)
def test_reference_matches_the_jax_tool_and_numpy(n, inverse, jax_reference):
    x = _signal(n)
    got, stages = sref.stockham_reference(x, inverse)
    assert len(stages) == len(st.stage_plan(n)) and stages[-1] is got
    assert got.dtype == np.complex128 and got.shape == x.shape
    assert _rel(got, jax_reference.stockham_reference(x, inverse)) <= LIMIT
    want = np.fft.ifft(x, axis=0) if inverse else np.fft.fft(x, axis=0)
    assert _rel(got, want) <= sref.REF_LIMIT == LIMIT


def test_reference_on_float64_tables_is_exact():
    """On the FP64 kernel's tables the reference is float64 throughout."""
    x = _signal(1024)
    got, _ = sref.stockham_reference(x, tables_dtype=np.float64)
    assert _rel(got, np.fft.fft(x, axis=0)) < 1e-13


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", KERNEL_N)
def test_diff_stages_finds_no_divergent_stage(n, inverse):
    first, diffs = sref.diff_stages(_signal(n), inverse, "cpu")
    assert first is None
    assert len(diffs) == len(st.stage_plan(n))
    assert max(diffs) < sref.STAGE_LIMIT["float32"] / 10


@pytest.mark.parametrize("broken", [0, 1, 2])
def test_diff_stages_reports_a_broken_stage_at_its_index(broken, monkeypatch):
    """A stage broken on purpose (row 1 of its output swapped with row 2) is
    reported at its own index, in both directions, the stages before it
    clean."""
    stage = st._stage
    calls = []

    def faulty(cre, cim, *args):
        ore, oim = stage(cre, cim, *args)
        if len(calls) == broken:
            ore, oim = ore[[0, 2, 1, *range(3, ore.shape[0])]], oim
        calls.append(1)
        return ore, oim
    monkeypatch.setattr(st, "_stage", faulty)
    for inverse in (False, True):
        calls.clear()
        first, diffs = sref.diff_stages(_signal(1024), inverse, "cpu")
        assert first == broken
        assert max(diffs[:broken], default=0.0) < sref.STAGE_LIMIT["float32"]


def test_diff_stages_scales_the_last_stage_alone(monkeypatch):
    """The inverse's 1/n reaches `_stage` on the plan's last stage only."""
    seen = []
    stage = st._stage

    def spy(cre, cim, n, r, l, tw, inverse, scale0):
        seen.append(scale0)
        return stage(cre, cim, n, r, l, tw, inverse, scale0)
    monkeypatch.setattr(st, "_stage", spy)
    sref.diff_stages(_signal(4096), True, "cpu")
    assert seen == [None, None, 1.0 / 4096]


@pytest.mark.parametrize("n", [2, 16, 1024])
def test_check_kernels_on_the_cpu(n):
    recs = sref.check_kernels(n, "cpu")
    assert [(r["instance"], r["inverse"]) for r in recs] == [
        (name, inv) for inv in (False, True) for name, *_ in sref.INSTANCES]
    assert all(r["ok"] and r["max_rel"] < r["limit"] and not r["launched"] for r in recs)
    for r in recs:     # the time-major instances take a column tile from n = 16
        assert (r["tile"] != [0, 0]) == (r["instance"].endswith("-nb") and n >= 16), r


@pytest.mark.parametrize("n", KERNEL_N)
def test_check_kernels_time_major_batch_gives_the_widest_tile(n):
    """The time-major batch makes the wrapper's rule give the widest tile
    the plan takes (`tile_shape` with no batch cap), a partial one at the
    end; the batch-major walk takes none."""
    radix = max(r for r, _ in st.stage_plan(n))
    for dt in ("float32", "float64"):
        size = np.dtype(dt).itemsize
        b = sref._batch(n, dt, "nb")
        assert sref._tile(n, dt, "bm", sref._batch(n, dt, "bm")) == (0, 0)
        if radix < st.MAX_RADIX:
            assert sref._tile(n, dt, "nb", b) == (0, 0)
            continue
        widest = st.tile_shape(n, size, 2 * size, None, radix, None)
        assert sref._tile(n, dt, "nb", b) == widest and widest[0] > st.engine_transforms(n)
        assert b % widest[0] == 3 % widest[0] != 0


def test_check_kernels_flags_a_wrong_output(monkeypatch):
    monkeypatch.setattr(st, "stockham_fft_nb", lambda re, im, inverse: (re, im))
    recs = sref.check_kernels(64, "cpu")
    assert {r["instance"] for r in recs if not r["ok"]} == {"c2c-nb", "fp64-nb"}


def test_check_kernels_flags_a_time_major_run_without_its_tile(monkeypatch):
    """A time-major instance whose launch would take the engine's walk where
    the plan takes a tile fails, though its output is right."""
    monkeypatch.setattr(sref, "_batch", lambda n, dt, layout: (1 << 15) // n + 3)
    recs = sref.check_kernels(64, "cpu")
    assert all(r["max_rel"] < r["limit"] for r in recs)
    assert {r["instance"] for r in recs if not r["ok"]} == {"c2c-nb", "fp64-nb"}


def test_stockham_reference_cli(capsys, monkeypatch):
    assert sref.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("MISMATCH") == 0
    assert out.count(" OK") == len(KERNEL_N) * 2 * (1 + len(sref.INSTANCES))
    assert sref.main(["64", "--log", "--inverse", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "forward" not in out and "  stage 1: R=4" in out
    code, recs = sref.run(["8192", "--cpu"])
    assert code == 0 and len(recs) == 2 and "no kernel run" in capsys.readouterr().out
    _no_cuda(monkeypatch)
    with pytest.raises(SystemExit) as exc:
        sref.main([])
    assert exc.value.code == 2


# -- the index visualizer -------------------------------------------------------------

def test_stage_patterns_match_the_jax_tool(jax_visualizer):
    same = [n for n in INDEX_N if jst.stage_plan(n) == st.stage_plan(n)]
    assert len(same) >= 8
    for n in same:
        assert iv.stage_patterns(n) == jax_visualizer.stage_patterns(n), n


@pytest.mark.parametrize("n", INDEX_N)
def test_the_four_invariants_hold(n):
    stages = iv.stage_patterns(n)
    assert iv.check_invariants(n, stages) == []
    P = iv.thread_width(n)
    assert P == min(n, 16) == max(r for r, _ in st.stage_plan(n))
    assert iv.check_thread_map(n, P, stages) == []
    tmap = iv.thread_map(n, P)
    assert all(t["tpt"] == n // P and t["m"] * t["r"] == P for t in tmap)


def test_thread_map_at_a_wider_thread():
    """Any P from the plan's largest radix up to n covers each butterfly
    once on the same rows (a thread doing more of them)."""
    for n, P in ((32, 32), (256, 64), (8, 8), (4096, 256)):
        assert iv.check_thread_map(n, P, iv.stage_patterns(n)) == []
    with pytest.raises(ValueError, match="radix-16"):
        iv.thread_map(64, 8)


@pytest.mark.parametrize("broken", ["_write_row", "_thread_base"])
def test_a_broken_write_formula_is_caught(broken, monkeypatch, capsys):
    if broken == "_write_row":   # drops the part: two outputs on one row
        monkeypatch.setattr(iv, "_write_row", lambda j, k, p, r, l: j * r * l + k)
    else:                        # the butterfly's l-block and k swapped
        monkeypatch.setattr(iv, "_thread_base",
                            lambda i, r, log2l: ((i & ((1 << log2l) - 1)) * r << log2l)
                            + (i >> log2l))
    assert iv.main(["--quiet", "64", "2048"]) == 1
    out = capsys.readouterr().out
    assert "written twice" in out if broken == "_write_row" else "P=16 stage 1" in out


def test_index_visualizer_cli(capsys):
    assert iv.main(["--quiet", *map(str, INDEX_N)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(INDEX_N) and all(": OK" in ln for ln in out)
    assert iv.main(["--rows", "2"]) == 0
    out = capsys.readouterr().out
    assert "n=64" in out and "n=2048" in out and "CUDA stage at P=16" in out
    assert "thread 1 m=0: butterfly 1" in out


# -- the single-case runner --------------------------------------------------------------

_CASES = [(s, dt) for dt in ("float32", "float64") for s in registry.SURFACES] + [
    ("complex-forward", "bfloat16"), ("complex-inverse", "bfloat16")]


@pytest.mark.parametrize("surface,dtype", _CASES)
def test_single_case_passes_on_the_cpu(surface, dtype, capsys):
    code, recs = sc.run(["64", "random", "--surface", surface, "--dtype", dtype,
                         "--bins", "5", "--cpu"])
    assert code == 0
    out = capsys.readouterr().out
    want = [e.name for e in registry.entries(surface, dtype) if e.min_size <= 64 <= e.max_size]
    assert [r["name"] for r in recs] == want
    assert all(r["ok"] and r["max_rel"] < r["tolerance"] and not r["launched"] for r in recs)
    assert recs[0]["tolerance"] == 4 * sc.limit(dtype)
    bins = [ln for ln in out.splitlines() if ln.strip() and ln.split()[0].isdigit()]
    assert len(bins) == 5 * len(want)
    assert out.count("launched: no kernel of the port") == len(want)


def test_single_case_bf16_limit():
    """bfloat16 has its tier's limit (the JAX tool has none: KeyError)."""
    assert sc.limit("bfloat16") == sc.BF16_LIMIT["interop"] == 3e-2
    assert sc.limit("float32") == 5e-6 and sc.limit("float64") == 1e-9


def test_single_case_all_bins_and_the_baseline(capsys):
    code, recs = sc.run(["16", "cosine", "--impl", "torch-fft", "--bins", "0", "--inverse",
                         "--cpu"])
    assert code == 0 and [r["name"] for r in recs] == ["torch-fft"]
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines() if ln.strip()[:1].isdigit()]) == 16


def test_single_case_oracle_past_the_exact_dft():
    n = 2 * sc.EXACT_MAX_N
    x, want = sc.case("complex-forward", n, "random")
    assert np.array_equal(want, np.fft.fft(x))
    sig, spec = sc.case("real-forward", 64, "sine")
    assert _rel(spec, np.fft.rfft(sig)) < 1e-13


def test_single_case_exits_1_on_a_bad_entry(monkeypatch, capsys):
    e = registry.entries("complex-forward", "float32")[0]

    def wrong(n, device="cuda"):
        return lambda x: torch.as_tensor(np.asarray(x) * 1.001)
    monkeypatch.setattr(registry, "REGISTRY", [
        registry.SurfaceEntry(**{**e.__dict__, "make": wrong})])
    assert sc.main(["64", "random", "--cpu"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_single_case_refusals(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        sc.main(["64", "random", "--impl", "no-such", "--cpu"])
    assert exc.value.code == 2
    assert sc.main(["8", "random", "--impl", "large-nb", "--cpu"]) == 1
    _no_cuda(monkeypatch)
    with pytest.raises(SystemExit) as exc:
        sc.main(["64", "random"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("surface", ["complex-forward", "complex-inverse"])
def test_single_case_bins_match_the_jax_entry(surface):
    """The `stockham-cuda` entry's bins against JAX's `stockham-pallas` on
    the same case (Pallas in interpret mode)."""
    port = [e for e in registry.entries(surface, "float32") if e.name == "stockham-cuda"][0]
    jax_e = [j for j in jreg.REGISTRY if (j.name, j.surface, j.dtype)
             == (registry.JAX_NAME[port.name], surface, "float32")][0]
    x, want = sc.case(surface, 64, "random")
    got, launched = sc.run_entry(port, 64, x, "cpu")
    theirs = np.asarray(jax_e.make(64)(x[None, :]), np.complex128)[0]
    assert not launched
    assert _rel(got, theirs) <= LIMIT
    assert _rel(got, want) <= sc.limit("float32")


# -- the dead-surface lint -----------------------------------------------------------------

def test_lint_is_clean_on_the_tree(capsys):
    assert lint.main(["--strict"]) == 0
    assert capsys.readouterr().out.startswith("OK:")
    package, sources = lint.port_files(ROOT)
    assert ROOT / lint.PACKAGE / "tools" / "lint_dead_surfaces.py" in package
    assert ROOT / "examples" / "torch_basic_usage.py" in sources
    assert not any("watfft_tpu/" in str(p.relative_to(ROOT)) or p.name == "test_stockham.py"
                   or p.name == "basic_usage.py" for p in sources)


def _write(root: Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_lint_flags_a_dead_module_and_a_dead_export(tmp_path, capsys):
    """References from the JAX package, its tests and its examples do not
    count; the port's tests and examples do."""
    pkg = lint.PACKAGE
    _write(tmp_path, f"{pkg}/__init__.py", "from . import alive\n")
    _write(tmp_path, f"{pkg}/alive.py", '__all__ = ["used_name", "unused_name"]\n')
    _write(tmp_path, f"{pkg}/orphan.py", "__all__ = []\n")
    _write(tmp_path, f"{pkg}/shown.py", '__all__ = ["shown_name"]\n')
    _write(tmp_path, "tests/test_torch_x.py", "from watfft_tpu_torch.alive import used_name\n")
    _write(tmp_path, "examples/torch_demo.py", "from watfft_tpu_torch.shown import shown_name\n")
    for rel in ("watfft_tpu/x.py", "tests/test_x.py", "examples/demo.py", "tools/t.py"):
        _write(tmp_path, rel, "orphan unused_name\n")
    assert lint.find_dead(tmp_path) == (4, [
        f"dead export: {pkg}/alive.py:__all__ -> unused_name",
        f"dead module: {pkg}/orphan.py (never imported)"])
    assert lint.main([str(tmp_path), "--strict"]) == 1
    assert lint.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("dead module") == 2 and out.count("dead export") == 2
    assert lint.main([str(tmp_path / "nowhere")]) == 2


# -- the examples ----------------------------------------------------------------------------

_RUN = """
import runpy, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["watfft_tpu"] = None
sys.argv = {argv!r}
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _example(name: str, args, cwd) -> subprocess.CompletedProcess:
    argv = [str(ROOT / "examples" / name), *args]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-c", _RUN.format(argv=argv)], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_basic_usage_example(tmp_path):
    proc = _example("torch_basic_usage.py", ["--cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    errs = {ln.split(":")[0]: float(ln.rsplit(" ", 1)[1])
            for ln in proc.stdout.splitlines() if " err" in ln}
    assert len(errs) == 6 and max(errs.values()) < 1e-5, errs
    assert "time-major output: (1024, 4) on cpu" in proc.stdout
    assert "spectrogram: (13, 129)" in proc.stdout
    assert "kernels launched: none (the plain versions)" in proc.stdout


def test_spectrogram_demo_example(tmp_path):
    proc = _example("torch_spectrogram_demo.py", ["--cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "frames=247, bins=513, mel=80" in proc.stdout
    data = (tmp_path / "spectrogram.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    assert struct.unpack(">II", data[16:24]) == (247, 80)
    assert data[24:26] == bytes([8, 3])                    # 8-bit indexed colour
    assert data[-8:-4] == b"IEND"


@pytest.mark.parametrize("name", ["torch_basic_usage.py", "torch_spectrogram_demo.py"])
def test_examples_exit_2_without_cuda(name, tmp_path):
    proc = _example(name, [], tmp_path)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert not list(tmp_path.iterdir())


def test_png_writer_round_trip(tmp_path):
    """The demo's writer: chunks with their CRCs, one filter byte a row, the
    palette of 256 colours, the pixels back through zlib."""
    import zlib

    demo = importlib.util.spec_from_file_location("torch_spectrogram_demo",
                                                  ROOT / "examples" / "torch_spectrogram_demo.py")
    mod = importlib.util.module_from_spec(demo)
    demo.loader.exec_module(mod)
    image = np.arange(3 * 5, dtype=np.uint8).reshape(3, 5) * 17
    path = tmp_path / "x.png"
    mod.write_png(str(path), image)
    data, at, chunks = path.read_bytes(), 8, {}
    while at < len(data):
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + size]
        assert struct.unpack(">I", data[at + 8 + size:at + 12 + size])[0] == zlib.crc32(kind + body)
        chunks[kind] = body
        at += 12 + size
    assert list(chunks) == [b"IHDR", b"PLTE", b"IDAT", b"IEND"]
    assert len(chunks[b"PLTE"]) == 3 * 256 and mod.PALETTE.shape == (256, 3)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(3, 6)
    assert (rows[:, 0] == 0).all() and np.array_equal(rows[:, 1:], image)
