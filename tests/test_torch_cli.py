"""The port's command-line apparatus on the CPU: the self-test CLI
(`python -m watfft_tpu_torch`), `analyze` and the playground page, the
accuracy report, the permutation validator and the butterfly tester.

Every command runs in this process through its `main` with `--cpu` (the
kernels' plain versions); without a CUDA device and without `--cpu` they
exit non-zero. The page's data is held against the JAX package's
`tools/playground_report.py` on the same WAV. The card runs the same
commands in chip_smoke.py phase 35.
"""

import base64
import importlib.util
import json
import re
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from watfft_tpu_torch import __main__ as cli
from watfft_tpu_torch import registry
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.tools import accuracy_report, butterfly_tester, permutation_validator
from watfft_tpu_torch.tools import playground_report as pr

ROOT = Path(__file__).resolve().parents[1]


def _exit_code(argv) -> int:
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    return exc.value.code


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("signal", sorted(ref.SIGNALS))
def test_self_test_passes_on_the_cpu(signal, dtype, capsys):
    assert _exit_code(["64", signal, "--dtype", dtype, "--cpu"]) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("  complex-forward")]
    want = [e.name for e in registry.entries("complex-forward", dtype, include_baselines=True)
            if e.min_size <= 64 <= e.max_size]
    assert [ln.split()[1] for ln in rows] == want
    assert all(ln.endswith("OK") for ln in rows)


@pytest.mark.parametrize("argv", [["64", "random"], ["analyze", "x.wav"]])
def test_no_cuda_without_cpu_exits_nonzero(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _exit_code(argv) not in (0, None)
    assert "no CUDA device" in capsys.readouterr().err


def test_self_test_reports_a_failing_surface(monkeypatch, capsys):
    """A surface that raises is an ERROR row and the exit code 1."""
    e = registry.entries("complex-forward", "float32")[0]

    def broken(n, device="cuda"):
        def run(x):
            raise RuntimeError("kernel refused")
        return run
    monkeypatch.setattr(registry, "REGISTRY", [
        registry.SurfaceEntry(**{**e.__dict__, "make": broken})])
    assert _exit_code(["64", "random", "--cpu"]) == 1
    assert "ERROR: kernel refused" in capsys.readouterr().out


def _write_wav(path: Path, sig: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """2 s of the playground's chirp and tones as a 16-bit WAV."""
    path = tmp_path_factory.mktemp("wav") / "synth.wav"
    _write_wav(path, pr.synth_signal(16000), 16000)
    return path


def test_analyze_writes_a_self_contained_page(wav, tmp_path):
    out = tmp_path / "page.html"
    cli.main(["analyze", str(wav), "--html", str(out), "--cpu"])
    s = out.read_text()
    assert not re.search(r"__[A-Z0-9_]+__", s), "placeholders left"
    assert "http://" not in s and "https://" not in s and "fetch(" not in s
    assert s.count("<script>") == 1 and "watfft_tpu_torch" in s and "Benchmark" not in s
    spec = json.loads(re.search(r"const SPEC = (\{.*?\});\n", s, re.S).group(1))
    assert len(base64.b64decode(spec["data_b64"])) == 96 * spec["frames"]
    sp = json.loads(re.search(r"const SPECTRUM = (\{.*?\});\n", s, re.S).group(1))
    assert len(sp["db"]) == sp["n"] // 2 + 1
    hzs = sorted(p["hz"] for p in sp["peaks"])
    assert any(abs(h - 2500) < 32 for h in hzs), hzs
    st = json.loads(re.search(r"const SELFTEST = (\{.*?\});\n", s, re.S).group(1))
    np.testing.assert_allclose(st["re"], np.fft.rfft(np.asarray(st["x"])).real, atol=1e-12)


def test_analyze_bad_wav_exits_2(tmp_path, capsys):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    assert _exit_code(["analyze", str(bad), "--cpu"]) == 2
    assert "not a readable PCM WAV" in capsys.readouterr().err


def _jax_report():
    spec = importlib.util.spec_from_file_location(
        "jax_playground_report", ROOT / "tools" / "playground_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_page_data_matches_the_jax_report(wav):
    """On the same WAV: the port's spectrum within 1e-3 dB of the JAX
    report's (its dB before the page's rounding to 0.01, taken with the JAX
    report's own steps, which the test first checks round to the JAX
    report's values), and the spectrogram's bytes within 1 count."""
    import watfft_tpu as jwt
    from watfft_tpu import stft as jstft
    jpr = _jax_report()
    sig, sr = pr.load_wav(str(wav))
    jsig, jsr = jpr.load_wav(str(wav))
    assert sr == jsr and np.array_equal(sig, jsig)

    jspec = jpr.spectrum_data(sig, sr)
    n = pr.SPECTRUM_N
    frame = sig[len(sig) // 2: len(sig) // 2 + n] * jstft.get_window("hann", n)
    jdb = 20 * np.log10(np.abs(np.asarray(jwt.rfft(frame.astype(np.float32))))
                        .astype(np.float64) + 1e-9)
    assert [round(float(v), 2) for v in jdb] == jspec["db"]
    db, _ = pr.spectrum_db(sig, sr, device="cpu")
    assert np.max(np.abs(db - jdb)) <= 1e-3
    port = pr.spectrum_data(sig, sr, device="cpu")
    assert [p["hz"] for p in port["peaks"]] == [p["hz"] for p in jspec["peaks"]]

    got, want = pr.spectrogram_data(sig, sr, device="cpu"), jpr.spectrogram_data(sig, sr)
    assert {k: v for k, v in got.items() if k != "data_b64"} == {
        k: v for k, v in want.items() if k != "data_b64"}
    a = np.frombuffer(base64.b64decode(got["data_b64"]), np.uint8).astype(int)
    b = np.frombuffer(base64.b64decode(want["data_b64"]), np.uint8).astype(int)
    assert a.shape == b.shape and np.max(np.abs(a - b)) <= 1


def test_accuracy_report_has_a_row_for_every_entry(monkeypatch, capsys):
    monkeypatch.setattr(accuracy_report, "FFT2_SHAPES", ((2, 16, 32), (32, 32)))
    monkeypatch.setattr(accuracy_report, "RFFT2_SHAPES", ((2, 16, 32), (64, 64)))
    rows = accuracy_report.main(["--sizes", "16,64", "--cpu"])
    assert not [r for r in rows if r["error"]]
    seen = {(r["impl"], r["surface"], r["dtype"]) for r in rows}
    for e in registry.REGISTRY:
        if e.min_size <= 64 <= e.max_size:
            assert (e.name, e.surface, e.dtype) in seen, e
    assert {("stockham-bf16-c", "complex-forward", "bfloat16"),
            ("fft2-planes", "2d-forward", "float32"),
            ("rfft2-planes", "2d-real", "float32")} <= seen
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines()[1:] if ln.strip()]) == len(rows)
    assert all(r["inv_abs"] < 1e-5 for r in rows if "inv_abs" in r)


def test_accuracy_report_exit_code_counts_errors(monkeypatch):
    """An ERROR row (a surface that raises) is in the rows main returns,
    which the command turns into exit code 1."""
    e = registry.entries("complex-forward", "float64")[0]

    def broken(n, device="cuda"):
        raise RuntimeError("no kernel")
    monkeypatch.setattr(registry, "REGISTRY", [
        registry.SurfaceEntry(**{**e.__dict__, "make": broken})])
    rows = accuracy_report.main(["--sizes", "16", "--cpu", "--dtype", "float64"])
    assert len(rows) == 1 and "no kernel" in rows[0]["error"]


def test_permutation_validator_passes():
    assert permutation_validator.main([]) == 0


def test_permutation_validator_catches_a_wrong_interleave(monkeypatch, capsys):
    def swapped(parts, g, l, rest):  # blocks stacked in the wrong order
        return torch.stack([p.reshape(g, l, *rest) for p in parts], dim=2).reshape(-1, *rest)
    monkeypatch.setattr(permutation_validator, "_interleave", swapped)
    assert permutation_validator.main(["64"]) == 1


def test_butterfly_tester_passes(capsys):
    assert butterfly_tester.main(["--device", "cpu", "--sizes", "16,512,4096"]) == 0
    assert "OK on cpu" in capsys.readouterr().out
