"""Accuracy thresholds over the port's registry, through the same
`measure_accuracy` as the port's accuracy report, and the apparatus itself
(`measure_accuracy`, `AccuracyResult.quality`, `quality`, `EPS`,
`REAL_SIGNALS`) against the JAX package's copies.

The port's counterpart of tests/test_accuracy.py: MAX_REL {f32: 5e-6,
f64: 1e-9} and RMS_REL {f32: 2e-6, f64: 5e-10} for every float32 and
float64 entry at every n of SIZES in its range, one case per entry and
dtype, on the CPU (the kernels' plain versions); the card runs the same
measure in chip_smoke.py phase 35 (b). The large entries start past SIZES
and are spot-checked in tests/test_torch_registry.py.
"""

import numpy as np
import pytest

from watfft_tpu.reference import dft as jref
from watfft_tpu.utils import accuracy as jacc
from watfft_tpu.utils import tolerances as jtol
from watfft_tpu_torch import registry
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils import tolerances as tol
from watfft_tpu_torch.utils.accuracy import AccuracyResult, measure_accuracy
from watfft_tpu_torch.utils.tolerances import MAX_REL, RMS_REL

SIZES = [16, 64, 256, 1024, 4096]
KIND = {"complex-forward": ("c2c", False), "complex-inverse": ("c2c", True),
        "real-forward": ("r2c", False), "real-inverse": ("c2r", True)}
CASES = [e for e in registry.entries(include_baselines=True)
         if e.dtype != "bfloat16" and any(e.min_size <= n <= e.max_size for n in SIZES)]


@pytest.mark.parametrize("e", CASES, ids=lambda e: f"{e.name}/{e.surface}/{e.dtype}")
def test_accuracy_thresholds(e):
    kind, inverse = KIND[e.surface]
    for n in SIZES:
        if not e.min_size <= n <= e.max_size:
            continue
        r = measure_accuracy(e.make(n, device="cpu"), n, e.dtype, kind=kind,
                             inverse=inverse, surface=e.name)
        assert r.max_rel < MAX_REL[e.dtype], f"{e.name} n={n} max_rel={r.max_rel:.3e}"
        assert r.rms_rel < RMS_REL[e.dtype], f"{e.name} n={n} rms_rel={r.rms_rel:.3e}"


def test_every_kernel_entry_is_covered():
    """Every registry name has threshold cases, apart from the large paths,
    whose smallest n is past SIZES."""
    names = {e.name for e in CASES}
    assert names | {"rfft-large", "large-nb", "stockham-bf16"} == set(registry.JAX_NAME)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quality_stays_flat(dtype):
    """quality = max_rel / (eps * sqrt(log2 N)) should not blow up with N
    (tools/accuracy_report.js:13-16 of wat-fft: near-optimal is 0.3-3)."""
    e = registry.flagship("complex-forward", dtype)
    qs = [measure_accuracy(e.make(n, device="cpu"), n, dtype, surface=e.name).quality
          for n in SIZES]
    assert max(qs) < 40, f"quality degraded: {qs}"


TRANSFORMS = [("c2c", False, np.fft.fft), ("c2c", True, np.fft.ifft),
              ("r2c", False, np.fft.rfft),
              ("c2r", True, lambda s: np.fft.irfft(s, 2 * (len(s) - 1)))]


@pytest.mark.parametrize("kind,inverse,transform", TRANSFORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_measure_accuracy_equals_jax(kind, inverse, transform, dtype):
    """The port's measure equals the JAX package's on numpy's transform with
    a gain error of 1e-3: the same seeded input, normalization, errors and
    quality. (The gain error puts the errors far above the last bits in
    which the two real oracles differ: the port's `real_dft` sums in blocks
    of bins; `test_oracles_equal_jax` holds those bits.)"""
    for n in (16, 256, 1000):
        for seed in (12345, 7):
            def off(x):
                return transform(x) * (1 + 1e-3)
            got = measure_accuracy(off, n, dtype, kind=kind, inverse=inverse, seed=seed,
                                   surface="numpy")
            want = jacc.measure_accuracy(off, n, dtype, kind=kind, inverse=inverse, seed=seed,
                                         surface="numpy")
            for key in ("max_rel", "rms_rel", "quality"):
                a, b = getattr(got, key), getattr(want, key)
                assert abs(a - b) <= 1e-12 * abs(b), (key, n, a, b)
            assert (got.surface, got.n, got.dtype) == (want.surface, want.n, want.dtype)


@pytest.mark.parametrize("kind,inverse,transform", TRANSFORMS)
def test_oracles_equal_jax(kind, inverse, transform):
    """On numpy's exact transform: the complex measures equal JAX's within
    1e-12 relative (one oracle code), and every measure stays at f64
    rounding (the two real oracles' last bits)."""
    for n in (16, 256, 1000):
        got = measure_accuracy(transform, n, "float64", kind=kind, inverse=inverse)
        want = jacc.measure_accuracy(transform, n, "float64", kind=kind, inverse=inverse)
        if kind == "c2c":
            assert abs(got.max_rel - want.max_rel) <= 1e-12 * want.max_rel
            assert abs(got.rms_rel - want.rms_rel) <= 1e-12 * want.rms_rel
        assert max(got.max_rel, want.max_rel) < 1e-13, (n, got.max_rel, want.max_rel)
        sig = ref.seeded_rng(n).uniform(-1, 1, n)
        a, b = ref.real_dft(sig), jref.real_dft(sig)
        assert np.max(np.abs(a - b)) <= 1e-13 * np.max(np.abs(b))


def test_quality_and_eps_equal_jax():
    assert tol.EPS == jtol.EPS
    assert (tol.REL_TOL, tol.ABS_TOL) == (jtol.REL_TOL, jtol.ABS_TOL)
    for dtype in tol.EPS:
        for n in (2, 64, 4096, 1 << 20):
            for m in (1e-7, 3.3e-3, 2e-15):
                assert abs(tol.quality(m, n, dtype) - jtol.quality(m, n, dtype)) <= (
                    1e-12 * jtol.quality(m, n, dtype))
                r = AccuracyResult("s", n, dtype, m, m / 2)
                assert r.quality == tol.quality(m, n, dtype)


@pytest.mark.parametrize("n", [8, 64, 1000])
def test_real_signals_equal_jax(n):
    assert set(ref.REAL_SIGNALS) == set(jref.REAL_SIGNALS)
    for name in ref.REAL_SIGNALS:
        a, b = ref.make_real_signal(name, n), jref.make_real_signal(name, n)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(ref.make_real_signal("random", n, seed=3),
                          jref.make_real_signal("random", n, seed=3))
