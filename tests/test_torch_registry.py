"""The port's surface registry (watfft_tpu_torch/registry.py) against the
JAX package's (watfft_tpu/registry.py): coverage, well-formedness, one
flagship per surface and dtype, an n = 64 spot check of every entry against
the f64 oracle and against its JAX counterpart on the same numpy input, and
the torch.fft baseline's fairness (tests/test_meta.py's checks, one case
per entry).

On the CPU every entry runs its kernels' plain versions (`device="cpu"`);
the JAX entries run as the JAX package's tests run them (Pallas interpret
mode, x64 from conftest.py). The entries whose range starts past 64 (the
large paths) are spot-checked at their smallest n against numpy's FFT in
float64, as the JAX package's meta test leaves them out. The kernels on the
card: tests/test_torch_cuda.py and chip_smoke.py phase 35.
"""

import numpy as np
import pytest

from watfft_tpu import registry as jreg
from watfft_tpu_torch import registry
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.registry import SurfaceEntry
from watfft_tpu_torch.utils.accuracy import to_host

# tests/test_meta.py:59-60: max |got - want| / max |want|
ORACLE_TOL = {"float32": 1e-4, "float64": 1e-9, "bfloat16": 3e-2}
# the port against the JAX entry on the same input, of the largest output
JAX_TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 3e-2}
N = 64


def _key(e):
    return f"{e.name}/{e.surface}/{e.dtype}"


def _jax_entry(e: SurfaceEntry):
    name = registry.JAX_NAME[e.name]
    found = [j for j in jreg.REGISTRY
             if (j.name, j.surface, j.dtype) == (name, e.surface, e.dtype)]
    assert len(found) == 1, _key(e)
    return found[0]


def _input(surface: str, n: int, seed: int):
    """(input, f64 oracle output) of a surface at n points."""
    rng = ref.seeded_rng(seed)
    big = n > 4096  # past the O(n^2) oracle's memory: numpy's FFT in float64
    if surface.startswith("complex"):
        x = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        if surface == "complex-forward":
            return x, np.fft.fft(x) if big else ref.dft(x)
        return x, np.fft.ifft(x) if big else ref.idft(x)
    sig = rng.uniform(-1, 1, n)
    spec = np.fft.rfft(sig) if big else ref.real_dft(sig)
    return (sig, spec) if surface == "real-forward" else (spec, sig)


def _err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def test_every_surface_has_exactly_one_flagship():
    for surface in registry.SURFACES:
        for dtype in ("float32", "float64"):
            e = registry.flagship(surface, dtype)
            assert e.flagship and not e.baseline and e.name == "dispatch"


def test_registry_entries_are_well_formed():
    names = set()
    for e in registry.REGISTRY:
        assert isinstance(e, SurfaceEntry)
        assert e.surface in registry.SURFACES
        assert e.dtype in ("float32", "float64", "bfloat16")
        assert 1 <= e.min_size <= e.max_size
        assert not (e.flagship and e.baseline), "a baseline cannot be flagship"
        assert e.name in registry.JAX_NAME
        names.add((e.name, e.surface, e.dtype))
    assert len(names) == len(registry.REGISTRY), "duplicate registry entries"


def test_every_jax_entry_has_its_counterpart():
    port = {(registry.JAX_NAME[e.name], e.surface, e.dtype, e.flagship, e.baseline)
            for e in registry.REGISTRY}
    jax_entries = {(j.name, j.surface, j.dtype, j.flagship, j.baseline) for j in jreg.REGISTRY}
    assert port == jax_entries
    assert len(set(registry.JAX_NAME.values())) == len(registry.JAX_NAME)


@pytest.mark.parametrize("e", registry.REGISTRY, ids=_key)
def test_entry_spot_check(e):
    """n = 64 (or the entry's smallest n) against the f64 oracle and, at
    n = 64, against the JAX entry on the same input."""
    n = N if e.min_size <= N <= e.max_size else e.min_size
    x, want = _input(e.surface, n, seed=64)
    got = to_host(e.make(n, device="cpu")(x))
    assert _err(got, want) < ORACLE_TOL[e.dtype], _key(e)
    # a batch of two: the leading shape is kept, each row transformed
    xb = np.stack([x, x])
    gotb = to_host(e.make(n, device="cpu")(xb))
    assert gotb.shape == (2,) + got.shape
    assert max(_err(gotb[0], want), _err(gotb[1], want)) < ORACLE_TOL[e.dtype], _key(e)
    if n != N:
        return
    j = _jax_entry(e)
    assert j.min_size <= n <= j.max_size
    want_jax = np.asarray(j.make(n)(x))
    assert _err(got, want_jax) < JAX_TOL[e.dtype], _key(e)


def test_torch_fft_baseline_is_fair():
    """The torch.fft baseline computes the same convention (unnormalized
    forward, 1/N inverse, the n//2+1 real bins) as the surfaces it is held
    against (tests/test_meta.py:71-83)."""
    n = 128
    rng = ref.seeded_rng(5)
    x = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    base = {e.surface: e for e in registry.entries(dtype="float64", include_baselines=True)
            if e.baseline}
    assert set(base) == set(registry.SURFACES)
    assert all(e.name == "torch-fft" for e in base.values())
    np.testing.assert_allclose(to_host(base["complex-forward"].make(n, "cpu")(x)),
                               ref.dft(x), atol=1e-9)
    np.testing.assert_allclose(to_host(base["complex-inverse"].make(n, "cpu")(x)),
                               ref.idft(x), atol=1e-9)
    sig = x.real
    np.testing.assert_allclose(to_host(base["real-forward"].make(n, "cpu")(sig)),
                               ref.real_dft(sig), atol=1e-9)
    np.testing.assert_allclose(to_host(base["real-inverse"].make(n, "cpu")(ref.real_dft(sig))),
                               sig, atol=1e-12)


def test_counters_name_every_entry_and_the_cpu_launches_nothing():
    """Each entry names the launch counters its kernels raise on the card
    (chip_smoke.py phase 35 checks they rise there); on the CPU the plain
    versions launch nothing."""
    assert set(registry.COUNTERS) == set(registry.JAX_NAME)
    before = {name: registry.launches(name) for name in registry.COUNTERS}
    for e in registry.entries("complex-forward", "float32", include_baselines=True):
        x, _ = _input(e.surface, max(e.min_size, N), seed=1)
        if e.max_size >= len(x):
            e.make(len(x), device="cpu")(x)
    assert {name: registry.launches(name) for name in registry.COUNTERS} == before
    assert not registry.COUNTERS["torch-fft"] and not registry.COUNTERS["fourstep-matmul"]
    assert all(set(c) <= set(registry.COUNTERS["dispatch"])
               for c in registry.COUNTERS.values())
