"""The port's loader of the native C++ host layer (watfft_tpu_torch/native.py)
against the port's numpy oracle and host tables: an independent
implementation stack, so a disagreement means one of the two has a bug
(tests/test_native.py's checks, through the port's own loader).

The library's twiddle pack follows the JAX package's stage plan (its
radix-32/64 overrides included), so the port's `make_twiddle_pack` is
given that plan here. Skipped only where there is no g++ to build the
library with, as tests/test_native.py is.
"""

import hashlib
import shutil
from pathlib import Path

import numpy as np
import pytest

from watfft_tpu.ops.pallas_stockham import stage_plan as jax_stage_plan
from watfft_tpu_torch import native, plan
from watfft_tpu_torch.ops.stockham import make_twiddle_pack
from watfft_tpu_torch.reference import dft as ref

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")

NATIVE = Path(__file__).resolve().parents[1] / "native"


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.build()


def test_native_dft_matches_numpy_oracle():
    rng = ref.seeded_rng(11)
    for n in (8, 64, 256):
        x = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        assert np.max(np.abs(native.dft(x) - ref.dft(x))) < n * 1e-13
        assert np.max(np.abs(native.dft(x, inverse=True) / n - ref.idft(x))) < 1e-13
    xb = rng.uniform(-1, 1, (3, 16)) + 0j
    assert np.max(np.abs(native.dft(xb) - ref.dft(xb))) < 16 * 1e-13


@pytest.mark.parametrize("n", [16, 32, 64, 128, 1024, 2048, 4096, 8192])
def test_native_twiddle_pack_matches_the_port_on_the_jax_plan(n):
    for inverse in (False, True):
        nre, nim = native.twiddle_pack(n, inverse)
        pre, pim, _ = make_twiddle_pack(n, inverse, stages=jax_stage_plan(n))
        assert nre.shape == pre.shape
        np.testing.assert_allclose(nre, pre, atol=2e-7)
        np.testing.assert_allclose(nim, pim, atol=2e-7)


def test_native_dft_matrix_matches_the_port():
    for n in (16, 128):
        for sign in (-1, 1):
            nre, nim = native.dft_matrix(n, sign, 1.0)
            pre, pim = plan.dft_matrix(n, float(sign))
            np.testing.assert_allclose(nre, pre, atol=1e-14)
            np.testing.assert_allclose(nim, pim, atol=1e-14)


def _tree_digest(root: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.iterdir()) if p.is_file()}


def test_forced_build_leaves_native_untouched(tmp_path):
    before = _tree_digest(NATIVE)
    try:
        assert native.build(force=True, directory=tmp_path)
        assert native.library_path() == tmp_path / "libwatfft_native.so"
        x = np.arange(8) + 0j
        assert np.max(np.abs(native.dft(x) - ref.dft(x))) < 8 * 1e-13
    finally:
        native.build(force=True)  # the default build again, for the other tests
    assert _tree_digest(NATIVE) == before
