"""The port's small-n DFT matmul (watfft_tpu_torch/ops/mxu_dft.py, kernel #20)
against the JAX package's (watfft_tpu/ops/mxu_dft.py) and the f64 oracle.

On the CPU the port's wrappers run the plain version (one torch.matmul in
full f32); the JAX kernel runs in Pallas interpret mode. Inputs are made
with numpy from a seed and handed to both as float32. The CUDA kernel
itself is checked on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watfft_tpu.ops import mxu_dft as jmd
from watfft_tpu_torch import config, convert
from watfft_tpu_torch.ops import mxu_dft as md
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, PER_BIN

SIZES = [2, 4, 8, 12, 16, 32, 64, 100, 128]
# max |port - jax| / max |jax|: both sum 2n f32 products, in other orders
JAX_LIMIT = 1e-6


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("n", range(1, 129))
def test_matrix_bit_equal_to_jax(n):
    for inverse in (False, True):
        got, want = md.dft_matrix_real(n, inverse), jmd.dft_matrix_real(n, inverse)
        assert got.dtype == want.dtype == np.float32 and got.shape == (2 * n, 2 * n)
        assert np.array_equal(got, want)
        wt = md.device_matrix(n, inverse, "cpu")
        assert wt.is_contiguous() and np.array_equal(wt.numpy(), want.T)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_jax_and_the_oracle(n, inverse):
    b = 256 if n <= 16 else 128  # the JAX function takes b % 128 == 0
    xre, xim = _planes((n, b), seed=n + inverse)
    ore, oim = md.dft_matmul_nb(*_t(xre, xim), inverse)
    jre, jim = jmd.dft_matmul_nb(jnp.asarray(xre), jnp.asarray(xim), inverse)
    got = ore.numpy() + 1j * oim.numpy()
    jax_got = np.asarray(jre) + 1j * np.asarray(jim)
    assert np.max(np.abs(got - jax_got)) / np.max(np.abs(jax_got)) <= JAX_LIMIT
    x = (xre + 1j * xim).T
    exp = (ref.idft(x) if inverse else ref.dft(x)).T
    assert rel_errors(got, exp)[0] <= MAX_REL["float32"]


@pytest.mark.parametrize("n", SIZES)
def test_plain_per_bin(n):
    """Each basis vector e^{2 pi i j k0 / n} lands on bin k0 alone, within
    n * 5e-6 (the per-bin limit of the accuracy tiers)."""
    t = np.arange(n)
    basis = np.exp(2j * np.pi * np.outer(t, t) / n)  # column k0: the k0-th basis vector
    ore, oim = md.dft_matmul_nb(*_t(basis.real.astype(np.float32),
                                    basis.imag.astype(np.float32)))
    err = np.abs(ore.numpy() + 1j * oim.numpy() - n * np.eye(n)).max()
    assert err < PER_BIN["float32"](n)


@pytest.mark.parametrize("batch", [1, 3, 77])
def test_odd_batches_and_every_layout(batch):
    """Any batch (the JAX b % 128 rule is a TPU tiling rule), and the three
    forms give one result."""
    for n in (3, 16, 100):
        xre, xim = _planes((batch, n), seed=batch * n)
        x = torch.complex(*_t(xre, xim))
        for inverse in (False, True):
            y = md.dft_matmul(x, inverse)
            bre, bim = md.dft_matmul_bm(*_t(xre, xim), inverse)
            tre, tim = md.dft_matmul_nb(*_t(xre.T.copy(), xim.T.copy()), inverse)
            assert torch.equal(torch.complex(bre, bim), y)
            assert torch.equal(torch.complex(tre, tim).T, y)
            exp = ref.idft(xre + 1j * xim) if inverse else ref.dft(xre + 1j * xim)
            assert rel_errors(y.numpy(), exp)[0] <= MAX_REL["float32"]


def test_roundtrip_and_the_nd_time_major_view():
    xre, xim = _planes((64, 4, 5), seed=3)
    fre, fim = md.dft_matmul_nb(*_t(xre, xim))
    assert fre.shape == (64, 4, 5)
    bre, bim = md.dft_matmul_nb(fre, fim, inverse=True)
    assert np.abs(bre.numpy() - xre).max() < 1e-5 and np.abs(bim.numpy() - xim).max() < 1e-5
    flat = md.dft_matmul_nb(*_t(xre.reshape(64, 20), xim.reshape(64, 20)))
    assert torch.equal(fre.reshape(64, 20), flat[0])


def test_matrix_carried_from_jax():
    """The JAX package's cached matrix, carried across by convert, is the
    port's device matrix bit for bit."""
    for n in (1, 12, 128):
        for inverse in (False, True):
            w = convert.dft_matrix_from_jax(jmd._WCache.get(n, inverse))
            assert torch.equal(w, md.device_matrix(n, inverse, "cpu"))
    with pytest.raises(ValueError, match="2n, 2n"):
        convert.dft_matrix_from_jax(np.zeros((24, 12), np.float32))


def test_refusals(monkeypatch):
    x = torch.zeros(129, 4)
    with pytest.raises(ValueError, match="DIRECT_MAX"):
        md.dft_matmul_nb(x, x)
    monkeypatch.setattr(config, "DIRECT_MAX", 64)
    with pytest.raises(ValueError, match="DIRECT_MAX = 64"):
        md.dft_matmul_bm(torch.zeros(4, 128), torch.zeros(4, 128))
    with pytest.raises(TypeError, match="float32"):
        md.dft_matmul_nb(x[:8].double(), x[:8].double())
    with pytest.raises(TypeError, match="complex64"):
        md.dft_matmul(torch.zeros(4, 8, dtype=torch.complex128))
    with pytest.raises(ValueError, match="differ"):
        md.dft_matmul_nb(x[:8], x[:8, :2])


@pytest.mark.parametrize("value, ok", [("64", True), ("256", False)])
def test_direct_max_is_one_setting(value, ok):
    """WATFFT_DIRECT_MAX drives the plan and the kernel's limit alike, as
    the JAX package's plan reads it; a value past the kernel's 128 is
    refused at import rather than taken by the plan alone."""
    code = ("from watfft_tpu_torch import config, plan; "
            "assert plan.DIRECT_MAX == config.DIRECT_MAX == 64; "
            "assert plan.factorize(1 << 16) == (64, 32, 32)")
    env = {**os.environ, "WATFFT_DIRECT_MAX": value}
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert (run.returncode == 0) == ok, run.stderr
    if not ok:
        assert "WATFFT_DIRECT_MAX=256" in run.stderr


def test_planes_that_require_grad_raise():
    """The JAX function has no gradient (no VJP for its pallas_call); the
    port raises rather than return outputs that drop it."""
    xre, xim = _t(*_planes((8, 4), seed=5))
    xre.requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        md.dft_matmul_nb(xre, xim)
    with pytest.raises(RuntimeError, match="no gradient"):
        md.dft_matmul(torch.complex(xre, xim))
    with torch.no_grad():
        assert md.dft_matmul_nb(xre, xim)[0].shape == (8, 4)


def test_cpu_runs_the_plain_version_without_launch():
    before = md.launches
    md.dft_matmul_nb(*_t(*_planes((16, 4), seed=6)))
    assert md.launches == before
