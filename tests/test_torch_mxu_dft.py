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
from watfft_tpu_torch.ops.fourstep import full_f32
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


# -- the tensor-core kernel's host side: TF32 split, fragment order, 3xTF32 ------------------

# the emulation of the kernel's arithmetic against the plain version, both
# f32 (the limit chip_smoke.py holds the kernel to)
KERNEL_LIMIT = 1e-6
EMULATED = [1, 2, 3, 12, 16, 100, 127, 128]


def _ref_tf32(v):
    """TF32 rounding of float32 values in float64 arithmetic: 11 significant
    bits, to nearest, ties away from zero."""
    v = np.asarray(v, np.float64)
    out = np.zeros_like(v)
    nz = v != 0
    ulp = 2.0 ** (np.floor(np.log2(np.abs(v[nz]))) - 10)
    out[nz] = np.sign(v[nz]) * np.floor(np.abs(v[nz]) / ulp + 0.5) * ulp
    return out


def test_tf32_rna_keeps_ten_bits_and_rounds_ties_away():
    rng = np.random.default_rng(7)
    v = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)).astype(np.float32)
    r = md.tf32_rna(v)
    assert r.dtype == np.float32
    assert not np.any(r.view(np.uint32) & 0x1FFF)            # the low 13 bits cleared
    assert np.array_equal(r.astype(np.float64), _ref_tf32(v))
    one = np.float32(1.0)
    tie, ulp, eps = np.float32(2.0 ** -11), np.float32(2.0 ** -10), np.float32(2.0 ** -23)
    cases = {one + tie: one + ulp, -(one + tie): -(one + ulp),        # ties: away from zero
             one + tie - eps: one, -(one + tie - eps): -one,          # below a tie: down
             one + ulp + tie: one + 2 * ulp,                          # an odd tie rounds away too
             np.float32(2.0) - eps: np.float32(2.0),                  # the carry into the exponent
             np.float32(0.0): np.float32(0.0)}
    for x, want in cases.items():
        assert md.tf32_rna(np.float32(x)) == want, (x, want)


@pytest.mark.parametrize("n", range(1, 129))
def test_tf32_split_of_w_is_good_to_2_22(n):
    """hi + lo of each entry of Wre and Wim is within 2^-22 of it, both
    directions; hi and lo are TF32 values."""
    for inverse in (False, True):
        w = md.dft_matrix_real(n, inverse)[:, :n].astype(np.float32)   # Wre over Wim
        hi = md.tf32_rna(w)
        lo = md.tf32_rna(w - hi)
        assert not np.any((hi.view(np.uint32) | lo.view(np.uint32)) & 0x1FFF)
        err = np.abs(w.astype(np.float64) - hi - lo)
        assert np.all(err <= 2.0 ** -22 * np.abs(w.astype(np.float64)))


def _unpermute(frags, n):
    """The fragment planes back as [4, 16 MT, 8 KT] padded planes (Wre hi, Wre
    lo, Wim hi, Wim lo), by the inverse of `fragment_index`."""
    idx = md.fragment_index(n)
    mt, kt = idx.shape[:2]
    planes = np.full((4, 16 * mt * 8 * kt), np.nan, np.float32)
    for p in range(4):
        planes[p][idx.reshape(-1)] = frags[:, :, p].reshape(-1)
    return planes.reshape(4, 16 * mt, 8 * kt)


@pytest.mark.parametrize("n", range(1, 129))
def test_fragment_order_is_a_permutation_that_gives_back_w(n):
    idx = md.fragment_index(n)
    mt, kt = -(-n // 16), -(-n // 8)
    assert idx.shape == (mt, kt, 32, 4)
    assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(16 * mt * 8 * kt))
    # lane 13 (g = 3, t = 1): a0..a3 at rows 3, 11, 3, 11 and columns 1, 1, 5, 5
    assert [divmod(int(i), 8 * kt) for i in idx[0, 0, 13]] == [(3, 1), (11, 1), (3, 5), (11, 5)]
    for inverse in (False, True):
        frags = md.mma_fragments(n, inverse)
        assert frags.shape == (mt, kt, 4, 32, 4) and frags.dtype == np.float32
        assert frags.flags.c_contiguous
        planes = _unpermute(frags, n)
        w = md.dft_matrix_real(n, inverse)
        for p, quad in enumerate((w[:n, :n], w[n:, :n])):
            hi, lo = planes[2 * p], planes[2 * p + 1]
            assert np.array_equal(hi[:n, :n], md.tf32_rna(quad))
            assert np.array_equal(lo[:n, :n], md.tf32_rna(quad - md.tf32_rna(quad)))
            for part in (hi, lo):   # zeros in the padding
                assert not part[n:].any() and not part[:, n:].any()
        assert torch.equal(md.device_fragments(n, inverse, "cpu"), torch.from_numpy(frags))


def _emulate(xre, xim, n, inverse):
    """The kernel's arithmetic on time-major [n, b] planes: W's hi and lo
    from the fragments, x split alike, and for each k-tile of 8, a fresh sum
    of lo*hi + hi*lo + hi*hi for Wre xre - Wim xim and Wim xre + Wre xim,
    added to the running sums, all in float32."""
    planes = torch.from_numpy(_unpermute(md.mma_fragments(n, inverse), n)[:, :n])
    rh, rl, ih, il = (planes[i][:, :n] for i in range(4))

    def split(v):
        hi = md.tf32_rna(v)
        return torch.from_numpy(hi), torch.from_numpy(md.tf32_rna(v - hi))
    (xrh, xrl), (xih, xil) = split(xre), split(xim)
    yre = torch.zeros(n, xre.shape[1])
    yim = torch.zeros_like(yre)
    for k0 in range(0, n, 8):
        k = slice(k0, min(k0 + 8, n))

        def prod(ah, al, bh, bl):
            return al[:, k] @ bh[k] + ah[:, k] @ bl[k] + ah[:, k] @ bh[k]
        yre += prod(rh, rl, xrh, xrl) + prod(-ih, -il, xih, xil)
        yim += prod(ih, il, xrh, xrl) + prod(rh, rl, xih, xil)
    return yre.numpy(), yim.numpy()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", EMULATED)
def test_3xtf32_emulation_matches_the_oracle_and_the_plain_version(n, inverse):
    xre, xim = _planes((n, 300), seed=100 + n + inverse)
    with full_f32():
        yre, yim = _emulate(xre, xim, n, inverse)
    got = yre + 1j * yim
    x = (xre + 1j * xim).T
    exp = (ref.idft(x) if inverse else ref.dft(x)).T
    assert rel_errors(got, exp)[0] <= MAX_REL["float32"]
    pre, pim = md.dft_matmul_nb(*_t(xre, xim), inverse)
    plain = pre.numpy() + 1j * pim.numpy()
    assert np.abs(got - plain).max() / np.abs(plain).max() <= KERNEL_LIMIT


@pytest.mark.parametrize("n", EMULATED)
def test_3xtf32_emulation_per_bin(n):
    t = np.arange(n)
    basis = np.exp(2j * np.pi * np.outer(t, t) / n)
    with full_f32():
        yre, yim = _emulate(basis.real.astype(np.float32), basis.imag.astype(np.float32), n,
                            False)
    assert np.abs(yre + 1j * yim - n * np.eye(n)).max() < PER_BIN["float32"](n)
