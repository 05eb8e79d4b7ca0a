"""The port's any-n path (watfft_tpu_torch/ops/bluestein.py, the Bluestein
chirp-z transform) against the JAX package's (watfft_tpu/ops/bluestein.py)
and the f64 oracle.

On the CPU the port's wrappers run each kernel's plain torch version on the
same strided views the CUDA kernels get. The JAX kernels #17 and #18 run in
Pallas interpret mode at m <= 256 (interpret mode compiles slowly past
that); at larger n the JAX function runs its XLA route (FORCE_INTERPRET
off: the same tables and algorithm, the m-point transforms as XLA
matmuls). Inputs are made with numpy from a seed and handed to both as
float32. The CUDA kernels are checked on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watfft_tpu import config
from watfft_tpu.ops import bluestein as jb
from watfft_tpu.ops import pallas_stockham as jst
from watfft_tpu_torch import convert, planner
from watfft_tpu_torch.ops import bluestein as bl
from watfft_tpu_torch.reference import dft as ref

# max |port - jax| / max |jax|: ulp-level, not bitwise (FMA contraction and
# XLA's fusion differ from torch's op-by-op rounding)
JAX_LIMIT = 1e-6
# the port against the JAX XLA route, whose m-point transforms are f32
# matmuls: each side is within ~4e-7 of the f64 DFT (relative to the
# largest output), so they differ by up to the sum
XLA_LIMIT = 1e-6
# tests/test_fft_reference.py:93-107: max error over the largest output
MAX_REL, ROUNDTRIP = 5e-6, 1e-5

INTERPRET_SIZES = [3, 12, 97]          # m = 8, 32, 256
TABLE_SIZES = list(range(1, 65)) + [97, 360, 1000, 1009, 4097, 10007]


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


def _rel_to_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(config, "FORCE_INTERPRET", True)


@pytest.fixture
def xla_route(monkeypatch):
    monkeypatch.setattr(config, "FORCE_INTERPRET", False)


# -- tables and planner ----------------------------------------------------------

@pytest.mark.parametrize("n", TABLE_SIZES)
def test_chirp_tables_bit_equal_to_jax(n):
    assert bl.bluestein_m(n) == jb.bluestein_m(n)
    for inverse in (False, True):
        got = bl.chirp_tables(n, inverse)
        want = jb._ChirpCache.get(n, inverse)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            assert np.array_equal(g, w)


def test_device_tables_carry_the_jax_fold():
    """The final chirp is c times f32(1/n) for the inverse, as
    `_bluestein_fused` folds it; the JAX tables through `convert` give the
    port's own tables where the plans agree (m = 256: radix 16, 16)."""
    n = 97
    m = bl.bluestein_m(n)
    for inverse in (False, True):
        own = bl.device_bluestein_tables(n, inverse, "cpu")
        chirp = jb._ChirpCache.get(n, inverse)
        fold = (jnp.asarray(chirp[1]) * (1.0 / n)) if inverse else jnp.asarray(chirp[1])
        assert np.array_equal(own.fre.numpy(), np.asarray(fold).reshape(-1))
        jt = convert.bluestein_tables_from_jax(n, chirp, jst.stage_plan(m),
                                               jst.make_twiddle_pack(m, False),
                                               jst.make_twiddle_pack(m, True), inverse)
        assert jt.fwd.stages == own.fwd.stages and jt.inv.stages == own.inv.stages
        for a in ("cre", "cim", "fre", "fim", "bre", "bim"):
            assert torch.equal(getattr(jt, a), getattr(own, a))
        for which in ("fwd", "inv"):
            assert torch.equal(getattr(jt, which).twre, getattr(own, which).twre)
            assert torch.equal(getattr(jt, which).twim, getattr(own, which).twim)


def test_planner_routes_any_n():
    k = planner.bluestein_kernel
    assert k(1) == k(3) == k(1000) == k(2048) == "bluestein-fused"     # m <= 4096
    assert k(2049) == "bluestein-large-cube"                           # m = 8192
    assert k(4097, batch=4) == "bluestein-large-cube"                  # m = 2^14: the cube
    assert k(4097, batch=1) == "bluestein-large-cube"                  # at every batch
    assert k(10007) == "bluestein-large-pipe2"                         # m = 2^15
    assert k((1 << 23) + 1) == "bluestein-fourstep"                    # m = 2^25
    with pytest.raises(ValueError):
        k(0)
    assert bl.device_bluestein_tables(2049, False, "cpu").fwd is None  # no m-point kernel tables


# -- each kernel's plain version against the JAX interpret kernel ---------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", INTERPRET_SIZES)
def test_plain_kernels_match_jax_interpret(n, inverse):
    """#17 `_bl_fwd_kernel` and #18 `_bl_inv_kernel` on [n, 128] -> [m, 128]
    -> [n, 128], on the JAX tables (its m-point plan: radix 32 at m = 32)."""
    b = 128
    chirp = jb._ChirpCache.get(n, inverse)
    m, cre, cim, bre, bim = chirp
    twf, twi = jst._TwCache.get(m, False), jst._TwCache.get(m, True)
    tables = convert.bluestein_tables_from_jax(n, chirp, jst.stage_plan(m),
                                               jst.make_twiddle_pack(m, False),
                                               jst.make_twiddle_pack(m, True), inverse)
    x = _x((n, b), n + inverse)
    fre, fim = jb._bl_fwd_call(_j(x.real), _j(x.imag), _j(twf[0]), _j(twf[1]), _j(cre),
                               _j(cim), _j(bre), _j(bim), n, m, 128, interpret=True)
    got = bl.plain_bluestein_fwd(_t(x.real), _t(x.imag), inverse, tables)
    assert got[0].shape == (m, b)
    assert _rel_to_max(_c(*got), _c(fre, fim)) <= JAX_LIMIT
    s = 1.0 / n if inverse else 1.0
    want = _c(*jb._bl_inv_call(fre, fim, _j(twi[0]), _j(twi[1]), _j(cre) * s, _j(cim) * s,
                               n, m, 128, interpret=True))
    got = bl.plain_bluestein_inv(_t(fre), _t(fim), n, inverse, tables)
    assert _rel_to_max(_c(*got), want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", INTERPRET_SIZES)
def test_plain_onepass_matches_jax_fused_interpret(n, inverse):
    """The one-pass kernel's plain version against `_bluestein_fused` (#17
    then #18 in interpret mode) on [n, 128], on the JAX tables."""
    b = 128
    chirp = jb._ChirpCache.get(n, inverse)
    m, cre, cim, bre, bim = chirp
    tables = convert.bluestein_tables_from_jax(n, chirp, jst.stage_plan(m),
                                               jst.make_twiddle_pack(m, False),
                                               jst.make_twiddle_pack(m, True), inverse)
    x = _x((n, b), 40 + n + inverse)
    want = _c(*jb._bluestein_fused(_j(x.real), _j(x.imag), n, m, inverse, cre, cim, bre, bim))
    got = bl.plain_bluestein_onepass(_t(x.real), _t(x.imag), inverse, tables)
    assert got[0].shape == (n, b)
    assert _rel_to_max(_c(*got), want) <= JAX_LIMIT


def _operands(x: torch.Tensor, layout: str):
    """The complex [batch, n] x as the fused route's operands in `layout`:
    (x, x strides, y, y as complex [batch, n])."""
    batch, n = x.shape
    if layout == "complex":
        fx = torch.view_as_real(x.contiguous()).view(-1)
        y = torch.empty_like(fx)
        return ((fx, fx[1:]), (2, 2 * n), (y, y[1:]),
                lambda: torch.view_as_complex(y.view(batch, n, 2)))
    if layout == "bm":
        xo, xs = (x.real.contiguous(), x.imag.contiguous()), (1, n)
        yo = (torch.empty_like(xo[0]), torch.empty_like(xo[1]))
        return xo, xs, yo, lambda: torch.complex(*yo)
    xo, xs = (x.real.T.contiguous(), x.imag.T.contiguous()), (batch, 1)
    yo = (torch.empty_like(xo[0]), torch.empty_like(xo[1]))
    return xo, xs, yo, lambda: torch.complex(*yo).T


@pytest.mark.parametrize("layout", ["complex", "bm", "nb"])
@pytest.mark.parametrize("n", [2, 3, 12, 97, 1000])
def test_plain_onepass_equals_the_chained_pair(n, layout):
    """The one-pass kernel's plain version and #17's then #18's, through a
    batch-major [2, batch * m] intermediate as the pair runs, agree bit for
    bit on the same strided operands, both directions."""
    batch = 5
    x = torch.from_numpy(_x((batch, n), 50 + n))
    for inverse in (False, True):
        bt = bl.device_bluestein_tables(n, inverse, "cpu")
        xo, xs, yo, out = _operands(x, layout)
        f = torch.empty(2, batch * bt.m)
        bl._fwd(xo, xs, (f[0], f[1]), (1, bt.m), batch, bt, plain=True)
        bl._inv((f[0], f[1]), (1, bt.m), yo, xs, batch, bt, plain=True)
        pair = out().clone()
        bl._onepass(xo, xs, yo, xs, batch, bt, plain=True)
        assert torch.equal(out(), pair)
        if layout == "nb":
            got = bl.plain_bluestein_onepass(xo[0], xo[1], inverse)
            assert torch.equal(torch.complex(*got).T, pair)


def test_fused_route_runs_the_onepass_plain_version(monkeypatch):
    """On the CPU the fused route (n = 1000) makes one call of the one-pass
    kernel's plain version per transform, through `bluestein_fft` and
    `fftlib.fft` alike."""
    from watfft_tpu_torch import fftlib
    calls = []
    real = bl._plain_onepass
    monkeypatch.setattr(bl, "_plain_onepass", lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.from_numpy(_x((3, 1000), 7))
    want = np.fft.fft(x.numpy().astype(np.complex128))
    assert _rel_to_max(bl.bluestein_fft(x).numpy(), want) <= MAX_REL
    assert calls == [(1000, 3)]
    assert _rel_to_max(fftlib.fft(x, device="cpu").numpy(), want) <= MAX_REL
    assert calls == [(1000, 3)] * 2


# -- the transform as a whole ------------------------------------------------------------

def _forms(x, inverse):
    """The port's three forms on the complex [b, n] x, as complex [b, n]."""
    xt = torch.from_numpy(x)
    re, im = xt.real.contiguous(), xt.imag.contiguous()
    return {"complex": bl.bluestein_fft(xt, inverse).numpy(),
            "bm": _c(*bl.bluestein_fft_bm(re, im, inverse)),
            "nb": _c(*bl.bluestein_fft_nb(re.T.contiguous(), im.T.contiguous(), inverse)).T}


def _jax(x, inverse):
    return _c(*jb.bluestein_fft_nb(_j(x.real.T), _j(x.imag.T), inverse=inverse)).T


@pytest.mark.parametrize("n", INTERPRET_SIZES)
def test_fft_matches_jax_fused_route(n, interpret):
    """At m <= 256 the JAX function takes its fused route (#17, #18 in
    interpret mode); the port's plain versions run its own plan."""
    x = _x((5, n), 10 + n)
    for inverse in (False, True):
        want = _jax(x, inverse)
        for form, got in _forms(x, inverse).items():
            assert _rel_to_max(got, want) <= JAX_LIMIT, form


@pytest.mark.parametrize("n", [1000, 4097, 10007])
def test_fft_matches_jax_xla_route(n, xla_route):
    """The JAX XLA route against the port's fused route (n = 1000) and its
    unfused route on the four-step kernels' plain version (m = 2^14, 2^15)."""
    assert (planner.bluestein_kernel(n, 3) == "bluestein-fused") == (n == 1000)
    x = _x((3, n), n)
    for inverse in (False, True):
        want = _jax(x, inverse)
        oracle = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128))
        assert _rel_to_max(want, oracle) <= MAX_REL
        for form, got in _forms(x, inverse).items():
            assert _rel_to_max(got, want) <= XLA_LIMIT, form
            assert _rel_to_max(got, oracle) <= MAX_REL, form


@pytest.mark.parametrize("n", [3, 12, 97, 360, 1000])
def test_fft_matches_reference_dft(n):
    """tests/test_fft_reference.py:93-107 for the port: the O(n^2) oracle,
    and the roundtrip."""
    rng = ref.seeded_rng(n)
    x = rng.uniform(-1, 1, (n, 2)) + 1j * rng.uniform(-1, 1, (n, 2))
    re, im = bl.bluestein_fft_nb(_t(x.real), _t(x.imag))
    expected = ref.dft(x, axis=0)
    assert _rel_to_max(_c(re, im), expected) < MAX_REL
    bre, bim = bl.bluestein_fft_nb(re, im, inverse=True)
    assert np.max(np.abs(_c(bre, bim) - x)) < ROUNDTRIP


def test_size_one_empty_batch_and_views():
    """n = 1 is the identity both ways; a batch of 0 runs nothing; a
    strided view and a lazy conj are read as their values."""
    x = torch.from_numpy(_x((4, 1), 1))
    assert torch.equal(bl.bluestein_fft(x), x) and torch.equal(bl.bluestein_fft(x, True), x)
    assert bl.bluestein_fft(torch.zeros(0, 7, dtype=torch.complex64)).shape == (0, 7)
    y = torch.from_numpy(_x((6, 12), 2))
    want = np.fft.fft(y.numpy().astype(np.complex128)[::2].conj())
    assert _rel_to_max(bl.bluestein_fft(y[::2].conj()).numpy(), want) <= MAX_REL
    with pytest.raises(ValueError, match="n >= 1"):
        bl.bluestein_fft(torch.zeros(3, 0, dtype=torch.complex64))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [12, 97])
def test_gradients_match_jax_vjp(n, inverse, xla_route):
    """The JAX custom VJP (n * IFFT for the forward, FFT / n for the
    inverse) against the port's autograd, on time-major planes."""
    b = 3
    x, g = _x((n, b), 20 + n), _x((n, b), 30 + n)
    _, vjp = jax.vjp(lambda a, c: jb.bluestein_fft_nb(a, c, inverse=inverse),
                     _j(x.real), _j(x.imag))
    want = _c(*vjp((_j(g.real), _j(g.imag))))
    xre, xim = _t(x.real).requires_grad_(), _t(x.imag).requires_grad_()
    yre, yim = bl.bluestein_fft_nb(xre, xim, inverse)
    got = _c(*torch.autograd.grad((yre, yim), (xre, xim), (_t(g.real), _t(g.imag))))
    assert _rel_to_max(got, want) <= XLA_LIMIT
    xc = torch.from_numpy(x.T.copy()).requires_grad_()
    bl.bluestein_fft(xc, inverse).backward(torch.from_numpy(g.T.copy()))
    assert _rel_to_max(xc.grad.numpy().T, want) <= XLA_LIMIT
