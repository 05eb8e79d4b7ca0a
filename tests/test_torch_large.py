"""The port's large-N four-step path (watfft_tpu_torch/ops/large.py, the
large routes of FFTContext / RFFTContext, stockham_fft_nb_postmul) against
the JAX package's (watfft_tpu/ops/large.py) and the f64 oracle.

On the CPU the port's wrappers run each kernel's plain torch version on the
same strided views the CUDA kernels get; the JAX kernels run in Pallas
interpret mode, as the JAX package's own tests run them off the TPU. Inputs
are made with numpy from a seed and handed to both as float32. The oracle
at these sizes is numpy's FFT in float64 (the O(n^2) DFT of
reference/dft.py is too slow at n = 2^14). The CUDA kernels are checked on
the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import watfft_tpu_torch as wtt
from watfft_tpu import config
from watfft_tpu.ops import large as jl
from watfft_tpu.ops import pallas_stockham as jst
from watfft_tpu_torch import convert, planner
from watfft_tpu_torch.ops import large as lg
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, ROUNDTRIP

# max |port - jax| / max |jax|: ulp-level, not bitwise (FMA contraction and
# XLA's fusion differ from torch's op-by-op rounding)
JAX_LIMIT = 1e-6


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(config, "FORCE_INTERPRET", True)


def _f32(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _rel_to_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


# -- tables and planner ----------------------------------------------------------

def test_large_split_matches_jax():
    for k in range(13, 27):
        assert lg.large_split(1 << k) == jl.large_split(1 << k)


@pytest.mark.parametrize("n", [1 << 13, 1 << 14, 1 << 17, 1 << 20])
def test_twiddle_grid_bit_equal_to_jax(n):
    n1, n2 = lg.large_split(n)
    for inverse in (False, True):
        got = lg.pm_grid(n, n1, n2, inverse)
        want = jl._TwCache.get(n, n1, n2, inverse)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape == (n2, n1)
            assert np.array_equal(g, w)
        lt = lg.device_large_tables(n, inverse, "cpu")
        assert np.array_equal(lt.pmre.numpy(), want[0].reshape(-1))
        assert np.array_equal(lt.pmim.numpy(), want[1].reshape(-1))


def test_planner_routes_large_sizes():
    c2c = planner.c2c_kernel
    assert c2c(4096, "float32") == "stockham"
    assert c2c(8192, "float32") == "large-cube"
    assert c2c(8192, "float32", batch=1) == "large-cube"
    assert c2c(8192, "float32", batch=16, time_major=True) == "large-pipe2"
    assert c2c(8192, "float32", batch=1, time_major=True) == "large-cube"
    assert c2c(1 << 14, "float32", batch=1) == "large-cube"       # the cube at every batch
    assert c2c(1 << 14, "float32", batch=1024) == "large-cube"
    assert c2c(1 << 14, "float32", batch=2, time_major=True) == "large-cube"
    assert c2c(1 << 14, "float32", batch=3, time_major=True) == "large-pipe2"
    assert planner.large_mode(4096, batch=1024) == "pipe2"  # the cube takes n >= 8192
    assert c2c(1 << 15, "float32", batch=1024) == "large-pipe2"
    assert c2c(1 << 24, "float32", batch=1) == "large-pipe2"
    assert c2c(1 << 25, "float32") == "fourstep"
    r2c = planner.r2c_kernel
    for direction in ("forward", "inverse"):
        assert r2c(4096, "float32", direction) == "rfft-fused"
        assert r2c(8192, "float32", direction) == "rfft-fused"
        for k in (14, 15, 24, 25):
            assert r2c(1 << k, "float32", direction) == "rfft-large"
    # past the large route: the real matmul surface; float64 takes the
    # matmul surface past the FP64 Stockham kernel
    assert r2c(1 << 26, "float32") == "fourstep"
    assert c2c(1 << 14, "float64") == "fourstep"


def test_bad_split_and_mode_raise():
    x = torch.zeros(2, 8192, dtype=torch.complex64)
    with pytest.raises(ValueError, match="split"):
        lg.fft_large_complex(x, split=(64, 64))
    with pytest.raises(ValueError, match="split"):
        lg.fft_large_complex(x, split=(8192, 1))
    with pytest.raises(ValueError, match="mode"):
        lg.fft_large_complex(x, mode="cubes")


# -- each kernel's plain version against the JAX kernel --------------------------

N1, N2, B = 16, 8, 128


@pytest.mark.parametrize("inverse", [False, True])
def test_stage1_matches_jax(inverse):
    """#11 `_stage1_kernel` on [n2, n1, b] blocks."""
    xre, xim = _f32((N2, N1, B), 1), _f32((N2, N1, B), 2)
    twre, twim = jst._TwCache.get(N2, inverse)
    want = _c(*jl._stage1_call(_j(xre), _j(xim), _j(twre), _j(twim), N2, inverse, N1, 128,
                               interpret=True))
    assert _rel_to_max(_c(*lg.stage1(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
def test_stage2_matches_jax(inverse):
    """#13 `_stage2_kernel`: twiddle in the load, transpose, n1-point FFT."""
    cre, cim = _f32((N2, N1, B), 3), _f32((N2, N1, B), 4)
    pmre, pmim = jl._TwCache.get(N1 * N2, N1, N2, inverse)
    twre, twim = jst._TwCache.get(N1, inverse)
    want = _c(*jl._stage2_call(_j(cre), _j(cim), _j(pmre), _j(pmim), _j(twre), _j(twim),
                               N1, N2, inverse, 8, 128, interpret=True))
    got = _c(*lg.stage2(_t(cre), _t(cim), inverse))
    assert got.shape == (N1, N2, B)
    assert _rel_to_max(got, want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
def test_cube_matches_jax(inverse):
    """#12 `_cube_kernel`: the whole four-step on [n2, n1, 128] (on the CPU
    the cube's plain version: stage 1 then stage 2)."""
    xre, xim = _f32((N2, N1, B), 5), _f32((N2, N1, B), 6)
    pmre, pmim = jl._TwCache.get(N1 * N2, N1, N2, inverse)
    s1, s2 = jst._TwCache.get(N2, inverse), jst._TwCache.get(N1, inverse)
    want = _c(*jl._cube_call(_j(xre), _j(xim), _j(pmre), _j(pmim), _j(s1[0]), _j(s1[1]),
                             _j(s2[0]), _j(s2[1]), N1, N2, inverse, interpret=True))
    got = _c(*lg.cube(_t(xre), _t(xim), inverse))
    assert _rel_to_max(got, want) <= JAX_LIMIT
    assert _rel_to_max(_c(*lg.plain_stage2(*lg.plain_stage1(_t(xre), _t(xim), inverse),
                                           inverse)), want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
def test_postmul_matches_jax(inverse):
    """#3 `_kernel_postmul`: the stages, then the multiply in the store."""
    n, b = 256, 128
    xre, xim, pre, pim = (_f32((n, b), s) for s in range(7, 11))
    want = _c(*jst.stockham_fft_nb_postmul(_j(xre), _j(xim), _j(pre), _j(pim), inverse=inverse))
    got = st.stockham_fft_nb_postmul(_t(xre), _t(xim), _t(pre), _t(pim), inverse)
    assert _rel_to_max(_c(*got), want) <= JAX_LIMIT
    plain = st.plain_postmul(_t(xre), _t(xim), _t(pre), _t(pim), inverse)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))


# -- the slice as a whole ----------------------------------------------------------

def _jax_large_nb(x, inverse):
    """JAX fft_large_nb on time-major planes of the complex [b, n] x."""
    return _c(*jl.fft_large_nb(_j(x.real.T.astype(np.float32)),
                               _j(x.imag.T.astype(np.float32)), inverse=inverse)).T


def _complex_input(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)


def _entry_points(ctx, x, inverse):
    """Every FFTContext entry point on x [b, n], as complex [b, n] arrays."""
    xt = _t(x)
    re, im = _t(x.real), _t(x.imag)
    f = ctx.inverse if inverse else ctx.forward
    fp = ctx.inverse_planes if inverse else ctx.forward_planes
    fn = ctx.inverse_planes_nb if inverse else ctx.forward_planes_nb
    return {"complex": f(xt).numpy(), "planes": _c(*fp(re, im)),
            "planes_nb": _c(*fn(re.T, im.T)).T}


@pytest.mark.parametrize("n", [1 << 13, 1 << 14])
def test_context_matches_jax_and_oracle(n):
    x = _complex_input((2, n), seed=n)
    ctx = wtt.create_fft_f32(n, device="cpu")
    x128 = x.astype(np.complex128)
    for inverse in (False, True):
        want_jax = _jax_large_nb(x, inverse)
        oracle = np.fft.ifft(x128) if inverse else np.fft.fft(x128)
        got = _entry_points(ctx, x, inverse)
        for mode in lg.MODES:
            got[mode] = _c(*lg.fft_large_nb(_t(x.real.T), _t(x.imag.T), inverse,
                                            mode=mode)).T
        for name, y in got.items():
            assert _rel_to_max(y, want_jax) <= JAX_LIMIT, name
            assert rel_errors(y, oracle)[0] <= MAX_REL["float32"], name
    back = ctx.inverse(ctx.forward(_t(x))).numpy()
    assert np.max(np.abs(back - x)) < ROUNDTRIP["float32"]


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_batches_jax_refuses(batch):
    """Batch 3 and 5 (the JAX path takes powers of two) against the oracle,
    in every mode and layout; batch 1 through the flat fft_large."""
    n = 1 << 13
    x = _complex_input((batch, n), seed=batch)
    want = np.fft.fft(x.astype(np.complex128))
    for mode in lg.MODES:
        y = lg.fft_large_complex(_t(x), mode=mode).numpy()
        assert rel_errors(y, want)[0] <= MAX_REL["float32"], mode
        yb = _c(*lg.fft_large_bm(_t(x.real), _t(x.imag), mode=mode))
        assert _rel_to_max(yb, y) == 0.0
    if batch == 1:
        flat = _c(*wtt.fft_large(_t(x.real[0]), _t(x.imag[0])))
        assert rel_errors(flat, want[0])[0] <= MAX_REL["float32"]


def test_fft_large_matches_jax():
    n = 1 << 14
    x = _complex_input((n,), seed=21)
    for inverse in (False, True):
        want = _c(*jl.fft_large(_j(x.real), _j(x.imag), inverse=inverse))
        got = _c(*lg.fft_large(_t(x.real), _t(x.imag), inverse))
        assert _rel_to_max(got, want) <= JAX_LIMIT


def test_other_split_order():
    """The split's other order gives the same transform."""
    n = 1 << 15
    x = _complex_input((2, n), seed=22)
    n1, n2 = lg.large_split(n)
    a = lg.fft_large_complex(_t(x)).numpy()
    b = lg.fft_large_complex(_t(x), split=(n2, n1)).numpy()
    assert (n1, n2) == (128, 256)
    assert rel_errors(b, np.fft.fft(x.astype(np.complex128)))[0] <= MAX_REL["float32"]
    assert _rel_to_max(b, a) <= JAX_LIMIT


def test_real_context_matches_jax():
    n, b = 1 << 14, 2
    x = _f32((b, n), seed=31)
    ctx = wtt.create_rfft_f32(n, device="cpu")
    want = _c(*jl.rfft_large_nb(_j(x.T))).T
    got = {"complex": ctx.forward(_t(x)).numpy(), "planes": _c(*ctx.forward_planes(_t(x))),
           "planes_nb": _c(*ctx.forward_planes_nb(_t(x.T))).T,
           "module_nb": _c(*wtt.rfft_large_nb(_t(x.T))).T}
    for name, y in got.items():
        assert _rel_to_max(y, want) <= JAX_LIMIT, name
    assert rel_errors(got["complex"], np.fft.rfft(x.astype(np.float64)))[0] <= MAX_REL["float32"]
    # the inverse on spectra whose DC and Nyquist rows have imaginary parts
    sre, sim = _f32((b, n // 2 + 1), 32), _f32((b, n // 2 + 1), 33)
    want_inv = np.asarray(jl.irfft_large_nb(_j(sre.T), _j(sim.T))).T
    got_inv = {"complex": ctx.inverse(_t(sre + 1j * sim)).numpy(),
               "planes": ctx.inverse_planes(_t(sre), _t(sim)).numpy(),
               "planes_nb": ctx.inverse_planes_nb(_t(sre.T), _t(sim.T)).numpy().T,
               "module_nb": wtt.irfft_large_nb(_t(sre.T), _t(sim.T)).numpy().T}
    for name, y in got_inv.items():
        assert _rel_to_max(y, want_inv) <= JAX_LIMIT, name
    back = ctx.inverse(ctx.forward(_t(x))).numpy()
    assert np.max(np.abs(back - x)) < ROUNDTRIP["float32"]


def test_real_gradients_match_jax_custom_vjp():
    """rfft_large_nb / irfft_large_nb gradients against the JAX package's
    custom VJPs (the loss of tests/test_fft2_large.py:280)."""
    n, b = 1 << 14, 2
    x = _f32((n, b), seed=41)
    w = np.random.default_rng(42).uniform(0.5, 1.5, (n // 2 + 1, 1)).astype(np.float32)

    def loss_jax(a):
        re, im = jl.rfft_large_nb(a)
        return jnp.sum(w * (re * re + im * im))

    want = np.asarray(jax.grad(loss_jax)(_j(x)))
    xt = _t(x).requires_grad_()
    re, im = wtt.rfft_large_nb(xt)
    (torch.from_numpy(w) * (re * re + im * im)).sum().backward()
    assert _rel_to_max(xt.grad.numpy(), want) <= MAX_REL["float32"]

    sre, sim = _f32((n // 2 + 1, b), 43), _f32((n // 2 + 1, b), 44)
    v = _f32((n, b), 45)

    def loss_inv(a, c):
        return jnp.sum(v * jl.irfft_large_nb(a, c))

    want_re, want_im = (np.asarray(g) for g in jax.grad(loss_inv, (0, 1))(_j(sre), _j(sim)))
    tre, tim = _t(sre).requires_grad_(), _t(sim).requires_grad_()
    (_t(v) * wtt.irfft_large_nb(tre, tim)).sum().backward()
    assert _rel_to_max(tre.grad.numpy(), want_re) <= JAX_LIMIT
    assert _rel_to_max(tim.grad.numpy(), want_im) <= JAX_LIMIT


def test_c2c_gradient_is_the_conjugate_transform():
    """The c2c gradient against jax.grad of the same loss through jnp.fft,
    in each layout."""
    n, b = 1 << 13, 2
    x = _complex_input((b, n), seed=51)
    g = _complex_input((b, n), seed=52)

    def loss_jax(re, im):
        z = jnp.fft.fft(jax.lax.complex(re, im))
        return jnp.sum(z.real * g.real + z.imag * g.imag)

    want_re, want_im = (np.asarray(a) for a in jax.grad(loss_jax, (0, 1))(
        _j(x.real.astype(np.float64)), _j(x.imag.astype(np.float64))))
    xt = _t(x).requires_grad_()
    (lg.fft_large_complex(xt) * _t(g).conj()).real.sum().backward()
    assert _rel_to_max(_c(xt.grad.real, xt.grad.imag), want_re + 1j * want_im) <= JAX_LIMIT
    re, im = _t(x.real.T).requires_grad_(), _t(x.imag.T).requires_grad_()
    yre, yim = lg.fft_large_nb(re, im, mode="2d")
    (yre * _t(g.real.T) + yim * _t(g.imag.T)).sum().backward()
    assert _rel_to_max(_c(re.grad, im.grad).T, want_re + 1j * want_im) <= JAX_LIMIT


def test_runs_on_jax_tables():
    """convert.large_tables_from_jax: the JAX package's grid and stage packs."""
    n = 1 << 14
    n1, n2 = jl.large_split(n)
    x = _complex_input((2, n), seed=61)
    for inverse in (False, True):
        packs = []
        for f in (n2, n1):
            twre, twim, offsets = jst.make_twiddle_pack(f, inverse)
            packs += [jst.stage_plan(f), offsets, twre, twim]
        tables = convert.large_tables_from_jax(*jl._TwCache.get(n, n1, n2, inverse), *packs,
                                               inverse=inverse)
        got = lg.fft_large_complex(_t(x), inverse, tables=tables).numpy()
        assert _rel_to_max(got, _jax_large_nb(x, inverse)) <= JAX_LIMIT


def test_lazy_conj_views():
    """The wrappers resolve lazy conj bits before reading storage."""
    n = 1 << 13
    x = _t(_complex_input((2, n), seed=71))
    want = np.fft.fft(x.numpy().conj().astype(np.complex128))
    assert rel_errors(lg.fft_large_complex(x.conj()).numpy(), want)[0] <= MAX_REL["float32"]
