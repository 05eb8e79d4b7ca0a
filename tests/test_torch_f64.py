"""The port's f64 tier (create_fft / create_rfft, dtype="float64") against
the JAX package's (watfft_tpu/ops/doublefloat.py and the float64 contexts'
matmul surface) and the f64 oracle.

On the CPU the port's wrappers run the kernels' plain torch versions in
float64: the c2c tier `stockham.run_stages`, the real tier `plain_rfft`'s
arithmetic. The JAX df kernel (`_df_kernel`, hi/lo f32 pairs) runs in
Pallas interpret mode, as its own tests run it off the TPU, on the hi/lo
split of the same numpy inputs, and its outputs are merged back to f64.
The port runs the JAX plan (radix 4 plus a remainder of 2 off the TPU) on
the tables `convert.df_tables_from_jax` carries across. The FP64 CUDA
kernels are checked on the card (chip_smoke.py, tests/test_torch_cuda.py).

Limits: port against the JAX df kernel 1e-11 of the largest output (the df
tier itself measures ~1e-13..1e-14, docs/accuracy_snapshot.txt:122); both
against the oracle MAX_REL["float64"] = 1e-9; per bin n * 1e-10 and
roundtrips 1.5e-10 (utils/tolerances.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import watfft_tpu
import watfft_tpu_torch as wtt
from watfft_tpu.ops import doublefloat as df
from watfft_tpu_torch import convert, planner
from watfft_tpu_torch.ops import rfft as rf
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, PER_BIN, ROUNDTRIP

JAX_LIMIT = 1e-11      # max |port - jax| / max |jax|
TABLE_LIMIT = 2.0 ** -46
SAME_TRANSFORM = 1e-13
BATCH = 128            # the df kernel takes b % 128 == 0
C2C_N = [4, 8, 64, 256, 1024]
REAL_N = [16, 64, 512]


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _split(a):
    return tuple(jnp.asarray(p) for p in df.split_f64(np.asarray(a, np.float64)))


def _merge(hi, lo):
    return df.merge_f64(np.asarray(hi), np.asarray(lo))


# -- the c2c tier: the port's plain f64 stages against _df_kernel ------------------

@functools.cache
def _jax_c2c(n: int, inverse: bool):
    """Time-major complex128 input [n, BATCH] and the JAX df kernel's output."""
    rng = np.random.default_rng(1000 + 2 * n + inverse)
    x = rng.uniform(-1, 1, (n, BATCH)) + 1j * rng.uniform(-1, 1, (n, BATCH))
    o = df.df_fft_nb(*_split(x.real), *_split(x.imag), inverse=inverse)
    return x, _merge(o[0], o[1]) + 1j * _merge(o[2], o[3])


def _df_tables(n: int, inverse: bool):
    packed, offsets = df._df_twiddle_pack(n, inverse)
    return convert.df_tables_from_jax(df._df_stage_plan(n), packed, offsets, inverse)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", C2C_N)
def test_c2c_matches_the_jax_df_kernel(n, inverse):
    x, want = _jax_c2c(n, inverse)
    ore, oim = st.stockham_fft_nb(_t(x.real), _t(x.imag), inverse, _df_tables(n, inverse))
    assert ore.dtype == torch.float64
    got = ore.numpy() + 1j * oim.numpy()
    assert _rel(got, want) <= JAX_LIMIT
    exp = ref.idft(x, axis=0) if inverse else ref.dft(x, axis=0)
    assert rel_errors(got, exp)[0] <= MAX_REL["float64"]
    assert rel_errors(want, exp)[0] <= MAX_REL["float64"]
    # the port's own plan and f64 tables (radix 16) give the same transform
    own = st.stockham_fft_nb(_t(x.real), _t(x.imag), inverse)
    assert _rel(own[0].numpy() + 1j * own[1].numpy(), got) <= SAME_TRANSFORM


# -- the real tier: the port's plain fused f64 path against df_rfft_nb / df_irfft_nb --

@functools.cache
def _jax_real(n: int):
    """Time-major real input [n, BATCH], a Hermitian-valid spectrum
    [n/2+1, BATCH], and the JAX df tier's rfft and irfft of them."""
    rng = np.random.default_rng(2000 + n)
    x = rng.uniform(-1, 1, (n, BATCH))
    spec = np.fft.rfft(rng.uniform(-1, 1, (n, BATCH)), axis=0)
    f = df.df_rfft_nb(*_split(x))
    i = df.df_irfft_nb(*_split(spec.real), *_split(spec.imag))
    return x, spec, _merge(f[0], f[1]) + 1j * _merge(f[2], f[3]), _merge(i[0], i[1])


def _df_rtables(n: int, inverse: bool):
    m = n // 2
    packed, offsets = df._df_twiddle_pack(m, inverse)
    return convert.df_rtables_from_jax(df._df_stage_plan(m), packed, offsets,
                                       df._df_post_twiddles(n, inverse), inverse)


@pytest.mark.parametrize("n", REAL_N)
def test_real_matches_the_jax_df_tier(n):
    x, spec, want_f, want_i = _jax_real(n)
    ore, oim = rf.rfft_nb_fused(_t(x), _df_rtables(n, False))
    got_f = ore.numpy() + 1j * oim.numpy()
    got_i = rf.irfft_nb_fused(_t(spec.real), _t(spec.imag), _df_rtables(n, True)).numpy()
    assert _rel(got_f, want_f) <= JAX_LIMIT
    assert _rel(got_i, want_i) <= JAX_LIMIT
    for f, i in ((got_f, got_i), (want_f, want_i)):
        assert rel_errors(f, ref.real_dft(x, axis=0))[0] <= MAX_REL["float64"]
        assert rel_errors(i, ref.real_idft(spec, n, axis=0))[0] <= MAX_REL["float64"]
    own_f = rf.rfft_nb_fused(_t(x))
    own_i = rf.irfft_nb_fused(_t(spec.real), _t(spec.imag))
    assert _rel(own_f[0].numpy() + 1j * own_f[1].numpy(), got_f) <= SAME_TRANSFORM
    assert _rel(own_i.numpy(), got_i) <= SAME_TRANSFORM


# -- the tables carried across ----------------------------------------------------

def _close_tables(got: torch.Tensor, want: np.ndarray) -> bool:
    got = got.numpy()
    return bool(np.all(np.abs(got - want) <= TABLE_LIMIT * np.abs(want)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2, 8, 64, 1024, 4096])
def test_df_tables_from_jax_equal_the_ports_f64_pack(n, inverse):
    t = _df_tables(n, inverse)
    assert t.dtype == torch.float64 and t.stages == tuple(df._df_stage_plan(n))
    re, im, offsets = st.make_twiddle_pack(n, inverse, np.float64, df._df_stage_plan(n))
    assert t.offsets == tuple(offsets)
    assert _close_tables(t.twre, re.reshape(-1)) and _close_tables(t.twim, im.reshape(-1))
    packed, offsets = df._df_twiddle_pack(n, inverse)
    if n > 2:  # a one-stage plan has no twiddles, so no direction to check
        with pytest.raises(ValueError, match="not"):
            convert.df_tables_from_jax(df._df_stage_plan(n), packed, offsets, not inverse)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [8, 64, 8192])
def test_df_rtables_from_jax_equal_the_ports_f64_tables(n, inverse):
    rt = _df_rtables(n, inverse)
    assert rt.dtype == torch.float64 and rt.n == n and rt.inverse == inverse
    wre, wim = rf.rfft_post_twiddles(n, inverse, np.float64)
    assert _close_tables(rt.wre, wre) and _close_tables(rt.wim, wim)
    m = n // 2
    re, im, _ = st.make_twiddle_pack(m, inverse, np.float64, df._df_stage_plan(m))
    assert _close_tables(rt.core.twre, re.reshape(-1))
    assert _close_tables(rt.core.twim, im.reshape(-1))
    rng = np.random.default_rng(n)
    if inverse:
        spec = np.fft.rfft(rng.uniform(-1, 1, (3, n)))
        got = rf.irfft(_t(spec), tables=rt)
        assert _rel(got.numpy(), rf.irfft(_t(spec)).numpy()) <= SAME_TRANSFORM
    else:
        x = _t(rng.uniform(-1, 1, (3, n)))
        assert _rel(rf.rfft(x, tables=rt).numpy(), rf.rfft(x).numpy()) <= SAME_TRANSFORM


# -- the matmul surface against the JAX float64 contexts ------------------------------

def _planes(shape, seed, complex_=True):
    rng = np.random.default_rng(seed)
    re = rng.uniform(-1, 1, shape)
    return (re, rng.uniform(-1, 1, shape)) if complex_ else re


@pytest.mark.parametrize("inverse", [False, True])
def test_c2c_matmul_surface_matches_jax(inverse):
    n = 8192
    assert planner.c2c_kernel(n, "float64") == "fourstep"
    xre, xim = _planes((2, n), 7)
    jctx = watfft_tpu.FFTContext(n, "float64")
    ctx = wtt.create_fft(n, device="cpu")
    jfn = jctx.inverse_planes_fourstep if inverse else jctx.forward_planes_fourstep
    fn = ctx.inverse_planes_fourstep if inverse else ctx.forward_planes_fourstep
    want = [np.asarray(a) for a in jfn(jnp.asarray(xre), jnp.asarray(xim))]
    got = fn(_t(xre), _t(xim))
    assert got[0].dtype == torch.float64
    assert _rel(got[0].numpy() + 1j * got[1].numpy(), want[0] + 1j * want[1]) <= MAX_REL["float64"]
    # the planner's route runs the same surface
    via = (ctx.inverse_planes if inverse else ctx.forward_planes)(_t(xre), _t(xim))
    assert torch.equal(via[0], got[0]) and torch.equal(via[1], got[1])


def test_real_matmul_surface_matches_jax():
    n = 16384
    assert planner.r2c_kernel(n, "float64") == "fourstep"
    x = _planes((2, n), 8, complex_=False)
    spec = np.fft.rfft(_planes((2, n), 9, complex_=False))
    jctx = watfft_tpu.RFFTContext(n, "float64")
    ctx = wtt.create_rfft(n, device="cpu")
    want_f = [np.asarray(a) for a in jctx.forward_planes_fourstep(jnp.asarray(x))]
    want_i = np.asarray(jctx.inverse_planes_fourstep(jnp.asarray(spec.real),
                                                     jnp.asarray(spec.imag)))
    got_f = ctx.forward_planes_fourstep(_t(x))
    got_i = ctx.inverse_planes_fourstep(_t(spec.real), _t(spec.imag))
    assert _rel(got_f[0].numpy() + 1j * got_f[1].numpy(),
                want_f[0] + 1j * want_f[1]) <= MAX_REL["float64"]
    assert _rel(got_i.numpy(), want_i) <= MAX_REL["float64"]
    assert rel_errors(got_f[0].numpy() + 1j * got_f[1].numpy(),
                      np.fft.rfft(x))[0] <= MAX_REL["float64"]
    assert rel_errors(got_i.numpy(), np.fft.irfft(spec, n))[0] <= MAX_REL["float64"]
    # the planner's route: every entry point on the same surface
    assert torch.equal(ctx.forward(_t(x)), torch.complex(*got_f))
    assert torch.equal(ctx.inverse(_t(spec)), got_i)


def test_f32_real_matmul_surface_matches_jax():
    n = 64
    x = _planes((3, n), 10, complex_=False).astype(np.float32)
    spec = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
    jctx = watfft_tpu.create_rfft_f32(n)
    ctx = wtt.create_rfft_f32(n, device="cpu")
    want_f = [np.asarray(a) for a in jctx.forward_planes_fourstep(jnp.asarray(x))]
    got_f = ctx.forward_planes_fourstep(_t(x))
    assert got_f[0].dtype == torch.float32
    assert _rel(got_f[0].numpy() + 1j * got_f[1].numpy(),
                want_f[0] + 1j * want_f[1]) <= MAX_REL["float32"]
    want_i = np.asarray(jctx.inverse_planes_fourstep(jnp.asarray(spec.real),
                                                     jnp.asarray(spec.imag)))
    got_i = ctx.inverse_planes_fourstep(_t(spec.real), _t(spec.imag))
    assert _rel(got_i.numpy(), want_i) <= MAX_REL["float32"]
    assert planner.r2c_kernel(1 << 26, "float32") == "fourstep"


# -- per bin and roundtrips through every entry point, under the f64 model -----------

def _c2c_forms(ctx):
    """(forward, inverse) pairs on complex128 [b, n] of every entry point."""
    def planes(f):
        return lambda z: torch.complex(*f(z.real, z.imag))

    def nb(f):
        return lambda z: torch.complex(*f(z.real.T.contiguous(), z.imag.T.contiguous())).T
    return {"complex": (ctx.forward, ctx.inverse),
            "planes": (planes(ctx.forward_planes), planes(ctx.inverse_planes)),
            "planes_nb": (nb(ctx.forward_planes_nb), nb(ctx.inverse_planes_nb)),
            "fourstep": (planes(ctx.forward_planes_fourstep),
                         planes(ctx.inverse_planes_fourstep))}


def _real_forms(ctx):
    """(forward, inverse) pairs on float64 [b, n] <-> complex128 [b, n/2+1]."""
    def inv_planes(f):
        return lambda s: f(s.real, s.imag)
    return {"complex": (ctx.forward, ctx.inverse),
            "planes": (lambda x: torch.complex(*ctx.forward_planes(x)),
                       inv_planes(ctx.inverse_planes)),
            "planes_nb": (lambda x: torch.complex(*ctx.forward_planes_nb(x.T.contiguous())).T,
                          lambda s: ctx.inverse_planes_nb(s.real.T.contiguous(),
                                                          s.imag.T.contiguous()).T),
            "fourstep": (lambda x: torch.complex(*ctx.forward_planes_fourstep(x)),
                         inv_planes(ctx.inverse_planes_fourstep))}


@pytest.mark.parametrize("n", [64, 1024])
def test_c2c_per_bin_and_roundtrip_every_entry_point(n):
    ctx = wtt.create_fft(n, device="cpu")
    t = torch.arange(n, dtype=torch.float64)
    basis = torch.exp(2j * torch.pi * torch.outer(t, t) / n)     # row k: bin k
    eye = n * torch.eye(n, dtype=torch.complex128)
    x = torch.complex(*(_t(p) for p in _planes((3, n), n)))
    for name, (fwd, inv) in _c2c_forms(ctx).items():
        y = fwd(basis)
        assert y.dtype == torch.complex128, name
        assert (y - eye).abs().max().item() < PER_BIN["float64"](n), name
        assert (inv(fwd(x)) - x).abs().max().item() < ROUNDTRIP["float64"], name
        assert rel_errors(fwd(x).numpy(), ref.dft(x.numpy()))[0] <= MAX_REL["float64"], name


@pytest.mark.parametrize("n", [64, 1024])
def test_real_per_bin_and_roundtrip_every_entry_point(n):
    ctx = wtt.create_rfft(n, device="cpu")
    m = n // 2
    t = torch.arange(n, dtype=torch.float64)
    k = torch.arange(m + 1, dtype=torch.float64)
    basis = torch.cos(2 * torch.pi * torch.outer(k, t) / n)       # row k: bin k
    want = torch.diag(torch.full((m + 1,), n / 2, dtype=torch.float64)).to(torch.complex128)
    want[0, 0] = want[m, m] = n
    x = _t(_planes((3, n), n + 1, complex_=False))
    for name, (fwd, inv) in _real_forms(ctx).items():
        y = fwd(basis)
        assert y.dtype == torch.complex128, name
        assert (y - want).abs().max().item() < PER_BIN["float64"](n), name
        assert (inv(fwd(x)) - x).abs().max().item() < ROUNDTRIP["float64"], name


def test_folded_view_runs_the_hybrid_in_f64():
    """The time-major view [n, 8, W] takes the hybrid route (the c2c stages
    through strides, the Hermitian post/pre in torch), in float64 too."""
    n = 256
    ctx = wtt.create_rfft(n, device="cpu")
    x = _t(_planes((n, 8, 2), 12, complex_=False))
    re, im = ctx.forward_planes_nb(x)
    assert re.shape == (n // 2 + 1, 8, 2) and re.dtype == torch.float64
    want = np.fft.rfft(x.numpy(), axis=0)
    assert rel_errors(re.numpy() + 1j * im.numpy(), want)[0] <= MAX_REL["float64"]
    assert (ctx.inverse_planes_nb(re, im) - x).abs().max().item() < ROUNDTRIP["float64"]


# -- gradients, the one-shot dtype= and the dtype trap ---------------------------------

@pytest.mark.parametrize("n", [8, 32])      # one stage; two, with twiddles
def test_gradcheck_f64_contexts(n):
    ctx, rctx = wtt.create_fft(n, device="cpu"), wtt.create_rfft(n, device="cpu")
    rng = np.random.default_rng(n)
    x = torch.complex(_t(rng.uniform(-1, 1, (2, n))), _t(rng.uniform(-1, 1, (2, n))))
    xr = _t(rng.uniform(-1, 1, (2, n)))
    spec = torch.fft.rfft(_t(rng.uniform(-1, 1, (2, n))))
    assert torch.autograd.gradcheck(ctx.forward, (x.requires_grad_(),))
    assert torch.autograd.gradcheck(ctx.inverse, (x,))
    assert torch.autograd.gradcheck(lambda a, b: ctx.forward_planes_nb(a, b),
                                    (x.real.T.contiguous().requires_grad_(),
                                     x.imag.T.contiguous().requires_grad_()))
    assert torch.autograd.gradcheck(rctx.forward, (xr.requires_grad_(),))
    assert torch.autograd.gradcheck(rctx.inverse, (spec.requires_grad_(),))
    assert torch.autograd.gradcheck(rctx.forward_planes_fourstep, (xr,))


def test_one_shot_functions_take_dtype():
    rng = np.random.default_rng(5)
    x = torch.complex(_t(rng.uniform(-1, 1, (2, 256))), _t(rng.uniform(-1, 1, (2, 256))))
    y = wtt.fft(x, dtype="float64", device="cpu")
    assert y.dtype == torch.complex128
    assert rel_errors(y.numpy(), ref.dft(x.numpy()))[0] <= MAX_REL["float64"]
    assert (wtt.ifft(y, dtype="float64", device="cpu") - x).abs().max() < ROUNDTRIP["float64"]
    assert wtt.fft(x, device="cpu").dtype == torch.complex64     # float32 by default
    xr = x.real.contiguous()
    s = wtt.rfft(xr, dtype="float64", device="cpu")
    assert s.dtype == torch.complex128
    assert (wtt.irfft(s, dtype="float64", device="cpu") - xr).abs().max() < ROUNDTRIP["float64"]
    assert wtt.create_fft(16, device="cpu").dtype == wtt.create_rfft(16, device="cpu").dtype \
        == "float64"


def test_tables_of_another_precision_raise():
    n = 64
    x64 = torch.zeros(n, 3, dtype=torch.float64)
    x32 = x64.float()
    t32, t64 = st.device_tables(n, False, "cpu"), st.device_tables(n, False, "cpu", torch.float64)
    for x, t in ((x64, t32), (x32, t64)):
        with pytest.raises(TypeError, match="precision"):
            st.stockham_fft_nb(x, x, tables=t)
        with pytest.raises(TypeError, match="precision"):
            st.run_stages(x, x, n, False, t.offsets, t.stages, t.twre, t.twim)
        with pytest.raises(TypeError, match="precision"):
            st.stockham_fft(torch.complex(x, x).T, tables=t)
    r32 = rf.device_rtables(n, False, "cpu")
    r64 = rf.device_rtables(n, False, "cpu", torch.float64)
    for x, rt in ((x64, r32), (x32, r64)):
        with pytest.raises(TypeError, match="precision"):
            rf.rfft_nb_fused(x, rt)
        with pytest.raises(TypeError, match="precision"):
            rf.rfft_nb(x, rt)
