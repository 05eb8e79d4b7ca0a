"""The port's 2D FFT path (watfft_tpu_torch/ops/fft2.py, api.fft2/ifft2/
rfft2/irfft2) against the JAX package's (watfft_tpu/ops/fft2.py) and the f64
oracle.

On the CPU the port's wrappers run each kernel's plain torch version on the
same strided views the CUDA kernels get; the JAX kernels run in Pallas
interpret mode (the FORCE_INTERPRET fixture, or direct interpret=True
calls), as the JAX package's own tests run them off the TPU. Inputs are made
with numpy from a seed and handed to both as float32. The CUDA kernels are
checked on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import watfft_tpu_torch as wtt
from watfft_tpu import config
from watfft_tpu.ops import fft2 as jf2
from watfft_tpu.ops import large as jl
from watfft_tpu.ops import pallas_stockham as jst
from watfft_tpu_torch import convert, planner
from watfft_tpu_torch.ops import fft2 as f2
from watfft_tpu_torch.reference import dft as ref
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


def _cx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)


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


# -- each kernel's plain version against the JAX kernel ----------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("h,w", [(2, 2), (4, 2), (8, 16), (32, 64)])
def test_cube_matches_jax(h, w, inverse):
    """#15 `_fft2_cube_kernel` on native [h, w, 128] planes."""
    xre, xim = _f32((h, w, 128), h), _f32((h, w, 128), w + 1)
    t1, t2 = jst._TwCache.get(h, inverse), jst._TwCache.get(w, inverse)
    want = _c(*jf2._fft2_cube_call(_j(xre), _j(xim), _j(t1[0]), _j(t1[1]), _j(t2[0]),
                                   _j(t2[1]), h, w, inverse, interpret=True))
    assert _rel_to_max(_c(*f2.fft2_cube(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT
    assert _rel_to_max(_c(*f2.plain_fft2_cube(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("h,w", [(8, 16), (4, 64)])
def test_k2_matches_jax(h, w, inverse):
    """#14 `_fft2_k2_kernel`: the w-axis pass of native [h, w, 128] planes."""
    xre, xim = _f32((h, w, 128), 3), _f32((h, w, 128), 4)
    twre, twim = jst._TwCache.get(w, inverse)
    want = _c(*jf2._fft2_k2_call(_j(xre), _j(xim), _j(twre), _j(twim), w, inverse, min(8, h),
                                 interpret=True))
    assert _rel_to_max(_c(*f2.fft2_k2(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT
    assert _rel_to_max(_c(*f2.plain_fft2_k2(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
def test_column_pass_matches_jax(inverse):
    """The column pass: #11 `_stage1_call` over h, as fft2.py:191 runs it."""
    h, w = 16, 8
    xre, xim = _f32((h, w, 128), 5), _f32((h, w, 128), 6)
    twre, twim = jst._TwCache.get(h, inverse)
    want = _c(*jl._stage1_call(_j(xre), _j(xim), _j(twre), _j(twim), h, inverse, min(16, w),
                               128, interpret=True))
    assert _rel_to_max(_c(*f2.fft2_cols(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT
    assert _rel_to_max(_c(*f2.plain_fft2_cols(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
def test_row_pass_matches_jax(inverse):
    """#16 `_rowfft_lanes_kernel`: the row FFT of [rows, w] planes."""
    rows, w = 256, 32
    xre, xim = _f32((rows, w), 7), _f32((rows, w), 8)
    twre, twim = jst._TwCache.get(w, inverse)
    want = _c(*jf2._rowfft_lanes_call(_j(xre), _j(xim), _j(twre), _j(twim), w, inverse,
                                      interpret=True))
    assert _rel_to_max(_c(*f2.fft2_rows(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT
    assert _rel_to_max(_c(*f2.plain_fft2_rows(_t(xre), _t(xim), inverse)), want) <= JAX_LIMIT


# -- the slice as a whole ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 128), (2, 64, 256), (1, 128, 512), (3, 8, 4)])
def test_fft2_planes_matches_jax_and_oracle(shape):
    x = _cx(shape, sum(shape))
    re, im = _t(x.real), _t(x.imag)
    for inverse in (False, True):
        want_jax = _c(*jf2.fft2_planes(_j(x.real), _j(x.imag), inverse=inverse))
        oracle = ref.dft2(x)
        if inverse:
            oracle = np.conj(ref.dft2(np.conj(x))) / (shape[-1] * shape[-2])
        got = {"planes": _c(*f2.fft2_planes(re, im, inverse)),
               "complex": f2.fft2_complex(_t(x), inverse).numpy(),
               "api": (wtt.ifft2 if inverse else wtt.fft2)(_t(x), device="cpu").numpy()}
        xn = np.moveaxis(x.reshape((-1,) + shape[-2:]), 0, -1)
        yn = _c(*wtt.fft2_nb(_t(xn.real), _t(xn.imag), inverse))
        got["native"] = np.moveaxis(yn, -1, 0).reshape(shape)
        for name, y in got.items():
            assert _rel_to_max(y, want_jax) <= JAX_LIMIT, name
            assert rel_errors(y, oracle)[0] <= MAX_REL["float32"], name
    back = wtt.ifft2(wtt.fft2(_t(x), device="cpu"), device="cpu").numpy()
    assert np.max(np.abs(back - x)) < ROUNDTRIP["float32"]


@pytest.mark.parametrize("shape", [(8, 8), (4, 16, 32), (2, 64, 256), (3, 8, 4)])
def test_rfft2_matches_jax(shape):
    """rfft2 / irfft2 against rfft2_planes / irfft2_planes, the inverse on a
    spectrum that is not Hermitian (the two agree on any spectrum)."""
    x = _f32(shape, sum(shape) + 1)
    want = _c(*jf2.rfft2_planes(_j(x)))
    got = {"planes": _c(*f2.rfft2_planes(_t(x))), "api": wtt.rfft2(_t(x), device="cpu").numpy()}
    for name, y in got.items():
        assert _rel_to_max(y, want) <= JAX_LIMIT, name
    assert rel_errors(got["planes"], np.fft.rfft2(x.astype(np.float64)))[0] <= MAX_REL["float32"]
    bins = shape[:-1] + (shape[-1] // 2 + 1,)
    sre, sim = _f32(bins, 11), _f32(bins, 12)
    want_inv = np.asarray(jf2.irfft2_planes(_j(sre), _j(sim)))
    assert _rel_to_max(f2.irfft2_planes(_t(sre), _t(sim)).numpy(), want_inv) <= JAX_LIMIT
    assert _rel_to_max(wtt.irfft2(_t(sre + 1j * sim), device="cpu").numpy(),
                       want_inv) <= JAX_LIMIT
    back = wtt.irfft2(wtt.rfft2(_t(x), device="cpu"), device="cpu").numpy()
    assert np.max(np.abs(back - x)) < ROUNDTRIP["float32"]


def test_herm2_matches_jax():
    """The 2D Hermitian recombination on planes of any content, both ways."""
    h, w = 8, 16
    zre, zim = _f32((3, h, w // 2), 21), _f32((3, h, w // 2), 22)
    want = jf2.herm2_post_nb(_j(zre), _j(zim), w, hax=-2, kax=-1)
    got = f2.herm2_post_nb(_t(zre), _t(zim), w, hax=-2, kax=-1)
    assert _rel_to_max(_c(*got), _c(*want)) <= JAX_LIMIT
    sre, sim = _f32((3, h, w // 2 + 1), 23), _f32((3, h, w // 2 + 1), 24)
    want = jf2.herm2_pre_nb(_j(sre), _j(sim), w, hax=-2, kax=-1)
    got = f2.herm2_pre_nb(_t(sre), _t(sim), w, hax=-2, kax=-1)
    assert _rel_to_max(_c(*got), _c(*want)) <= JAX_LIMIT


def test_parseval_gradient():
    """The loss of tests/test_fft2_large.py:90-112: grad of sum |fft2(z)|^2
    is 2*h*w*x (VJP(fft2) = h*w * ifft2)."""
    n = 128
    x, y = _t(_f32((n, n), 52)).requires_grad_(), _t(_f32((n, n), 53)).requires_grad_()
    r, i = f2.fft2_planes(x, y)
    (r * r + i * i).sum().backward()
    for g, v in ((x.grad, x), (y.grad, y)):
        np.testing.assert_allclose(g.numpy(), 2 * n * n * v.detach().numpy(),
                                   rtol=1e-4, atol=2 * n * n * 2e-6)


def test_rfft2_and_irfft2_gradients_match_jax():
    shape = (2, 16, 32)
    x = _f32(shape, 61)
    wgt = np.random.default_rng(62).uniform(0.5, 1.5, (16, 17)).astype(np.float32)

    def loss_jax(a):
        re, im = jf2.rfft2_planes(a)
        return jnp.sum(wgt * (re * re + im * im) + re)

    want = np.asarray(jax.grad(loss_jax)(_j(x)))
    xt = _t(x).requires_grad_()
    re, im = f2.rfft2_planes(xt)
    (_t(wgt) * (re * re + im * im) + re).sum().backward()
    assert _rel_to_max(xt.grad.numpy(), want) <= JAX_LIMIT

    sre, sim = _f32((2, 16, 17), 63), _f32((2, 16, 17), 64)
    v = _f32(shape, 65)

    def loss_inv(a, c):
        return jnp.sum(v * jf2.irfft2_planes(a, c))

    want_re, want_im = (np.asarray(g) for g in jax.grad(loss_inv, (0, 1))(_j(sre), _j(sim)))
    tre, tim = _t(sre).requires_grad_(), _t(sim).requires_grad_()
    (_t(v) * f2.irfft2_planes(tre, tim)).sum().backward()
    assert _rel_to_max(tre.grad.numpy(), want_re) <= JAX_LIMIT
    assert _rel_to_max(tim.grad.numpy(), want_im) <= JAX_LIMIT


@pytest.mark.parametrize("layout", ["complex", "native"])
def test_gradient_is_the_conjugate_transform(layout):
    """VJP(fft2) = h*w * ifft2 and VJP(ifft2) = fft2 / (h*w), in two layouts."""
    b, h, w = 3, 8, 32
    x, g = _cx((b, h, w), 71), _cx((b, h, w), 72)
    for inverse in (False, True):
        s = 1.0 / (h * w) if inverse else float(h * w)
        want = (np.fft.fft2 if inverse else np.fft.ifft2)(g.astype(np.complex128)) * s
        if layout == "complex":
            xt = _t(x).requires_grad_()
            (f2.fft2_complex(xt, inverse) * _t(g).conj()).real.sum().backward()
            got = xt.grad.numpy()
        else:
            xn, gn = (np.moveaxis(a, 0, -1) for a in (x, g))
            re, im = _t(xn.real).requires_grad_(), _t(xn.imag).requires_grad_()
            yre, yim = f2.fft2_nb(re, im, inverse)
            (yre * _t(gn.real) + yim * _t(gn.imag)).sum().backward()
            got = np.moveaxis(_c(re.grad, im.grad), -1, 0)
        assert rel_errors(got, want)[0] <= MAX_REL["float32"], inverse


def test_axes_route_matches_jax():
    """An axis over 4096 (8192 x 4): the large route on the h axis."""
    shape = (8192, 4)
    assert planner.fft2_kernel(*shape) == "fft2-axes"
    x = _cx(shape, 81)
    for inverse in (False, True):
        want = _c(*jf2.fft2_planes(_j(x.real), _j(x.imag), inverse=inverse))
        got = f2.fft2_complex(_t(x), inverse).numpy()
        assert _rel_to_max(got, want) <= JAX_LIMIT
        oracle = (np.fft.ifft2 if inverse else np.fft.fft2)(x.astype(np.complex128))
        assert rel_errors(got, oracle)[0] <= MAX_REL["float32"]


def test_axes_route_past_the_large_kernels(monkeypatch):
    """An axis past planner.LARGE_MAX_N runs the matmul surface, as the 1D
    route does (shown at a small size by lowering the limit)."""
    monkeypatch.setattr(planner, "LARGE_MAX_N", 4096)
    x = _cx((2, 4, 8192), 82)
    assert planner.c2c_kernel(8192, "float32") == "fourstep"
    oracle = np.fft.fft2(x.astype(np.complex128))
    assert rel_errors(f2.fft2_complex(_t(x)).numpy(), oracle)[0] <= MAX_REL["float32"]


@pytest.mark.parametrize("route", f2.ROUTES)
def test_routes_and_layouts_agree(route):
    """Each route in each layout (the cube's plain version is the two
    passes; the axes route's passes run the Stockham plan where the axis is
    at most 4096)."""
    b, h, w = 3, 16, 32
    x = _cx((b, h, w), 91)
    want = np.fft.fft2(x.astype(np.complex128))
    base = f2._complex_route(_t(x), False, route).numpy()
    assert rel_errors(base, want)[0] <= MAX_REL["float32"]
    planes = _c(*f2._planes_route(_t(x.real), _t(x.imag), False, route))
    xn = np.moveaxis(x, 0, -1)
    native = np.moveaxis(_c(*f2._nb_route(_t(xn.real), _t(xn.imag), False, route)), -1, 0)
    assert _rel_to_max(planes, base) == 0.0 and _rel_to_max(native, base) == 0.0
    assert _rel_to_max(f2.plain_fft2(_t(x)).numpy(), base) == 0.0


def test_planner_routes():
    route = planner.fft2_kernel
    assert route(2, 2) == "fft2-cube"
    assert route(128, 128) == "fft2-cube"
    assert route(8192, 2) == route(2, 8192) == "fft2-cube"
    assert route(256, 128) == "fft2-2pass"
    assert route(4096, 4096) == "fft2-2pass"
    assert route(8192, 4) == route(4, 8192) == "fft2-axes"
    # measured on the card: up to 64 images of 2^14 points the 2-pass route,
    # from 96 the cube
    least = planner.FFT2_CUBE_MIN_BATCH[1 << 14]
    assert route(128, 128, least) == route(16, 1024, 96) == "fft2-cube"
    assert route(128, 128, least - 1) == route(16, 1024, 1) == "fft2-2pass"
    assert route(128, 128, 64) == route(32, 512, 64) == "fft2-2pass"
    assert route(64, 64, 1) == route(8192, 2, 1) == "fft2-cube"
    # native [h, w, B] planes with one image per cube block: the 2-pass route
    assert route(64, 64, 1024, "nb") == route(128, 128, 1024, "nb") == "fft2-2pass"
    assert route(64, 64, 16, "nb") == route(32, 32, 1024, "nb") == "fft2-cube"
    assert route(2, 4096, 2048, "nb") == "fft2-cube"
    with pytest.raises(ValueError, match="power"):
        route(12, 8)
    with pytest.raises(ValueError, match="route must be one of"):
        f2._complex_route(torch.zeros(4, 4, dtype=torch.complex64), False, "cube")
    with pytest.raises(ValueError, match="h\\*w <="):
        f2._complex_route(torch.zeros(256, 128, dtype=torch.complex64), False, "fft2-cube")
    with pytest.raises(ValueError, match="h, w <="):
        f2._complex_route(torch.zeros(8192, 4, dtype=torch.complex64), False, "fft2-2pass")


@pytest.mark.parametrize("shape,match", [((8, 12), "power of two"), ((8, 1), "power of two"),
                                         ((8,), "2 trailing axes"), ((0, 8), "power of two")])
def test_validation_messages(shape, match):
    """The JAX package's messages, word for word (ops/fft2.py:35)."""
    with pytest.raises(ValueError, match=match) as port:
        f2.fft2_planes(torch.zeros(shape), torch.zeros(shape))
    with pytest.raises(ValueError, match=match) as jax_err:
        jf2.validate_fft2_shape(shape)
    assert str(port.value) == str(jax_err.value)


@pytest.mark.parametrize("shape,match", [((8, 12), "power of two"), ((8, 2), "w >= 4"),
                                         ((8,), "2 trailing axes")])
def test_rfft2_validation_messages(shape, match):
    """tests/test_fft2_large.py:115-122 on the port."""
    with pytest.raises(ValueError, match=match) as port:
        f2.rfft2_planes(torch.zeros(shape))
    with pytest.raises(ValueError, match=match) as jax_err:
        jf2.validate_rfft2_shape(shape)
    assert str(port.value) == str(jax_err.value)
    with pytest.raises(ValueError, match=match):
        wtt.rfft2(torch.zeros(shape), device="cpu")


def test_runs_on_jax_tables():
    """convert.tables_from_jax: the JAX _TwCache packs and plans for h and w."""
    h, w = 16, 32
    x = _cx((2, h, w), 101)
    for inverse in (False, True):
        tables = []
        for n in (h, w):
            twre, twim = jst._TwCache.get(n, inverse)
            tables.append(convert.tables_from_jax(jst.stage_plan(n),
                                                  jst.make_twiddle_pack(n, inverse)[2],
                                                  twre, twim))
        want = _c(*jf2.fft2_planes(_j(x.real), _j(x.imag), inverse=inverse))
        for route in ("fft2-cube", "fft2-2pass"):
            got = f2._complex_route(_t(x), inverse, route, tuple(tables)).numpy()
            assert _rel_to_max(got, want) <= JAX_LIMIT, route


def test_lazy_conj_view():
    x = _t(_cx((2, 8, 16), 111))
    want = np.fft.fft2(x.numpy().conj().astype(np.complex128))
    assert rel_errors(f2.fft2_complex(x.conj()).numpy(), want)[0] <= MAX_REL["float32"]
    assert rel_errors(wtt.fft2(x.conj(), device="cpu").numpy(), want)[0] <= MAX_REL["float32"]
