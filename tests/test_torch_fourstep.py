"""The port's matmul surface (watfft_tpu_torch/plan.py, ops/fourstep.py,
FFTContext.forward_planes_fourstep and the planner's "fourstep" route)
against the JAX package's (watfft_tpu/plan.py, watfft_tpu/ops/fourstep.py)
and the f64 oracle, on the CPU. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import watfft_tpu_torch as wtt
from watfft_tpu import plan as jplan
from watfft_tpu.ops import fourstep as jfs
from watfft_tpu_torch import plan, planner
from watfft_tpu_torch.ops import fourstep
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, ROUNDTRIP

# max |port - jax| / max |jax|: both are f32 matmuls, summed in other orders
JAX_LIMIT = 1e-6


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)


def _rel_to_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("n", [2, 128, 256, 4096, 1 << 16])
def test_tree_and_tables_bit_equal_to_jax(n):
    assert plan.DIRECT_MAX == jplan.DIRECT_MAX
    assert plan.factorize(n) == jplan.factorize(n)
    for inverse in (False, True):
        got = plan.build_tree(n, inverse=inverse)
        want = jplan.build_tree(n, inverse=inverse)
        levels = list(zip(got.leaves(), want.leaves()))
        assert len(levels) == len(list(want.leaves()))
        for g, w in levels:
            assert (g.n, g.n1, g.n2) == (w.n, w.n1, w.n2)
            for name in ("w_re", "w_im", "tw_re", "tw_im"):
                a, b = getattr(g, name), getattr(w, name)
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == b.dtype and np.array_equal(a, b), name
        for tg, tw in zip(fourstep.fft_tables(got), jfs.fft_tables(want)):
            assert tg.keys() == tw.keys()
            for key in tg:
                assert np.array_equal(tg[key].numpy(), np.asarray(tw[key])), key
    tg = plan.twiddle_grid(8, 32, -1.0)
    assert all(np.array_equal(a, b) for a, b in zip(tg, jplan.twiddle_grid(8, 32, -1.0)))
    dm = plan.dft_matrix(16, 1.0, np.float32, 0.5)
    assert all(np.array_equal(a, b) for a, b in zip(dm, jplan.dft_matrix(16, 1.0, np.float32, 0.5)))


@pytest.mark.parametrize("n", [256, 4096])
def test_forward_planes_fourstep_matches_jax(n):
    x = _x((3, n), seed=n)
    ctx = wtt.create_fft_f32(n, device="cpu")
    for inverse in (False, True):
        want = jfs.fft_planes(jnp.asarray(x.real), jnp.asarray(x.imag), inverse=inverse)
        f = ctx.inverse_planes_fourstep if inverse else ctx.forward_planes_fourstep
        got = f(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
        assert _rel_to_max(torch.complex(*got).numpy(),
                           np.asarray(want[0]) + 1j * np.asarray(want[1])) <= JAX_LIMIT
        oracle = ref.idft(x) if inverse else ref.dft(x)
        assert rel_errors(torch.complex(*got).numpy(), oracle)[0] <= MAX_REL["float32"]
        one = fourstep.fft_planes(torch.from_numpy(x.real.copy()),
                                  torch.from_numpy(x.imag.copy()), inverse)
        assert all(torch.equal(a, b) for a, b in zip(one, got))


def test_fourstep_route_serves_every_entry_point(monkeypatch):
    """Past LARGE_MAX_N the planner routes to the matmul surface; lowered
    here so that n = 8192 takes the route."""
    monkeypatch.setattr(planner, "LARGE_MAX_N", 4096)
    n = 8192
    assert planner.c2c_kernel(n, "float32") == "fourstep"
    ctx = wtt.create_fft_f32(n, device="cpu")
    x = _x((2, n), seed=1)
    want = np.fft.fft(x.astype(np.complex128))
    xt = torch.from_numpy(x)
    re, im = xt.real.contiguous(), xt.imag.contiguous()
    got = {"complex": ctx.forward(xt).numpy(),
           "planes": torch.complex(*ctx.forward_planes(re, im)).numpy(),
           "planes_nb": torch.complex(*ctx.forward_planes_nb(re.T, im.T)).T.numpy()}
    for name, y in got.items():
        assert rel_errors(y, want)[0] <= MAX_REL["float32"], name
    back = ctx.inverse(ctx.forward(xt)).numpy()
    assert np.max(np.abs(back - x)) < ROUNDTRIP["float32"]
    bre, bim = ctx.inverse_planes_nb(*ctx.forward_planes_nb(re.T, im.T))
    assert np.max(np.abs(torch.complex(bre, bim).T.numpy() - x)) < ROUNDTRIP["float32"]


def test_full_f32_scopes_the_matmul_setting():
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with fourstep.full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
        x = _x((2, 256), seed=2)
        got = fourstep.fft_planes(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
        assert torch.get_float32_matmul_precision() == "high"
        assert rel_errors(torch.complex(*got).numpy(), ref.dft(x))[0] <= MAX_REL["float32"]
    finally:
        torch.set_float32_matmul_precision(prev)


def test_precision_ladder_scopes_and_restores_the_callers_setting(monkeypatch):
    """config.MXU_PRECISION: "default" runs the matmul surface with TF32 on,
    "highest" with it off, and the caller's own setting, either one, comes
    back after the call."""
    from watfft_tpu_torch import config

    def setting():
        return torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    seen = []
    real = fourstep._apply
    monkeypatch.setattr(fourstep, "_apply", lambda *a: seen.append(setting()) or real(*a))
    x = _x((2, 256), seed=4)
    planes = (torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
    prev = setting()
    try:
        for caller in ("highest", "high"):
            torch.set_float32_matmul_precision(caller)
            before = setting()
            for ladder, inside in (("default", ("high", True)), ("highest", ("highest", False))):
                monkeypatch.setattr(config, "MXU_PRECISION", ladder)
                seen.clear()
                got = fourstep.fft_planes(*planes)
                assert seen and set(seen) == {inside}
                assert setting() == before
                assert rel_errors(torch.complex(*got).numpy(), ref.dft(x))[0] < 1e-2
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


def test_fourstep_gradient_flows():
    """The matmul surface is differentiable by autograd: the gradient of
    sum(Re(X * conj(g))) is n * ifft(g)."""
    n = 256
    x = torch.from_numpy(_x((2, n), seed=3))
    g = torch.from_numpy(_x((2, n), seed=4))
    re, im = x.real.clone().requires_grad_(), x.imag.clone().requires_grad_()
    ctx = wtt.create_fft_f32(n, device="cpu")
    yre, yim = ctx.forward_planes_fourstep(re, im)
    (yre * g.real + yim * g.imag).sum().backward()
    want = np.fft.ifft(g.numpy().astype(np.complex128)) * n
    assert rel_errors(torch.complex(re.grad, im.grad).numpy(), want)[0] <= MAX_REL["float32"]
