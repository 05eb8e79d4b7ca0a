"""#1's bf16 tiers in the port (watfft_tpu_torch/ops/stockham.py on bfloat16
planes) against the JAX package's (tests/test_bf16.py) and the f64 oracle.

The interop tier keeps bf16 planes around f32 stages; the compute tier
(config.BF16_COMPUTE, set on both packages' config) runs the stages in
bf16 on 2-D time-major planes. On the CPU the port runs the plain versions
(f32 `run_stages` between a widening and a rounding; `run_stages` on bf16
tensors with the codelet constants rounded to bf16), the JAX kernel runs in
Pallas interpret mode. Inputs are made with numpy from a seed.

Port against JAX: at most one bf16 ulp at the largest output (2^-7 of it).
Measured on this CPU: the compute tier bit-identical on the same plan (the
port's own plan where it is the JAX one, the JAX plan carried across by
`convert.bf16_tables_from_jax` where JAX overrides it, as at n = 1024); the
interop tier within 1.53e-3, where the f32 stages' roundings differ and
flip a bf16 rounding of the store. Against the oracle the bounds of
tests/test_bf16.py: < 3e-2 (interop) and < 5e-2 (compute); roundtrips
< 5e-2 and < 1e-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watfft_tpu import config as jconfig
from watfft_tpu.ops import pallas_stockham as jst
from watfft_tpu_torch import config, convert
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.reference import dft as ref

JAX_LIMIT = 2.0 ** -7


@pytest.fixture
def compute(monkeypatch):
    """The bf16 compute tier on, in both packages."""
    monkeypatch.setattr(jconfig, "BF16_COMPUTE", True)
    monkeypatch.setattr(config, "BF16_COMPUTE", True)


def _planes(shape, seed):
    """f32 planes from the seed, and their bf16 roundings for each package."""
    rng = np.random.default_rng(seed)
    xre = rng.uniform(-1, 1, shape).astype(np.float32)
    xim = rng.uniform(-1, 1, shape).astype(np.float32)
    port = (torch.from_numpy(xre).bfloat16(), torch.from_numpy(xim).bfloat16())
    jax_ = (jnp.asarray(xre, jnp.bfloat16), jnp.asarray(xim, jnp.bfloat16))
    return port, jax_


def _np(planes):
    """A pair of bf16 planes of either package as one complex128 array."""
    re, im = (np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else
                         t.astype(jnp.float32)).astype(np.float64) for t in planes)
    return re + 1j * im


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _dft_along(x, axis):
    """The f64 oracle's DFT of x along `axis`."""
    return np.moveaxis(ref.dft(np.moveaxis(x, axis, -1)), -1, axis)


# -- the interop tier ------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 256, 1024])
def test_interop_tier_matches_jax_and_the_oracle(n):
    port, jx = _planes((n, 128), seed=n)
    for inverse in (False, True):
        got = st.stockham_fft_nb(*port, inverse)
        assert got[0].dtype == got[1].dtype == torch.bfloat16
        want = jst.stockham_fft_nb(*jx, inverse)
        assert want[0].dtype == jnp.bfloat16
        assert _rel(_np(got), _np(want)) <= JAX_LIMIT
    x = _np(port)
    assert _rel(_np(st.stockham_fft_nb(*port)), _dft_along(x, 0)) < 3e-2


def test_interop_tier_roundtrip():
    port, _ = _planes((512, 256), seed=7)
    back = st.stockham_fft_nb(*st.stockham_fft_nb(*port), inverse=True)
    assert back[0].dtype == torch.bfloat16
    assert (back[0].float() - port[0].float()).abs().max().item() < 5e-2


@pytest.mark.parametrize("n", [16, 64])
def test_interop_tier_on_the_folded_view(n, compute):
    """The [n, 8, W] view takes the interop tier whatever BF16_COMPUTE says
    (_kernel_dma3d casts to f32), in both packages."""
    b = 1024
    port, jx = _planes((n, b), seed=n + 1)
    got = st.stockham_fft_nb(*(t.view(n, 8, b // 8) for t in port))
    want = jst.stockham_fft_nb(*(t.reshape(n, 8, b // 8) for t in jx))
    assert got[0].shape == (n, 8, b // 8) and got[0].dtype == torch.bfloat16
    g, w = _np(got).reshape(n, b), _np(want).reshape(n, b)
    assert _rel(g, w) <= JAX_LIMIT
    assert _rel(g, _dft_along(_np(port), 0)) < 3e-2
    # the same numbers as the interop tier on [n, b] planes
    config.BF16_COMPUTE = False
    flat = st.stockham_fft_nb(*port)
    assert torch.equal(got[0].reshape(n, b), flat[0])
    assert torch.equal(got[1].reshape(n, b), flat[1])


@pytest.mark.parametrize("inverse", [False, True])
def test_interop_tier_on_batch_major_planes(inverse, compute):
    """Batch-major planes take the interop tier whatever BF16_COMPUTE says
    (_kernel_bm casts to f32), in both packages."""
    n, b = 256, 64
    port, jx = _planes((b, n), seed=11)
    got = st.stockham_fft_bm(*port, inverse)
    want = jst.stockham_fft_bm(*jx, inverse)
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    assert _rel(_np(got), _np(want)) <= JAX_LIMIT
    x = _np(port)
    exp = ref.idft(x) if inverse else ref.dft(x)
    assert _rel(_np(got), exp) < 3e-2


# -- the compute tier ------------------------------------------------------------------

def _compute_tables(n, inverse):
    """The JAX plan and f32 pack of n, rounded to bf16 (its compute tier's)."""
    re, im, offsets = jst.make_twiddle_pack(n, inverse)
    return convert.bf16_tables_from_jax(jst.stage_plan(n), offsets, re, im)


@pytest.mark.parametrize("n,b", [(64, 128), (1024, 128), (64, 2048)])
def test_compute_tier_matches_jax_and_the_oracle(n, b, compute):
    port, jx = _planes((n, b), seed=n + b + 3)
    for inverse in (False, True):
        tables = _compute_tables(n, inverse)
        assert tables.dtype == torch.bfloat16
        got = st.stockham_fft_nb(*port, inverse, tables)
        want = jst.stockham_fft_nb(*jx, inverse)
        assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
        assert _rel(_np(got), _np(want)) <= JAX_LIMIT
    # the port's own tables: its own plan, against the oracle
    y = st.stockham_fft_nb(*port)
    assert y[0].dtype == torch.bfloat16
    assert _rel(_np(y), _dft_along(_np(port), 0)) < 5e-2
    back = st.stockham_fft_nb(*y, inverse=True)
    assert (back[0].float() - port[0].float()).abs().max().item() < 1e-1


def test_compute_tier_is_not_the_interop_tier(compute):
    """The switch changes the result of [n, b] planes (another tier), and
    the tables choose the tier when given."""
    port, _ = _planes((256, 128), seed=5)
    c = st.stockham_fft_nb(*port)
    config.BF16_COMPUTE = False
    i = st.stockham_fft_nb(*port)
    assert not torch.equal(c[0], i[0])
    t32 = st.device_tables(256, False, "cpu")
    t16 = st.device_tables(256, False, "cpu", torch.bfloat16)
    assert torch.equal(st.stockham_fft_nb(*port, tables=t32)[0], i[0])
    assert torch.equal(st.stockham_fft_nb(*port, tables=t16)[0], c[0])


# -- tables, refusals, gradients ---------------------------------------------------------

@pytest.mark.parametrize("n", [16, 64, 1024])
def test_compute_tables_are_the_jax_pack_rounded(n):
    """The port's own bf16 pack is its f32 pack rounded to bf16, as JAX casts
    its pack (pallas_stockham.py:409-411); carried across, the JAX pack."""
    for inverse in (False, True):
        own = st.device_tables(n, inverse, "cpu", torch.bfloat16)
        f32 = st.device_tables(n, inverse, "cpu")
        assert torch.equal(own.twre, f32.twre.bfloat16())
        assert torch.equal(own.twim, f32.twim.bfloat16())
        re, im, _ = jst.make_twiddle_pack(n, inverse)
        carried = _compute_tables(n, inverse)
        assert np.array_equal(carried.twre.float().numpy(),
                              np.asarray(jnp.asarray(re, jnp.bfloat16).astype(jnp.float32))
                              .reshape(-1))
        assert np.array_equal(carried.twim.float().numpy(),
                              np.asarray(jnp.asarray(im, jnp.bfloat16).astype(jnp.float32))
                              .reshape(-1))


def test_dtype_pairs():
    """bf16 planes take f32 (interop) or bf16 (compute) tables; f32 planes
    refuse bf16 tables and f64 planes f32 ones; the stages themselves run
    in the tables' dtype alone."""
    st.check_dtype(torch.float32, torch.bfloat16)
    st.check_dtype(torch.bfloat16, torch.bfloat16)
    for tables, data in ((torch.float64, torch.bfloat16), (torch.bfloat16, torch.float32),
                         (torch.float32, torch.float64)):
        with pytest.raises(TypeError):
            st.check_dtype(tables, data)
    t = st.device_tables(16, False, "cpu")
    x = torch.zeros(16, 2, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="precision"):
        st.run_stages(x, x, 16, False, t.offsets, t.stages, t.twre, t.twim)
    with pytest.raises(TypeError):
        st.stockham_fft_nb(torch.zeros(16, 2), torch.zeros(16, 2),
                           tables=st.device_tables(16, False, "cpu", torch.bfloat16))


@pytest.mark.parametrize("tier", ["interop", "compute"])
def test_backward_matches_jax(tier, monkeypatch):
    """The gradient is the conjugate transform on bf16 planes
    (_stockham_diff_bwd): n * IFFT of the cotangent, in the same tier."""
    if tier == "compute":
        monkeypatch.setattr(jconfig, "BF16_COMPUTE", True)
        monkeypatch.setattr(config, "BF16_COMPUTE", True)
    n, b = 64, 128
    port, jx = _planes((n, b), seed=17)
    gport, gjx = _planes((n, b), seed=18)
    xre, xim = (t.clone().requires_grad_() for t in port)
    yre, yim = st.stockham_fft_nb(xre, xim)
    torch.autograd.backward((yre, yim), gport)
    assert xre.grad.dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda a, c: jst.stockham_fft_nb(a, c), *jx)
    want = vjp(gjx)
    assert want[0].dtype == jnp.bfloat16
    got = _np((xre.grad, xim.grad))
    assert _rel(got, _np(want)) <= JAX_LIMIT
    assert _rel(got, n * ref.idft(_np(gport).T).T) < (5e-2 if tier == "compute" else 3e-2)


@pytest.mark.parametrize("tier", ["interop", "compute"])
def test_backward_runs_in_the_forward_tier(tier, monkeypatch):
    """Tables given to the forward pick its tier whatever BF16_COMPUTE says,
    and the gradient follows that tier: bf16 tables with the switch off give
    the compute tier's gradient, f32 tables with it on the interop tier's."""
    n, b = 64, 128
    port, _ = _planes((n, b), seed=19)
    gport, _ = _planes((n, b), seed=20)
    tdtype = torch.bfloat16 if tier == "compute" else torch.float32

    def grads(switch, tables):
        monkeypatch.setattr(config, "BF16_COMPUTE", switch)
        xre, xim = (t.clone().requires_grad_() for t in port)
        y = st.stockham_fft_nb(xre, xim, tables=tables)
        torch.autograd.backward(y, gport)
        return y, (xre.grad, xim.grad)

    given = grads(tier == "interop", st.device_tables(n, False, "cpu", tdtype))
    own = grads(tier == "compute", None)
    for got, want in zip(given, own):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    other = grads(tier == "interop", None)[1]
    assert not all(torch.equal(g, w) for g, w in zip(given[1], other))
