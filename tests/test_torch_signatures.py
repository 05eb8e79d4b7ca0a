"""The port's public functions take the JAX package's parameter names.

For every public function of every module pair (a function the JAX module
defines, jitted ones included, and that the port's module of the same role
also has), the port's parameters start with the JAX function's names in
their order, leaving out the TPU tiling arguments (`tbk`, `tbj`,
`three_d`, `fold_scale`) and Pallas's `interpret`; the port may add its own
after them (`tables=`). So a caller moving from the JAX package with
keyword arguments gets the same function. Then each function whose names
were repaired is called with the JAX keywords on seeded inputs and held
against the JAX function on the same inputs (its module's tests' limit).
JAX runs on the CPU, the Pallas kernels in interpret mode.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watfft_tpu import config as jconfig

# (port module, JAX module) of the same role, under each package's root
PAIRS = [("", ""), ("api", "api"), ("fftlib", "fftlib"), ("plan", "plan"),
         ("planner", "planner"), ("stft", "stft"), ("config", "config"),
         ("ops.stockham", "ops.pallas_stockham"), ("ops.rfft", "ops.pallas_rfft"),
         ("ops.fourstep", "ops.fourstep"), ("ops.fourstep", "ops.rfft"),
         ("ops.large", "ops.large"), ("ops.fft2", "ops.fft2"),
         ("ops.bluestein", "ops.bluestein"), ("ops.mxu_dft", "ops.mxu_dft"),
         ("parallel.sharded", "parallel.sharded"),
         ("parallel.large_sharded", "parallel.large_sharded"),
         ("parallel.real_sharded", "parallel.real_sharded"),
         ("reference.dft", "reference.dft"), ("utils.accuracy", "utils.accuracy"),
         ("utils.tolerances", "utils.tolerances"), ("registry", "registry"),
         ("native", "native")]
TPU_ONLY = {"tbk", "tbj", "three_d", "fold_scale", "interpret"}
# max |port - jax| / max |jax|, the limit of the modules' own tests
JAX_LIMIT = 1e-6


def _module(root: str, name: str):
    return importlib.import_module(root + ("." + name if name else ""))


def _cases():
    out = []
    for port_name, jax_name in PAIRS:
        jm = _module("watfft_tpu", jax_name)
        pm = _module("watfft_tpu_torch", port_name)
        for name, f in vars(jm).items():
            if name.startswith("_") or inspect.isclass(f) or not callable(f):
                continue
            if getattr(inspect.unwrap(f), "__module__", None) != jm.__name__:
                continue  # imported from elsewhere: checked in its own module
            if callable(getattr(pm, name, None)) and not inspect.isclass(getattr(pm, name)):
                out.append(pytest.param(port_name, jax_name, name,
                                        id=f"{port_name or 'pkg'}.{name}"))
    return out


@pytest.mark.parametrize("port_name,jax_name,name", _cases())
def test_port_takes_the_jax_parameter_names(port_name, jax_name, name):
    jf = getattr(_module("watfft_tpu", jax_name), name)
    pf = getattr(_module("watfft_tpu_torch", port_name), name)
    want = [p for p in inspect.signature(jf).parameters if p not in TPU_ONLY]
    got = list(inspect.signature(pf).parameters)
    assert got[:len(want)] == want, f"port {got}, JAX {want}"


def test_every_repaired_function_is_among_the_cases():
    ids = {p.id for p in _cases()}
    for case in ("ops.stockham.stockham_fft_nb", "ops.stockham.stockham_fft_bm",
                 "ops.fft2.fft2_planes", "ops.fft2.fft2_nb", "ops.large.fft_large_nb",
                 "ops.large.fft_large", "ops.fourstep.apply_tables",
                 "ops.fourstep.fft_planes", "ops.fourstep.rfft_planes",
                 "ops.fourstep.irfft_planes"):
        assert case in ids, case


# -- the repaired functions, called with the JAX keywords ---------------------------

def _cx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _rel_to_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_planes_with_jax_keywords(inverse):
    from watfft_tpu.ops import pallas_stockham as jst
    from watfft_tpu_torch.ops import stockham as st
    x = _cx((64, 128), seed=1)  # time-major [n, b]
    want = _c(*jst.stockham_fft_nb(xre=_j(x.real), xim=_j(x.imag), inverse=inverse))
    got = _c(*st.stockham_fft_nb(xre=_t(x.real), xim=_t(x.imag), inverse=inverse))
    assert _rel_to_max(got, want) <= JAX_LIMIT
    xb = x.T.copy()  # batch-major [b, n]
    want = _c(*jst.stockham_fft_bm(xre=_j(xb.real), xim=_j(xb.imag), inverse=inverse))
    got = _c(*st.stockham_fft_bm(xre=_t(xb.real), xim=_t(xb.imag), inverse=inverse))
    assert _rel_to_max(got, want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
def test_fft2_with_jax_keywords(inverse):
    from watfft_tpu.ops import fft2 as jf2
    from watfft_tpu_torch.ops import fft2 as f2
    x = _cx((2, 64, 128), seed=2)
    want = _c(*jf2.fft2_planes(xre=_j(x.real), xim=_j(x.imag), inverse=inverse))
    got = _c(*f2.fft2_planes(xre=_t(x.real), xim=_t(x.imag), inverse=inverse))
    assert _rel_to_max(got, want) <= JAX_LIMIT
    xn = _cx((32, 64, 128), seed=3)  # native [h, w, B]
    want = _c(*jf2.fft2_nb(xre=_j(xn.real), xim=_j(xn.imag), inverse=inverse))
    got = _c(*f2.fft2_nb(xre=_t(xn.real), xim=_t(xn.imag), inverse=inverse))
    assert _rel_to_max(got, want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
def test_large_with_jax_keywords(inverse, monkeypatch):
    from watfft_tpu.ops import large as jl
    from watfft_tpu_torch.ops import large as lg
    monkeypatch.setattr(jconfig, "FORCE_INTERPRET", True)
    n = 1 << 14
    x = _cx((n, 2), seed=4)
    want = _c(*jl.fft_large_nb(xre=_j(x.real), xim=_j(x.imag), inverse=inverse))
    got = _c(*lg.fft_large_nb(xre=_t(x.real), xim=_t(x.imag), inverse=inverse))
    assert _rel_to_max(got, want) <= JAX_LIMIT
    want = _c(*jl.fft_large(xre=_j(x.real[:, 0]), xim=_j(x.imag[:, 0]), inverse=inverse))
    got = _c(*lg.fft_large(xre=_t(x.real[:, 0]), xim=_t(x.imag[:, 0]), inverse=inverse))
    assert _rel_to_max(got, want) <= JAX_LIMIT


@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_with_jax_keywords(inverse):
    from watfft_tpu import plan as jplan
    from watfft_tpu.ops import fourstep as jfs
    from watfft_tpu_torch import plan
    from watfft_tpu_torch.ops import fourstep as fs
    n = 4096
    x = _cx((3, n), seed=5)
    jtree = jplan.build_tree(n, inverse=inverse, dtype=np.float32)
    tree = plan.build_tree(n, inverse=inverse, dtype=np.float32)
    want = _c(*jfs.apply_tables(xre=_j(x.real), xim=_j(x.imag), tables=jfs.fft_tables(jtree),
                                shape_info=jfs._shape_of(jtree)))
    got = _c(*fs.apply_tables(xre=_t(x.real), xim=_t(x.imag), tables=fs.fft_tables(tree),
                              shape_info=fs.shape_info(tree)))
    assert _rel_to_max(got, want) <= JAX_LIMIT
    want = _c(*jfs.fft_planes(xre=_j(x.real), xim=_j(x.imag), inverse=inverse, dtype=None))
    got = _c(*fs.fft_planes(xre=_t(x.real), xim=_t(x.imag), inverse=inverse, dtype=None))
    assert _rel_to_max(got, want) <= JAX_LIMIT


def test_fourstep_fft_planes_dtype():
    """dtype= sets the tables' dtype; f32 planes on float64 tables run in
    float64, as jnp's promotion runs them under x64."""
    from watfft_tpu.ops import fourstep as jfs
    from watfft_tpu_torch.ops import fourstep as fs
    x = _cx((2, 256), seed=6)
    want = jfs.fft_planes(xre=_j(x.real), xim=_j(x.imag), dtype=np.float64)
    got = fs.fft_planes(xre=_t(x.real), xim=_t(x.imag), dtype=np.float64)
    assert got[0].dtype == torch.float64 and str(want[0].dtype) == "float64"
    assert _rel_to_max(_c(*got), _c(*want)) <= 1e-12
    exact = np.fft.fft(x.astype(np.complex128))
    assert _rel_to_max(_c(*got), exact) <= 1e-12


def test_real_fourstep_with_jax_keywords():
    from watfft_tpu import plan as jplan
    from watfft_tpu.ops import fourstep as jfs
    from watfft_tpu.ops import rfft as jrf
    from watfft_tpu_torch import plan
    from watfft_tpu_torch.ops import fourstep as fs
    n = 2048
    x = np.random.default_rng(7).uniform(-1, 1, (3, n)).astype(np.float32)
    jf, pf = (jplan.build_tree(n // 2, inverse=False, dtype=np.float32),
              plan.build_tree(n // 2, inverse=False, dtype=np.float32))
    jw = jrf.rfft_post_twiddles(n, False)
    pw = fs.rfft_post_twiddles(n, False)
    want = _c(*jrf.rfft_planes(x=_j(x), tables=jfs.fft_tables(jf), shape_info=jfs._shape_of(jf),
                               wre=_j(jw[0]), wim=_j(jw[1])))
    got = _c(*fs.rfft_planes(x=_t(x), tables=fs.fft_tables(pf), shape_info=fs.shape_info(pf),
                             wre=_t(pw[0]), wim=_t(pw[1])))
    assert _rel_to_max(got, want) <= JAX_LIMIT
    ji, pi = (jplan.build_tree(n // 2, inverse=True, dtype=np.float32),
              plan.build_tree(n // 2, inverse=True, dtype=np.float32))
    jw = jrf.rfft_post_twiddles(n, True)
    pw = fs.rfft_post_twiddles(n, True)
    spec = want.astype(np.complex64)
    want = np.asarray(jrf.irfft_planes(
        xre=_j(spec.real), xim=_j(spec.imag), inv_tables=jfs.fft_tables(ji),
        inv_shape_info=jfs._shape_of(ji), wre=_j(jw[0]), wim=_j(jw[1])))
    got = fs.irfft_planes(xre=_t(spec.real), xim=_t(spec.imag), inv_tables=fs.fft_tables(pi),
                          inv_shape_info=fs.shape_info(pi), wre=_t(pw[0]), wim=_t(pw[1]))
    assert _rel_to_max(got.numpy(), want) <= JAX_LIMIT
