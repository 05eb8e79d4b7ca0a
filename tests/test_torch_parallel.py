"""The port's sharded faces (watfft_tpu_torch/parallel/) against the JAX
package's (watfft_tpu/parallel/) and the f64 oracle, on the CPU.

Eight gloo ranks, started once by `dryrun.spawn`, run every face of
`dryrun.faces` on their shards of seeded numpy inputs (the shapes of
tests/test_sharded.py and __graft_entry__._dryrun_body) and write their
output shards; the tests put the shards together and hold the global
outputs against the JAX functions on the 8-device virtual mesh
(tests/conftest.py), which run their CPU route as tests/test_sharded.py
runs them, and against numpy in float64. A world-size-1 gloo group in this
process holds each face against the port's single-device function. The
ranks run the kernels' plain versions (CPU tensors); the CUDA kernels and
NCCL are checked on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import watfft_tpu_torch as wtt
from watfft_tpu.parallel import large_sharded as jls
from watfft_tpu.parallel import real_sharded as jrs
from watfft_tpu.parallel import sharded as jsh
from watfft_tpu_torch import stft as wstft
from watfft_tpu_torch.parallel import dryrun
from watfft_tpu_torch.utils.tolerances import MAX_REL

WORLD = 8
SEED = 15
SIZES = dryrun.CPU_SIZES
# max |port - jax| / max |jax|: ulp-level, not bitwise (the JAX CPU route is
# the matmul four-step, the port's the Stockham stages)
JAX_LIMIT = 1e-6
# the JAX package's own limits (tests/test_sharded.py, _dryrun_body)
MESH_2D_REL = 1e-5
COMPLEX_ROUNDTRIP = 1e-4
REAL_ROUNDTRIP = 1e-5
GRAD_ATOL = 1e-3
# one rank hung or slow fails the fixture, not the suite's clock
SPAWN_TIMEOUT = 120.0

needs_devices = pytest.mark.skipif(jax.device_count() < WORLD,
                                   reason="needs 8 virtual devices")


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def inp():
    return dryrun.inputs(SIZES, SEED)


@pytest.fixture(scope="module")
def runs(inp, tmp_path_factory):
    """(the 8 ranks' global outputs, each rank's refusals, the JAX outputs):
    the ranks run in their processes while this one runs the JAX side."""
    out_dir = tmp_path_factory.mktemp("ranks")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(dryrun.spawn, WORLD, "gloo", "cpu", dryrun.rank_faces, SIZES, SEED,
                            str(out_dir), "cpu", timeout=SPAWN_TIMEOUT)
        jax_out = _jax_outputs(inp)
        said = ranks.result()
    shards = []
    for r in range(WORLD):
        with np.load(out_dir / f"rank{r}.npz") as f:
            shards.append(dict(f))
    return dryrun.assemble(shards), said, jax_out


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def refused(runs):
    return runs[1]


@pytest.fixture(scope="module")
def jax_out(runs):
    return runs[2]


def _jax_outputs(inp) -> dict:
    """The JAX package's faces on the same global inputs, keyed as the port's."""
    mesh = jsh.make_mesh(WORLD)
    out = {}

    def put(key, pair):
        out[key + ".re"], out[key + ".im"] = (np.asarray(t) for t in pair)

    put("fft_batch", jax.jit(lambda a, b: jsh.fft_batch_sharded(a, b, mesh))(
        inp["fft_batch.re"], inp["fft_batch.im"]))
    fft2 = jax.jit(lambda a, b, inv: jsh.fft2_sharded(a, b, mesh, inverse=inv),
                   static_argnums=2)
    for h, w in SIZES["fft2"]:
        key = f"fft2.{h}x{w}"
        re, im = fft2(inp[key + ".re"], inp[key + ".im"], False)
        put(key, (re, im))
        put(key + ".back", fft2(re, im, True))

    nb, nt = dryrun.mesh2_shape(WORLD)
    mesh2 = Mesh(np.array(jax.devices()[:WORLD]).reshape(nb, nt), ("b", "t"))
    sh = NamedSharding(mesh2, P("b", "t", None))
    put("mesh2", jax.jit(lambda a, b: jsh.fft2_sharded(a, b, mesh2, axis="t", batch_axis="b"))(
        jax.device_put(inp["mesh2.re"], sh), jax.device_put(inp["mesh2.im"], sh)))

    large = jax.jit(lambda a, b, inv: jls.fft_large_sharded(a, b, mesh, inverse=inv),
                    static_argnums=2)
    re, im = large(inp["large.re"], inp["large.im"], False)
    put("large", (re, im))
    put("large.back", large(re, im, True))
    put("large.inv", large(inp["large.spec.re"], inp["large.spec.im"], True))

    re, im = jax.jit(lambda a: jsh.rfft_batch_sharded(a, mesh))(inp["rbatch.x"])
    put("rbatch", (re, im))
    irfft = jax.jit(lambda a, b: jsh.irfft_batch_sharded(a, b, mesh))
    out["rbatch.back"] = np.asarray(irfft(re, im))
    out["irfft_batch.y"] = np.asarray(irfft(inp["irfft_batch.re"], inp["irfft_batch.im"]))

    def parseval(a):
        re, im = jsh.rfft_batch_sharded(a, mesh)
        m = a.shape[-1] // 2
        w = jnp.concatenate([jnp.ones(1), 2 * jnp.ones(m - 1), jnp.ones(1)])
        return jnp.sum(w * (re * re + im * im)) / a.shape[-1]

    out["rgrad.g"] = np.asarray(jax.jit(jax.grad(parseval))(jnp.asarray(inp["rgrad.x"])))
    h, w = SIZES["grad2"]

    def energy(a, b):
        re, im = jsh.fft2_sharded(a, b, mesh)
        return jnp.sum(re * re + im * im) / (h * w)

    gre, gim = jax.jit(jax.grad(energy, argnums=(0, 1)))(inp["grad2.re"], inp["grad2.im"])
    out["grad2.gre"], out["grad2.gim"] = np.asarray(gre), np.asarray(gim)
    h, w = SIZES["r2grad"]

    def parseval2(a):
        re, im = jrs.rfft2_sharded(a, mesh)
        wt = jnp.concatenate([jnp.ones(1), 2 * jnp.ones(w // 2 - 1), jnp.ones(1)])
        return jnp.sum(wt * (re * re + im * im)) / (h * w)

    out["r2grad.g"] = np.asarray(jax.jit(jax.grad(parseval2))(inp["r2grad.x"]))
    n = SIZES["lgrad"]

    def energy_large(a, b):
        re, im = jls.fft_large_sharded(a, b, mesh)
        return jnp.sum(re * re + im * im) / n

    gre, gim = jax.jit(jax.grad(energy_large, argnums=(0, 1)))(inp["lgrad.re"], inp["lgrad.im"])
    out["lgrad.gre"], out["lgrad.gim"] = np.asarray(gre), np.asarray(gim)

    re, im = jax.jit(lambda a: jrs.rfft_large_sharded(a, mesh))(inp["rlarge.x"])
    put("rlarge", (re, im))
    irfft_large = jax.jit(lambda a, b: jrs.irfft_large_sharded(a, b, mesh))
    out["rlarge.back"] = np.asarray(irfft_large(re, im))
    out["rlarge.inv"] = np.asarray(irfft_large(inp["rlarge.spec.re"], inp["rlarge.spec.im"]))
    rfft2 = jax.jit(lambda a: jrs.rfft2_sharded(a, mesh))
    irfft2 = jax.jit(lambda a, b: jrs.irfft2_sharded(a, b, mesh))
    for h, w in SIZES["rfft2"]:
        key = f"rfft2.{h}x{w}"
        re, im = rfft2(inp[key + ".x"])
        put(key, (re, im))
        out[key + ".back"] = np.asarray(irfft2(re, im))
        out[key + ".inv"] = np.asarray(irfft2(inp[key + ".spec.re"], inp[key + ".spec.im"]))
    _, _, n_fft, hop = SIZES["stft"]
    put("stft", jax.jit(lambda a: jrs.stft_sharded(a, mesh, n_fft=n_fft, hop=hop))(
        inp["stft.x"]))
    return out


KEYS = dryrun.output_keys(SIZES)
# the round trips ("back") run each side's inverse on its own forward's
# output: they are held against x (the oracle tests), the inverses against
# JAX on spectra of their own ("inv")
JAX_KEYS = [k for k in KEYS if ".back" not in k]


@needs_devices
@pytest.mark.parametrize("key", JAX_KEYS)
def test_eight_ranks_match_jax_mesh(key, port, jax_out):
    """Every output of the 8 gloo ranks, put together, against the JAX
    function on the 8-device mesh (the same inputs): the inverses on
    spectra whose DC and Nyquist bins have imaginary parts, which both
    read."""
    assert _rel(port[key], jax_out[key]) <= JAX_LIMIT


def _c(inp, key):
    return inp[key + ".re"].astype(np.float64) + 1j * inp[key + ".im"].astype(np.float64)


def _frames(x, n_fft, hop):
    num = (x.shape[-1] - n_fft) // hop + 1
    win = wstft.get_window("hann", n_fft, np.float64)
    return np.stack([x[:, j * hop:j * hop + n_fft] * win for j in range(num)], axis=1)


def _oracle_cases():
    """(name, output key, oracle(inp), limit, kind): kind "rel" is
    max |diff| / max |oracle|, "abs" max |diff| (round trips, gradients); a
    key with .re / .im outputs is held as one complex array."""
    f32 = MAX_REL["float32"]
    cases = [("fft_batch", "fft_batch", lambda i: np.fft.fft(_c(i, "fft_batch")), f32, "rel")]
    for h, w in SIZES["fft2"]:
        key = f"fft2.{h}x{w}"
        cases += [(key, key, lambda i, k=key: np.fft.fft2(_c(i, k)), MESH_2D_REL, "rel"),
                  (key + ".roundtrip", key + ".back", lambda i, k=key: _c(i, k),
                   COMPLEX_ROUNDTRIP, "abs")]
    cases += [
        ("mesh2", "mesh2", lambda i: np.fft.fft2(_c(i, "mesh2")), MESH_2D_REL, "rel"),
        ("large", "large", lambda i: np.fft.fft(_c(i, "large")), f32, "rel"),
        ("large.roundtrip", "large.back", lambda i: _c(i, "large"), COMPLEX_ROUNDTRIP, "abs"),
        ("rbatch", "rbatch", lambda i: np.fft.rfft(i["rbatch.x"].astype(np.float64)), f32,
         "rel"),
        ("rbatch.roundtrip", "rbatch.back", lambda i: i["rbatch.x"], REAL_ROUNDTRIP, "abs"),
        ("rgrad", "rgrad.g", lambda i: 2.0 * i["rgrad.x"], GRAD_ATOL, "abs"),
        ("grad2.re", "grad2.gre", lambda i: 2.0 * i["grad2.re"], GRAD_ATOL, "abs"),
        ("grad2.im", "grad2.gim", lambda i: 2.0 * i["grad2.im"], GRAD_ATOL, "abs"),
        ("r2grad", "r2grad.g", lambda i: 2.0 * i["r2grad.x"], GRAD_ATOL, "abs"),
        ("lgrad.re", "lgrad.gre", lambda i: 2.0 * i["lgrad.re"], GRAD_ATOL, "abs"),
        ("lgrad.im", "lgrad.gim", lambda i: 2.0 * i["lgrad.im"], GRAD_ATOL, "abs"),
        ("rlarge", "rlarge", lambda i: np.fft.rfft(i["rlarge.x"].astype(np.float64)), f32,
         "rel"),
        ("rlarge.roundtrip", "rlarge.back", lambda i: i["rlarge.x"], REAL_ROUNDTRIP, "abs"),
        ("stft", "stft", lambda i: np.fft.rfft(_frames(i["stft.x"].astype(np.float64),
                                                       *SIZES["stft"][2:]), axis=-1), f32,
         "rel"),
    ]
    for h, w in SIZES["rfft2"]:
        key = f"rfft2.{h}x{w}"
        cases += [(key, key, lambda i, k=key: np.fft.rfft2(i[k + ".x"].astype(np.float64)),
                   f32, "rel"),
                  (key + ".roundtrip", key + ".back", lambda i, k=key: i[k + ".x"],
                   REAL_ROUNDTRIP, "abs")]
    return cases


ORACLE = _oracle_cases()


def _get(out, key):
    return out[key + ".re"] + 1j * out[key + ".im"] if key + ".re" in out else out[key]


@pytest.mark.parametrize("name,key,oracle,limit,kind", ORACLE, ids=[c[0] for c in ORACLE])
def test_eight_ranks_match_f64_oracle(name, key, oracle, limit, kind, port, inp):
    """The 8 ranks' outputs against numpy in float64, at the JAX package's
    limits: MAX_REL for the 1D faces, 1e-5 for fft2 on the meshes, 1e-4
    and 1e-5 for complex and real round trips, 1e-3 for the gradients
    (2x, by Parseval; the large FFT's in its [n2, n1] blocks, flattened to
    x's order)."""
    want, got = oracle(inp), _get(port, key)
    err = _rel(got, want) if kind == "rel" else float(np.max(np.abs(got - want)))
    assert err < limit, err


# -- what the faces refuse, on every rank -------------------------------------------

REFUSALS = {"large_factors": "factors 128x4 must divide by mesh size 8",
            "rlarge_factors": "factors 128x4 must divide by mesh size 8",
            "fft2_width": "W=4 must divide by the mesh size 8",
            "rfft2_half_width": "W/2=4 must divide by mesh size 8",
            "batch_axis_without_batch": "batch_axis requires a leading batch dim"}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_eight_ranks_refuse(name, refused):
    """Factors the mesh size does not divide (N = 512 splits 128 x 4),
    W % D, (W/2) % D and a batch axis without a batch dim raise on every
    rank, before any collective."""
    assert [said[name] for said in refused] == [REFUSALS[name]] * WORLD


# -- world size 1 in this process: each face equals the single-device function --------

@pytest.fixture(scope="module")
def world1(inp):
    """`dryrun.faces` on a world-size-1 gloo group (an in-memory store)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        out = dryrun.faces(dryrun.make_mesh(device="cpu"), inp, SIZES)
    finally:
        dist.destroy_process_group()
    return dryrun.assemble([out])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(z):
    return {"re": z.real.numpy(), "im": z.imag.numpy()}


def _grad(fn, *xs):
    xs = [_t(x).requires_grad_(True) for x in xs]
    fn(*xs).backward()
    return [x.grad.numpy() for x in xs]


def _single(inp) -> dict:
    """The port's single-device functions (device="cpu") on the global
    inputs, keyed as the faces' outputs."""
    cpu = "cpu"
    out = {}

    def put(key, **parts):
        out.update({f"{key}.{k}": v for k, v in parts.items()})

    ctx = wtt.create_fft_f32(SIZES["fft_batch"][1], device=cpu)
    re, im = ctx.forward_planes(_t(inp["fft_batch.re"]), _t(inp["fft_batch.im"]))
    put("fft_batch", re=re.numpy(), im=im.numpy())
    for h, w in SIZES["fft2"]:
        key = f"fft2.{h}x{w}"
        z = wtt.fft2(_t(_c(inp, key).astype(np.complex64)), device=cpu)
        put(key, **_pair(z))
        put(key + ".back", **_pair(wtt.ifft2(z, device=cpu)))
    put("mesh2", **_pair(wtt.fft2(_t(_c(inp, "mesh2").astype(np.complex64)), device=cpu)))
    re, im = wtt.fft_large(_t(inp["large.re"]), _t(inp["large.im"]))
    put("large", re=re.numpy(), im=im.numpy())
    bre, bim = wtt.fft_large(re, im, inverse=True)
    put("large.back", re=bre.numpy(), im=bim.numpy())
    bre, bim = wtt.fft_large(_t(inp["large.spec.re"]), _t(inp["large.spec.im"]), inverse=True)
    put("large.inv", re=bre.numpy(), im=bim.numpy())
    rctx = wtt.create_rfft_f32(SIZES["rbatch"][1], device=cpu)
    re, im = rctx.forward_planes(_t(inp["rbatch.x"]))
    put("rbatch", re=re.numpy(), im=im.numpy(), back=rctx.inverse_planes(re, im).numpy())
    ictx = wtt.create_rfft_f32(SIZES["irfft_batch"][1], device=cpu)
    out["irfft_batch.y"] = ictx.inverse_planes(_t(inp["irfft_batch.re"]),
                                               _t(inp["irfft_batch.im"])).numpy()
    n = SIZES["rgrad"][1]
    gctx = wtt.create_rfft_f32(n, device=cpu)
    wt = torch.full((n // 2 + 1,), 2.0)
    wt[0] = wt[-1] = 1.0

    def parseval(x):
        re, im = gctx.forward_planes(x)
        return torch.sum(wt * (re * re + im * im)) / n

    out["rgrad.g"], = _grad(parseval, inp["rgrad.x"])
    h, w = SIZES["grad2"]

    def energy(a, b):
        z = wtt.fft2(torch.complex(a, b), device=cpu)
        return torch.sum(z.real * z.real + z.imag * z.imag) / (h * w)

    out["grad2.gre"], out["grad2.gim"] = _grad(energy, inp["grad2.re"], inp["grad2.im"])
    h, w = SIZES["r2grad"]
    wt2 = torch.full((w // 2 + 1,), 2.0)
    wt2[0] = wt2[-1] = 1.0

    def parseval2(x):
        z = wtt.rfft2(x, device=cpu)
        return torch.sum(wt2 * (z.real * z.real + z.imag * z.imag)) / (h * w)

    out["r2grad.g"], = _grad(parseval2, inp["r2grad.x"])
    n = SIZES["lgrad"]

    def energy_large(a, b):
        re, im = wtt.fft_large(a, b)
        return torch.sum(re * re + im * im) / n

    out["lgrad.gre"], out["lgrad.gim"] = _grad(energy_large, inp["lgrad.re"], inp["lgrad.im"])
    re, im = wtt.rfft_large_nb(_t(inp["rlarge.x"])[:, None])
    put("rlarge", re=re[:, 0].numpy(), im=im[:, 0].numpy(),
        back=wtt.irfft_large_nb(re, im)[:, 0].numpy(),
        inv=wtt.irfft_large_nb(_t(inp["rlarge.spec.re"])[:, None],
                               _t(inp["rlarge.spec.im"])[:, None])[:, 0].numpy())
    for h, w in SIZES["rfft2"]:
        key = f"rfft2.{h}x{w}"
        z = wtt.rfft2(_t(inp[key + ".x"]), device=cpu)
        spec = _t(_c(inp, key + ".spec").astype(np.complex64))
        put(key, **_pair(z), back=wtt.irfft2(z, device=cpu).numpy(),
            inv=wtt.irfft2(spec, device=cpu).numpy())
    _, _, n_fft, hop = SIZES["stft"]
    re, im = wstft.stft(_t(inp["stft.x"]), n_fft=n_fft, hop=hop, device=cpu)
    put("stft", re=re.numpy(), im=im.numpy())
    return out


@pytest.fixture(scope="module")
def single(inp):
    return _single(inp)


@pytest.mark.parametrize("key", KEYS)
def test_world1_equals_single_device(key, world1, single):
    """At world size 1 every face computes what the port's single-device
    function computes (within 1e-6 of its largest output: the 2D faces run
    rows then columns, `fft2` columns then rows; the large faces the "2d"
    mode)."""
    assert _rel(world1[key], single[key]) <= JAX_LIMIT

