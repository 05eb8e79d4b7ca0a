"""Every sharded face once, and the launcher that starts the ranks.

The port of the faces of `__graft_entry__._dryrun_body`: `faces(mesh,
inputs)` runs each sharded function of this package once on this rank's
shards of global inputs (the batch FFT, the 2D FFT and its inverse, the 2D
FFT on the (D/2, 2) mesh with a batch axis, the large FFT and its inverse,
the real batch FFT, its inverse on a spectrum whose DC and Nyquist bins
have imaginary parts, the large real FFT and its inverse, the 2D real FFT
and its inverse, the STFT, and four gradients: the 2D FFT's energy, whose
gradient is 2x, the real batch FFT's and the 2D real FFT's
Parseval-weighted energies and the large FFT's energy, 2x each). `inputs(sizes, seed)` makes the global inputs with numpy, the same on
every rank; `assemble` puts the ranks' output shards back into global
arrays. `spawn` starts the ranks of a process group and runs a function
in each; `rank_faces` is the rank body the CPU tests and `chip_smoke.py`
run through it. Nothing here imports a test module (the JAX package's
tests import JAX; a spawned rank must not).
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.large import large_split
from .large_sharded import fft_large_sharded
from .real_sharded import (irfft2_sharded, irfft_large_sharded, rfft2_sharded,
                           rfft_large_sharded, stft_sharded)
from .sharded import (axis_group, fft2_sharded, fft_batch_sharded, irfft_batch_sharded,
                      make_mesh, mesh_device, rfft_batch_sharded)

__all__ = ["CPU_SIZES", "MID_SIZES", "inputs", "output_keys", "faces", "assemble", "refusals",
           "rank_faces", "spawn", "mesh2_shape"]

# The shapes of tests/test_sharded.py and _dryrun_body: (rows, n) batches,
# (h, w) images, the (D/2, 2) mesh's [B, H, W], N of the large faces, the
# STFT's (B, T, n_fft, hop).
CPU_SIZES = {"fft_batch": (16, 256), "fft2": ((64, 64), (128, 32)), "mesh2": (8, 32, 32),
             "large": 1 << 16, "rbatch": (16, 256), "irfft_batch": (16, 256),
             "rgrad": (16, 64), "grad2": (64, 64), "r2grad": (64, 64), "lgrad": 1 << 16,
             "rlarge": 1 << 15, "rfft2": ((64, 64), (64, 128)), "stft": (16, 512, 128, 64)}
# chip_smoke.py's four ranks on one card: mid sizes
MID_SIZES = {"fft_batch": (1024, 1024), "fft2": ((1024, 1024),), "mesh2": (4, 256, 256),
             "large": 1 << 20, "rbatch": (1024, 1024), "irfft_batch": (1024, 1024),
             "rgrad": (1024, 1024), "grad2": (1024, 1024), "r2grad": (1024, 1024),
             "lgrad": 1 << 20, "rlarge": 1 << 21, "rfft2": ((1024, 1024),),
             "stft": (8, 255 * 256 + 1024, 1024, 256)}

# the axis along which each face's shards lie (None: its own layout)
_ROWS = {"fft_batch": 0, "rbatch": 0, "irfft_batch": 0, "rgrad": 0, "stft": 0,
         "fft2": -2, "grad2": -2, "r2grad": -2, "rfft2": -2}


def mesh2_shape(d: int) -> tuple[int, int]:
    """The (b, t) mesh of d ranks: (d/2, 2), or (d, 1) for odd d."""
    return (d // 2, 2) if d % 2 == 0 else (d, 1)


def inputs(sizes: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """The global inputs of every face, float32, uniform in [-1, 1) from
    numpy's generator at `seed` (the same on every rank)."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    out = {}
    b, n = sizes["fft_batch"]
    out["fft_batch.re"], out["fft_batch.im"] = u(b, n), u(b, n)
    for h, w in sizes["fft2"]:
        out[f"fft2.{h}x{w}.re"], out[f"fft2.{h}x{w}.im"] = u(h, w), u(h, w)
    out["mesh2.re"], out["mesh2.im"] = u(*sizes["mesh2"]), u(*sizes["mesh2"])
    n = sizes["large"]
    out["large.re"], out["large.im"] = u(n), u(n)
    out["large.spec.re"], out["large.spec.im"] = u(n), u(n)
    out["rbatch.x"] = u(*sizes["rbatch"])
    b, n = sizes["irfft_batch"]
    out["irfft_batch.re"], out["irfft_batch.im"] = u(b, n // 2 + 1), u(b, n // 2 + 1)
    out["rgrad.x"] = u(*sizes["rgrad"])
    out["grad2.re"], out["grad2.im"] = u(*sizes["grad2"]), u(*sizes["grad2"])
    out["r2grad.x"] = u(*sizes["r2grad"])
    out["lgrad.re"], out["lgrad.im"] = u(sizes["lgrad"]), u(sizes["lgrad"])
    out["rlarge.x"] = u(sizes["rlarge"])
    m = sizes["rlarge"] // 2
    out["rlarge.spec.re"], out["rlarge.spec.im"] = u(m + 1), u(m + 1)
    for h, w in sizes["rfft2"]:
        out[f"rfft2.{h}x{w}.x"] = u(h, w)
        out[f"rfft2.{h}x{w}.spec.re"] = u(h, w // 2 + 1)
        out[f"rfft2.{h}x{w}.spec.im"] = u(h, w // 2 + 1)
    b, t, _, _ = sizes["stft"]
    out["stft.x"] = u(b, t)
    return out


def output_keys(sizes: dict) -> list[str]:
    """The keys of `faces`' outputs at these sizes, in its order."""
    keys = ["fft_batch.re", "fft_batch.im"]
    for h, w in sizes["fft2"]:
        keys += [f"fft2.{h}x{w}.{s}" for s in ("re", "im", "back.re", "back.im")]
    keys += ["mesh2.re", "mesh2.im", "large.re", "large.im", "large.back.re", "large.back.im",
             "large.inv.re", "large.inv.im", "rbatch.re", "rbatch.im", "rbatch.back",
             "irfft_batch.y", "rgrad.g", "grad2.gre", "grad2.gim", "r2grad.g", "lgrad.gre",
             "lgrad.gim", "rlarge.re", "rlarge.im",
             "rlarge.back", "rlarge.inv"]
    for h, w in sizes["rfft2"]:
        keys += [f"rfft2.{h}x{w}.{s}" for s in ("re", "im", "back", "inv")]
    return keys + ["stft.re", "stft.im"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def faces(mesh, inp: dict[str, np.ndarray], sizes: dict, axis: str = "x") -> dict:
    """Run every face once on this rank's shards of the global inputs `inp`
    (from `inputs(sizes)`); returns this rank's output shards as numpy
    arrays, keyed "<face>[.<shape>].<output>". Collective: every rank of
    the mesh calls it, and it builds the (D/2, 2) mesh over them."""
    from torch.distributed.device_mesh import init_device_mesh

    _, d, r = axis_group(mesh, axis)
    dev = mesh_device(mesh)

    def block(a, ax=0, i=r, parts=d):
        return torch.as_tensor(np.ascontiguousarray(np.split(a, parts, axis=ax)[i]), device=dev)

    out = {}
    re, im = fft_batch_sharded(block(inp["fft_batch.re"]), block(inp["fft_batch.im"]), mesh)
    out["fft_batch.re"], out["fft_batch.im"] = _np(re), _np(im)
    for h, w in sizes["fft2"]:
        key = f"fft2.{h}x{w}"
        re, im = fft2_sharded(block(inp[key + ".re"], -2), block(inp[key + ".im"], -2), mesh)
        bre, bim = fft2_sharded(re, im, mesh, inverse=True)
        out.update({key + ".re": _np(re), key + ".im": _np(im), key + ".back.re": _np(bre),
                    key + ".back.im": _np(bim)})

    nb, nt = mesh2_shape(d)
    mesh2 = init_device_mesh(mesh.device_type, (nb, nt), mesh_dim_names=("b", "t"))
    (_, _, ib), (_, _, it) = axis_group(mesh2, "b"), axis_group(mesh2, "t")
    re, im = (block(np.split(inp[k], nb, axis=0)[ib], -2, it, nt)
              for k in ("mesh2.re", "mesh2.im"))
    re, im = fft2_sharded(re, im, mesh2, axis="t", batch_axis="b")
    out["mesh2.re"], out["mesh2.im"] = _np(re), _np(im)

    n1, n2 = large_split(sizes["large"])
    re, im = (block(inp[k].reshape(n2, n1), 1) for k in ("large.re", "large.im"))
    re, im = fft_large_sharded(re, im, mesh)
    bre, bim = fft_large_sharded(re, im, mesh, inverse=True)
    out.update({"large.re": _np(re), "large.im": _np(im), "large.back.re": _np(bre),
                "large.back.im": _np(bim)})
    # the inverse on a spectrum of its own, in the forward's output layout
    re, im = (block(inp[k].reshape(n1, n2), 1) for k in ("large.spec.re", "large.spec.im"))
    re, im = fft_large_sharded(re, im, mesh, inverse=True)
    out["large.inv.re"], out["large.inv.im"] = _np(re), _np(im)

    re, im = rfft_batch_sharded(block(inp["rbatch.x"]), mesh)
    out.update({"rbatch.re": _np(re), "rbatch.im": _np(im),
                "rbatch.back": _np(irfft_batch_sharded(re, im, mesh))})
    out["irfft_batch.y"] = _np(irfft_batch_sharded(block(inp["irfft_batch.re"]),
                                                   block(inp["irfft_batch.im"]), mesh))

    x = block(inp["rgrad.x"]).requires_grad_(True)
    re, im = rfft_batch_sharded(x, mesh)
    m = x.shape[-1] // 2
    wt = torch.full((m + 1,), 2.0, device=dev)
    wt[0] = wt[m] = 1.0
    (torch.sum(wt * (re * re + im * im)) / x.shape[-1]).backward()
    out["rgrad.g"] = _np(x.grad)
    xre, xim = (block(inp[k], -2).requires_grad_(True) for k in ("grad2.re", "grad2.im"))
    re, im = fft2_sharded(xre, xim, mesh)
    h, w = sizes["grad2"]
    (torch.sum(re * re + im * im) / (h * w)).backward()
    out["grad2.gre"], out["grad2.gim"] = _np(xre.grad), _np(xim.grad)
    # the 2D real FFT's Parseval-weighted energy (its Nyquist gather's
    # gradient is a reduce-scatter) and the large FFT's energy: 2x each
    x = block(inp["r2grad.x"], -2).requires_grad_(True)
    re, im = rfft2_sharded(x, mesh)
    h, w = sizes["r2grad"]
    wt = torch.full((w // 2 + 1,), 2.0, device=dev)
    wt[0] = wt[-1] = 1.0
    (torch.sum(wt * (re * re + im * im)) / (h * w)).backward()
    out["r2grad.g"] = _np(x.grad)
    n1, n2 = large_split(sizes["lgrad"])
    xre, xim = (block(inp[k].reshape(n2, n1), 1).requires_grad_(True)
                for k in ("lgrad.re", "lgrad.im"))
    re, im = fft_large_sharded(xre, xim, mesh)
    (torch.sum(re * re + im * im) / sizes["lgrad"]).backward()
    out["lgrad.gre"], out["lgrad.gim"] = _np(xre.grad), _np(xim.grad)

    n1, n2 = large_split(sizes["rlarge"] // 2)
    re, im = rfft_large_sharded(block(inp["rlarge.x"].reshape(n2, 2 * n1), 1), mesh)
    out.update({"rlarge.re": _np(re), "rlarge.im": _np(im),
                "rlarge.back": _np(irfft_large_sharded(re, im, mesh))})
    m = sizes["rlarge"] // 2  # a spectrum whose DC and Nyquist bins have imaginary parts

    def spec_block(a):
        body = block(a[:m].reshape(n1, n2), 1).reshape(-1)
        return torch.cat([body, torch.as_tensor(a[m:], device=dev)]) if r == 0 else body

    out["rlarge.inv"] = _np(irfft_large_sharded(spec_block(inp["rlarge.spec.re"]),
                                                spec_block(inp["rlarge.spec.im"]), mesh))

    for h, w in sizes["rfft2"]:
        key = f"rfft2.{h}x{w}"
        re, im = rfft2_sharded(block(inp[key + ".x"], -2), mesh)
        out.update({key + ".re": _np(re), key + ".im": _np(im),
                    key + ".back": _np(irfft2_sharded(re, im, mesh)),
                    key + ".inv": _np(irfft2_sharded(block(inp[key + ".spec.re"], -2),
                                                     block(inp[key + ".spec.im"], -2), mesh))})

    _, _, n_fft, hop = sizes["stft"]
    re, im = stft_sharded(block(inp["stft.x"]), mesh, n_fft=n_fft, hop=hop)
    out["stft.re"], out["stft.im"] = _np(re), _np(im)
    return out


def assemble(shards: list[dict]) -> dict[str, np.ndarray]:
    """The global outputs from every rank's `faces` output, in rank order."""
    d = len(shards)
    out = {}
    for key in shards[0]:
        face = key.split(".")[0]
        parts = [s[key] for s in shards]
        if face in _ROWS:
            out[key] = np.concatenate(parts, axis=_ROWS[face])
        elif face == "mesh2":  # rank b*nt + t holds images block b, rows block t
            nb, nt = mesh2_shape(d)
            out[key] = np.concatenate([np.concatenate(parts[b * nt:(b + 1) * nt], axis=-2)
                                       for b in range(nb)], axis=0)
        elif key in ("rlarge.re", "rlarge.im"):  # [n1*c2] blocks; Nyquist on rank 0
            m = sum(p.size for p in parts) - 1
            n1 = large_split(m)[0]
            body = [p[:-1] if i == 0 else p for i, p in enumerate(parts)]
            out[key] = np.concatenate([np.concatenate([p.reshape(n1, -1) for p in body], axis=1)
                                       .reshape(-1), parts[0][-1:]])
        else:  # the large faces' column blocks
            out[key] = np.concatenate(parts, axis=1).reshape(-1)
    return out


def refusals(mesh, axis: str = "x") -> dict[str, str]:
    """What each face refuses on this mesh (its error text; "" where it ran):
    large factors D does not divide, and the 2D faces' W % D and (W/2) % D.
    The refusals come before any collective, so no rank waits on another."""
    _, d, _ = axis_group(mesh, axis)
    dev = mesh_device(mesh)

    def z(*shape):
        return torch.zeros(shape, device=dev)

    # at D = 8: N = 512 splits 128 x 4, m = 512 likewise; W = 4, W/2 = 4
    cases = {"large_factors": lambda: fft_large_sharded(z(4, 16), z(4, 16), mesh),
             "rlarge_factors": lambda: rfft_large_sharded(z(4, 32), mesh),
             "fft2_width": lambda: fft2_sharded(z(8, 4), z(8, 4), mesh),
             "rfft2_half_width": lambda: rfft2_sharded(z(8, 8), mesh),
             "batch_axis_without_batch": lambda: fft2_sharded(z(8, 64), z(8, 64), mesh,
                                                              batch_axis=axis)}
    said = {}
    for name, call in cases.items():
        try:
            call()
            said[name] = ""
        except ValueError as exc:
            said[name] = str(exc)
    return said


def rank_faces(sizes: dict, seed: int, out_dir: str, device: str) -> dict[str, str]:
    """A rank's body: the faces on a 1-D mesh of the group, its output shards
    written to out_dir/rank<r>.npz; returns its `refusals`."""
    mesh = make_mesh(device=device)
    res = faces(mesh, inputs(sizes, seed), sizes)
    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **res)
    return refusals(mesh)


def _rank(rank, world, backend, device, init, results, fn, args):
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn(world: int, backend: str, device: str, fn, *args, timeout: float = 300.0) -> list:
    """Run fn(*args) in `world` new processes (the spawn start method, one
    torch thread each), rank r of a `backend` process group on a file store
    in a temporary directory, with `device` ("cuda": every rank on the
    card its rank gives) current. Returns the ranks' results in rank order.
    A rank that raises raises here with its traceback; past `timeout`
    seconds every rank is killed and TimeoutError raised."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank, daemon=True,
                             args=(r, world, backend, device, init, results, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world - len(got)} of {world} ranks did not finish "
                                       f"within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                            and r not in got]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {world} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]
