"""Batched FFT as recursive four-step DFT matmuls (the matmul surface).

Counterpart of `watfft_tpu/ops/fourstep.py`, on split planes [..., n], and
of the real matmul surface of `watfft_tpu/ops/rfft.py` (`rfft_planes`,
`irfft_planes`, `rfft_post_twiddles`: pack-as-complex around the m = n/2
-point transform). That JAX module is the real FFT's XLA path; the port's
`ops/rfft.py` is the counterpart of `pallas_rfft.py`, its kernels, so the
matmul forms live here beside the complex ones. Both run in the tables'
dtype, float32 or float64 (the JAX planner's f64 route, and the port's
past the FP64 kernels' range):

  n <= DIRECT_MAX:  X = x @ W_n                        (one complex matmul)
  n = n1 * n2:      reshape [n] -> [n2, n1], FFT_{n2} along the inner axis
                    (recursive), elementwise twiddle T[j1, k2] = w_N^{j1 k2},
                    outer matmul with W_{n1}, flatten [n1, n2] -> [n].

The tables come from `plan.build_tree` (f64 on the host, cast to the table
dtype); the inverse folds 1/n into the outermost matrix. None of this is a
kernel of the JAX package: XLA ran it there, `torch.matmul` runs it here.
Its float32 precision follows the JAX package's ladder,
`config.MXU_PRECISION` (`_precision`): "highest" (the default) runs full
f32, "default" one TF32 pass on the card's tensor cores (~1e-3), the
counterpart of the TPU's single bf16 MXU pass. Either way the caller's own
setting (`torch.set_float32_matmul_precision`,
`torch.backends.cuda.matmul.allow_tf32`) is replaced for the call and
restored after it, so it is not thread-safe against another thread that
changes the setting meanwhile. The kernels' plain versions hold to full
f32 (`full_f32`) whatever the ladder says.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import config
from ..plan import PlanNode, build_tree
from .stockham import np_dtype

__all__ = ["fft_tables", "shape_info", "apply_tables", "fft_planes", "full_f32",
           "rfft_post_twiddles", "rfft_planes", "irfft_planes"]


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    """float32 matmuls in one TF32 pass (`tf32`) or in full precision inside
    the block, the caller's setting restored after it (untouched when it is
    that one already)."""
    prev = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    want = ("high", True) if tf32 else ("highest", False)
    if prev == want:
        yield
        return
    torch.set_float32_matmul_precision(want[0])
    torch.backends.cuda.matmul.allow_tf32 = want[1]
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


def full_f32():
    """float32 matmuls in full precision inside the block, the caller's
    setting restored after it (untouched when it is full precision already)."""
    return _matmul_precision(False)


def _precision():
    """The matmul surface's precision ladder (config.MXU_PRECISION, read at
    each call; watfft_tpu/ops/fourstep.py:43): "default" one TF32 pass,
    anything else full f32."""
    return _matmul_precision(config.MXU_PRECISION == "default")


def _cmatmul_last(xre, xim, wre, wim):
    """[..., n] @ [n, m] complex matmul on split planes (4 real matmuls)."""
    mm = torch.matmul
    return mm(xre, wre) - mm(xim, wim), mm(xre, wim) + mm(xim, wre)


def _cmatmul_outer(cre, cim, wre, wim):
    """Contract axis -2 (j1) with W[j1, k1]: D[..., k1, k2] = sum_j C[..., j, k2] W[j, k1]."""
    wre, wim = wre.T, wim.T
    mm = torch.matmul
    return mm(wre, cre) - mm(wim, cim), mm(wim, cre) + mm(wre, cim)


def fft_tables(node: PlanNode, device="cpu") -> list[dict]:
    """The tree's tables as tensors on `device`, one dict per level."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    out = []
    for level in node.leaves():
        d = {"w_re": put(level.w_re), "w_im": put(level.w_im)}
        if not level.is_direct:
            d["tw_re"] = put(level.tw_re)
            d["tw_im"] = put(level.tw_im)
        out.append(d)
    return out


def shape_info(node: PlanNode) -> list[tuple]:
    """(n, n1, n2) per level of the tree."""
    return [(lv.n, lv.n1, lv.n2) for lv in node.leaves()]


def apply_tables(xre, xim, tables, shape_info):
    """The recursive four-step transform of x [..., n] (split planes) with
    the tables of `fft_tables` and the levels of `shape_info`, at the
    precision `_precision` gives."""
    with _precision():
        return _apply(xre, xim, tables, shape_info, 0)


def _apply(xre, xim, tables, info, lvl):
    n, n1, n2 = info[lvl]
    t = tables[lvl]
    if n1 is None:
        return _cmatmul_last(xre, xim, t["w_re"], t["w_im"])
    batch = xre.shape[:-1]
    # [..., n] -> [..., n2, n1] -> [..., n1, n2]: element (j1, j2) is x[j1 + n1*j2]
    xre = xre.reshape(*batch, n2, n1).transpose(-1, -2)
    xim = xim.reshape(*batch, n2, n1).transpose(-1, -2)
    bre, bim = _apply(xre, xim, tables, info, lvl + 1)
    twre, twim = t["tw_re"], t["tw_im"]
    cre = bre * twre - bim * twim
    cim = bre * twim + bim * twre
    # outer DFT over j1; [..., k1, k2] flattens to X[k1*n2 + k2]
    dre, dim = _cmatmul_outer(cre, cim, t["w_re"], t["w_im"])
    return dre.reshape(*batch, n), dim.reshape(*batch, n)


def fft_planes(xre, xim, inverse: bool = False, dtype=None):
    """One-shot batched FFT on split planes [..., n] (builds the tables for
    the call on their device). dtype: the tables' numpy dtype, the planes'
    by default; as in the JAX package the transform runs in the promotion
    of the two (f32 planes on float64 tables give float64)."""
    n = xre.shape[-1]
    tree = build_tree(n, inverse=inverse, dtype=np.dtype(dtype or np_dtype(xre.dtype)))
    tables = fft_tables(tree, xre.device)
    common = torch.promote_types(xre.dtype, tables[0]["w_re"].dtype)
    tables = [{k: v.to(common) for k, v in t.items()} for t in tables]
    return apply_tables(xre.to(common), xim.to(common), tables, shape_info(tree))


# -- the real matmul surface (watfft_tpu/ops/rfft.py:31-81) ----------------------

def rfft_post_twiddles(n: int, inverse: bool, dtype=np.float32):
    """w_n^{-+k}: forward k = 0..m (m+1 values), inverse k = 0..m-1, with
    m = n/2. f64 host math, the code of watfft_tpu/ops/rfft.py:31-37."""
    m = n // 2
    sign = +1.0 if inverse else -1.0
    k = np.arange(m + (0 if inverse else 1))
    ang = sign * 2.0 * np.pi * k / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def rfft_planes(x, tables, shape_info, wre, wim):
    """Real x [..., n] -> spectrum planes (Xre, Xim) [..., n//2+1]: the
    m-point transform of z[j] = x[2j] + i x[2j+1] on the tables of
    `fft_tables` / `shape_info` (the forward m-point tree), then the
    Hermitian post X = E + w O with E = (A + conj B)/2, O = -i (A - conj B)/2,
    A = Z[k], B = Z[(m-k) mod m], k = 0..m. wre/wim: the forward post
    twiddles (m+1 values)."""
    zre, zim = apply_tables(x[..., 0::2], x[..., 1::2], tables, shape_info)
    first_re, first_im = zre[..., :1], zim[..., :1]
    are = torch.cat([zre, first_re], dim=-1)
    aim = torch.cat([zim, first_im], dim=-1)
    bre = torch.cat([first_re, torch.flip(zre[..., 1:], (-1,)), first_re], dim=-1)
    bim = torch.cat([first_im, torch.flip(zim[..., 1:], (-1,)), first_im], dim=-1)
    ere = 0.5 * (are + bre)
    eim = 0.5 * (aim - bim)
    ore = 0.5 * (aim + bim)
    oim = -0.5 * (are - bre)
    return ere + wre * ore - wim * oim, eim + wre * oim + wim * ore


def irfft_planes(xre, xim, inv_tables, inv_shape_info, wre, wim):
    """Spectrum planes [..., m+1] -> real [..., 2m], normalized: the
    pre-process Z = E + w O with E = (A + B)/2, O = i (A - B)/2, A = X[k],
    B = conj X[m-k], k = 0..m-1, the m-point inverse on the tables of the
    inverse tree (1/m folded in), then x[2j] = Re z[j], x[2j+1] = Im z[j].
    wre/wim: the inverse post twiddles (m values)."""
    m = xre.shape[-1] - 1
    are, aim = xre[..., :m], xim[..., :m]
    bre = torch.cat([xre[..., m:], torch.flip(xre[..., 1:m], (-1,))], dim=-1)
    bim = -torch.cat([xim[..., m:], torch.flip(xim[..., 1:m], (-1,))], dim=-1)
    ere = 0.5 * (are + bre)
    eim = 0.5 * (aim + bim)
    ore = -0.5 * (aim - bim)
    oim = 0.5 * (are - bre)
    zre = ere + wre * ore - wim * oim
    zim = eim + wre * oim + wim * ore
    zre, zim = apply_tables(zre, zim, inv_tables, inv_shape_info)
    return torch.stack([zre, zim], dim=-1).reshape(*zre.shape[:-1], 2 * m)
