"""Batched FFT as recursive four-step DFT matmuls (the matmul surface).

Counterpart of `watfft_tpu/ops/fourstep.py`, on split planes [..., n]:

  n <= DIRECT_MAX:  X = x @ W_n                        (one complex matmul)
  n = n1 * n2:      reshape [n] -> [n2, n1], FFT_{n2} along the inner axis
                    (recursive), elementwise twiddle T[j1, k2] = w_N^{j1 k2},
                    outer matmul with W_{n1}, flatten [n1, n2] -> [n].

The tables come from `plan.build_tree` (f64 on the host, cast to f32); the
inverse folds 1/n into the outermost matrix. None of this is a kernel of
the JAX package: XLA ran it there, `torch.matmul` runs it here. It runs in
full float32: a caller's TF32 setting (`torch.set_float32_matmul_precision`,
`torch.backends.cuda.matmul.allow_tf32`) is switched off for the call and
restored after it, so it is not thread-safe against another thread that
changes the setting meanwhile. The JAX package's opt-in bf16 tier
(`config.MXU_PRECISION`) is not ported (ROADMAP A11).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..plan import PlanNode, build_tree

__all__ = ["fft_tables", "shape_info", "apply_tables", "fft_planes", "full_f32"]


@contextlib.contextmanager
def full_f32():
    """float32 matmuls in full precision inside the block, the caller's
    setting restored after it (untouched when it is full precision already)."""
    prev = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    if prev == "highest" and not prev_tf32:
        yield
        return
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


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


def apply_tables(xre, xim, tables, info):
    """The recursive four-step transform of x [..., n] (split planes) with
    the tables of `fft_tables` and the levels of `shape_info`."""
    with full_f32():
        return _apply(xre, xim, tables, info, 0)


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


def fft_planes(xre, xim, inverse: bool = False):
    """One-shot batched FFT on split planes [..., n] (builds the tables for
    the call, in the planes' dtype, on their device)."""
    n = xre.shape[-1]
    dtype = {torch.float32: np.float32, torch.float64: np.float64}[xre.dtype]
    tree = build_tree(n, inverse=inverse, dtype=dtype)
    return apply_tables(xre, xim, fft_tables(tree, xre.device), shape_info(tree))
