"""Carry the JAX package's tables across to the port.

The FFT has no weights; its counterpart is the stage plan and the twiddle
pack. `tables_from_jax` takes them as `watfft_tpu.ops.pallas_stockham`'s
`stage_plan` and `make_twiddle_pack` return them (lists and numpy arrays,
measured TPU plan overrides included) and puts them on a device, so the
port can run exactly the JAX plan; `rfft_tables_from_jax` does the same
for the real FFT, whose m = n/2-point core plan comes with the post-twiddle
columns of `watfft_tpu.ops.rfft.rfft_post_twiddles` (or `pallas_rfft`'s
`_Cache`). `large_tables_from_jax` carries the four-step tables across:
the twiddle grid of `watfft_tpu.ops.large._TwCache.get` and the n2- and
n1-point stage plans and packs. `bluestein_tables_from_jax` takes the
any-n transform's chirp and kernel spectrum as
`watfft_tpu.ops.bluestein._ChirpCache.get` returns them, with the m-point
plan and both of its twiddle packs. `df_tables_from_jax` and
`df_rtables_from_jax` carry the f64 tier's tables across: the plan and the
four hi/lo f32 planes of `watfft_tpu.ops.doublefloat._df_stage_plan`,
`_df_twiddle_pack` and `_df_post_twiddles`, merged into f64 (hi + lo), the
values the port's FP64 kernels take. The plain versions run any such plan;
the CUDA kernels refuse radices above 16 (the JAX plans of n = 1024..8192
have radix-32/64 stages), as they refuse them from any source.
`bf16_tables_from_jax` carries the bf16 compute tier's tables across: the
plan and f32 pack of `pallas_stockham`, rounded to bf16 as
`pallas_stockham.py:409-411` casts them. `dft_matrix_from_jax` puts the
small-n DFT matrix of `watfft_tpu.ops.mxu_dft` (`_WCache.get`,
`dft_matrix_real`) on a device in the layout the port's kernel reads, to
be compared with the port's own (`mxu_dft.device_matrix`).
Nothing here imports JAX.
"""

from __future__ import annotations

from .ops.bluestein import BluesteinTables, make_bluestein_tables
from .ops.large import LargeTables, make_large_tables
import numpy as np
import torch

from .ops.rfft import RTables, make_rtables
from .ops.stockham import Tables, make_tables

__all__ = ["tables_from_jax", "rfft_tables_from_jax", "large_tables_from_jax",
           "bluestein_tables_from_jax", "df_tables_from_jax", "df_rtables_from_jax",
           "bf16_tables_from_jax", "dft_matrix_from_jax"]


def tables_from_jax(stages, offsets, twre, twim, device="cpu") -> Tables:
    """stages: [(R, l), ...]; offsets: per-stage pack offsets (-1 for the
    twiddle-free stage); twre/twim: the [total, 1] f32 pack planes."""
    return make_tables(stages, offsets, twre, twim, device)


def bf16_tables_from_jax(stages, offsets, twre, twim, device="cpu") -> Tables:
    """The bf16 compute tier's tables: the plan and the [total, 1] f32 pack
    as for `tables_from_jax`, the pack rounded to bf16 (to nearest)."""
    return make_tables(stages, offsets, twre, twim, device, torch.bfloat16)


def dft_matrix_from_jax(w, device="cpu") -> torch.Tensor:
    """w: the [2n, 2n] f32 real DFT matrix W of the JAX package. Returns
    W^T as a contiguous f32 tensor on `device`, the layout of
    `mxu_dft.device_matrix`."""
    w = np.asarray(w)
    if w.ndim != 2 or w.shape[0] != w.shape[1] or w.shape[0] % 2 or w.dtype != np.float32:
        raise ValueError(f"the DFT matrix is [2n, 2n] float32, got {w.shape} {w.dtype}")
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(device)


def rfft_tables_from_jax(stages, offsets, twre, twim, wre, wim, inverse: bool,
                         device="cpu") -> RTables:
    """stages/offsets/twre/twim: the m-point plan and twiddle pack of the
    direction, as for `tables_from_jax`; wre/wim: the post-twiddle columns
    w_n^{-+k} (m+1 values forward, m inverse; any shape)."""
    return make_rtables(stages, offsets, twre, twim, wre, wim, inverse, device)


def large_tables_from_jax(pmre, pmim, stages1, offsets1, tw1re, tw1im,
                          stages2, offsets2, tw2re, tw2im, inverse: bool,
                          device="cpu") -> LargeTables:
    """pmre/pmim: the [n2, n1] twiddle grid T[k2, j1]; stages1 ... tw1im:
    the n2-point plan and pack (stage 1); stages2 ... tw2im: the n1-point
    ones (stage 2), each as for `tables_from_jax`, all of one direction."""
    t1 = make_tables(stages1, offsets1, tw1re, tw1im, device)
    t2 = make_tables(stages2, offsets2, tw2re, tw2im, device)
    return make_large_tables(t2.n, t1.n, pmre, pmim, t1, t2, inverse)


def bluestein_tables_from_jax(n: int, chirp, stages, fwd_pack, inv_pack, inverse: bool,
                              device="cpu") -> BluesteinTables:
    """chirp: `_ChirpCache.get(n, inverse)`, (m, cre, cim, bre, bim); stages:
    the m-point plan [(R, l), ...]; fwd_pack / inv_pack: the m-point
    forward and inverse twiddle packs as `make_twiddle_pack` returns them,
    (twre, twim, offsets). The final chirp gets the JAX package's 1/n for
    the inverse."""
    m, cre, cim, bre, bim = chirp
    fwd, inv = (make_tables(stages, pack[2], pack[0], pack[1], device)
                for pack in (fwd_pack, inv_pack))
    if fwd.n != m:
        raise ValueError(f"the plan is for m={fwd.n}, the chirp tables for m={m}")
    return make_bluestein_tables(n, cre, cim, bre, bim, fwd, inv, inverse, device)


def _merge(hi, lo) -> np.ndarray:
    """An f64 value from its hi/lo f32 pair (doublefloat.merge_f64)."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _check_direction(offsets, im: np.ndarray, inverse: bool) -> None:
    """The pack's first twiddle, w_{Rl}^{-+1} at row 1 of the first stage
    that has twiddles, has a negative imaginary part forward and a positive
    one inverse; a pack of the other direction raises."""
    first = next((o for o in offsets if o >= 0), None)
    if first is not None and (im.reshape(-1)[first + 1] > 0) != inverse:
        raise ValueError(f"the twiddle pack is not {'inverse' if inverse else 'forward'}")


def df_tables_from_jax(stages, packed, offsets, inverse: bool, device="cpu") -> Tables:
    """stages: `_df_stage_plan(n)`, [(R, l), ...]; packed, offsets: what
    `_df_twiddle_pack(n, inverse)` returns, the four [total, 1] f32 planes
    (re_hi, re_lo, im_hi, im_lo) and the per-stage offsets. Returns f64
    Tables of the merged pack; a pack of the other direction raises."""
    rh, rl, ih, il = packed
    im = _merge(ih, il)
    _check_direction(offsets, im, inverse)
    return make_tables(stages, offsets, _merge(rh, rl), im, device, torch.float64)


def df_rtables_from_jax(stages, packed, offsets, post, inverse: bool,
                        device="cpu") -> RTables:
    """The f64 real-FFT tables of n = 2m points: stages / packed / offsets
    as for `df_tables_from_jax`, of the m-point core in the direction;
    post: `_df_post_twiddles(n, inverse)`, the four hi/lo planes of
    w_n^{-+k} (m+1 values forward, m inverse)."""
    rh, rl, ih, il = packed
    wrh, wrl, wih, wil = post
    im = _merge(ih, il)
    _check_direction(offsets, im, inverse)
    return make_rtables(stages, offsets, _merge(rh, rl), im, _merge(wrh, wrl),
                        _merge(wih, wil), inverse, device, torch.float64)
