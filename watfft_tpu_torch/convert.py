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
plan and both of its twiddle packs. The plain versions run any such plan;
the CUDA kernels refuse radices above 16 (the JAX plans of n = 1024..8192
have radix-32/64 stages), as they refuse them from any source. Nothing
here imports JAX.
"""

from __future__ import annotations

from .ops.bluestein import BluesteinTables, make_bluestein_tables
from .ops.large import LargeTables, make_large_tables
from .ops.rfft import RTables, make_rtables
from .ops.stockham import Tables, make_tables

__all__ = ["tables_from_jax", "rfft_tables_from_jax", "large_tables_from_jax",
           "bluestein_tables_from_jax"]


def tables_from_jax(stages, offsets, twre, twim, device="cpu") -> Tables:
    """stages: [(R, l), ...]; offsets: per-stage pack offsets (-1 for the
    twiddle-free stage); twre/twim: the [total, 1] f32 pack planes."""
    return make_tables(stages, offsets, twre, twim, device)


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
