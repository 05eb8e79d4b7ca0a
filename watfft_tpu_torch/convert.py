"""Carry the JAX package's tables across to the port.

The FFT has no weights; its counterpart is the stage plan and the twiddle
pack. `tables_from_jax` takes them as `watfft_tpu.ops.pallas_stockham`'s
`stage_plan` and `make_twiddle_pack` return them (lists and numpy arrays,
measured TPU plan overrides included) and puts them on a device, so the
port can run exactly the JAX plan; `rfft_tables_from_jax` does the same
for the real FFT, whose m = n/2-point core plan comes with the post-twiddle
columns of `watfft_tpu.ops.rfft.rfft_post_twiddles` (or `pallas_rfft`'s
`_Cache`). The plain versions run any such plan; the CUDA kernels refuse
radices above 16, as they refuse them from any source. Nothing here
imports JAX.
"""

from __future__ import annotations

from .ops.rfft import RTables, make_rtables
from .ops.stockham import Tables, make_tables

__all__ = ["tables_from_jax", "rfft_tables_from_jax"]


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
