"""Carry the JAX package's tables across to the port.

The FFT has no weights; its counterpart is the stage plan and the twiddle
pack. `tables_from_jax` takes them as `watfft_tpu.ops.pallas_stockham`'s
`stage_plan` and `make_twiddle_pack` return them (lists and numpy arrays,
measured TPU plan overrides included) and puts them on a device, so the
port can run exactly the JAX plan. Nothing here imports JAX.
"""

from __future__ import annotations

from .ops.stockham import Tables, make_tables

__all__ = ["tables_from_jax"]


def tables_from_jax(stages, offsets, twre, twim, device="cpu") -> Tables:
    """stages: [(R, l), ...]; offsets: per-stage pack offsets (-1 for the
    twiddle-free stage); twre/twim: the [total, 1] f32 pack planes."""
    return make_tables(stages, offsets, twre, twim, device)
