"""Runtime switches of the port: the counterpart of `watfft_tpu/config.py`.

Only the three the port reads, from the JAX package's environment names
with its defaults, so one setting drives both packages:

  WATFFT_MXU_PRECISION  the matmul surface's precision ladder
                        (`ops/fourstep.py`): "highest" (default, full f32)
                        or "default" (one TF32 pass, ~1e-3), the
                        counterpart of the TPU's single bf16 MXU pass
  WATFFT_DIRECT_MAX     the largest factor computed as one DFT matmul:
                        the matmul surface's factorization (`plan.py`)
                        and the largest n of the small-n DFT-matmul
                        kernel (`ops/mxu_dft.py`); 128, the kernel's
                        limit, and a larger value is refused at import
  WATFFT_BF16_COMPUTE   bf16 time-major [n, b] planes run the Stockham
                        stages in bf16 end to end (the compute tier, ~1e-2)
                        instead of f32 stages between bf16 loads and stores
                        (the interop tier); off by default

Every other tunable of the JAX config is a table measured on a TPU and is
not carried over. Read at import; tests set the attributes directly.

One switch is the port's own and has no environment name: COLUMN_TILE,
the column tile of the c2c and strided c2c kernels' column walks
(`ops/stockham.py` `tile_shape`). None (default): the helper's tile; 0:
every launch at the engine's own T (the walk without column tiles); a
power of two C, or (C, threads): every column walk at that tile, in a
block of 256 threads or the given 256 or 512. A tile the kernels would
refuse raises before any launch. Checks and timing scripts set it; the
outputs are the same at every tile.
"""

from __future__ import annotations

import os

__all__ = ["MXU_PRECISION", "DIRECT_MAX", "BF16_COMPUTE", "COLUMN_TILE"]


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


MXU_PRECISION = os.environ.get("WATFFT_MXU_PRECISION", "highest")
DIRECT_MAX = _int_env("WATFFT_DIRECT_MAX", 128)
if not 2 <= DIRECT_MAX <= 128:
    raise ValueError(f"WATFFT_DIRECT_MAX={DIRECT_MAX}: the port takes 2..128 (the "
                     f"DFT-matmul kernel's largest n is 128)")
BF16_COMPUTE = os.environ.get("WATFFT_BF16_COMPUTE", "") not in ("", "0", "false")
COLUMN_TILE: int | tuple[int, int] | None = None
