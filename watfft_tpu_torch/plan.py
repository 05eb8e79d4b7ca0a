"""Host-side plan helpers: the four-step tree of the matmul surface.

A numpy-only copy of `watfft_tpu/plan.py` (`dft_matrix`, `twiddle_grid`,
`factorize`, `PlanNode`, `build_tree`): DFT matrices per factor and
four-step twiddle grids, computed in float64 on the host with the phase
index reduced mod n before the trig call, then cast to the table dtype. The
native inverse folds 1/n into the outermost DFT matrix. `ops/fourstep.py`
runs the tree as matmuls. `DIRECT_MAX` is `config.DIRECT_MAX`, as in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# DIRECT_MAX: the largest factor computed as one DFT matmul (WATFFT_DIRECT_MAX)
from .config import DIRECT_MAX

__all__ = ["DIRECT_MAX", "is_power_of_two", "dft_matrix", "twiddle_grid", "factorize",
           "PlanNode", "build_tree"]


def is_power_of_two(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def dft_matrix(n: int, sign: float, dtype=np.float64, scale: float = 1.0):
    """(W_re, W_im) for W[j, k] = scale * exp(sign * 2i pi j k / n), the
    phase index j*k reduced mod n before the trig call."""
    k = np.arange(n, dtype=np.int64)
    ang = sign * 2.0 * np.pi * (np.outer(k, k) % n) / n
    return (scale * np.cos(ang)).astype(dtype), (scale * np.sin(ang)).astype(dtype)


def twiddle_grid(n1: int, n2: int, sign: float, dtype=np.float64):
    """Four-step twiddle grid T[j1, k2] = exp(sign * 2i pi j1 k2 / (n1*n2)),
    with the phase reduced mod n."""
    n = n1 * n2
    jk = np.outer(np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64)) % n
    ang = sign * 2.0 * np.pi * jk / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def factorize(n: int, direct_max: int = DIRECT_MAX) -> tuple[int, ...]:
    """Split n into factors (outermost first), each <= direct_max: each
    level splits the remaining size about in half in log-space."""
    if not is_power_of_two(n):
        raise ValueError(f"n must be a power of two, got {n}")
    if n <= direct_max:
        return (n,)
    log = n.bit_length() - 1
    n1 = 1 << min((log + 1) // 2, direct_max.bit_length() - 1)
    return (n1,) + factorize(n // n1, direct_max)


@dataclass
class PlanNode:
    """One level of the recursive four-step decomposition.

    direct (n2 is None): one [n, n] DFT matmul.
    composite: n = n1 * n2; inner FFT_{n2} (recursive), twiddle [n1, n2],
    outer DFT matmul with W_{n1}.
    """

    n: int
    w_re: np.ndarray  # direct: [n, n];  composite: [n1, n1] outer matrix
    w_im: np.ndarray
    n1: Optional[int] = None
    n2: Optional[int] = None
    tw_re: Optional[np.ndarray] = None  # composite: [n1, n2]
    tw_im: Optional[np.ndarray] = None
    inner: Optional["PlanNode"] = None

    @property
    def is_direct(self) -> bool:
        return self.inner is None

    def leaves(self):
        node = self
        while node is not None:
            yield node
            node = node.inner


def build_tree(n: int, inverse: bool = False, dtype=np.float32,
               direct_max: int = DIRECT_MAX, _scale: Optional[float] = None) -> PlanNode:
    """The constant tree of an n-point transform. The inverse tree uses
    sign +1 and folds 1/n into the outermost matmul."""
    sign = +1.0 if inverse else -1.0
    scale = _scale if _scale is not None else ((1.0 / n) if inverse else 1.0)
    if n <= direct_max:
        w_re, w_im = dft_matrix(n, sign, dtype, scale=scale)
        return PlanNode(n=n, w_re=w_re, w_im=w_im)
    log = n.bit_length() - 1
    n1 = 1 << min((log + 1) // 2, direct_max.bit_length() - 1)
    n2 = n // n1
    w_re, w_im = dft_matrix(n1, sign, dtype, scale=scale)
    tw_re, tw_im = twiddle_grid(n1, n2, sign, dtype)
    inner = build_tree(n2, inverse, dtype, direct_max, _scale=1.0)
    return PlanNode(n=n, n1=n1, n2=n2, w_re=w_re, w_im=w_im,
                    tw_re=tw_re, tw_im=tw_im, inner=inner)
