"""Host-side plan helpers. Only `is_power_of_two` is ported so far: the
four-step tree of `watfft_tpu/plan.py` serves large N, which is not yet part
of the port (ROADMAP A7)."""

from __future__ import annotations

__all__ = ["is_power_of_two"]


def is_power_of_two(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0
