"""c2c_n1024: the port's f32 complex context at n = 1024, forward then
inverse, on complex64 rows [batch, n] (BENCHMARK.json; c2c_n1024.json)."""

from __future__ import annotations

import torch

from fftbench.reference import fft as ref


def least_bytes(batch: int, n: int) -> int:
    """A request's least bytes: x read once, y and z written once (complex64)."""
    return 3 * batch * n * 8


class Workload:
    def __init__(self, config: dict, request: dict, device: torch.device):
        from watfft_tpu_torch import create_fft_f32

        self.n, self.batch, self.device = int(config["n"]), int(request["batch"]), device
        self.ctx = create_fft_f32(self.n, device=device)
        self.input_bytes = self.batch * self.n * 8
        self.points = 2 * self.batch * self.n  # forward and inverse
        self.least_bytes = least_bytes(self.batch, self.n)

    def calls(self) -> list:
        return [("forward", self.ctx.forward), ("inverse", self.ctx.inverse)]

    def make_pool(self, seed: int, count: int) -> torch.Tensor:
        """`count` distinct requests [count, batch, n], complex64, on the device."""
        g = torch.Generator(device=self.device).manual_seed(seed % 2**64)
        u = torch.rand((count, self.batch, self.n, 2), generator=g, device=self.device)
        return torch.view_as_complex(u.mul_(2).sub_(1))

    def check(self, x: torch.Tensor, outs: list) -> dict:
        y, z = outs
        return {"fwd_err": ref.max_rel(y, ref.c2c(x, False)),
                "inv_err": ref.max_rel(z, ref.c2c(y, True))}

    def control_calls(self) -> list:
        """The port's own bfloat16 path in the program's place: bf16 planes
        in and out of the Stockham kernel (its interop tier)."""
        from watfft_tpu_torch.ops import stockham

        def call(inverse):
            def fn(x):
                re, im = stockham.stockham_fft_bm(x.real.to(torch.bfloat16),
                                                  x.imag.to(torch.bfloat16), inverse)
                return torch.complex(re.float(), im.float())
            return fn
        return [("forward", call(False)), ("inverse", call(True))]
