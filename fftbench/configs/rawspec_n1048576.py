"""rawspec_n1048576: the port's spectrometer (`watfft_tpu_torch.spectrometer`)
as Breakthrough Listen's product 0000 makes it: 2^20-point spectra of int8
dual-polarisation voltages [chans, t, pols, 2], total power integrated over
51 spectra (BENCHMARK.json; rawspec_n1048576.json)."""

from __future__ import annotations

import torch

from fftbench.reference import rawspec as ref


def least_bytes(chans: int, t: int, pols: int, nout: int, nfft: int) -> int:
    """A request's least bytes: the int8 voltages read once, the float32
    spectra written once."""
    return chans * t * pols * 2 + 4 * chans * nout * nfft


def pipe2_least_bytes(points: int) -> int:
    """The least bytes of the four-step pipe2 route over `points` transform
    points: each of its two passes reads and writes every point's complex64
    once (4 x 8 B a point)."""
    return 4 * 8 * points


class Workload:
    def __init__(self, config: dict, request: dict, device: torch.device):
        from watfft_tpu_torch import spectrometer

        self.spectrometer = spectrometer
        self.nfft, self.nint = int(config["nfft"]), int(config["nint"])
        self.pols = int(config["pols"])
        self.chans, spectra = int(request["chans"]), int(request["nint"])
        if spectra % self.nint:
            raise ValueError(f"a request of {spectra} spectra is not whole integrations "
                             f"of {self.nint}")
        self.t, self.device = self.nfft * spectra, device
        self.input_bytes = self.chans * self.t * self.pols * 2
        self.points = self.chans * self.pols * self.t  # one point a sample of each stream
        self.least_bytes = least_bytes(self.chans, self.t, self.pols, spectra // self.nint,
                                       self.nfft)

    def calls(self) -> list:
        sp, nfft, nint, dev = self.spectrometer, self.nfft, self.nint, self.device
        return [("integrate", lambda v: sp.integrate(v, nfft, nint, device=dev))]

    def make_pool(self, seed: int, count: int) -> torch.Tensor:
        """`count` distinct requests [count, chans, t, pols, 2], int8 uniform
        in [-127, 127], on the device."""
        g = torch.Generator(device=self.device).manual_seed(seed % 2**64)
        return torch.randint(-127, 128, (count, self.chans, self.t, self.pols, 2), generator=g,
                             dtype=torch.int8, device=self.device)

    def check(self, x: torch.Tensor, outs: list) -> dict:
        power, = outs
        return {"power_err": ref.power_err(power, x, self.nfft, self.nint)}

    def control_calls(self) -> list:
        """The reference in the program's place, each spectrum rounded to
        bfloat16 before detection (int8 samples are exact in bfloat16, so
        rounding the input would control nothing), served as float32."""
        nfft, nint = self.nfft, self.nint
        return [("integrate", lambda v: ref.integrate(v, nfft, nint, torch.bfloat16).float())]
