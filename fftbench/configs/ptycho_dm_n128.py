"""ptycho_dm_n128: the port's difference-map ptychography
(`watfft_tpu_torch.ptycho`) as PtyPy's DM engine iterates over one scan:
16,384 exit waves complex64 [128, 128] and their magnitudes, a 2160^2
object and a 128^2 probe (BENCHMARK.json; ptycho_dm_n128.json).

The pool entry is the exit waves, the request's input; the magnitudes, the
starting object and probe, the positions and the buffer the new exit waves
go into (`out`) are the workload's, made by `make_pool` from the seed.
"""

from __future__ import annotations

import math

import torch

from fftbench.reference import ptycho as ref

BLOCK = 256  # frames a block while the magnitudes are simulated
ROOT_SPAN = "ptycho.dm"  # the port's span of one request


def cube_least_bytes(points: int) -> int:
    """The cube's least bytes over a request's `points` (each frame
    transformed forward and inverse, every point by the cube): each point's
    complex64 read and written once a transform (16 B a point)."""
    return 16 * points


def exit_least_bytes(frames: int, m: int, side: int) -> int:
    """The exit pass: psi read, t written (16 B a frame pixel); the object
    and the probe read once."""
    return 16 * frames * m * m + 8 * side * side + 8 * m * m


def fourier_least_bytes(frames: int, m: int, side: int) -> int:
    """The projection: the transform read and written, the magnitude read
    (20 B a frame pixel)."""
    return 20 * frames * m * m


def update_least_bytes(frames: int, m: int, side: int) -> int:
    """The update: psi and the inverse transform read, the new psi written
    (24 B a frame pixel); the object and the probe read once, the object's
    sums (numerator and denominator, 12 B a pixel) written once."""
    return 24 * frames * m * m + 20 * side * side + 8 * m * m


def probe_least_bytes(frames: int, m: int, side: int) -> int:
    """The probe's sums: the new psi read (8 B a frame pixel); the object
    read once, the probe's sums (12 B a pixel) written once."""
    return 8 * frames * m * m + 8 * side * side + 12 * m * m


def request_least_bytes(frames: int, m: int, side: int) -> int:
    """A request: psi read, the magnitudes read, the new psi written and
    read again for the probe's sums, which need the new object, which needs
    every new psi (28 B a frame pixel); the object and the probe read and
    written once."""
    return 28 * frames * m * m + 16 * side * side + 16 * m * m


def model_probe(m: int, diameter: int, turns: float) -> torch.Tensor:
    """complex64 [m, m]: a disc `diameter` px across centred at (m/2, m/2),
    modulus 1, phase 2 pi turns (r / radius)^2, 0 outside."""
    y = torch.arange(m, dtype=torch.float64) - m // 2
    r2 = (y[:, None] ** 2 + y[None, :] ** 2) / (diameter / 2) ** 2
    p = torch.polar(torch.ones_like(r2), 2 * math.pi * turns * r2)
    return torch.where(r2 <= 1, p, 0).to(torch.complex64)


def raster(scan: int, step: int) -> torch.Tensor:
    """int32 [scan^2, 2]: (row, column) of a scan x scan raster, row-major."""
    k = torch.arange(scan, dtype=torch.int32) * step
    return torch.stack((k.repeat_interleave(scan), k.repeat(scan)), 1)


class Workload:
    def __init__(self, config: dict, request: dict, device: torch.device):
        from watfft_tpu_torch import ptycho

        self.ptycho, self.device = ptycho, device
        self.m, self.scan, self.step = int(config["m"]), int(config["scan"]), int(config["step"])
        self.side = int(config["object_side"])
        self.frames = int(request["frames"])
        if self.frames != self.scan ** 2 or self.side != (self.scan - 1) * self.step + self.m:
            raise ValueError(f"{self.frames} frames of a {self.scan}^2 raster at step "
                             f"{self.step} over an object of {self.side}^2: they disagree")
        self.probe = model_probe(self.m, int(config["probe_diameter"]),
                                 float(config["probe_turns"])).to(device)
        self.pos = raster(self.scan, self.step).to(device)
        self.input_bytes = 8 * self.frames * self.m * self.m
        self.points = 2 * self.frames * self.m * self.m  # each frame forward and inverse
        self.least_bytes = request_least_bytes(self.frames, self.m, self.side)

    def _complex(self, g, shape, scale=1.0):
        """Each part uniform in [-scale, scale]."""
        u = torch.rand((*shape, 2), generator=g, device=self.device)
        return torch.view_as_complex(u.mul_(2 * scale).sub_(scale))

    def make_pool(self, seed: int, count: int) -> torch.Tensor:
        """The workload's state from the seed (the true object, whose
        magnitudes are simulated, and the starting object) and `count`
        distinct requests [count, frames, m, m] of exit waves, complex64 on
        the device (see the configuration's `assumed`)."""
        g = torch.Generator(device=self.device).manual_seed(seed % 2**64)
        s, m, dev = self.side, self.m, self.device
        modulus = 0.8 + 0.2 * torch.rand((s, s), generator=g, device=dev, dtype=torch.float64)
        phase = math.pi * (torch.rand((s, s), generator=g, device=dev, dtype=torch.float64)
                           - 0.5)
        true = torch.polar(modulus, phase)
        del modulus, phase
        p64 = self.probe.to(torch.complex128)
        self.fmag = torch.empty((self.frames, m, m), dtype=torch.float32, device=dev)
        for j0 in range(0, self.frames, BLOCK):
            view = ref.views(true, self.pos[j0:j0 + BLOCK], m)
            self.fmag[j0:j0 + BLOCK] = torch.fft.fft2(p64 * view).abs()
        del true
        self.obj = (1 + self._complex(g, (s, s), 0.1)).contiguous()
        pool = torch.empty((count, self.frames, m, m), dtype=torch.complex64, device=dev)
        for i in range(count):
            for j0 in range(0, self.frames, BLOCK):
                phi = self.probe * ref.views(self.obj, self.pos[j0:j0 + BLOCK], m)
                pool[i, j0:j0 + BLOCK] = phi + self._complex(g, phi.shape, 0.1)
        self.out = torch.empty((self.frames, m, m), dtype=torch.complex64, device=dev)
        return pool

    def calls(self) -> list:
        """The iteration into the workload's `out` (the state `make_pool`
        makes, read at each call)."""
        return [("dm", lambda x: self.ptycho.dm_iterate(x, self.obj, self.probe, self.fmag,
                                                        self.pos, out=self.out,
                                                        device=self.device))]

    def check(self, x: torch.Tensor, outs: list) -> dict:
        return ref.errors(outs, x, self.obj, self.probe, self.fmag, self.pos)

    def control_calls(self) -> list:
        """The reference in the program's place, each frame's transforms
        rounded to bfloat16, its outputs served in the program's dtypes."""
        def control(x):
            out, obj, probe, err = ref.iterate(x, self.obj, self.probe, self.fmag, self.pos,
                                               torch.bfloat16, out=self.out)
            return out, obj.to(torch.complex64), probe.to(torch.complex64), err.float()
        return [("dm", control)]
