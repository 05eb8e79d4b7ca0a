"""wstack_n4096: the port's w-stacking imager (`watfft_tpu_torch.imaging`)
as WSClean inverts one pass of w-layers: complex64 grids [layers, N, N]
to a float32 image [N, N] (BENCHMARK.json; wstack_n4096.json)."""

from __future__ import annotations

import math

import torch

from fftbench.reference import wstack as ref

ARCSEC = math.pi / (180 * 3600)


def fft2_least_bytes(points: int) -> int:
    """The least bytes of the 2D two-pass route over `points` image points:
    each of its passes reads and writes every point's complex64 once (4 x 8
    B a point)."""
    return 4 * 8 * points


def wstack_least_bytes(planes: int, n: int) -> int:
    """The accumulation's least bytes over `planes` N x N planes of one
    request: each plane's complex64 read once (8 B a pixel a plane), the
    float32 image written once (4 B a pixel a request). Over a request's
    layers these are also the request's least bytes: the grids read once,
    the image written once."""
    return 8 * planes * n * n + 4 * n * n


def kb_taper(n: int, cells: int, beta: float) -> torch.Tensor:
    """float32 [n]: the image-domain correction of a Kaiser-Bessel kernel of
    `cells` cells, sinh(sqrt(beta^2 - (pi cells v)^2)) / sqrt(...) at v = (x -
    n/2) / n, normalised to 1 at x = n/2 (beta >= pi cells / 2 keeps the
    root real)."""
    v = (torch.arange(n, dtype=torch.float64) - n // 2) / n
    a = torch.sqrt(beta * beta - (math.pi * cells * v) ** 2)
    c = torch.sinh(a) / a
    return (c / (math.sinh(beta) / beta)).float()


class Workload:
    def __init__(self, config: dict, request: dict, device: torch.device):
        from watfft_tpu_torch import imaging

        self.imaging = imaging
        self.n, self.layers, self.device = int(config["n"]), int(request["layers"]), device
        self.pixel_scale = float(config["pixel_scale_arcsec"]) * ARCSEC
        self.uv_max = float(config["uv_max"])
        w_max = float(config["w_max"])
        self.w = torch.linspace(-w_max, w_max, self.layers, dtype=torch.float64, device=device)
        self.taper = kb_taper(self.n, int(config["kernel_cells"]),
                              float(config["kb_beta"])).to(device)
        self.input_bytes = 8 * self.layers * self.n * self.n
        self.points = self.layers * self.n * self.n  # one point a pixel of each layer
        self.least_bytes = wstack_least_bytes(self.layers, self.n)

    def calls(self) -> list:
        im, w, ps, taper, dev = self.imaging, self.w, self.pixel_scale, self.taper, self.device
        return [("invert", lambda g: im.wstack_invert(g, w, ps, taper, device=dev))]

    def make_pool(self, seed: int, count: int) -> torch.Tensor:
        """`count` distinct requests [count, layers, N, N], complex64 on the
        device: uniform in [-1, 1] (each part) within the uv disc of radius
        uv_max, zero outside (u = v = 0 at index N/2)."""
        n = self.n
        g = torch.Generator(device=self.device).manual_seed(seed % 2**64)
        u = torch.rand((count, self.layers, n, n, 2), generator=g, device=self.device)
        du = 1.0 / (n * self.pixel_scale)  # wavelengths a cell
        uv = (torch.arange(n, dtype=torch.float64, device=self.device) - n // 2) * du
        disc = (uv[:, None] ** 2 + uv[None, :] ** 2 <= self.uv_max ** 2).float()
        return torch.view_as_complex(u.mul_(2).sub_(1).mul_(disc[:, :, None]))

    def check(self, x: torch.Tensor, outs: list) -> dict:
        image, = outs
        return {"image_err": ref.image_err(image, x, self.w, self.pixel_scale, self.taper)}

    def control_calls(self) -> list:
        """The reference in the program's place, each layer's inverse
        transform rounded to bfloat16 before the screen, served as float32."""
        w, ps, taper = self.w, self.pixel_scale, self.taper
        return [("invert", lambda g: ref.invert(g, w, ps, taper, torch.bfloat16).float())]
