"""stft_n1024: the port's STFT and inverse STFT (n_fft 1024, hop 256, periodic
Hann) on float32 clips [clips, t] (BENCHMARK.json; stft_n1024.json)."""

from __future__ import annotations

import torch

from fftbench.reference import fft as cref
from fftbench.reference import stft as ref


def least_bytes(clips: int, t: int, n_fft: int, hop: int) -> int:
    """A request's least bytes, float32: the clips read once; the re and im
    planes and the resynthesized signal written once."""
    m = ref.num_frames(t, n_fft, hop)
    signal = min(t, (m - 1) * hop + n_fft)
    return 4 * clips * (t + 2 * m * (n_fft // 2 + 1) + signal)


class Workload:
    def __init__(self, config: dict, request: dict, device: torch.device):
        from watfft_tpu_torch import stft

        self.stft = stft
        self.n_fft, self.hop = int(config["n_fft"]), int(config["hop"])
        self.window = config["window"]
        self.clips, self.t, self.device = int(request["batch"]), int(request["samples"]), device
        self.frames = ref.num_frames(self.t, self.n_fft, self.hop)
        self.input_bytes = 4 * self.clips * self.t
        self.points = 2 * self.clips * self.frames * self.n_fft  # stft and istft
        self.least_bytes = least_bytes(self.clips, self.t, self.n_fft, self.hop)

    def calls(self) -> list:
        st, n, hop, t, w, dev = self.stft, self.n_fft, self.hop, self.t, self.window, self.device
        return [("stft", lambda x: st.stft(x, n, hop, w, device=dev)),
                ("istft", lambda s: st.istft(s[0], s[1], n, hop, w, length=t, device=dev))]

    def make_pool(self, seed: int, count: int) -> torch.Tensor:
        """`count` distinct requests [count, clips, t], float32, on the device."""
        g = torch.Generator(device=self.device).manual_seed(seed % 2**64)
        u = torch.rand((count, self.clips, self.t), generator=g, device=self.device)
        return u.mul_(2).sub_(1)

    def check(self, x: torch.Tensor, outs: list) -> dict:
        re, im, y = outs
        n, hop = self.n_fft, self.hop
        rre, rim = ref.stft(x, n, hop)
        spec = torch.complex(re.double(), im.double())
        want = ref.istft(re, im, n, hop, length=self.t)
        norm = ref.overlap(self.frames, n, hop, x.device)[:want.shape[-1]]
        inner = norm >= 0.5 * norm.max()
        return {"spec_err": cref.max_rel(spec, torch.complex(rre, rim)),
                "sig_err": cref.max_rel(y, want),
                "sig_err_cola": cref.max_rel(y[..., inner], want[..., inner])}

    def control_calls(self) -> list:
        """The reference in the program's place, its transforms computed in
        bfloat16 (DFT matrix products), its outputs served as float32."""
        n, hop, t, bf = self.n_fft, self.hop, self.t, torch.bfloat16
        return [("stft", lambda x: tuple(p.float() for p in ref.stft(x, n, hop, bf))),
                ("istft", lambda s: ref.istft(s[0], s[1], n, hop, t, bf).float())]
