"""Spectrogram demo on the PyTorch/CUDA port: a chirp and two tones, a
log-mel spectrogram through `watfft_tpu_torch.stft`, saved as a PNG.

The port's counterpart of examples/spectrogram_demo.py. The image is
written by a small standard-library PNG writer (`zlib`, `struct`, a fixed
colour table), so the script needs no plotting package: one pixel a frame
across, one a mel bin up, low bins at the bottom. Runs on the CUDA device
(the real FFT's Hopper kernel); `--cpu` runs its plain torch version.
Without a CUDA device and without `--cpu` it exits 2.

Usage: python examples/torch_spectrogram_demo.py [out.png] [--cpu]
"""

import os
import struct
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# Colour stops of the table, dark to bright (a magma-like ramp), and the
# 256-entry palette interpolated between them.
_STOPS = np.array([(0, 0, 4), (59, 15, 112), (140, 41, 129), (222, 73, 104),
                   (254, 159, 109), (252, 253, 191)], np.float64)
PALETTE = np.stack([np.interp(np.linspace(0, len(_STOPS) - 1, 256),
                              np.arange(len(_STOPS)), _STOPS[:, c]) for c in range(3)],
                   axis=1).round().astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit indexed-colour PNG of `image` [height, width] (uint8 indices
    into PALETTE), row 0 at the top."""
    h, w = image.shape
    rows = b"".join(b"\x00" + image[r].astype(np.uint8).tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)))
        f.write(_chunk(b"PLTE", PALETTE.tobytes()))
        f.write(_chunk(b"IDAT", zlib.compress(rows, 9)))
        f.write(_chunk(b"IEND", b""))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch

    from watfft_tpu_torch import stft as S
    from watfft_tpu_torch.tools import device_or_exit

    dev = device_or_exit("--cpu" in argv, "torch_spectrogram_demo")
    paths = [a for a in argv if not a.startswith("-")]
    out_path = paths[0] if paths else "spectrogram.png"

    sr = 16000
    t = np.arange(4 * sr) / sr
    # chirp 200 Hz -> 4 kHz + two steady tones + noise floor
    sig = (np.sin(2 * np.pi * (200 * t + (3800 / 8) * t * t))
           + 0.5 * np.sin(2 * np.pi * 1000 * t)
           + 0.3 * np.sin(2 * np.pi * 3000 * t)
           + 0.02 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)

    n_fft, hop = 1024, 256
    p = S.spectrogram(torch.as_tensor(sig, device=dev), n_fft=n_fft, hop=hop, log=False,
                      device=dev)
    fb = torch.as_tensor(S.mel_filterbank(80, n_fft, sr), device=dev)
    mel = torch.log(p @ fb.T + 1e-10).cpu().numpy()        # [frames, 80]

    lo, hi = float(mel.min()), float(mel.max())
    image = np.round((mel.T[::-1] - lo) / max(hi - lo, 1e-30) * 255).astype(np.uint8)
    write_png(out_path, image)
    print(f"wrote {out_path}  (frames={p.shape[0]}, bins={p.shape[1]}, mel={mel.shape[1]}, "
          f"{image.shape[1]}x{image.shape[0]} px, on {p.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
