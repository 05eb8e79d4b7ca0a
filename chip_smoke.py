"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check them.

Run from the repository root with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. Device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions. Without a CUDA device it stops here with exit code 1.
2. Build: nvcc compiles every kernel source of `watfft_tpu_torch/ops/csrc`
   (the Stockham c2c kernel and its FP64 and bf16 instances, the real,
   large-N, 2D and Bluestein kernels and the small-n DFT matmul), one
   process per source, all at once.
3. c2c kernel against its plain torch version on the card, every
   power-of-two n = 2..4096, forward and inverse, at batch 3 and at 2^22/n
   (limit 1e-6 of the largest output); at batch 3 also against the f64
   numpy oracle (MAX_REL 5e-6), and per-bin and roundtrip checks at
   n = 64, 1024, 4096.
4. c2c main path at full size: `create_fft_f32(1024, device="cuda")` on a
   [4096, 1024] complex64 tensor (BASELINE config 4) — forward, inverse,
   roundtrip, the plane entry points and a backward — against cuFFT in
   complex128, with the kernel's launch count for that run.
   A conjugated view (`x.conj()`, whose storage holds x) goes through too.
5. c2c times at 2^22 points per n: the kernel in three layouts, its plain
   version, torch.fft (cuFFT) and a device copy of the same bytes — device
   time (CUDA events, median of 25 after warm-up) and the host's time per
   call.
6. Host time per call at a small batch (8 x 1024, where the host, not the
   card, bounds back-to-back calls): the c2c wrapper without and with
   autograd, `FFTContext.forward` and cuFFT, and the real path's wrapper,
   `RFFTContext.forward` and torch.fft.rfft, each over 200 calls.
7. Real kernels against their plain versions, every power-of-two
   n = 4..8192, forward and inverse, the fused r2c / c2r kernels and the
   hybrid (the c2c kernel through strides), batch-major, time-major and
   interleaved-complex layouts, at batch 3 and 2^22/n real points (limit
   1e-6 of the largest output; the inverse on spectra whose DC and Nyquist
   rows have nonzero imaginary parts). At batch 3 also against the f64
   oracle (MAX_REL), and per-bin and roundtrip checks at n = 64, 1024, 4096.
8. Real main path at full size: `create_rfft_f32(1024, device="cuda")` on
   [4096, 1024] f32 (BASELINE config 4) — forward, inverse, roundtrip,
   both plane forms (the folded time-major view [n, 8, W] runs the hybrid)
   and a backward through each direction — against torch.fft in float64
   (the inverse on a Hermitian-valid spectrum), with each kernel's launch
   count for that run.
9. STFT at the same scale: `stft(x, n_fft=1024, hop=256)` on 4095*256 +
   1024 samples (4096 frames) against framing x window -> torch.fft.rfft in
   float64, and `istft` back, with the launch counts of that run.
10. Real times at 2^22 real points per n (at n = 1024 that is the main
   path's shape): fused r2c and c2r, the hybrid forward and inverse and
   their c2c core launches alone, the plain versions, torch.fft.rfft /
   irfft (cuFFT, the library call the port never makes) and a device copy
   of the same bytes; at n = 1024 also the time-major forms.
11. Large-N kernels against their plain versions, every n = 2^13..2^24:
   each mode (the cube at n <= 2^14, pipe2 and 2d at every n), forward
   and inverse, three layouts (complex64, batch-major and time-major
   planes), batch 3 and 2^24/n (limit 1e-6 of the largest output); at
   batch 3 also against torch.fft.fft in complex128 (MAX_REL), and a
   roundtrip at 2^16 and 2^24.
12. Large main path at full size: `create_fft_f32(2**20, device="cuda")`
   on [16, 2^20] complex64 (BASELINE config 5, the planner's pipe2) —
   forward, inverse, roundtrip, both plane forms and a backward, against
   cuFFT in complex128, with each kernel's launch count for that run;
   then the same calls at [2048, 8192], where the planner takes the cube.
13. Large real path: `create_rfft_f32(2**20, device="cuda")` on [16, 2^20]
   f32 — forward, inverse on a Hermitian-valid spectrum, roundtrip, the
   plane forms and a backward through each direction, against torch.fft
   in float64, with the launch counts.
14. `fft_large` (one flat sequence, the "2d" mode) at n = 2^20 and 2^24,
   the matmul surface (`forward_planes_fourstep`) at 2^16, and the
   planner's route at n = 2^25 (the matmul surface), batch 1, against
   torch.fft.fft in complex128, with the launch counts.
15. Large times at 2^24 points per call for every n = 2^13..2^24: each mode
   (complex64 layout; pipe2 also time-major), stage 1 and stage 2 launched
   alone (time-major [n2, n1, b] blocks), the split's other order at 2^15
   and 2^21, the plain version (3 calls), torch.fft.fft and a device copy
   of the same bytes; then cube against pipe2 over batches at 2^13 and
   2^14 in complex64 and time-major planes, the planner's crossovers; and
   the large real path at its main shape (each direction, its core alone,
   torch.fft.rfft / irfft).
16. 2D kernels against their plain versions: the 2D cube at every
   power-of-two h, w >= 2 with h*w <= 2^14, forward and inverse, at batch 3
   in three layouts (batch-major planes, interleaved complex64, native
   [h, w, B]), the square sizes and the extremes 2x8192, 8192x2 also at
   2^20 points; the 2-pass route and each of its passes alone at
   h, w in {16, 256, 4096} (limit 1e-6 of the largest output); at batch 3
   also against torch.fft.fft2 in complex128 (MAX_REL).
17. 2D main path at full size: `fft2` / `ifft2` on one 4096 x 4096
   complex64 image (BASELINE config 5's 2D shape, the 2-pass route),
   `rfft2` / `irfft2` on 4096 x 4096 f32, `fft2` on [1024, 128, 128] (the
   cube) and [64, 512, 512] (2-pass), and `fft2_nb` on native
   [512, 512, 64] planes (the native row pass): forward, inverse,
   roundtrip and a backward against torch.fft in complex128 / float64,
   with each kernel's launch count for that run.
18. 2D times at 2^24 points per call, squares h = w = 16..4096 and the
   rectangles 128x8192, 8192x128, 2x4096: the cube, the 2-pass route, each
   pass alone, the native layout, the plain version (3 calls),
   torch.fft.fft2 (the library call the port never makes) and a device
   copy of the same bytes; rfft2 / irfft2 with the torch recombination
   timed alone; then cube against 2-pass over batches and layouts, the
   planner's crossover.
19. Bluestein kernels against their plain versions: #17 and #18 alone and
   the fused transform (the one-pass kernel), n = 2..64 and 13 larger n up
   to 2048, forward and inverse, three layouts (interleaved complex64,
   batch-major and time-major planes), batch 3 and 2^22/m transforms
   (limit 1e-6 of the largest output); the one-pass kernel also against
   #17 then #18 (its largest difference, and whether they are equal); at
   batch 3 also against torch.fft.fft in complex128.
20. Any-n main path at full size through `watfft_tpu_torch.fftlib`:
   fft / ifft / roundtrip / a backward on [4096, 1000] complex64 (n = 1000,
   m = 2048), the same rows padded to 1024 (the Stockham kernel), the
   prime n = 1009, rfft / irfft at n = 400 on [8, 3001, 400] (eight 30-s
   clips framed as Whisper frames them), irfft at odd n = 1001, the
   unfused route at n = 10007 (m = 32768, the four-step kernels) and
   fft2 / ifft2 on [4, 1000, 1000], against torch.fft in complex128 /
   float64, with each kernel's launch count for each run (the fused runs
   launch the one-pass kernel alone); then #17 and #18 through their own
   entry points (`bluestein_fwd`, `bluestein_inv`) on time-major
   [1000, 4096] planes, both directions.
21. Any-n times at 2^22 points per call, n in {100, 400, 1000, 1009, 2000,
   10007}: #17 and #18 alone, the one-pass kernel alone, the whole
   transform, the plain version, torch.fft.fft and a device copy of the
   same bytes; the main shapes of phase 20 beside torch.fft (and the
   unfused route's m-point transform alone); host time per call at
   [8, 1000]. #17, #18 and the one-pass kernel are then held against their
   plain versions at [4096, 1000] and timed there for the kernels line.
22. FP64 kernels (the f64 tier) against their plain versions in float64:
   the c2c kernel at every n = 2..4096 and the fused r2c / c2r kernels and
   the hybrid at every n = 4..8192, forward and inverse, three layouts
   (complex128, batch-major and time-major planes), at batch 3 and 2^21
   points (32 MiB of complex128; limit 1e-12 of the largest output); at
   batch 3 also against torch.fft in complex128 / float64 (MAX_REL 1e-9),
   and per-bin (n * 1e-10) and roundtrip (1.5e-10) checks at n = 64, 1024,
   4096.
23. f64 main path at full size, each run with its launch counts, against
   torch.fft in complex128 / float64: BASELINE config 1
   (`create_fft(1024)` on one complex128 transform); `create_fft(1024)` on
   [4096, 1024] complex128 (forward, inverse, roundtrip, both plane forms,
   a backward); `create_rfft(1024)` on [4096, 1024] float64 (both
   directions, the plane forms, a backward each way; the inverse on a
   Hermitian-valid spectrum); `create_fft(2**16)` and `create_rfft(2**16)`
   on the float64 matmul surface and `create_rfft_f32(2**26)` on the real
   matmul surface, where no FFT kernel launches.
24. f64 times at 2^21 points per n: the FP64 kernels, their plain versions,
   torch.fft in complex128 / float64 (the library call the port never
   makes) and a device copy of the same bytes; host time per call at
   batch 1, n = 1024 (BASELINE config 1) against torch.fft.fft; then the
   three FP64 kernels held against their plain versions and timed at the
   main shapes, [4096, 1024], for the kernels line.
25. The small-n DFT matmul (#20: the 3xTF32 tensor-core kernel, the FP32
   cores at n <= 2) against its plain version, the same product of the
   same f32 W and x summed in float64 (`dft_plain64`; limit 1e-6 of the
   largest output), at every n = 1..128, forward and inverse, three layouts
   (complex64, batch-major and time-major planes), batch 3 and 2^22/n; at
   both batches also against torch.fft in complex128 (MAX_REL), per bin
   (n * 5e-6) at every n, and the reading against the f32 plain version
   (one matmul in full f32, recorded: its own rounding is most of that
   difference); then #20's own path,
   `dft_matmul_nb` (the JAX signature) on time-major [128, 32768] and
   [16, 262144] forward and inverse and `dft_matmul` on the complex64
   layout, with its launch counts.
26. #20's times at 2^22 points per n = 2..128 in three layouts and, on
   complex64, the tensor-core kernel forced at n = 2 (`forced_mma`), beside
   the f32 c2c kernel (#1) on the same input, the plain
   version and torch.fft.fft, and its bound: bytes over 3.35 TB/s or the
   3xTF32 form's 3 * 8 n^2 flops a transform over the TF32 tensor-core rate
   (495 TFLOP/s); the kernels line's #20 rows at n = 128 and 16.
27. #1's bf16 tiers: the interop instance (bf16 planes, f32 stages) on
   time-major, batch-major and folded [n, 8, W] planes and the compute
   instance (`config.BF16_COMPUTE`, bf16 stages) on time-major planes,
   against their plain versions in bf16 at every n = 2..4096, batch 3 and
   2^22/n (limit 2^-7 of the largest output, one bf16 ulp); at batch 3
   against torch.fft in complex128 of the bf16 input (< 3e-2 interop,
   < 5e-2 compute) and the roundtrips (< 5e-2, < 1e-1). The main shape,
   bf16 [1024, 4096] time-major, in each tier: forward, inverse,
   roundtrip and a backward (the interop tier also batch-major and
   folded), each run with its launch counts (bf16 planes launch only their
   tier's instance). Times at 2^22 points per n: both tiers, the f32
   kernel on the same values, the plain versions, torch.fft.fft on
   complex32 (fp16, the nearest library call) and complex64, a device copy;
   the bound is 8 bytes a point.
28. The matmul surface's precision ladder: `forward_planes_fourstep` at
   n = 2^16 and 256 (the fftlib case) under `config.MXU_PRECISION`
   "highest" (within MAX_REL of torch.fft in complex128) and "default"
   (one TF32 pass, within 1e-2 of the largest output), with the device
   time; no kernel launches, and the caller's TF32 setting is back after
   every call.
29. The column tile (C > T adjacent transforms a block on walks down
   columns): the c2c kernel's four instances on time-major planes at
   n = 512..4096 (2^22 points and an odd tail of C * 132 + 3) and the
   strided kernel through fft2_cols (native [h, w, B], h = 512..4096,
   w = 2, 16, 4096), fft2_k2 on native [2, 4096, 2048], the pipe2 stages on
   the [n2, n1, b] blocks of [16, 2^20] and [1, 2^24], pipe2 at [16, 2^20]
   and fft2 on one 4096^2 image, forward and inverse: each against the
   same launch at C = T (`config.COLUMN_TILE = 0`, torch.equal) and its
   plain version (1e-6, 1e-12, 2^-7 of the largest output); each timed at
   C = T and at the kept C. Then a path run with its launch counts:
   `create_fft_f32(n).forward_planes_nb` on time-major [n, 2^22/n] at each
   n and fft2 on a 4096^2 image (against torch.fft in complex128).
30. The redesigned kernels at their main shapes: the cube (#12) on
   [2048, 8192] and [256, 16384] complex64, both directions, torch.equal
   to pipe2's kernels (the same operations in two passes) and within 1e-6
   of its plain version, timed beside pipe2; the fused f32 r2c (#9) at
   every n = 4..8192, batch 3 and 2^22 real points, complex64 and
   batch-major spectra, the resident kernel torch.equal to the engine's
   walk (the kernel before the redesign, each forced at every n through
   the walk argument `rfft.r2c_launch` passes) and within 1e-6 of its
   plain version, timed in both walks. The kernels line's #12 and #9 rows
   carry what they were held to and the time in the other walk. Their
   launch counts come from the cube path of phase 12 and the real path of
   phase 8, which run them.
31. The redesigned batch-major walk (`stockham_c2c_resident_kernel`,
   `rfft_r2c_block_f64_kernel`), each launch forced in every walk
   (`forced_walk`: the engine's, the kernel before the redesign; resident
   blocks with two buffers; a block a tile): the c2c kernel at every
   n = 2..4096 in f32 and FP64, both directions, in four layouts
   (interleaved complex, split planes, views one scalar off alignment
   whose pairs are refused, the real core's even and odd rows) at batch 1,
   a tail under one tile, more tiles than the resident grid by a tail and
   2^22 points, and the rows pass of one 4096^2 image; the FP64 r2c at
   every n = 4..8192 in four layouts at the same kinds of batch. The
   redesigned walks torch.equal to the engine's and within 1e-6 (f32) /
   1e-12 (FP64) of the plain version; each case timed in the three walks
   in turns, and the real core (batch-major and time-major), the hybrid
   real route and the end-to-end calls `create_fft_f32(1024)`,
   `create_fft(1024)` and a 4096^2 fft2 likewise. The kernels line's
   #1/#4, #16, #19, FP64 r2c and real core rows gain the walk the rule
   takes and `old_walk_ms`, their time in the engine's walk. Their launch
   counts come from the main paths of phases 4, 8, 17 and 23, which run
   the redesigned walk.
32. The redesigned f32 c2r (`irfft_c2r_resident_kernel`) and 2D cube
   (`fft2_cube_block_kernel`), each launch forced in every walk
   (`forced_walk`; the cube's also with its row pass storing after the
   pass and from its last stage): the c2r at every n = 4..8192 in four
   layouts (interleaved complex, split planes, time-major planes, the
   interleaved spectrum one scalar off alignment into signal rows one
   scalar off) at batch 1, 3, past the resident grid by a tail and 2^22
   real points; the cube at every h*w <= 2^14 in four layouts (complex64,
   batch-major and native planes, rfft2's / irfft2's packed real layout)
   at batch 1, 5 and past the SMs by a tail, both directions. Every
   redesigned walk torch.equal to the engine's (the kernels before the
   redesign) and within 1e-6 of the plain version; timed in each walk in
   turns: the c2r at every n, the cube at the squares 16^2..128^2 (2^24
   points) in three layouts and rfft2 / irfft2 there, and the end-to-end
   `create_rfft_f32(1024).inverse`, the STFT's inverse and its frames'
   transform alone (each the median of five rounds) and fft2 on
   [1024, 128, 128]; beside them
   `create_rfft(1024).inverse` (the FP64 c2r, which keeps the engine's
   walk) and `torch.fft.fft` / `ifft` along dim 0 of the time-major real
   core's complex [512, 4096]. The kernels line's c2r and 2D cube rows
   gain the walk the rule takes and `old_walk_ms`, the FP64 c2r's the walk
   it runs; their launch counts come from the main paths of phases 8, 9,
   17 and 23, which run the rules' walks.
33. The sharded faces (`watfft_tpu_torch/parallel`) at world 1 on NCCL
   (an in-memory store): `fft_batch_sharded`, `rfft_batch_sharded` and
   `irfft_batch_sharded` on [4096, 1024] (BASELINE config 4),
   `fft2_sharded`, `rfft2_sharded` and `irfft2_sharded` on one 4096^2
   image (config 5), `fft2_sharded` with `batch_axis` on a (1, 1) mesh on
   [4, 1024, 1024], `fft_large_sharded` at 2^24, `rfft_large_sharded` /
   `irfft_large_sharded` at 2^25, `stft_sharded` on phase 9's signal and
   the `fft2_sharded` backward: each with torch.fft patched to raise,
   its launch counts (the kernels the face names and no others), within
   KERNEL_LIMIT of the port's single-device function, within MAX_REL of
   torch.fft in float64, round trips within ROUNDTRIP, timed beside the
   single-device function (the backward at the energy's cotangent, fft2's
   backward at the same one, and within 1e-3 of 2x); the a2a of one 64 MiB plane and a pack and an
   unpack as four ranks would lay them out, timed apart; one `sharded`
   line. Then `dryrun.faces` at its mid sizes, world 1, for phase 34.
34. `dryrun.faces` on four gloo ranks of the one card (CUDA tensors; NCCL
   refuses two ranks a GPU), a (4,) and a (2, 2) mesh, the kernels built
   before the ranks start: the ranks' outputs put together within
   KERNEL_LIMIT of world 1's; each phase prints its wall seconds.

The line before the last is a JSON object naming each kernel of the paths
with its launch count, error, times and the least time the card could take
(its bytes at 3.35 TB/s or its flops at 67 TFLOP/s, 34 TFLOP/s for the
FP64 kernels, whichever is larger; the bf16 rows have no library call);
the last line is {"ok": true, "device": {...}}. Phase 3 also holds the
c2c kernel against its plain version in the batch-major planes layout
(`stockham_fft_bm`, the port of `_kernel_bm`).
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time

import torch

import watfft_tpu_torch as wtt
from watfft_tpu_torch import (config, create_fft, create_fft_f32, create_rfft, create_rfft_f32,
                              fftlib, planner)
from watfft_tpu_torch import stft as wstft
from watfft_tpu_torch.ops import _build
from watfft_tpu_torch.ops import bluestein as bl
from watfft_tpu_torch.ops import fft2 as f2
from watfft_tpu_torch.ops import large as lg
from watfft_tpu_torch.ops import mxu_dft as md
from watfft_tpu_torch.ops import rfft as rf
from watfft_tpu_torch.ops import stockham as st
from watfft_tpu_torch.reference import dft as ref
from watfft_tpu_torch.utils.accuracy import rel_errors
from watfft_tpu_torch.utils.tolerances import MAX_REL, PER_BIN, ROUNDTRIP

KERNEL_LIMIT = 1e-6      # kernel vs plain version: max |diff| / max |plain|
POINTS = 1 << 22         # 32 MiB of complex64 (16 MiB of f32) per buffer at every n
MAIN_N, MAIN_B = 1024, 4096
SIZES = [1 << k for k in range(1, 13)]
REAL_SIZES = [1 << k for k in range(2, 14)]
STFT_HOP = 256
LARGE_POINTS = 1 << 24   # 128 MiB of complex64 per buffer at every large n
LARGE_SIZES = [1 << k for k in range(13, 25)]
LARGE_N, LARGE_B = 1 << 20, 16
CUBE_N, CUBE_B = 1 << 13, 2048
SINGLE_SIZES = (1 << 20, 1 << 24)        # fft_large, one flat sequence
FOURSTEP_N, PLANNER_FOURSTEP_N = 1 << 16, 1 << 25
CROSSOVER_BATCHES = (1, 2, 4, 8, 16, 32, 64, 132, 264, 1024)
LARGE_SRC = "watfft_tpu_torch/ops/csrc/large.cu"
# the 2D cube at every h*w <= 2^14; squares and extremes also at 2^20 points
FFT2_PAIRS = [(1 << a, 1 << b) for a in range(1, 14) for b in range(1, 15 - a)]
FFT2_WIDE = [(1 << k, 1 << k) for k in range(1, 8)] + [(2, 1 << 13), (1 << 13, 2)]
FFT2_PASS_SIZES = (16, 256, 4096)
FFT2_POINTS, FFT2_TIME_POINTS = 1 << 20, 1 << 24
FFT2_MAIN = 4096                           # one 4096 x 4096 image (BASELINE config 5)
FFT2_CUBE_SHAPE, FFT2_2PASS_SHAPE = (1024, 128, 128), (64, 512, 512)
FFT2_TIME_SHAPES = [(1 << k, 1 << k) for k in range(4, 13)] + [(128, 8192), (8192, 128),
                                                                  (2, 4096)]
FFT2_CROSS_SHAPES = [(64, 64), (64, 128), (128, 128), (16, 1024), (1024, 16), (64, 256),
                     (32, 512)]
FFT2_CROSS_BATCHES = (1, 16, 64, 96, 128, 160, 192, 256, 1024)
FFT2_SRC = "watfft_tpu_torch/ops/csrc/fft2.cu"
# the any-n path: #17 and #18 at n = 2..64 and at these n
BL_SIZES = list(range(2, 65)) + [97, 127, 360, 400, 509, 1000, 1001, 1009, 1023, 1025, 1500,
                                 2047, 2048]
BL_MAIN_B, BL_MAIN_N = 4096, 1000          # the JAX package's Bluestein point, m = 2048
BL_PRIME_N, BL_ODD_N = 1009, 1001
BL_REAL_SHAPE, BL_REAL_HOP = (8, 3001, 400), 160   # Whisper: 30-s clips, 16 kHz, n_fft 400
BL_UNFUSED_B, BL_UNFUSED_N = 256, 10007    # m = 32768: the four-step kernels
BL_2D_SHAPE = (4, 1000, 1000)
BL_TIME_SIZES = (100, 400, 1000, 1009, 2000, 10007)
BL_SRC = "watfft_tpu_torch/ops/csrc/bluestein.cu"
# the f64 tier: 2^21 points (32 MiB of complex128) per buffer at every n
F64_KERNEL_LIMIT = 1e-12
F64_POINTS = 1 << 21
F64_FOURSTEP_N, F32_REAL_FOURSTEP_N = 1 << 16, 1 << 26
F64_SRC = {"c2c": "watfft_tpu_torch/ops/csrc/stockham.cu",
           "real": "watfft_tpu_torch/ops/csrc/rfft.cu"}
# #20 at every n = 1..128, timed at 2..128; the kernels line's #20 rows at
# these n
DFT_SIZES = list(range(1, 129))
DFT_TIME_SIZES = [1 << k for k in range(1, 8)]
DFT_ROWS = (128, 16)
DFT_SRC = "watfft_tpu_torch/ops/csrc/mxu_dft.cu"
# the bf16 tiers: kernel vs plain version in bf16 (max |diff| / max |plain|,
# one bf16 ulp at the largest output); against torch.fft in complex128 and
# roundtrips, the bounds of tests/test_bf16.py
BF16_KERNEL_LIMIT = 2.0 ** -7
BF16_ORACLE = {"interop": 3e-2, "compute": 5e-2}
BF16_ROUNDTRIP = {"interop": 5e-2, "compute": 1e-1}
# the matmul surface's precision ladder: forward_planes_fourstep at (n, batch),
# and whether cuBLAS must show the switch there: at 2^16 "default" (TF32) has
# to be at least LADDER_TF32_GAIN times further off than "highest", so a
# ladder that never turns TF32 on fails. [4, 256] is the fftlib case of
# tests/test_fftlib.py, whose tiny products cuBLAS ran without TF32 on an
# H100 (PERF.md), and [4096, 256] asks whether a wider batch of them takes it.
LADDER_CASES = ((1 << 16, 4, True), (256, 4, False), (256, 4096, False))
LADDER_DEFAULT_LIMIT = 1e-2
LADDER_TF32_GAIN = 10.0
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, FP32 flop/s
# outside the tensor cores, FP64 flop/s (non-tensor) and TF32 flop/s on the
# tensor cores (dense)
PEAK_BYTES, PEAK_FLOPS, PEAK_FLOPS_F64 = 3.35e12, 67e12, 34e12
PEAK_FLOPS_TF32 = 495e12
# the column tile: the c2c kernel's four instances (tier, planes, tables,
# limit against the plain version) at these n on time-major planes; the
# strided kernel through fft2_cols at these widths, fft2_k2 on native
# [2, 4096, 2048] and the pipe2 stages of [sequences, n]
COL_SIZES = (512, 1024, 2048, 4096)
COL_TIERS = (("f32", torch.float32, torch.float32, KERNEL_LIMIT),
             ("f64", torch.float64, torch.float64, F64_KERNEL_LIMIT),
             ("bf16", torch.bfloat16, torch.float32, BF16_KERNEL_LIMIT),
             ("bf16c", torch.bfloat16, torch.bfloat16, BF16_KERNEL_LIMIT))
COL_FFT2_WIDTHS = (2, 16, 4096)
COL_K2_SHAPE = (2, 4096, 2048)
COL_PIPE2 = ((LARGE_B, LARGE_N), (1, 1 << 24))
# the redesigned cube's main shapes (sequences, n); the redesigned r2c runs at
# every REAL_SIZES n
CUBE_SHAPES = ((CUBE_B, CUBE_N), (256, 1 << 14))
# the redesigned batch-major walk: the c2c's tiers (complex dtype, limit
# against the plain version) and the walks it is held and timed in
WALK_TIERS = (("f32", torch.complex64, KERNEL_LIMIT), ("f64", torch.complex128, F64_KERNEL_LIMIT))
WALKS = (("engine", st.WALK_ENGINE), ("resident", st.WALK_RESIDENT), ("block", st.WALK_BLOCK))


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def card() -> tuple[str, str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(out, flush=True)
    name, limit = (s.strip() for s in out.split(",", 1))
    return name, limit


def rand_complex(shape, gen, dev) -> torch.Tensor:
    re = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    im = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    return torch.complex(re, im)


def rand_real(shape, gen, dev) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=dev) * 2 - 1


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def time_ms(fn, reps: int = 25, warmup: int = 3) -> tuple[float, float]:
    """(device_ms, call_ms) of one call. device_ms: median over `reps` CUDA
    event pairs, recorded while the stream is held behind a sleep kernel
    that outlasts the enqueueing, so the host's time to issue a call does
    not show. call_ms: host wall time per call of `reps` back-to-back calls
    ending in a synchronize (what a caller waits, Python included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    call_s = (time.perf_counter() - t0) / reps
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(int(min(reps * call_s * 4e9, 4e10)))  # cycles; > 2x the enqueue time
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev), call_s * 1e3


def phase_kernel_vs_plain(dev, gen) -> None:
    for n in SIZES:
        worst = 0.0
        for batch in (3, POINTS // n):
            x = rand_complex((batch, n), gen, dev)
            xt_re, xt_im = x.real.T.contiguous(), x.imag.T.contiguous()
            x_re, x_im = x.real.contiguous(), x.imag.contiguous()
            for inverse in (False, True):
                y = st.stockham_fft(x, inverse)
                p = st.plain_fft(x, inverse)
                d = rel_diff(y, p)
                tre, tim = st.stockham_fft_nb(xt_re, xt_im, inverse)
                d_nb = rel_diff(torch.complex(tre, tim).T, p)
                bre, bim = st.stockham_fft_bm(x_re, x_im, inverse)
                d_bm = rel_diff(torch.complex(bre, bim), p)
                worst = max(worst, d, d_nb, d_bm)
                check(max(d, d_nb, d_bm) <= KERNEL_LIMIT,
                      f"n={n} batch={batch} inverse={inverse}: kernel vs plain "
                      f"{d:.3e} (complex) {d_nb:.3e} (time-major) {d_bm:.3e} (batch-major)")
                if batch == 3:
                    xs = x.cpu().numpy()
                    exp = ref.idft(xs) if inverse else ref.dft(xs)
                    e = rel_errors(y.cpu().numpy(), exp)[0]
                    check(e <= MAX_REL["float32"],
                          f"n={n} inverse={inverse}: max rel {e:.3e} vs oracle")
        line = {"phase": "kernel_vs_plain", "n": n, "max_rel_diff": worst}
        if n in (64, 1024, 4096):
            t = torch.arange(n, device=dev, dtype=torch.float64)
            basis = torch.exp(2j * torch.pi * torch.outer(t, t) / n).to(torch.complex64)
            eye = n * torch.eye(n, device=dev, dtype=torch.complex64)
            per_bin = (st.stockham_fft(basis) - eye).abs().max().item()
            x = rand_complex((3, n), gen, dev)
            rt = (st.stockham_fft(st.stockham_fft(x), True) - x).abs().max().item()
            check(per_bin < PER_BIN["float32"](n), f"n={n}: per-bin error {per_bin:.3e}")
            check(rt < ROUNDTRIP["float32"], f"n={n}: roundtrip error {rt:.3e}")
            line.update(per_bin_err=per_bin, roundtrip_err=rt)
        print(json.dumps(line), flush=True)


def phase_main_path(dev, gen) -> tuple[int, float]:
    ctx = create_fft_f32(MAIN_N, device="cuda")
    x = rand_complex((MAIN_B, MAIN_N), gen, dev)
    g = rand_complex((MAIN_B, MAIN_N), gen, dev)
    re, im = x.real.contiguous(), x.imag.contiguous()
    re_t, im_t = re.T.contiguous(), im.T.contiguous()
    xg = x.clone().requires_grad_()
    torch.cuda.synchronize()

    zero_counts()
    y = ctx.forward(x)
    xi = ctx.inverse(x)
    back = ctx.inverse(y)
    pre, pim = ctx.forward_planes(re, im)
    nre, nim = ctx.forward_planes_nb(re_t, im_t)
    ctx.forward(xg).backward(g)
    torch.cuda.synchronize()
    launches = st.launches
    check(counts() == expect(stockham_c2c=7), f"main path: launches {counts()} for 7 calls")

    x128 = x.to(torch.complex128)
    fwd_err = rel_errors(y.cpu().numpy(), torch.fft.fft(x128).cpu().numpy())[0]
    inv_err = rel_errors(xi.cpu().numpy(), torch.fft.ifft(x128).cpu().numpy())[0]
    rt_err = (back - x).abs().max().item()
    planes_diff = max(rel_diff(torch.complex(pre, pim), y),
                      rel_diff(torch.complex(nre, nim).T, y))
    grad_exact = (xg.grad - ctx.inverse(g) * MAIN_N).abs().max().item()
    grad_err = rel_errors(xg.grad.cpu().numpy(),
                          (torch.fft.ifft(g.to(torch.complex128)) * MAIN_N).cpu().numpy())[0]
    max_abs_err = (y - st.plain_fft(x)).abs().max().item()
    conj_err = rel_errors(ctx.forward(x.conj()).cpu().numpy(),
                          torch.fft.fft(x128.conj()).cpu().numpy())[0]
    print(json.dumps({"phase": "main_path", "n": MAIN_N, "batch": MAIN_B,
                      "launches": launches, "fwd_max_rel_vs_cufft_c128": fwd_err,
                      "inv_max_rel_vs_cufft_c128": inv_err, "roundtrip_err": rt_err,
                      "planes_vs_complex": planes_diff, "grad_vs_conj_transform": grad_exact,
                      "grad_max_rel_vs_cufft_c128": grad_err,
                      "kernel_vs_plain_max_abs": max_abs_err,
                      "conj_view_max_rel_vs_cufft_c128": conj_err}), flush=True)
    check(fwd_err <= MAX_REL["float32"], f"main path forward: max rel {fwd_err:.3e}")
    check(inv_err <= MAX_REL["float32"], f"main path inverse: max rel {inv_err:.3e}")
    check(conj_err <= MAX_REL["float32"], f"main path on x.conj(): max rel {conj_err:.3e}")
    check(rt_err < ROUNDTRIP["float32"], f"main path roundtrip: {rt_err:.3e}")
    check(planes_diff <= KERNEL_LIMIT, f"plane entry points vs forward: {planes_diff:.3e}")
    check(grad_exact == 0.0, f"backward vs n * inverse: {grad_exact:.3e}")
    check(grad_err <= MAX_REL["float32"], f"backward vs cuFFT: max rel {grad_err:.3e}")
    check(bool(torch.isfinite(y).all()) and y.shape == x.shape, "main path output")
    return launches, max_abs_err


def phase_times(dev, gen, name: str, limit: str) -> dict:
    times = {}
    for n in SIZES:
        batch = POINTS // n
        x = rand_complex((batch, n), gen, dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        re_t, im_t = re.T.contiguous(), im.T.contiguous()
        xt = x.T.contiguous()
        out = torch.empty_like(x)
        fns = {
            "kernel_fwd": lambda: st.stockham_fft(x),
            "kernel_inv": lambda: st.stockham_fft(x, True),
            "kernel_planes_bm_fwd": lambda: st.stockham_fft_bm(re, im),
            "kernel_planes_nb_fwd": lambda: st.stockham_fft_nb(re_t, im_t),
            "plain_fwd": lambda: st.plain_fft(x),
            "plain_inv": lambda: st.plain_fft(x, True),
            "cufft_fwd": lambda: torch.fft.fft(x),
            "cufft_inv": lambda: torch.fft.ifft(x),
            # the library call for time-major [n, B] (#2): the transform down dim 0
            "cufft_nb_fwd": lambda: torch.fft.fft(xt, dim=0),
            "copy": lambda: out.copy_(x),  # the same 16 B per point, no FFT
        }
        row = {}
        for key, fn in fns.items():
            dev_ms, call_ms = time_ms(fn)
            row[key + "_ms"] = dev_ms
            row[key + "_call_ms"] = call_ms
            row[key + "_GBps"] = 16 * POINTS / (dev_ms * 1e-3) / 1e9
        times[n] = row
        print(json.dumps({"phase": "times", "n": n, "batch": batch, **row,
                          "card": name, "power_limit": limit}), flush=True)
    return times


def phase_host(dev, gen, name: str, limit: str) -> None:
    n, batch = MAIN_N, 8
    ctx = create_fft_f32(n, device="cuda")
    x = rand_complex((batch, n), gen, dev)
    xg = x.clone().requires_grad_()
    rctx = create_rfft_f32(n, device="cuda")
    xr = rand_real((batch, n), gen, dev)
    fns = {
        "wrapper": lambda: st.stockham_fft(x),
        "wrapper_autograd": lambda: st.stockham_fft(xg),
        "ctx_forward": lambda: ctx.forward(x),
        "cufft": lambda: torch.fft.fft(x),
        "rfft_wrapper": lambda: rf.rfft(xr),
        "rctx_forward": lambda: rctx.forward(xr),
        "cufft_rfft": lambda: torch.fft.rfft(xr),
    }
    row = {}
    for key, fn in fns.items():
        dev_ms, call_ms = time_ms(fn, reps=200)
        row[key + "_ms"] = dev_ms
        row[key + "_call_ms"] = call_ms
    print(json.dumps({"phase": "host", "n": n, "batch": batch, **row,
                      "card": name, "power_limit": limit}), flush=True)


def zero_counts() -> None:
    st.launches = 0
    st.launches_f64 = 0
    st.launches_bf16 = 0
    st.launches_bf16c = 0
    md.launches = 0
    for key in rf.launches:
        rf.launches[key] = 0
    for key in lg.launches:
        lg.launches[key] = 0
    for key in f2.launches:
        f2.launches[key] = 0
    for key in bl.launches:
        bl.launches[key] = 0


def counts() -> dict:
    return {"stockham_c2c": st.launches, "stockham_c2c_f64": st.launches_f64,
            "stockham_c2c_bf16": st.launches_bf16, "stockham_c2c_bf16c": st.launches_bf16c,
            "mxu_dft": md.launches, **rf.launches,
            **{"large_" + k: v for k, v in lg.launches.items()}, **f2.launches, **bl.launches}


def expect(**launched) -> dict:
    """The counts of a run that launched these kernels and no other."""
    want = {key: 0 for key in counts()}
    want.update(launched)
    return want


def hermitian_valid(spec: torch.Tensor) -> torch.Tensor:
    """spec with the imaginary parts of its DC and Nyquist bins set to 0:
    the spectra cuFFT's c2r defines a result for."""
    spec = spec.clone()
    spec[..., 0] = spec[..., 0].real
    spec[..., -1] = spec[..., -1].real
    return spec


def phase_real_kernel_vs_plain(dev, gen) -> None:
    for n in REAL_SIZES:
        m = n // 2
        worst = 0.0
        for batch in (3, POINTS // n):
            x = rand_real((batch, n), gen, dev)
            spec = torch.complex(rand_real((batch, m + 1), gen, dev),
                                 rand_real((batch, m + 1), gen, dev))
            want, want_inv = rf.plain_rfft(x), rf.plain_irfft(spec)
            xt = x.T.contiguous()
            sre, sim = spec.real.contiguous(), spec.imag.contiguous()
            for fused in (True, False):
                fwd_nb = rf.rfft_nb_fused if fused else rf.rfft_nb
                inv_nb = rf.irfft_nb_fused if fused else rf.irfft_nb
                diffs = {
                    "fwd_complex": rel_diff(rf.rfft(x, fused), want),
                    "fwd_bm": rel_diff(torch.complex(*rf.rfft_bm(x, fused)), want),
                    "fwd_nb": rel_diff(torch.complex(*fwd_nb(xt)).T, want),
                    "inv_complex": rel_diff(rf.irfft(spec, fused), want_inv),
                    "inv_bm": rel_diff(rf.irfft_bm(sre, sim, fused), want_inv),
                    "inv_nb": rel_diff(inv_nb(sre.T.contiguous(), sim.T.contiguous()).T,
                                       want_inv),
                }
                worst = max(worst, *diffs.values())
                check(max(diffs.values()) <= KERNEL_LIMIT,
                      f"real n={n} batch={batch} fused={fused}: kernel vs plain {diffs}")
            if batch == 3:
                xs = x.double().cpu().numpy()
                e = rel_errors(rf.rfft(x).cpu().numpy(), ref.real_dft(xs))[0]
                check(e <= MAX_REL["float32"], f"real n={n}: forward max rel {e:.3e} vs oracle")
                hs = hermitian_valid(spec.cdouble()).cpu().numpy()
                got = rf.irfft(torch.from_numpy(hs).to(dev, torch.complex64))
                e_inv = rel_errors(got.cpu().numpy(), ref.real_idft(hs, n))[0]
                check(e_inv <= MAX_REL["float32"],
                      f"real n={n}: inverse max rel {e_inv:.3e} vs oracle")
        line = {"phase": "real_kernel_vs_plain", "n": n, "max_rel_diff": worst}
        if n in (64, 1024, 4096):
            t = torch.arange(n, device=dev, dtype=torch.float64)
            k = torch.arange(m + 1, device=dev, dtype=torch.float64)
            basis = torch.cos(2 * torch.pi * torch.outer(k, t) / n).float()  # [bin, time]
            expect = torch.diag(torch.full((m + 1,), n / 2, device=dev, dtype=torch.float64))
            expect[0, 0] = expect[m, m] = n
            per_bin = (rf.rfft(basis).cdouble() - expect).abs().max().item()
            x = rand_real((3, n), gen, dev)
            rt = (rf.irfft(rf.rfft(x)) - x).abs().max().item()
            check(per_bin < PER_BIN["float32"](n), f"real n={n}: per-bin error {per_bin:.3e}")
            check(rt < ROUNDTRIP["float32"], f"real n={n}: roundtrip error {rt:.3e}")
            line.update(per_bin_err=per_bin, roundtrip_err=rt)
        print(json.dumps(line), flush=True)


def phase_real_main_path(dev, gen) -> tuple[dict, dict]:
    n, m = MAIN_N, MAIN_N // 2
    ctx = create_rfft_f32(n, device="cuda")
    x = rand_real((MAIN_B, n), gen, dev)
    spec = hermitian_valid(torch.fft.rfft(rand_real((MAIN_B, n), gen, dev).double()))
    spec32 = spec.to(torch.complex64)
    g = torch.complex(rand_real((MAIN_B, m + 1), gen, dev), rand_real((MAIN_B, m + 1), gen, dev))
    ybar = rand_real((MAIN_B, n), gen, dev)
    x_t = x.T.contiguous()
    folded = x_t.view(n, 8, MAIN_B // 8)
    xg, sg = x.clone().requires_grad_(), spec32.clone().requires_grad_()
    torch.cuda.synchronize()

    zero_counts()
    y = ctx.forward(x)
    xi = ctx.inverse(spec32)
    back = ctx.inverse(y)
    pre, pim = ctx.forward_planes(x)
    bx = ctx.inverse_planes(spec32.real, spec32.imag)
    nre, nim = ctx.forward_planes_nb(x_t)
    fre, fim = ctx.forward_planes_nb(folded)           # the hybrid, as in the JAX API
    fback = ctx.inverse_planes_nb(fre, fim)
    ctx.forward(xg).backward(g)
    ctx.inverse(sg).backward(ybar)
    torch.cuda.synchronize()
    launches = counts()
    want = expect(stockham_c2c=2, rfft_r2c_fused=5, irfft_c2r_fused=5, real_core_fwd=1,
                  real_core_inv=1)
    check(launches == want, f"real main path: launches {launches}, expected {want}")

    x64 = x.double()
    fwd_err = rel_errors(y.cpu().numpy(), torch.fft.rfft(x64).cpu().numpy())[0]
    inv_err = rel_errors(xi.cpu().numpy(), torch.fft.irfft(spec, n).cpu().numpy())[0]
    rt_err = max((back - x).abs().max().item(), (fback.reshape(n, -1).T - x).abs().max().item())
    planes_diff = max(rel_diff(torch.complex(pre, pim), y), rel_diff(torch.complex(nre, nim).T, y),
                      rel_diff(bx, xi))
    hybrid_diff = rel_diff(torch.complex(fre, fim).reshape(m + 1, -1).T, y)
    # backward: torch.fft.rfft's own gradient (same convention: the
    # imaginary end rows are constants); the inverse's is the JAX adjoint
    # identity, VJP(irfft)(y) = rfft(y)/m with its end-row corrections
    x64g = x64.clone().requires_grad_()
    torch.fft.rfft(x64g).backward(g.cdouble())
    grad_fwd_err = rel_errors(xg.grad.cpu().numpy(), x64g.grad.cpu().numpy())[0]
    r = torch.fft.rfft(ybar.double())
    gre = r.real.clone()
    gre[:, [0, m]] *= 0.5
    gim = r.imag.clone()
    gim[:, 0], gim[:, m] = -0.5 * r.real[:, m], -0.5 * r.real[:, 0]
    grad_inv_err = rel_errors(sg.grad.cpu().numpy(), (torch.complex(gre, gim) / m).cpu().numpy())[0]
    # each kernel against its plain version on the same inputs (the hybrid's
    # inverse again on spec32, off the counted run)
    plain_y, plain_xi = rf.plain_rfft(x), rf.plain_irfft(spec32)
    hyb_fwd = torch.complex(fre, fim).reshape(m + 1, -1).T
    hyb_inv = rf.irfft_nb(spec32.real.T.contiguous(), spec32.imag.T.contiguous()).T
    errs = {"rfft_r2c_fused": (y - plain_y).abs().max().item(),
            "irfft_c2r_fused": (xi - plain_xi).abs().max().item(),
            "real_core_fwd": (hyb_fwd - plain_y).abs().max().item(),
            "real_core_inv": (hyb_inv - plain_xi).abs().max().item()}
    print(json.dumps({"phase": "real_main_path", "n": n, "batch": MAIN_B, "launches": launches,
                      "fwd_max_rel_vs_torch_fft_f64": fwd_err,
                      "inv_max_rel_vs_torch_fft_f64": inv_err, "roundtrip_err": rt_err,
                      "planes_vs_complex": planes_diff, "folded_hybrid_vs_fused": hybrid_diff,
                      "grad_fwd_max_rel_vs_torch_f64": grad_fwd_err,
                      "grad_inv_max_rel_vs_adjoint_f64": grad_inv_err,
                      "kernel_vs_plain_max_abs": errs}), flush=True)
    check(fwd_err <= MAX_REL["float32"], f"real main path forward: max rel {fwd_err:.3e}")
    check(inv_err <= MAX_REL["float32"], f"real main path inverse: max rel {inv_err:.3e}")
    check(rt_err < ROUNDTRIP["float32"], f"real main path roundtrip: {rt_err:.3e}")
    check(planes_diff <= KERNEL_LIMIT, f"real plane entry points vs complex: {planes_diff:.3e}")
    check(hybrid_diff <= KERNEL_LIMIT, f"folded hybrid vs fused: {hybrid_diff:.3e}")
    check(grad_fwd_err <= MAX_REL["float32"], f"rfft backward: max rel {grad_fwd_err:.3e}")
    check(grad_inv_err <= MAX_REL["float32"], f"irfft backward: max rel {grad_inv_err:.3e}")
    check(bool(torch.isfinite(y).all()) and y.shape == (MAIN_B, m + 1), "real main path output")
    return launches, errs


def phase_stft(dev, gen) -> dict:
    n_fft, hop = MAIN_N, STFT_HOP
    sig = rand_real(((MAIN_B - 1) * hop + n_fft,), gen, dev)
    torch.cuda.synchronize()
    zero_counts()
    re, im = wstft.stft(sig, n_fft=n_fft, hop=hop)
    back = wstft.istft(re, im, n_fft=n_fft, hop=hop, length=sig.shape[-1])
    torch.cuda.synchronize()
    launches = counts()
    want_counts = expect(rfft_r2c_fused=1, irfft_c2r_fused=1)
    check(launches == want_counts, f"stft: launches {launches}, expected {want_counts}")
    w = torch.as_tensor(wstft.get_window("hann", n_fft), device=dev, dtype=torch.float64)
    want = torch.fft.rfft(sig.double().unfold(-1, n_fft, hop) * w)
    err = rel_errors(torch.complex(re, im).cpu().numpy(), want.cpu().numpy())[0]
    rt = (back - sig)[n_fft:-n_fft].abs().max().item()  # the ends: window power ~0
    print(json.dumps({"phase": "stft", "samples": sig.shape[-1], "frames": re.shape[-2],
                      "bins": re.shape[-1], "launches": launches,
                      "max_rel_vs_torch_fft_f64": err, "istft_roundtrip_err": rt}), flush=True)
    check(re.shape == (MAIN_B, n_fft // 2 + 1), f"stft output shape {tuple(re.shape)}")
    check(err <= MAX_REL["float32"], f"stft: max rel {err:.3e} vs torch.fft in float64")
    check(rt < ROUNDTRIP["float32"], f"istft roundtrip: {rt:.3e}")
    return launches


def phase_real_times(dev, gen, name: str, limit: str) -> dict:
    times = {}
    for n in REAL_SIZES:
        m, batch = n // 2, POINTS // n
        x = rand_real((batch, n), gen, dev)
        spec = torch.complex(rand_real((batch, m + 1), gen, dev),
                             rand_real((batch, m + 1), gen, dev))
        xv = x.view(batch, n).T  # the hybrid's [n, B] views, batch-major
        zre, zim = (torch.empty(batch, m, device=dev).T for _ in range(2))
        z = torch.complex(rand_real((batch, m), gen, dev), rand_real((batch, m), gen, dev))
        zv = torch.view_as_real(z).view(batch, m, 2)
        out = torch.empty(batch, n, device=dev)
        fwd_t, inv_t = rf.device_rtables(n, False, dev), rf.device_rtables(n, True, dev)
        c = fwd_t.core
        ci = inv_t.core
        fns = {
            "r2c_fused": lambda: rf.rfft(x),
            "c2r_fused": lambda: rf.irfft(spec),
            "hybrid_fwd": lambda: rf.rfft(x, fused=False),
            "hybrid_inv": lambda: rf.irfft(spec, fused=False),
            "core_fwd": lambda: st.fft_views(xv[0::2], xv[1::2], zre, zim, False, c),
            "core_inv": lambda: st.fft_views(zv[..., 0].T, zv[..., 1].T, out.T[0::2],
                                             out.T[1::2], True, ci),
            "plain_r2c": lambda: rf.plain_rfft(x),
            "plain_c2r": lambda: rf.plain_irfft(spec),
            "plain_core_fwd": lambda: st.run_stages(xv[0::2], xv[1::2], m, False, c.offsets,
                                                    c.stages, c.twre, c.twim),
            "plain_core_inv": lambda: st.run_stages(zv[..., 0].T, zv[..., 1].T, m, True,
                                                    ci.offsets, ci.stages, ci.twre, ci.twim),
            "lib_rfft": lambda: torch.fft.rfft(x),
            "lib_irfft": lambda: torch.fft.irfft(spec, n),
            "lib_core_fwd": lambda: torch.fft.fft(torch.view_as_complex(x.view(batch, m, 2))),
            "lib_core_inv": lambda: torch.fft.ifft(z),
            "copy": lambda: out.copy_(x),  # the 8 B per real point the r2c moves
        }
        if n == MAIN_N:
            x_t = x.T.contiguous()
            sre_t, sim_t = spec.real.T.contiguous(), spec.imag.T.contiguous()
            fns.update({
                "r2c_fused_nb": lambda: rf.rfft_nb_fused(x_t),
                "c2r_fused_nb": lambda: rf.irfft_nb_fused(sre_t, sim_t),
                "hybrid_fwd_folded": lambda: rf.rfft_nb(x_t.view(n, 8, -1)),
            })
        row = {}
        for key, fn in fns.items():
            dev_ms, call_ms = time_ms(fn)
            row[key + "_ms"] = dev_ms
            row[key + "_call_ms"] = call_ms
        times[n] = row
        print(json.dumps({"phase": "real_times", "n": n, "batch": batch, **row,
                          "card": name, "power_limit": limit}), flush=True)
    return times


def c128(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """torch.fft (cuFFT) in complex128: the reference of the large phases."""
    x = x.to(torch.complex128)
    return torch.fft.ifft(x) if inverse else torch.fft.fft(x)


def phase_large_kernel_vs_plain(dev, gen) -> None:
    for n in LARGE_SIZES:
        modes = [m for m in lg.MODES if m != "cube" or n <= planner.CUBE_MAX_N]
        worst = 0.0
        for batch in (3, LARGE_POINTS // n):
            x = rand_complex((batch, n), gen, dev)
            re, im = x.real.contiguous(), x.imag.contiguous()
            re_t, im_t = re.T.contiguous(), im.T.contiguous()
            for inverse in (False, True):
                p = lg.plain_fft_large(x, inverse)
                for mode in modes:
                    diffs = {
                        "complex": rel_diff(lg.fft_large_complex(x, inverse, mode=mode), p),
                        "bm": rel_diff(torch.complex(*lg.fft_large_bm(re, im, inverse, mode=mode)),
                                       p),
                        "nb": rel_diff(torch.complex(*lg.fft_large_nb(re_t, im_t, inverse,
                                                                      mode=mode)).T, p),
                    }
                    worst = max(worst, *diffs.values())
                    check(max(diffs.values()) <= KERNEL_LIMIT,
                          f"large n={n} batch={batch} inverse={inverse} mode={mode}: "
                          f"kernel vs plain {diffs}")
                if batch == 3:
                    e = rel_errors(lg.fft_large_complex(x, inverse).cpu().numpy(),
                                   c128(x, inverse).cpu().numpy())[0]
                    check(e <= MAX_REL["float32"],
                          f"large n={n} inverse={inverse}: max rel {e:.3e} vs torch.fft c128")
        line = {"phase": "large_kernel_vs_plain", "n": n, "split": lg.large_split(n),
                "modes": modes, "max_rel_diff": worst}
        if n in (1 << 16, 1 << 24):
            x = rand_complex((1, n), gen, dev)
            rt = (lg.fft_large_complex(lg.fft_large_complex(x), True) - x).abs().max().item()
            check(rt < ROUNDTRIP["float32"], f"large n={n}: roundtrip error {rt:.3e}")
            line["roundtrip_err"] = rt
        print(json.dumps(line), flush=True)


def _c2c_calls(n: int, batch: int, gen, dev) -> dict:
    """The entry points of create_fft_f32(n) on [batch, n] complex64, with
    the counts of the run and their errors against cuFFT in complex128."""
    ctx = create_fft_f32(n, device="cuda")
    x = rand_complex((batch, n), gen, dev)
    g = rand_complex((batch, n), gen, dev)
    re, im = x.real.contiguous(), x.imag.contiguous()
    re_t, im_t = re.T.contiguous(), im.T.contiguous()
    xg = x.clone().requires_grad_()
    torch.cuda.synchronize()
    zero_counts()
    y = ctx.forward(x)
    xi = ctx.inverse(x)
    back = ctx.inverse(y)
    pre, pim = ctx.forward_planes(re, im)
    nre, nim = ctx.forward_planes_nb(re_t, im_t)
    ctx.forward(xg).backward(g)
    torch.cuda.synchronize()
    launches = counts()
    res = {"n": n, "batch": batch, "route": planner.c2c_kernel(n, "float32", batch),
           "launches": launches,
           "fwd_max_rel_vs_cufft_c128": rel_errors(y.cpu().numpy(), c128(x).cpu().numpy())[0],
           "inv_max_rel_vs_cufft_c128": rel_errors(xi.cpu().numpy(),
                                                   c128(x, True).cpu().numpy())[0],
           "roundtrip_err": (back - x).abs().max().item(),
           "planes_vs_complex": max(rel_diff(torch.complex(pre, pim), y),
                                    rel_diff(torch.complex(nre, nim).T, y)),
           "grad_vs_conj_transform": (xg.grad - ctx.inverse(g) * n).abs().max().item(),
           "grad_max_rel_vs_cufft_c128": rel_errors(xg.grad.cpu().numpy(),
                                                    (c128(g, True) * n).cpu().numpy())[0],
           "kernel_vs_plain_max_abs": (y - lg.plain_fft_large(x)).abs().max().item()}
    check(bool(torch.isfinite(y).all()) and y.shape == x.shape, f"large n={n} output")
    for key in ("fwd_max_rel_vs_cufft_c128", "inv_max_rel_vs_cufft_c128",
                "grad_max_rel_vs_cufft_c128"):
        check(res[key] <= MAX_REL["float32"], f"large main path n={n}: {key} {res[key]:.3e}")
    check(res["roundtrip_err"] < ROUNDTRIP["float32"], f"large n={n}: roundtrip")
    check(res["planes_vs_complex"] <= KERNEL_LIMIT, f"large n={n}: plane entry points")
    check(res["grad_vs_conj_transform"] == 0.0, f"large n={n}: backward vs n * inverse")
    return res


def phase_large_main_path(dev, gen) -> tuple[dict, dict]:
    """The main path at BASELINE config 5's shape (pipe2), then the cube's."""
    main = _c2c_calls(LARGE_N, LARGE_B, gen, dev)
    check(main["route"] == "large-pipe2" and main["launches"] == expect(large_stage1=7,
                                                                          large_stage2=7),
          f"large main path: route {main['route']}, launches {main['launches']}")
    print(json.dumps({"phase": "large_main_path", **main}), flush=True)
    # the planner runs time-major [n, 2048] planes through pipe2 (large_mode)
    cube = _c2c_calls(CUBE_N, CUBE_B, gen, dev)
    check(cube["route"] == "large-cube"
          and cube["launches"] == expect(large_cube=6, large_stage1=1, large_stage2=1),
          f"cube path: route {cube['route']}, launches {cube['launches']}")
    print(json.dumps({"phase": "large_cube_path", **cube}), flush=True)
    return main, cube


def phase_large_real_main_path(dev, gen) -> dict:
    n, m, b = LARGE_N, LARGE_N // 2, LARGE_B
    ctx = create_rfft_f32(n, device="cuda")
    x = rand_real((b, n), gen, dev)
    spec = hermitian_valid(torch.fft.rfft(rand_real((b, n), gen, dev).double()))
    spec32 = spec.to(torch.complex64)
    g = torch.complex(rand_real((b, m + 1), gen, dev), rand_real((b, m + 1), gen, dev))
    ybar = rand_real((b, n), gen, dev)
    x_t = x.T.contiguous()
    xg, sg = x.clone().requires_grad_(), spec32.clone().requires_grad_()
    torch.cuda.synchronize()
    zero_counts()
    y = ctx.forward(x)
    xi = ctx.inverse(spec32)
    back = ctx.inverse(y)
    pre, pim = ctx.forward_planes(x)
    bx = ctx.inverse_planes(spec32.real, spec32.imag)
    nre, nim = ctx.forward_planes_nb(x_t)
    nback = ctx.inverse_planes_nb(nre, nim)
    ctx.forward(xg).backward(g)
    ctx.inverse(sg).backward(ybar)
    torch.cuda.synchronize()
    launches = counts()
    # 11 m-point core transforms: 7 calls and 2 backwards through the other direction
    want = expect(large_stage1=11, large_stage2=11)
    check(launches == want, f"large real path: launches {launches}, expected {want}")
    x64 = x.double()
    fwd_err = rel_errors(y.cpu().numpy(), torch.fft.rfft(x64).cpu().numpy())[0]
    inv_err = rel_errors(xi.cpu().numpy(), torch.fft.irfft(spec, n).cpu().numpy())[0]
    rt_err = max((back - x).abs().max().item(), (nback.T - x).abs().max().item())
    planes_diff = max(rel_diff(torch.complex(pre, pim), y), rel_diff(torch.complex(nre, nim).T, y),
                      rel_diff(bx, xi))
    x64g = x64.clone().requires_grad_()
    torch.fft.rfft(x64g).backward(g.cdouble())
    grad_fwd_err = rel_errors(xg.grad.cpu().numpy(), x64g.grad.cpu().numpy())[0]
    r = torch.fft.rfft(ybar.double())
    gre = r.real.clone()
    gre[:, [0, m]] *= 0.5
    gim = r.imag.clone()
    gim[:, 0], gim[:, m] = -0.5 * r.real[:, m], -0.5 * r.real[:, 0]
    grad_inv_err = rel_errors(sg.grad.cpu().numpy(), (torch.complex(gre, gim) / m).cpu().numpy())[0]
    res = {"phase": "large_real_main_path", "n": n, "batch": b, "launches": launches,
           "fwd_max_rel_vs_torch_fft_f64": fwd_err, "inv_max_rel_vs_torch_fft_f64": inv_err,
           "roundtrip_err": rt_err, "planes_vs_complex": planes_diff,
           "grad_fwd_max_rel_vs_torch_f64": grad_fwd_err,
           "grad_inv_max_rel_vs_adjoint_f64": grad_inv_err}
    print(json.dumps(res), flush=True)
    check(fwd_err <= MAX_REL["float32"], f"large real forward: max rel {fwd_err:.3e}")
    check(inv_err <= MAX_REL["float32"], f"large real inverse: max rel {inv_err:.3e}")
    check(rt_err < ROUNDTRIP["float32"], f"large real roundtrip: {rt_err:.3e}")
    check(planes_diff <= KERNEL_LIMIT, f"large real plane entry points: {planes_diff:.3e}")
    check(grad_fwd_err <= MAX_REL["float32"], f"large rfft backward: {grad_fwd_err:.3e}")
    check(grad_inv_err <= MAX_REL["float32"], f"large irfft backward: {grad_inv_err:.3e}")
    check(bool(torch.isfinite(y).all()) and y.shape == (b, m + 1), "large real output")
    return res


def phase_large_real_times(dev, gen, name: str, limit: str) -> None:
    """The large real path at the main shape: each direction, its m-point
    core alone (the c2c kernels on the complex view of the signal) and
    torch.fft.rfft / irfft."""
    n, m, b = LARGE_N, LARGE_N // 2, LARGE_B
    ctx = create_rfft_f32(n, device="cuda")
    x = rand_real((b, n), gen, dev)
    spec = ctx.forward(x)
    z = torch.view_as_complex(x.view(b, m, 2))
    fns = {"rfft_large": lambda: ctx.forward(x), "irfft_large": lambda: ctx.inverse(spec),
           "core_fwd": lambda: lg.fft_large_complex(z),
           "core_inv": lambda: lg.fft_large_complex(z, True),
           "lib_rfft": lambda: torch.fft.rfft(x), "lib_irfft": lambda: torch.fft.irfft(spec, n)}
    row = {}
    for key, fn in fns.items():
        dev_ms, call_ms = time_ms(fn)
        row[key + "_ms"] = dev_ms
        row[key + "_call_ms"] = call_ms
    print(json.dumps({"phase": "large_real_times", "n": n, "batch": b, **row, "card": name,
                      "power_limit": limit}), flush=True)


def phase_large_single(dev, gen) -> dict:
    """fft_large (the 2d mode on one flat sequence) at 2^20 and 2^24, with
    counts; the matmul surface at 2^16 and through the planner at 2^25."""
    xs = {n: rand_complex((n,), gen, dev) for n in SINGLE_SIZES}
    torch.cuda.synchronize()
    zero_counts()
    ys = {n: lg.fft_large(x.real.contiguous(), x.imag.contiguous()) for n, x in xs.items()}
    torch.cuda.synchronize()
    launches = counts()
    check(launches == expect(large_postmul=2, large_outer=2),
          f"fft_large: launches {launches}")
    line = {"phase": "large_single", "launches": launches}
    for n, x in xs.items():
        e = rel_errors(torch.complex(*ys[n]).cpu().numpy(), c128(x).cpu().numpy())[0]
        check(e <= MAX_REL["float32"], f"fft_large n={n}: max rel {e:.3e}")
        line[f"fft_large_{n}_max_rel_vs_cufft_c128"] = e
    x = rand_complex((4, FOURSTEP_N), gen, dev)
    ctx = create_fft_f32(FOURSTEP_N, device="cuda")
    fs = torch.complex(*ctx.forward_planes_fourstep(x.real, x.imag))
    e = rel_errors(fs.cpu().numpy(), c128(x).cpu().numpy())[0]
    check(e <= MAX_REL["float32"], f"fourstep surface n={FOURSTEP_N}: max rel {e:.3e}")
    line[f"fourstep_{FOURSTEP_N}_max_rel_vs_cufft_c128"] = e
    n = PLANNER_FOURSTEP_N
    check(planner.c2c_kernel(n, "float32", 1) == "fourstep", "the planner's route past 2^24")
    x = rand_complex((1, n), gen, dev)
    zero_counts()
    y = create_fft_f32(n, device="cuda").forward(x)
    torch.cuda.synchronize()
    e = rel_errors(y.cpu().numpy(), c128(x).cpu().numpy())[0]
    check(e <= MAX_REL["float32"], f"planner route n=2^25: max rel {e:.3e}")
    check(counts() == expect(), f"the matmul surface launched kernels: {counts()}")
    line[f"planner_{n}_max_rel_vs_cufft_c128"] = e
    print(json.dumps(line), flush=True)
    return line


def phase_large_times(dev, gen, name: str, limit: str) -> dict:
    times = {}
    for n in LARGE_SIZES:
        batch = LARGE_POINTS // n
        n1, n2 = lg.large_split(n)
        x = rand_complex((batch, n), gen, dev)
        x3re = x.real.T.contiguous().view(n2, n1, batch)
        x3im = x.imag.T.contiguous().view(n2, n1, batch)
        re_t, im_t = x3re.view(n, batch), x3im.view(n, batch)
        out = torch.empty_like(x)
        fns = {"pipe2": lambda: lg.fft_large_complex(x, mode="pipe2"),
               "pipe2_inv": lambda: lg.fft_large_complex(x, True, mode="pipe2"),
               "2d": lambda: lg.fft_large_complex(x, mode="2d"),
               "pipe2_nb": lambda: lg.fft_large_nb(re_t, im_t, mode="pipe2"),
               "stage1": lambda: lg.stage1(x3re, x3im),
               "stage2": lambda: lg.stage2(x3re, x3im),
               "cufft_fwd": lambda: torch.fft.fft(x),
               "cufft_stage1": lambda: torch.fft.fft(x.view(batch, n2, n1), dim=1),
               "copy": lambda: out.copy_(x)}
        if n <= planner.CUBE_MAX_N:
            fns["cube"] = lambda: lg.fft_large_complex(x, mode="cube")
            fns["cube_inv"] = lambda: lg.fft_large_complex(x, True, mode="cube")
            fns["cube_nb"] = lambda: lg.fft_large_nb(re_t, im_t, mode="cube")
        if n in (1 << 15, 1 << 21):
            fns["pipe2_split_n2_n1"] = lambda: lg.fft_large_complex(x, split=(n2, n1),
                                                                    mode="pipe2")
        row = {}
        for key, fn in fns.items():
            dev_ms, call_ms = time_ms(fn)
            row[key + "_ms"] = dev_ms
            row[key + "_call_ms"] = call_ms
        dev_ms, call_ms = time_ms(lambda: lg.plain_fft_large(x), reps=3, warmup=1)
        row["plain_ms"], row["plain_call_ms"] = dev_ms, call_ms
        times[n] = row
        print(json.dumps({"phase": "large_times", "n": n, "batch": batch, "split": [n1, n2],
                          **row, "card": name, "power_limit": limit}), flush=True)
    return times


def phase_large_crossover(dev, gen, name: str, limit: str) -> dict:
    """Cube against pipe2 over batches at 2^13 and 2^14, complex64 (the
    least batch from which the cube wins at every larger batch timed; the
    planner sends every batch to the cube) and time-major planes (the
    batches at which the cube wins; the planner sends more than
    CUBE_NB_MAX_BATCH sequences to pipe2, `large_mode`)."""
    wins = {}
    for n in (1 << 13, planner.CUBE_MAX_N):
        row, nb = {}, {}
        for batch in CROSSOVER_BATCHES:
            x = rand_complex((batch, n), gen, dev)
            re_t, im_t = x.real.T.contiguous(), x.imag.T.contiguous()
            for mode in ("cube", "pipe2"):
                row[f"{mode}_b{batch}_ms"] = time_ms(
                    lambda: lg.fft_large_complex(x, mode=mode))[0]
                nb[f"{mode}_nb_b{batch}_ms"] = time_ms(
                    lambda: lg.fft_large_nb(re_t, im_t, mode=mode))[0]
        losing = [b for b in CROSSOVER_BATCHES if row[f"cube_b{b}_ms"] > row[f"pipe2_b{b}_ms"]]
        wins[n] = next((b for b in CROSSOVER_BATCHES if not losing or b > max(losing)), None)
        nb_wins = [b for b in CROSSOVER_BATCHES
                   if nb[f"cube_nb_b{b}_ms"] <= nb[f"pipe2_nb_b{b}_ms"]]
        print(json.dumps({"phase": "large_crossover", "n": n, **row, **nb,
                          "cube_wins_from": wins[n], "cube_nb_wins_at": nb_wins,
                          "planner_nb_max_batch": planner.CUBE_NB_MAX_BATCH[n], "card": name,
                          "power_limit": limit}), flush=True)
    return wins


def large_kernel_rows(main: dict, cube: dict, single: dict, times: dict, dev, gen) -> list:
    """The large kernels' rows of the kernels line: each timed alone at the
    shape its path gives it, against its plain version on the same inputs.
    Stage 1 and 2 at the main path's [16, 2^20] ([n2, n1, b] blocks), the
    cube at the cube path's [2048, 8192], the post-multiply and the outer
    pass at fft_large's n = 2^20 (one sequence, [n2, n1])."""
    rows = []
    n, b = LARGE_N, LARGE_B
    n1, n2 = lg.large_split(n)
    x = rand_complex((b, n), gen, dev)
    x3 = (x.real.T.contiguous().view(n2, n1, b), x.imag.T.contiguous().view(n2, n1, b))
    c3 = lg.plain_stage1(*x3)
    lt = lg.device_large_tables(n, False, dev)
    err1 = (torch.complex(*lg.stage1(*x3)) - torch.complex(*c3)).abs().max().item()
    err2 = (torch.complex(*lg.stage2(*c3)) - torch.complex(*lg.plain_stage2(*c3))).abs().max().item()
    plain1 = time_ms(lambda: lg.plain_stage1(*x3), reps=3, warmup=1)[0]
    plain2 = time_ms(lambda: lg.plain_stage2(*c3), reps=3, warmup=1)[0]
    t = times[n]
    pass_bytes, tw_bytes = 16 * n * b, 8 * n
    rows.append(("large_stage1", "watfft_tpu/ops/large.py:136", [], main["launches"]["large_stage1"],
                 err1, t["stage1_ms"], plain1,
                 bound(pass_bytes, 5 * n * (n2.bit_length() - 1) * b), t["cufft_stage1_ms"]))
    rows.append(("large_stage2", "watfft_tpu/ops/large.py:250", [], main["launches"]["large_stage2"],
                 err2, t["stage2_ms"], plain2,
                 bound(pass_bytes + tw_bytes, (5 * (n1.bit_length() - 1) + 6) * n * b), None))
    # the cube at the cube path's shape
    cn, cb = CUBE_N, CUBE_B
    xc = rand_complex((cb, cn), gen, dev)
    errc = (lg.fft_large_complex(xc, mode="cube") - lg.plain_fft_large(xc)).abs().max().item()
    plainc = time_ms(lambda: lg.plain_fft_large(xc), reps=3, warmup=1)[0]
    rows.append(("large_cube", "watfft_tpu/ops/large.py:177", [], cube["launches"]["large_cube"],
                 errc, times[cn]["cube_ms"], plainc,
                 bound(16 * cn * cb + 8 * cn, (5 * (cn.bit_length() - 1) + 6) * cn * cb),
                 times[cn]["cufft_fwd_ms"]))
    # fft_large at 2^20: the post-multiplying pass [n2, n1] and the outer pass
    s = rand_complex((n2, n1), gen, dev)
    pm = (lt.pmre.view(n2, n1), lt.pmim.view(n2, n1))
    sre, sim = s.real.contiguous(), s.imag.contiguous()
    post = st.stockham_fft_nb_postmul(sre, sim, *pm)
    errp = (torch.complex(*post) - torch.complex(*st.plain_postmul(sre, sim, *pm))).abs().max().item()
    outer_out = (torch.empty(n, device=dev), torch.empty(n, device=dev))

    def outer(plain=False):
        # C [n2, n1] -> D[k1, k2] at row k1*n2 + k2, as fft_large's second pass
        lg.strided_c2c((post[0].view(-1), post[1].view(-1)), outer_out, n1, (1, n2, 1),
                       [(n2, n1, 1, n1), (1, n, n, 0)], False, lt.t2, "outer", plain=plain)
        return torch.complex(*outer_out)
    erro = (outer() - outer(plain=True)).abs().max().item()
    ms_p = time_ms(lambda: st.stockham_fft_nb_postmul(sre, sim, *pm))[0]
    plain_p = time_ms(lambda: st.plain_postmul(sre, sim, *pm), reps=3, warmup=1)[0]
    ms_o = time_ms(outer)[0]
    plain_o = time_ms(lambda: outer(plain=True), reps=3, warmup=1)[0]
    rows.append(("large_postmul", "watfft_tpu/ops/pallas_stockham.py:291", [],
                 single["launches"]["large_postmul"], errp, ms_p, plain_p,
                 bound(24 * n, (5 * (n2.bit_length() - 1) + 6) * n), None))
    rows.append(("large_outer_c2c", "watfft_tpu/ops/pallas_stockham.py:260", [],
                 single["launches"]["large_outer"], erro, ms_o, plain_o,
                 bound(16 * n, 5 * (n1.bit_length() - 1) * n), None))
    return [(name, LARGE_SRC, *rest) for name, *rest in rows]


# -- the 2D path ------------------------------------------------------------------

def c128_2d(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """torch.fft.fft2 (cuFFT) in complex128: the reference of the 2D phases."""
    x = x.to(torch.complex128)
    return torch.fft.ifft2(x) if inverse else torch.fft.fft2(x)


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The max_rel of `rel_errors` computed on the card: |got - want| over
    max(|want|, the rms of |want|), in double precision."""
    dt = torch.complex128 if want.is_complex() else torch.float64
    got, want = got.to(dt), want.to(dt)
    scale = max(want.abs().square().mean().sqrt().item(), 1e-300)
    return ((got - want).abs() / want.abs().clamp_min(scale)).max().item()


def native(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The native [h, w, B] planes of a complex [B, h, w] batch."""
    xn = x.permute(1, 2, 0)
    return xn.real.contiguous(), xn.imag.contiguous()


def from_native(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re, im).permute(2, 0, 1)


def phase_fft2_kernel_vs_plain(dev, gen) -> None:
    worst, n_checked = 0.0, 0
    for h, w in FFT2_PAIRS:
        batches = (3, FFT2_POINTS // (h * w)) if (h, w) in FFT2_WIDE else (3,)
        for batch in batches:
            x = rand_complex((batch, h, w), gen, dev)
            re, im = x.real.contiguous(), x.imag.contiguous()
            nre, nim = native(x)
            for inverse in (False, True):
                p = f2.plain_fft2(x, inverse)
                y = f2._complex_route(x, inverse, "fft2-cube")
                diffs = {
                    "complex": rel_diff(y, p),
                    "bm": rel_diff(torch.complex(*f2._planes_route(re, im, inverse,
                                                                   "fft2-cube")), p),
                    "nb": rel_diff(from_native(*f2._nb_route(nre, nim, inverse,
                                                             "fft2-cube")), p),
                }
                worst = max(worst, *diffs.values())
                n_checked += 3
                check(max(diffs.values()) <= KERNEL_LIMIT,
                      f"fft2 cube {h}x{w} batch={batch} inverse={inverse}: kernel vs plain {diffs}")
                if batch == 3:
                    e = rel_diff(y.to(torch.complex128), c128_2d(x, inverse))
                    check(e <= MAX_REL["float32"],
                          f"fft2 cube {h}x{w} inverse={inverse}: {e:.3e} vs torch.fft c128")
    print(json.dumps({"phase": "fft2_cube_vs_plain", "pairs": len(FFT2_PAIRS),
                      "wide_pairs": FFT2_WIDE, "checks": n_checked, "max_rel_diff": worst}),
          flush=True)
    for h in FFT2_PASS_SIZES:
        for w in FFT2_PASS_SIZES:
            batch = max(1, FFT2_POINTS // (h * w))
            x = rand_complex((batch, h, w), gen, dev)
            nre, nim = native(x)
            rre, rim = x.real.reshape(-1, w).contiguous(), x.imag.reshape(-1, w).contiguous()
            line = {"phase": "fft2_passes_vs_plain", "h": h, "w": w, "batch": batch}
            for inverse in (False, True):
                p = f2.plain_fft2(x, inverse)
                diffs = {
                    "2pass_complex": rel_diff(f2._complex_route(x, inverse, "fft2-2pass"), p),
                    "2pass_nb": rel_diff(from_native(*f2._nb_route(nre, nim, inverse,
                                                                   "fft2-2pass")), p),
                    "cols": rel_diff(torch.complex(*f2.fft2_cols(nre, nim, inverse)),
                                     torch.complex(*f2.plain_fft2_cols(nre, nim, inverse))),
                    "k2": rel_diff(torch.complex(*f2.fft2_k2(nre, nim, inverse)),
                                   torch.complex(*f2.plain_fft2_k2(nre, nim, inverse))),
                    "rows": rel_diff(torch.complex(*f2.fft2_rows(rre, rim, inverse)),
                                     torch.complex(*f2.plain_fft2_rows(rre, rim, inverse))),
                }
                check(max(diffs.values()) <= KERNEL_LIMIT,
                      f"fft2 passes {h}x{w} inverse={inverse}: kernel vs plain {diffs}")
                line.update({f"{k}_{'inv' if inverse else 'fwd'}": v for k, v in diffs.items()})
            x3 = x[:3]
            e = rel_diff(f2._complex_route(x3, False, "fft2-2pass").to(torch.complex128),
                         c128_2d(x3))
            check(e <= MAX_REL["float32"], f"fft2 2-pass {h}x{w}: {e:.3e} vs torch.fft c128")
            line["max_rel_vs_torch_fft_c128"] = e
            print(json.dumps(line), flush=True)


def _fft2_calls(shape, gen, dev) -> dict:
    """fft2 / ifft2 on complex64 `shape`: forward, inverse, roundtrip and a
    backward, with the counts of the run and the errors against torch.fft
    in complex128."""
    h, w = shape[-2:]
    x = rand_complex(shape, gen, dev)
    g = rand_complex(shape, gen, dev)
    xg = x.clone().requires_grad_()
    torch.cuda.synchronize()
    zero_counts()
    y = wtt.fft2(x)
    xi = wtt.ifft2(x)
    back = wtt.ifft2(y)
    wtt.fft2(xg).backward(g)
    torch.cuda.synchronize()
    launches = counts()
    p = f2.plain_fft2(x)
    res = {"shape": list(shape), "route": planner.fft2_kernel(h, w, x.numel() // (h * w),
                                                              "complex"),
           "launches": launches,
           "fwd_max_rel_vs_torch_fft_c128": max_rel(y, c128_2d(x)),
           "inv_max_rel_vs_torch_fft_c128": max_rel(xi, c128_2d(x, True)),
           "roundtrip_err": (back - x).abs().max().item(),
           "grad_max_rel_vs_torch_fft_c128": max_rel(xg.grad, c128_2d(g, True) * (h * w)),
           "kernel_vs_plain_max_abs": (y - p).abs().max().item(),
           "kernel_vs_plain_rel": rel_diff(y, p)}
    check(res["kernel_vs_plain_rel"] <= KERNEL_LIMIT,
          f"fft2 {shape}: kernels vs plain {res['kernel_vs_plain_rel']:.3e}")
    check(bool(torch.isfinite(y).all()) and y.shape == x.shape, f"fft2 {shape} output")
    for key in ("fwd_max_rel_vs_torch_fft_c128", "inv_max_rel_vs_torch_fft_c128",
                "grad_max_rel_vs_torch_fft_c128"):
        check(res[key] <= MAX_REL["float32"], f"fft2 {shape}: {key} {res[key]:.3e}")
    check(res["roundtrip_err"] < ROUNDTRIP["float32"], f"fft2 {shape}: roundtrip")
    return res


def phase_fft2_main_path(dev, gen) -> dict:
    out = {}
    # 5 transforms per run: forward, two inverses, the backward's forward and inverse
    single = _fft2_calls((FFT2_MAIN, FFT2_MAIN), gen, dev)
    check(single["route"] == "fft2-2pass" and single["launches"] == expect(
        fft2_cols=5, fft2_rows=5, stockham_c2c=5),
        f"fft2 {FFT2_MAIN}^2: route {single['route']}, launches {single['launches']}")
    print(json.dumps({"phase": "fft2_main_path", **single}), flush=True)
    out["single"] = single
    cube = _fft2_calls(FFT2_CUBE_SHAPE, gen, dev)
    check(cube["route"] == "fft2-cube" and cube["launches"] == expect(fft2_cube=5),
          f"fft2 {FFT2_CUBE_SHAPE}: route {cube['route']}, launches {cube['launches']}")
    print(json.dumps({"phase": "fft2_cube_path", **cube}), flush=True)
    out["cube"] = cube
    two = _fft2_calls(FFT2_2PASS_SHAPE, gen, dev)
    check(two["route"] == "fft2-2pass" and two["launches"] == expect(
        fft2_cols=5, fft2_rows=5, stockham_c2c=5),
        f"fft2 {FFT2_2PASS_SHAPE}: route {two['route']}, launches {two['launches']}")
    print(json.dumps({"phase": "fft2_2pass_path", **two}), flush=True)
    out["2pass"] = two

    # native [h, w, B] planes: the column pass and the native row pass (#14)
    b, h, w = FFT2_2PASS_SHAPE
    x = rand_complex((b, h, w), gen, dev)
    nre, nim = native(x)
    gre, gim = native(rand_complex((b, h, w), gen, dev))
    are, aim = nre.clone().requires_grad_(), nim.clone().requires_grad_()
    torch.cuda.synchronize()
    zero_counts()
    yre, yim = wtt.fft2_nb(nre, nim)
    bre, bim = wtt.fft2_nb(yre, yim, inverse=True)
    ore, oim = wtt.fft2_nb(are, aim)
    (ore * gre + oim * gim).sum().backward()
    torch.cuda.synchronize()
    launches = counts()
    check(launches == expect(fft2_cols=4, fft2_k2=4),
          f"fft2_nb {h}x{w}x{b}: launches {launches}")
    y = from_native(yre, yim)
    g = from_native(gre, gim)
    p = f2.plain_fft2(x)
    res = {"shape": [h, w, b], "route": planner.fft2_kernel(h, w, b, "nb"), "launches": launches,
           "fwd_max_rel_vs_torch_fft_c128": max_rel(y, c128_2d(x)),
           "roundtrip_err": (from_native(bre, bim) - x).abs().max().item(),
           "grad_max_rel_vs_torch_fft_c128": max_rel(from_native(are.grad, aim.grad),
                                                     c128_2d(g, True) * (h * w)),
           "kernel_vs_plain_max_abs": (y - p).abs().max().item(),
           "kernel_vs_plain_rel": rel_diff(y, p)}
    print(json.dumps({"phase": "fft2_native_path", **res}), flush=True)
    check(res["kernel_vs_plain_rel"] <= KERNEL_LIMIT,
          f"fft2_nb: kernels vs plain {res['kernel_vs_plain_rel']:.3e}")
    for key in ("fwd_max_rel_vs_torch_fft_c128", "grad_max_rel_vs_torch_fft_c128"):
        check(res[key] <= MAX_REL["float32"], f"fft2_nb: {key} {res[key]:.3e}")
    check(res["roundtrip_err"] < ROUNDTRIP["float32"], "fft2_nb roundtrip")
    out["native"] = res

    # the real path at the 4096 x 4096 shape
    n = FFT2_MAIN
    xr = rand_real((n, n), gen, dev)
    spec = torch.fft.rfft2(rand_real((n, n), gen, dev).double())
    spec32 = spec.to(torch.complex64)
    gs = torch.complex(rand_real((n, n // 2 + 1), gen, dev), rand_real((n, n // 2 + 1), gen, dev))
    xg = xr.clone().requires_grad_()
    torch.cuda.synchronize()
    zero_counts()
    yr = wtt.rfft2(xr)
    xi = wtt.irfft2(spec32)
    back = wtt.irfft2(yr)
    wtt.rfft2(xg).backward(gs)
    torch.cuda.synchronize()
    launches = counts()
    # 5 half-width transforms [4096, 2048]: two rfft2, two irfft2, the backward
    check(launches == expect(fft2_cols=5, fft2_rows=5, stockham_c2c=5),
          f"rfft2 {n}^2: launches {launches}")
    x64 = xr.double().requires_grad_()
    torch.fft.rfft2(x64).backward(gs.cdouble())
    res = {"shape": [n, n], "launches": launches,
           "fwd_max_rel_vs_torch_fft_f64": max_rel(yr, torch.fft.rfft2(xr.double())),
           "inv_max_rel_vs_torch_fft_f64": max_rel(xi, torch.fft.irfft2(spec, (n, n))),
           "roundtrip_err": (back - xr).abs().max().item(),
           "grad_max_rel_vs_torch_fft_f64": max_rel(xg.grad, x64.grad)}
    print(json.dumps({"phase": "rfft2_main_path", **res}), flush=True)
    for key in ("fwd_max_rel_vs_torch_fft_f64", "inv_max_rel_vs_torch_fft_f64",
                "grad_max_rel_vs_torch_fft_f64"):
        check(res[key] <= MAX_REL["float32"], f"rfft2: {key} {res[key]:.3e}")
    check(res["roundtrip_err"] < ROUNDTRIP["float32"], "rfft2 roundtrip")
    check(bool(torch.isfinite(yr).all()) and yr.shape == (n, n // 2 + 1), "rfft2 output")
    out["real"] = res
    return out


def _passes(x, h, w, batch, inverse=False):
    """The 2-pass route's passes on the complex layout, as `fft2_complex`
    launches them: col(plain=False) writes batch-major planes c from x,
    row(plain=False) writes the interleaved `out` from c. Returns
    (col, row, c, out)."""
    xo, xs = f2._operand("complex", x, None), f2._strides("complex", h, w, batch)
    c = tuple(torch.empty(batch * h * w, device=x.device) for _ in range(2))
    cs = f2._strides("bm", h, w, batch)
    out = torch.empty_like(x)
    yo = f2._operand("complex", out, None)
    th, tw = (st.device_tables(n, inverse, x.device) for n in (h, w))
    return (lambda plain=False: f2._cols(xo, xs, c, cs, h, w, batch, inverse, th, plain),
            lambda plain=False: f2._rows(c, cs, yo, xs, h, w, batch, inverse, tw, plain),
            c, out)


def phase_fft2_times(dev, gen, name: str, limit: str) -> dict:
    times = {}
    for h, w in FFT2_TIME_SHAPES:
        batch = FFT2_TIME_POINTS // (h * w)
        x = rand_complex((batch, h, w), gen, dev)
        nre, nim = native(x)
        out = torch.empty_like(x)
        fns = {"planner": lambda: f2.fft2_complex(x),
               "lib_fft2": lambda: torch.fft.fft2(x),
               "lib_fft2_inv": lambda: torch.fft.ifft2(x),
               "lib_cols": lambda: torch.fft.fft(x, dim=-2),
               "lib_rows": lambda: torch.fft.fft(x, dim=-1),
               "copy": lambda: out.copy_(x)}
        if h * w <= planner.CUBE_MAX_N:
            fns.update({"cube": lambda: f2._complex_route(x, False, "fft2-cube"),
                        "cube_inv": lambda: f2._complex_route(x, True, "fft2-cube"),
                        "cube_nb": lambda: f2._nb_route(nre, nim, False, "fft2-cube")})
        if max(h, w) <= planner.STOCKHAM_MAX_N:
            cols, rows, _, _ = _passes(x, h, w, batch)
            fns.update({"2pass": lambda: f2._complex_route(x, False, "fft2-2pass"),
                        "2pass_inv": lambda: f2._complex_route(x, True, "fft2-2pass"),
                        "2pass_nb": lambda: f2._nb_route(nre, nim, False, "fft2-2pass"),
                        "cols": cols, "rows": rows,
                        "cols_nb": lambda: f2.fft2_cols(nre, nim),
                        "k2_nb": lambda: f2.fft2_k2(nre, nim)})
        row = {"route": planner.fft2_kernel(h, w, batch, "complex")}
        for key, fn in fns.items():
            dev_ms, call_ms = time_ms(fn)
            row[key + "_ms"] = dev_ms
            row[key + "_call_ms"] = call_ms
        row["plain_ms"], row["plain_call_ms"] = time_ms(lambda: f2.plain_fft2(x), reps=3,
                                                        warmup=1)
        # the real path: the half-width transform and the torch recombination
        xr = rand_real((batch, h, w), gen, dev)
        spec = torch.fft.rfft2(xr)
        zre, zim = (t.contiguous() for t in f2.fft2_planes(xr[..., 0::2].contiguous(),
                                                           xr[..., 1::2].contiguous()))
        sre, sim = spec.real.contiguous(), spec.imag.contiguous()
        rfns = {"rfft2": lambda: f2.rfft2_planes(xr),
                "irfft2": lambda: f2.irfft2_planes(sre, sim),
                "rfft2_core": lambda: f2._transform(xr, None, False, "real", "bm", None, None),
                "herm2_post": lambda: f2.herm2_post_nb(zre, zim, w, -2, -1),
                "herm2_pre": lambda: f2.herm2_pre_nb(sre, sim, w, -2, -1),
                "lib_rfft2": lambda: torch.fft.rfft2(xr),
                "lib_irfft2": lambda: torch.fft.irfft2(spec, (h, w))}
        for key, fn in rfns.items():
            row[key + "_ms"] = time_ms(fn)[0]
        times[(h, w)] = row
        print(json.dumps({"phase": "fft2_times", "h": h, "w": w, "batch": batch, **row,
                          "card": name, "power_limit": limit}), flush=True)
    for h, w in FFT2_CROSS_SHAPES:
        row = {}
        for batch in FFT2_CROSS_BATCHES:
            x = rand_complex((batch, h, w), gen, dev)
            nre, nim = native(x)
            for route in ("fft2-cube", "fft2-2pass"):
                r = route[len("fft2-"):]
                row[f"{r}_b{batch}_ms"] = time_ms(lambda: f2._complex_route(x, False, route))[0]
                row[f"{r}_nb_b{batch}_ms"] = time_ms(
                    lambda: f2._nb_route(nre, nim, False, route))[0]
        print(json.dumps({"phase": "fft2_crossover", "h": h, "w": w, **row, "card": name,
                          "power_limit": limit}), flush=True)
    return times


def fft2_kernel_rows(main: dict, times: dict, dev, gen) -> list:
    """The 2D kernels' rows of the kernels line, each at the shape its main
    path gives it: the cube at [1024, 128, 128]; the column pass and #16 at
    the single 4096 x 4096 image; #14 at native [512, 512, 64]. Each is
    held there against its plain version: max |diff| / max |plain| within
    KERNEL_LIMIT, in both directions where the main path runs both."""
    rows, rels = [], {}

    def held(name, kernel, plain):
        """max |kernel - plain| over the pairs, checked relative to max |plain|."""
        err = max((a - p).abs().max().item() for a, p in zip(kernel, plain))
        rels[name] = rel = err / max(p.abs().max().item() for p in plain)
        check(rel <= KERNEL_LIMIT, f"{name} at its main-path shape: {rel:.3e} vs plain")
        return err

    b, h, w = FFT2_CUBE_SHAPE
    n = b * h * w
    x = rand_complex((b, h, w), gen, dev)
    err = max(held(f"fft2_cube {FFT2_CUBE_SHAPE} inverse={inv}",
                   [f2._complex_route(x, inv, "fft2-cube")], [f2.plain_fft2(x, inv)])
              for inv in (False, True))
    plain = time_ms(lambda: f2.plain_fft2(x), reps=3, warmup=1)[0]
    t = times[(h, w)]
    rows.append(("fft2_cube", FFT2_SRC, "watfft_tpu/ops/fft2.py:129", [],
                 main["cube"]["launches"]["fft2_cube"], err, t["cube_ms"], plain,
                 bound(16 * n, 5 * n * ((h * w).bit_length() - 1)), t["lib_fft2_ms"]))
    # the single image's passes, as fft2() and ifft2() run them
    m = FFT2_MAIN
    xm = rand_complex((m, m), gen, dev)
    err_c = err_r = 0.0
    for inv in (False, True):
        col, row, c, out = _passes(xm, m, m, 1, inv)
        col()
        kernel_c = [t.clone() for t in c]
        col(plain=True)
        err_c = max(err_c, held(f"fft2_cols {m}^2 inverse={inv}", kernel_c, c))
        row()
        kernel_y = out.clone()
        row(plain=True)
        err_r = max(err_r, held(f"fft2_rows {m}^2 inverse={inv}", [kernel_y], [out]))
    col, row, _, _ = _passes(xm, m, m, 1)
    plain_c = time_ms(lambda: col(plain=True), reps=3, warmup=1)[0]
    plain_r = time_ms(lambda: row(plain=True), reps=3, warmup=1)[0]
    t = times[(m, m)]
    n = m * m
    flops = 5 * n * (m.bit_length() - 1)
    single = main["single"]["launches"]
    rows.append(("fft2_cols", LARGE_SRC, "watfft_tpu/ops/large.py:136",
                 ["watfft_tpu/ops/fft2.py:191"], single["fft2_cols"], err_c, t["cols_ms"], plain_c,
                 bound(16 * n, flops), t["lib_cols_ms"]))
    rows.append(("fft2_rows", "watfft_tpu_torch/ops/csrc/stockham.cu",
                 "watfft_tpu/ops/fft2.py:241", [], single["fft2_rows"], err_r, t["rows_ms"], plain_r,
                 bound(16 * n, flops), t["lib_rows_ms"]))
    # #14 on the native main path's [512, 512, 64] planes
    b, h, w = FFT2_2PASS_SHAPE
    n = b * h * w
    nre, nim = native(rand_complex((b, h, w), gen, dev))
    err_k = max(held(f"fft2_k2 native [{h}, {w}, {b}] inverse={inv}",
                     f2.fft2_k2(nre, nim, inv), f2.plain_fft2_k2(nre, nim, inv))
                for inv in (False, True))
    plain_k = time_ms(lambda: f2.plain_fft2_k2(nre, nim), reps=3, warmup=1)[0]
    xn = torch.complex(nre, nim)
    lib_k = time_ms(lambda: torch.fft.fft(xn, dim=1))[0]
    rows.append(("fft2_k2", LARGE_SRC, "watfft_tpu/ops/fft2.py:91", [],
                 main["native"]["launches"]["fft2_k2"], err_k, times[(h, w)]["k2_nb_ms"], plain_k,
                 bound(16 * n, 5 * n * (w.bit_length() - 1)), lib_k))
    print(json.dumps({"phase": "fft2_kernels_at_main_shapes", "rel_diff_vs_plain": rels}),
          flush=True)
    return rows


# -- the any-n path ---------------------------------------------------------------

def _bl_passes(x: torch.Tensor, layout: str, inverse: bool = False):
    """The pair #17, #18 and the one-pass kernel on the complex [batch, n] x
    given in `layout` ("complex", batch-major planes "bm", time-major
    planes "nb"): fwd(plain=False) writes a batch-major intermediate f,
    inv(plain=False) writes the output `out` (in the layout) from f, and
    onepass(plain=False) writes `out` from x in one launch (the fused
    route). Returns (fwd, inv, onepass, f, out), out as a pair of float
    tensors."""
    batch, n = x.shape
    bt = bl.device_bluestein_tables(n, inverse, x.device)
    if layout == "complex":
        xc = x.contiguous()
        fx = torch.view_as_real(xc).view(-1)
        xo, xs = (fx, fx[1:]), (2, 2 * n)
        y = torch.empty(2 * batch * n, device=x.device)
        yo = (y, y[1:])
    elif layout == "bm":
        xo, xs = (x.real.contiguous(), x.imag.contiguous()), (1, n)
        yo = (torch.empty_like(xo[0]), torch.empty_like(xo[1]))
    else:
        xo, xs = (x.real.T.contiguous(), x.imag.T.contiguous()), (batch, 1)
        yo = (torch.empty_like(xo[0]), torch.empty_like(xo[1]))
    f = torch.empty(2, batch * bt.m, device=x.device)
    fo, fs = (f[0], f[1]), (1, bt.m)
    return (lambda plain=False: bl._fwd(xo, xs, fo, fs, batch, bt, plain),
            lambda plain=False: bl._inv(fo, fs, yo, xs, batch, bt, plain),
            lambda plain=False: bl._onepass(xo, xs, yo, xs, batch, bt, plain), f, yo)


def held_pair(kernel, plain) -> float:
    """max |kernel - plain| / max |plain| over a pair of planes."""
    return (max((a - p).abs().max().item() for a, p in zip(kernel, plain))
            / max(p.abs().max().item() for p in plain))


def _bl_alone(x: torch.Tensor, layout: str, inverse: bool) -> dict:
    """Each kernel alone and its plain version on the same inputs: #17 on
    x, then #18 on the plain version's intermediate. Returns {"fwd": (kernel,
    plain), "inv": (kernel, plain)}, each output a pair of planes."""
    fwd, inv, _, f, out = _bl_passes(x, layout, inverse)
    fwd()
    kf = f.clone()
    fwd(plain=True)
    inv()
    ko = [t.clone() for t in out]
    inv(plain=True)
    return {"fwd": (kf, f), "inv": (ko, out)}


def _bl_vs_pair(x: torch.Tensor, layout: str, inverse: bool) -> tuple[float, bool]:
    """The one-pass kernel against the pair #17 then #18 on x in `layout`:
    max |onepass - pair| / max |pair|, and whether they are equal."""
    fwd, inv, onepass, _, out = _bl_passes(x, layout, inverse)
    fwd()
    inv()
    pair = [t.clone() for t in out]
    onepass()
    return held_pair(out, pair), all(torch.equal(a, b) for a, b in zip(out, pair))


def phase_bluestein_kernel_vs_plain(dev, gen) -> None:
    worst, n_checked, pair_worst, pair_equal = 0.0, 0, 0.0, True
    for n in BL_SIZES:
        m = bl.bluestein_m(n)
        line = {"phase": "bluestein_kernel_vs_plain", "n": n, "m": m}
        for batch in (3, POINTS // m):
            x = rand_complex((batch, n), gen, dev)
            re, im = x.real.contiguous(), x.imag.contiguous()
            tre, tim = re.T.contiguous(), im.T.contiguous()
            for inverse in (False, True):
                p = bl.plain_bluestein_fft(x, inverse)
                y = bl.bluestein_fft(x, inverse)
                diffs = {"complex": rel_diff(y, p),
                         "bm": rel_diff(torch.complex(*bl.bluestein_fft_bm(re, im, inverse)), p),
                         "nb": rel_diff(torch.complex(*bl.bluestein_fft_nb(tre, tim, inverse)).T,
                                        p)}
                for layout in ("complex", "bm", "nb"):
                    diffs.update({f"{key}_{layout}": held_pair(*pair)
                                  for key, pair in _bl_alone(x, layout, inverse).items()})
                    d, eq = _bl_vs_pair(x, layout, inverse)
                    pair_worst, pair_equal = max(pair_worst, d), pair_equal and eq
                    line["onepass_vs_pair_max_rel_diff"] = max(
                        line.get("onepass_vs_pair_max_rel_diff", 0.0), d)
                    line["onepass_equal_pair"] = line.get("onepass_equal_pair", True) and eq
                worst = max(worst, *diffs.values())
                n_checked += len(diffs)
                check(max(diffs.values()) <= KERNEL_LIMIT,
                      f"bluestein n={n} batch={batch} inverse={inverse}: kernel vs plain {diffs}")
                if batch == 3:
                    e = max_rel(y, c128(x, inverse))
                    check(e <= MAX_REL["float32"],
                          f"bluestein n={n} inverse={inverse}: {e:.3e} vs torch.fft c128")
                    line[f"max_rel_vs_torch_fft_c128_{'inv' if inverse else 'fwd'}"] = e
            line[f"batch_{batch}_max_rel_diff"] = max(diffs.values())
        print(json.dumps(line), flush=True)
    print(json.dumps({"phase": "bluestein_kernels_vs_plain", "sizes": len(BL_SIZES),
                      "checks": n_checked, "max_rel_diff": worst,
                      "onepass_vs_pair_max_rel_diff": pair_worst,
                      "onepass_equal_pair": pair_equal}), flush=True)


def _bl_vs_plain(pairs) -> float:
    """The largest rel_diff of the one-pass kernel (bluestein_fft) against
    its plain version over (input, inverse, output) triples: output, where
    given, is what the main path's kernel made of input, else it runs again
    on it."""
    worst = 0.0
    for x, inverse, y in pairs:
        y = bl.bluestein_fft(x, inverse) if y is None else y
        worst = max(worst, rel_diff(y, bl.plain_bluestein_fft(x, inverse)))
    return worst


def _bl_2d_vs_plain(x: torch.Tensor, inverse: bool) -> float:
    """The one-pass kernel against its plain version on fftlib's operands of an
    axis-by-axis fft2 (ifft2) of x: the rows of x, then the columns of the
    row pass's output, moved to the last axis."""
    rows = bl.bluestein_fft(x, inverse)
    return _bl_vs_plain([(x, inverse, rows), (rows.movedim(-2, -1), inverse, None)])


def _bl_run(label: str, calls, want_counts: dict, checks: dict, limits: dict,
            phase: str = "any_n_main_path") -> dict:
    """Runs `calls` with the counts set to 0, checks the counts against
    want_counts, then each of checks' values (a callable giving the error)
    against its limit. The checks run after the counts are read: their
    launches do not count."""
    torch.cuda.synchronize()
    zero_counts()
    outs = calls()
    torch.cuda.synchronize()
    launches = counts()
    check(launches == expect(**want_counts), f"{label}: launches {launches}, "
                                              f"expected {want_counts}")
    res = {"phase": phase, "run": label, "launches": launches}
    for key, err in checks.items():
        res[key] = e = err(outs)
        check(e <= limits[key], f"{label}: {key} {e:.3e} over {limits[key]}")
    print(json.dumps(res), flush=True)
    return res


def phase_bluestein_main_path(dev, gen) -> dict:
    """The any-n path at full size through watfft_tpu_torch.fftlib."""
    rel_lim, rt_lim = MAX_REL["float32"], ROUNDTRIP["float32"]
    out = {}
    # [4096, 1000] complex64: fft, ifft, the roundtrip, a backward
    b, n = BL_MAIN_B, BL_MAIN_N
    x = rand_complex((b, n), gen, dev)
    g = rand_complex((b, n), gen, dev)
    xg = x.clone().requires_grad_()

    def main_calls():
        y = fftlib.fft(x)
        xi = fftlib.ifft(x)
        back = fftlib.ifft(y)
        fftlib.fft(xg).backward(g)
        return y, xi, back

    out["main"] = _bl_run(
        f"fft/ifft [{b}, {n}]", main_calls, {"bluestein_onepass": 5},
        {"fwd_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[0], c128(x)),
         "inv_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[1], c128(x, True)),
         "roundtrip_err": lambda o: (o[2] - x).abs().max().item(),
         "grad_max_rel_vs_torch_fft_c128": lambda o: max_rel(xg.grad, c128(g, True) * n),
         "kernels_vs_plain_rel": lambda o: rel_diff(o[0], bl.plain_bluestein_fft(x))},
        {"fwd_max_rel_vs_torch_fft_c128": rel_lim, "inv_max_rel_vs_torch_fft_c128": rel_lim,
         "roundtrip_err": rt_lim, "grad_max_rel_vs_torch_fft_c128": rel_lim,
         "kernels_vs_plain_rel": KERNEL_LIMIT})
    check(planner.bluestein_kernel(n, b) == "bluestein-fused", "the planner's route at n=1000")
    # the pair #17, #18 through their own entry points (the JAX package's
    # _bl_fwd_call, _bl_inv_call) on time-major planes, both directions
    xre, xim = x.real.T.contiguous(), x.imag.T.contiguous()

    def pair_calls():
        return [bl.bluestein_inv(*bl.bluestein_fwd(xre, xim, inv), n, inv)
                for inv in (False, True)]

    out["pair"] = _bl_run(
        f"bluestein_fwd, bluestein_inv [{n}, {b}]", pair_calls,
        {"bluestein_fwd": 2, "bluestein_inv": 2},
        {"fwd_max_rel_vs_torch_fft_c128": lambda o: max_rel(torch.complex(*o[0]).T, c128(x)),
         "inv_max_rel_vs_torch_fft_c128": lambda o: max_rel(torch.complex(*o[1]).T,
                                                            c128(x, True))},
        {"fwd_max_rel_vs_torch_fft_c128": rel_lim, "inv_max_rel_vs_torch_fft_c128": rel_lim})
    # the same rows padded to 1024: the Stockham kernel, no Bluestein kernel
    _bl_run(f"fft [{b}, {n}] n=1024", lambda: fftlib.fft(x, n=1024), {"stockham_c2c": 1},
            {"max_rel_vs_torch_fft_c128": lambda o: max_rel(o, c128(
                torch.cat([x, x.new_zeros(b, 1024 - n)], dim=-1)))},
            {"max_rel_vs_torch_fft_c128": rel_lim})
    # the prime n = 1009
    xp = rand_complex((b, BL_PRIME_N), gen, dev)
    out["prime"] = _bl_run(
        f"fft/ifft [{b}, {BL_PRIME_N}]", lambda: (fftlib.fft(xp), fftlib.ifft(xp)),
        {"bluestein_onepass": 2},
        {"fwd_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[0], c128(xp)),
         "inv_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[1], c128(xp, True)),
         "kernels_vs_plain_rel": lambda o: _bl_vs_plain([(xp, False, o[0]), (xp, True, o[1])])},
        {"fwd_max_rel_vs_torch_fft_c128": rel_lim, "inv_max_rel_vs_torch_fft_c128": rel_lim,
         "kernels_vs_plain_rel": KERNEL_LIMIT})
    # rfft / irfft at n = 400 on Whisper's framing of eight 30-s clips
    clips, frames, nr = BL_REAL_SHAPE
    hop = BL_REAL_HOP
    sig = rand_real((clips, (frames - 1) * hop + nr), gen, dev)
    window = torch.hann_window(nr, periodic=True, device=dev)
    fr = sig.unfold(-1, nr, hop) * window
    out["real"] = _bl_run(
        f"rfft/irfft {list(BL_REAL_SHAPE)}",
        lambda: (lambda s: (s, fftlib.irfft(s, n=nr)))(fftlib.rfft(fr)),
        {"bluestein_onepass": 2},
        {"fwd_max_rel_vs_torch_fft_f64": lambda o: max_rel(o[0], torch.fft.rfft(fr.double())),
         "roundtrip_err": lambda o: (o[1] - fr).abs().max().item(),
         # the complex operands the kernels were fed: the frames, and the
         # Hermitian extension of the spectrum
         "kernels_vs_plain_rel": lambda o: _bl_vs_plain([
             (fr.to(torch.complex64), False, None),
             (fftlib._hermitian_full(o[0], nr), True, None)])},
        {"fwd_max_rel_vs_torch_fft_f64": rel_lim, "roundtrip_err": rt_lim,
         "kernels_vs_plain_rel": KERNEL_LIMIT})
    # irfft at odd n = 1001: the last bin's imaginary part is used
    no = BL_ODD_N
    spec = torch.complex(rand_real((b, no // 2 + 1), gen, dev),
                         rand_real((b, no // 2 + 1), gen, dev))
    spec[:, 0] = spec[:, 0].real.clone()  # cuFFT's c2r defines no result for Im X[0]
    out["odd"] = _bl_run(
        f"irfft [{b}, {no // 2 + 1}] n={no}", lambda: fftlib.irfft(spec, n=no),
        {"bluestein_onepass": 1},
        {"max_rel_vs_torch_fft_f64": lambda o: max_rel(o, torch.fft.irfft(spec.cdouble(), n=no)),
         "kernels_vs_plain_rel": lambda o: _bl_vs_plain(
             [(fftlib._hermitian_full(spec, no), True, None)])},
        {"max_rel_vs_torch_fft_f64": rel_lim, "kernels_vs_plain_rel": KERNEL_LIMIT})
    # the unfused route: m = 32768 on the four-step kernels (pipe2)
    bu, nu = BL_UNFUSED_B, BL_UNFUSED_N
    xu = rand_complex((bu, nu), gen, dev)
    check(planner.bluestein_kernel(nu, bu) == "bluestein-large-pipe2",
          f"the planner's route at n={nu}")
    out["unfused"] = _bl_run(
        f"fft/ifft [{bu}, {nu}]", lambda: (lambda y: (y, fftlib.ifft(y)))(fftlib.fft(xu)),
        {"large_stage1": 4, "large_stage2": 4},
        {"fwd_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[0], c128(xu)),
         "roundtrip_err": lambda o: (o[1] - xu).abs().max().item()},
        {"fwd_max_rel_vs_torch_fft_c128": rel_lim, "roundtrip_err": rt_lim})
    # fft2 / ifft2 axis by axis: two Bluestein transforms per call
    x2 = rand_complex(BL_2D_SHAPE, gen, dev)
    out["2d"] = _bl_run(
        f"fft2/ifft2 {list(BL_2D_SHAPE)}",
        lambda: (lambda y: (y, fftlib.ifft2(y)))(fftlib.fft2(x2)),
        {"bluestein_onepass": 4},
        {"fwd_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[0], c128_2d(x2)),
         "roundtrip_err": lambda o: (o[1] - x2).abs().max().item(),
         "kernels_vs_plain_rel": lambda o: max(_bl_2d_vs_plain(x2, False),
                                               _bl_2d_vs_plain(o[0], True))},
        {"fwd_max_rel_vs_torch_fft_c128": rel_lim, "roundtrip_err": rt_lim,
         "kernels_vs_plain_rel": KERNEL_LIMIT})
    return out


def phase_bluestein_times(dev, gen, name: str, limit: str) -> dict:
    """Each n at 2^22 points per call: #17 and #18 alone and the one-pass
    kernel alone (complex64 layout), the whole transform, the plain
    version, torch.fft.fft and a device copy of the same bytes; then the
    main shapes and the host time per call at a small batch."""
    times = {}
    for n in BL_TIME_SIZES:
        batch = POINTS // n
        x = rand_complex((batch, n), gen, dev)
        out = torch.empty_like(x)
        route = planner.bluestein_kernel(n, batch)
        fns = {"fft": lambda: bl.bluestein_fft(x), "ifft": lambda: bl.bluestein_fft(x, True),
               "lib_fft": lambda: torch.fft.fft(x), "copy": lambda: out.copy_(x)}
        if route == "bluestein-fused":
            fwd, inv, onepass, _, _ = _bl_passes(x, "complex")
            fns.update({"fwd": fwd, "inv": inv, "onepass": onepass})
        row = {"route": route, "m": bl.bluestein_m(n)}
        for key, fn in fns.items():
            dev_ms, call_ms = time_ms(fn)
            row[key + "_ms"] = dev_ms
            row[key + "_call_ms"] = call_ms
        row["plain_ms"] = time_ms(lambda: bl.plain_bluestein_fft(x), reps=3, warmup=1)[0]
        times[n] = row
        print(json.dumps({"phase": "bluestein_times", "n": n, "batch": batch, **row,
                          "card": name, "power_limit": limit}), flush=True)
    clips, frames, nr = BL_REAL_SHAPE
    fr = rand_real(BL_REAL_SHAPE, gen, dev)
    spec = fftlib.rfft(fr)
    xm = rand_complex((BL_MAIN_B, BL_MAIN_N), gen, dev)
    xu = rand_complex((BL_UNFUSED_B, BL_UNFUSED_N), gen, dev)
    xm_u = rand_complex((BL_UNFUSED_B, bl.bluestein_m(BL_UNFUSED_N)), gen, dev)
    x2 = rand_complex(BL_2D_SHAPE, gen, dev)
    fns = {"fft_main": lambda: fftlib.fft(xm), "lib_fft_main": lambda: torch.fft.fft(xm),
           "rfft_real": lambda: fftlib.rfft(fr), "lib_rfft_real": lambda: torch.fft.rfft(fr),
           "irfft_real": lambda: fftlib.irfft(spec, n=nr),
           "lib_irfft_real": lambda: torch.fft.irfft(spec, n=nr),
           "fft_unfused": lambda: fftlib.fft(xu), "lib_fft_unfused": lambda: torch.fft.fft(xu),
           "fft_m_unfused": lambda: wtt.fft(xm_u),  # one of its two m-point transforms
           "fft2_2d": lambda: fftlib.fft2(x2), "lib_fft2_2d": lambda: torch.fft.fft2(x2)}
    row = {}
    for key, fn in fns.items():
        dev_ms, call_ms = time_ms(fn)
        row[key + "_ms"] = dev_ms
        row[key + "_call_ms"] = call_ms
    print(json.dumps({"phase": "bluestein_main_times", "main": [BL_MAIN_B, BL_MAIN_N],
                      "real": list(BL_REAL_SHAPE), "unfused": [BL_UNFUSED_B, BL_UNFUSED_N],
                      "2d": list(BL_2D_SHAPE), **row, "card": name, "power_limit": limit}),
          flush=True)
    times["main"] = row
    x8 = rand_complex((8, BL_MAIN_N), gen, dev)
    host = {}
    for key, fn in {"fftlib_fft": lambda: fftlib.fft(x8),
                    "bluestein_fft": lambda: bl.bluestein_fft(x8),
                    "lib_fft": lambda: torch.fft.fft(x8)}.items():
        dev_ms, call_ms = time_ms(fn, reps=200)
        host[key + "_ms"], host[key + "_call_ms"] = dev_ms, call_ms
    print(json.dumps({"phase": "bluestein_host", "n": BL_MAIN_N, "batch": 8, **host,
                      "card": name, "power_limit": limit}), flush=True)
    return times


def bluestein_kernel_rows(main: dict, dev, gen, name: str, limit: str) -> list:
    """#17, #18 and the one-pass kernel at the main path's [4096, 1000]
    (complex64), each held against its plain version there in both
    directions and timed alone. Bytes: 8 (n + m) per transform for each of
    the pair (n points read and m written, or the reverse), 16 n for the
    one-pass kernel (n read, n written); flops 5 m log2 m + 6 (n + m) per
    transform for each of the pair, 2 * 5 m log2 m + 6 (2n + m) for the
    one-pass kernel. The library call, torch.fft.fft on the same tensor,
    computes the whole transform. The pair's launches are those of its own
    entry points' run (phase 20, "pair"); the one-pass kernel's those of
    the main run."""
    b, n = BL_MAIN_B, BL_MAIN_N
    m = bl.bluestein_m(n)
    log_m = m.bit_length() - 1
    x = rand_complex((b, n), gen, dev)
    errs = {"bluestein_fwd": 0.0, "bluestein_inv": 0.0, "bluestein_onepass": 0.0}
    rels = {}
    for inverse in (False, True):
        _, _, onepass, _, out = _bl_passes(x, "complex", inverse)
        onepass()
        kernel = [t.clone() for t in out]
        onepass(plain=True)
        held = dict(_bl_alone(x, "complex", inverse), onepass=(kernel, out))
        for which, (k, p) in held.items():
            key = "bluestein_" + which
            errs[key] = max(errs[key], max((a - q).abs().max().item() for a, q in zip(k, p)))
            rels[f"{key} inverse={inverse}"] = rel = held_pair(k, p)
            check(rel <= KERNEL_LIMIT, f"{key} at [{b}, {n}] inverse={inverse}: {rel:.3e} vs plain")
    print(json.dumps({"phase": "bluestein_kernels_at_main_shape", "rel_diff_vs_plain": rels}),
          flush=True)
    fwd, inv, onepass, _, _ = _bl_passes(x, "complex")
    lib = time_ms(lambda: torch.fft.fft(x))[0]
    pair_bound = bound(8 * (n + m) * b, (5 * m * log_m + 6 * (n + m)) * b)
    rows = []
    for key, fn, repl, launches, bnd in (
            ("bluestein_fwd", fwd, "watfft_tpu/ops/bluestein.py:91",
             main["pair"]["launches"]["bluestein_fwd"], pair_bound),
            ("bluestein_inv", inv, "watfft_tpu/ops/bluestein.py:113",
             main["pair"]["launches"]["bluestein_inv"], pair_bound),
            ("bluestein_onepass", onepass, "watfft_tpu/ops/bluestein.py:192",
             main["main"]["launches"]["bluestein_onepass"],
             bound(16 * n * b, (10 * m * log_m + 6 * (2 * n + m)) * b))):
        what = "the whole transform" if key == "bluestein_onepass" else "the pair #17 + #18"
        rows.append({"name": key, "route": "cuda", "source": BL_SRC, "replaces": repl,
                     "also_replaces": [], "launches": launches,
                     "max_abs_err": errs[key], "ms": time_ms(fn)[0],
                     "plain_ms": time_ms(lambda: fn(plain=True), reps=3, warmup=1)[0],
                     "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
                     "library_call": f"torch.fft.fft on [{b}, {n}] complex64 ({what})",
                     "card": name, "power_limit": limit})
    return rows


# -- the f64 tier ---------------------------------------------------------------------

def rand_c128(shape, gen, dev) -> torch.Tensor:
    re = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 2 - 1
    im = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 2 - 1
    return torch.complex(re, im)


def rand_f64(shape, gen, dev) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 2 - 1


def phase_f64_kernel_vs_plain(dev, gen) -> None:
    rel_lim = MAX_REL["float64"]
    for n in SIZES:
        worst, vs_lib = 0.0, 0.0
        for batch in (3, F64_POINTS // n):
            x = rand_c128((batch, n), gen, dev)
            re, im = x.real.contiguous(), x.imag.contiguous()
            re_t, im_t = re.T.contiguous(), im.T.contiguous()
            for inverse in (False, True):
                p = st.plain_fft(x, inverse)
                y = st.stockham_fft(x, inverse)
                diffs = {"complex": rel_diff(y, p),
                         "bm": rel_diff(torch.complex(*st.stockham_fft_bm(re, im, inverse)), p),
                         "nb": rel_diff(torch.complex(*st.stockham_fft_nb(re_t, im_t,
                                                                          inverse)).T, p)}
                worst = max(worst, *diffs.values())
                check(max(diffs.values()) <= F64_KERNEL_LIMIT,
                      f"f64 n={n} batch={batch} inverse={inverse}: kernel vs plain {diffs}")
                if batch == 3:
                    vs_lib = max(vs_lib, e := max_rel(y, c128(x, inverse)))
                    check(e <= rel_lim, f"f64 n={n} inverse={inverse}: {e:.3e} vs torch.fft")
        line = {"phase": "f64_kernel_vs_plain", "n": n, "max_rel_diff": worst,
                "max_rel_vs_torch_fft_c128": vs_lib}
        if n in (64, 1024, 4096):
            t = torch.arange(n, device=dev, dtype=torch.float64)
            basis = torch.exp(2j * torch.pi * torch.outer(t, t) / n)
            eye = n * torch.eye(n, device=dev, dtype=torch.complex128)
            per_bin = (st.stockham_fft(basis) - eye).abs().max().item()
            x = rand_c128((3, n), gen, dev)
            rt = (st.stockham_fft(st.stockham_fft(x), True) - x).abs().max().item()
            check(per_bin < PER_BIN["float64"](n), f"f64 n={n}: per-bin error {per_bin:.3e}")
            check(rt < ROUNDTRIP["float64"], f"f64 n={n}: roundtrip error {rt:.3e}")
            line.update(per_bin_err=per_bin, roundtrip_err=rt)
        print(json.dumps(line), flush=True)
    for n in REAL_SIZES:
        m = n // 2
        worst = 0.0
        for batch in (3, F64_POINTS // n):
            x = rand_f64((batch, n), gen, dev)
            spec = rand_c128((batch, m + 1), gen, dev)
            want, want_inv = rf.plain_rfft(x), rf.plain_irfft(spec)
            xt = x.T.contiguous()
            sre, sim = spec.real.contiguous(), spec.imag.contiguous()
            for fused in (True, False):
                fwd_nb = rf.rfft_nb_fused if fused else rf.rfft_nb
                inv_nb = rf.irfft_nb_fused if fused else rf.irfft_nb
                diffs = {
                    "fwd_complex": rel_diff(rf.rfft(x, fused), want),
                    "fwd_bm": rel_diff(torch.complex(*rf.rfft_bm(x, fused)), want),
                    "fwd_nb": rel_diff(torch.complex(*fwd_nb(xt)).T, want),
                    "inv_complex": rel_diff(rf.irfft(spec, fused), want_inv),
                    "inv_bm": rel_diff(rf.irfft_bm(sre, sim, fused), want_inv),
                    "inv_nb": rel_diff(inv_nb(sre.T.contiguous(), sim.T.contiguous()).T,
                                       want_inv),
                }
                worst = max(worst, *diffs.values())
                check(max(diffs.values()) <= F64_KERNEL_LIMIT,
                      f"f64 real n={n} batch={batch} fused={fused}: kernel vs plain {diffs}")
            if batch == 3:
                e = max_rel(rf.rfft(x), torch.fft.rfft(x))
                check(e <= MAX_REL["float64"], f"f64 real n={n}: forward {e:.3e} vs torch.fft")
                hs = hermitian_valid(spec)
                e_inv = max_rel(rf.irfft(hs), torch.fft.irfft(hs, n))
                check(e_inv <= MAX_REL["float64"],
                      f"f64 real n={n}: inverse {e_inv:.3e} vs torch.fft")
        line = {"phase": "f64_real_kernel_vs_plain", "n": n, "max_rel_diff": worst,
                "max_rel_vs_torch_fft_f64": max(e, e_inv)}
        if n in (64, 1024, 4096):
            t = torch.arange(n, device=dev, dtype=torch.float64)
            k = torch.arange(m + 1, device=dev, dtype=torch.float64)
            basis = torch.cos(2 * torch.pi * torch.outer(k, t) / n)
            want = torch.diag(torch.full((m + 1,), n / 2, device=dev, dtype=torch.float64))
            want[0, 0] = want[m, m] = n
            per_bin = (rf.rfft(basis) - want).abs().max().item()
            x = rand_f64((3, n), gen, dev)
            rt = (rf.irfft(rf.rfft(x)) - x).abs().max().item()
            check(per_bin < PER_BIN["float64"](n), f"f64 real n={n}: per-bin {per_bin:.3e}")
            check(rt < ROUNDTRIP["float64"], f"f64 real n={n}: roundtrip {rt:.3e}")
            line.update(per_bin_err=per_bin, roundtrip_err=rt)
        print(json.dumps(line), flush=True)


def phase_f64_main_path(dev, gen) -> dict:
    """BASELINE config 1, the [4096, 1024] f64 main paths and the f64 (and
    f32 real) matmul surface, through the public entry points."""
    rel_lim, rt_lim = MAX_REL["float64"], ROUNDTRIP["float64"]
    out = {}

    def run(*args):
        return _bl_run(*args, phase="f64_main_path")
    # BASELINE config 1: one f64 complex forward transform of n = 1024
    ctx = create_fft(MAIN_N, device="cuda")
    x1 = rand_c128((MAIN_N,), gen, dev)
    out["config1"] = run(
        f"create_fft({MAIN_N}).forward on one complex128 [{MAIN_N}]", lambda: ctx.forward(x1),
        {"stockham_c2c_f64": 1},
        {"max_rel_vs_torch_fft_c128": lambda y: max_rel(y, torch.fft.fft(x1)),
         "kernel_vs_plain_rel": lambda y: rel_diff(y, st.plain_fft(x1))},
        {"max_rel_vs_torch_fft_c128": rel_lim, "kernel_vs_plain_rel": F64_KERNEL_LIMIT})
    # [4096, 1024] complex128: every entry point and a backward
    x = rand_c128((MAIN_B, MAIN_N), gen, dev)
    g = rand_c128((MAIN_B, MAIN_N), gen, dev)
    re, im = x.real.contiguous(), x.imag.contiguous()
    re_t, im_t = re.T.contiguous(), im.T.contiguous()
    xg = x.clone().requires_grad_()

    def c2c_calls():
        y = ctx.forward(x)
        xi = ctx.inverse(x)
        back = ctx.inverse(y)
        pre, pim = ctx.forward_planes(re, im)
        nre, nim = ctx.forward_planes_nb(re_t, im_t)
        ctx.forward(xg).backward(g)
        return y, xi, back, torch.complex(pre, pim), torch.complex(nre, nim).T
    out["c2c"] = run(
        f"create_fft({MAIN_N}) on [{MAIN_B}, {MAIN_N}] complex128", c2c_calls,
        {"stockham_c2c_f64": 7},
        {"fwd_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[0], torch.fft.fft(x)),
         "inv_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[1], torch.fft.ifft(x)),
         "roundtrip_err": lambda o: (o[2] - x).abs().max().item(),
         "planes_vs_complex": lambda o: max(rel_diff(o[3], o[0]), rel_diff(o[4], o[0])),
         "grad_max_rel_vs_torch_fft_c128": lambda o: max_rel(xg.grad,
                                                             torch.fft.ifft(g) * MAIN_N),
         "kernel_vs_plain_rel": lambda o: rel_diff(o[0], st.plain_fft(x))},
        {"fwd_max_rel_vs_torch_fft_c128": rel_lim, "inv_max_rel_vs_torch_fft_c128": rel_lim,
         "roundtrip_err": rt_lim, "planes_vs_complex": F64_KERNEL_LIMIT,
         "grad_max_rel_vs_torch_fft_c128": rel_lim, "kernel_vs_plain_rel": F64_KERNEL_LIMIT})
    # [4096, 1024] float64 through create_rfft(1024), both directions
    n, m = MAIN_N, MAIN_N // 2
    rctx = create_rfft(n, device="cuda")
    xr = rand_f64((MAIN_B, n), gen, dev)
    spec = hermitian_valid(torch.fft.rfft(rand_f64((MAIN_B, n), gen, dev)))
    gs = rand_c128((MAIN_B, m + 1), gen, dev)
    ybar = rand_f64((MAIN_B, n), gen, dev)
    xrg, sg = xr.clone().requires_grad_(), spec.clone().requires_grad_()
    xr_t = xr.T.contiguous()

    def real_calls():
        y = rctx.forward(xr)
        xi = rctx.inverse(spec)
        back = rctx.inverse(y)
        pre, pim = rctx.forward_planes(xr)
        bx = rctx.inverse_planes(spec.real, spec.imag)
        nre, nim = rctx.forward_planes_nb(xr_t)
        nback = rctx.inverse_planes_nb(nre, nim)
        rctx.forward(xrg).backward(gs)
        rctx.inverse(sg).backward(ybar)
        return (y, xi, back, torch.complex(pre, pim), bx, torch.complex(nre, nim).T,
                nback.T)

    def grad_fwd_err(_):
        x64g = xr.clone().requires_grad_()
        torch.fft.rfft(x64g).backward(gs)
        return max_rel(xrg.grad, x64g.grad)

    def grad_inv_err(_):
        r = torch.fft.rfft(ybar)
        gre = r.real.clone()
        gre[:, [0, m]] *= 0.5
        gim = r.imag.clone()
        gim[:, 0], gim[:, m] = -0.5 * r.real[:, m], -0.5 * r.real[:, 0]
        return max_rel(sg.grad, torch.complex(gre, gim) / m)
    # 5 r2c: forward, forward_planes, forward_planes_nb, the forward before
    # its backward, the inverse's backward; 6 c2r: inverse, the roundtrip,
    # inverse_planes, inverse_planes_nb, the inverse before its backward,
    # the forward's backward
    out["real"] = run(
        f"create_rfft({n}) on [{MAIN_B}, {n}] float64", real_calls,
        {"rfft_r2c_fused_f64": 5, "irfft_c2r_fused_f64": 6},
        {"fwd_max_rel_vs_torch_fft_f64": lambda o: max_rel(o[0], torch.fft.rfft(xr)),
         "inv_max_rel_vs_torch_fft_f64": lambda o: max_rel(o[1], torch.fft.irfft(spec, n)),
         "roundtrip_err": lambda o: max((o[2] - xr).abs().max().item(),
                                        (o[6] - xr).abs().max().item()),
         "planes_vs_complex": lambda o: max(rel_diff(o[3], o[0]), rel_diff(o[4], o[1]),
                                            rel_diff(o[5], o[0])),
         "grad_fwd_max_rel_vs_torch_f64": grad_fwd_err,
         "grad_inv_max_rel_vs_adjoint_f64": grad_inv_err,
         "r2c_vs_plain_rel": lambda o: rel_diff(o[0], rf.plain_rfft(xr)),
         "c2r_vs_plain_rel": lambda o: rel_diff(o[1], rf.plain_irfft(spec))},
        {"fwd_max_rel_vs_torch_fft_f64": rel_lim, "inv_max_rel_vs_torch_fft_f64": rel_lim,
         "roundtrip_err": rt_lim, "planes_vs_complex": F64_KERNEL_LIMIT,
         "grad_fwd_max_rel_vs_torch_f64": rel_lim, "grad_inv_max_rel_vs_adjoint_f64": rel_lim,
         "r2c_vs_plain_rel": F64_KERNEL_LIMIT, "c2r_vs_plain_rel": F64_KERNEL_LIMIT})
    # past the kernels: the float64 matmul surface, no FFT kernel launched
    nf = F64_FOURSTEP_N
    check(planner.c2c_kernel(nf, "float64") == planner.r2c_kernel(nf, "float64") == "fourstep",
          "the planner's f64 route past the kernels")
    fctx, frctx = create_fft(nf, device="cuda"), create_rfft(nf, device="cuda")
    xf = rand_c128((4, nf), gen, dev)
    xfr = rand_f64((4, nf), gen, dev)
    out["fourstep"] = run(
        f"create_fft / create_rfft({nf}) on [4, {nf}]",
        lambda: (lambda y, s: (y, fctx.inverse(y), s, frctx.inverse(s)))(fctx.forward(xf),
                                                                         frctx.forward(xfr)),
        {}, {"fwd_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[0], torch.fft.fft(xf)),
             "rfft_max_rel_vs_torch_fft_f64": lambda o: max_rel(o[2], torch.fft.rfft(xfr)),
             "roundtrip_err": lambda o: max((o[1] - xf).abs().max().item(),
                                            (o[3] - xfr).abs().max().item())},
        {"fwd_max_rel_vs_torch_fft_c128": rel_lim, "rfft_max_rel_vs_torch_fft_f64": rel_lim,
         "roundtrip_err": rt_lim})
    # the f32 real FFT past 2^25: the real matmul surface
    nb = F32_REAL_FOURSTEP_N
    check(planner.r2c_kernel(nb, "float32") == "fourstep", "the planner's f32 real route past 2^25")
    bctx = create_rfft_f32(nb, device="cuda")
    xb = rand_real((1, nb), gen, dev)
    out["f32_real_fourstep"] = run(
        f"create_rfft_f32({nb}) on one signal", lambda: bctx.forward(xb), {},
        {"max_rel_vs_torch_fft_f64": lambda o: max_rel(o, torch.fft.rfft(xb.double()))},
        {"max_rel_vs_torch_fft_f64": MAX_REL["float32"]})
    return out


def phase_f64_times(dev, gen, name: str, limit: str) -> dict:
    """2^21 points per call at every n: the FP64 kernels (complex128
    layout), their plain versions, torch.fft in complex128 / float64 and a
    device copy of the same bytes; then the host's time per call at
    BASELINE config 1 (batch 1, n = 1024)."""
    times = {}
    for n in SIZES:
        batch = F64_POINTS // n
        x = rand_c128((batch, n), gen, dev)
        out = torch.empty_like(x)
        fns = {"kernel_fwd": lambda: st.stockham_fft(x), "kernel_inv": lambda: st.stockham_fft(x, True),
               "plain_fwd": lambda: st.plain_fft(x), "lib_fft": lambda: torch.fft.fft(x),
               "copy": lambda: out.copy_(x)}
        row = {}
        for key, fn in fns.items():
            dev_ms, call_ms = time_ms(fn)
            row[key + "_ms"], row[key + "_call_ms"] = dev_ms, call_ms
        times[("c2c", n)] = row
        print(json.dumps({"phase": "f64_times", "n": n, "batch": batch, **row, "card": name,
                          "power_limit": limit}), flush=True)
    for n in REAL_SIZES:
        m, batch = n // 2, F64_POINTS // n
        x = rand_f64((batch, n), gen, dev)
        spec = rand_c128((batch, m + 1), gen, dev)
        out = torch.empty_like(x)
        fns = {"r2c": lambda: rf.rfft(x), "c2r": lambda: rf.irfft(spec),
               "plain_r2c": lambda: rf.plain_rfft(x), "plain_c2r": lambda: rf.plain_irfft(spec),
               "lib_rfft": lambda: torch.fft.rfft(x), "lib_irfft": lambda: torch.fft.irfft(spec, n),
               "copy": lambda: out.copy_(x)}
        row = {}
        for key, fn in fns.items():
            dev_ms, call_ms = time_ms(fn)
            row[key + "_ms"], row[key + "_call_ms"] = dev_ms, call_ms
        times[("real", n)] = row
        print(json.dumps({"phase": "f64_real_times", "n": n, "batch": batch, **row,
                          "card": name, "power_limit": limit}), flush=True)
    ctx = create_fft(MAIN_N, device="cuda")
    x1 = rand_c128((MAIN_N,), gen, dev)
    host = {}
    for key, fn in {"ctx_forward": lambda: ctx.forward(x1),
                    "wrapper": lambda: st.stockham_fft(x1),
                    "lib_fft": lambda: torch.fft.fft(x1)}.items():
        dev_ms, call_ms = time_ms(fn, reps=200)
        host[key + "_ms"], host[key + "_call_ms"] = dev_ms, call_ms
    print(json.dumps({"phase": "f64_host", "n": MAIN_N, "batch": 1, **host, "card": name,
                      "power_limit": limit}), flush=True)
    return times


def f64_kernel_rows(main: dict, dev, gen, name: str, limit: str) -> list:
    """The three FP64 kernels at the main shapes, [4096, 1024] complex128 and
    float64: each held against its plain version there and timed alone,
    with torch.fft on the same tensor. Bytes: each input read once and each
    output written once (16 B a complex128 point, 8 B a float64 one); flops
    5 n log2 n per c2c transform and 5 m log2 m + 10 per bin for the real
    ones, over the FP64 rate."""
    b, n, m = MAIN_B, MAIN_N, MAIN_N // 2
    x = rand_c128((b, n), gen, dev)
    xr = rand_f64((b, n), gen, dev)
    spec = rand_c128((b, m + 1), gen, dev)
    log_n, log_m = n.bit_length() - 1, m.bit_length() - 1
    real_bytes = 8 * n * b + 16 * (m + 1) * b
    rows, rels = [], {}
    for key, fn, plain, lib, nbytes, flops, src, also, launched in (
            ("stockham_c2c_f64", lambda: st.stockham_fft(x), lambda: st.plain_fft(x),
             lambda: torch.fft.fft(x), 32 * n * b, 5 * n * log_n * b, F64_SRC["c2c"], [],
             main["c2c"]["launches"]["stockham_c2c_f64"]
             + main["config1"]["launches"]["stockham_c2c_f64"]),
            ("rfft_r2c_fused_f64", lambda: rf.rfft(xr), lambda: rf.plain_rfft(xr),
             lambda: torch.fft.rfft(xr), real_bytes, (5 * m * log_m + 10 * (m + 1)) * b,
             F64_SRC["real"], ["watfft_tpu/ops/doublefloat.py:376"],
             main["real"]["launches"]["rfft_r2c_fused_f64"]),
            ("irfft_c2r_fused_f64", lambda: rf.irfft(spec), lambda: rf.plain_irfft(spec),
             lambda: torch.fft.irfft(spec, n), real_bytes, (5 * m * log_m + 10 * m) * b,
             F64_SRC["real"], ["watfft_tpu/ops/doublefloat.py:415"],
             main["real"]["launches"]["irfft_c2r_fused_f64"])):
        k, p = fn(), plain()
        rels[key] = rel = rel_diff(k, p)
        check(rel <= F64_KERNEL_LIMIT, f"{key} at [{b}, {n}]: {rel:.3e} vs plain")
        bnd = bound(nbytes, flops, PEAK_FLOPS_F64)
        rows.append({"name": key, "route": "cuda", "source": src,
                     "replaces": "watfft_tpu/ops/doublefloat.py:280", "also_replaces": also,
                     "launches": launched, "max_abs_err": (k - p).abs().max().item(),
                     "ms": time_ms(fn)[0], "plain_ms": time_ms(plain, reps=3, warmup=1)[0],
                     "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": time_ms(lib)[0],
                     "card": name, "power_limit": limit})
    print(json.dumps({"phase": "f64_kernels_at_main_shape", "rel_diff_vs_plain": rels}),
          flush=True)
    return rows


# -- #20, the small-n DFT matmul ------------------------------------------------------

def dft_plain64(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """#20's plain version summed in float64: the product of the same f32 W
    (`md.device_matrix`) and complex64 x [..., n], widened, in complex128.
    The kernel's difference from it is its own rounding; from the f32 plain
    version (`md.plain_dft_matmul`) it is mostly that version's."""
    n = x.shape[-1]
    y = torch.cat([x.real, x.imag], -1).double() @ md.device_matrix(n, inverse, x.device).double()
    return torch.complex(y[..., :n], y[..., n:])


def phase_dft_kernel_vs_plain(dev, gen) -> None:
    """#20 against its plain version summed in float64 (`dft_plain64`) at
    n = 1..128 in three layouts, batch 3 and 2^22/n, and against torch.fft in
    complex128; per bin at every n; the reading against the f32 plain
    version recorded beside."""
    worst = worst_f32 = 0.0
    for n in DFT_SIZES:
        line = {"phase": "dft_kernel_vs_plain", "n": n}
        for batch in (3, POINTS // n):
            x = rand_complex((batch, n), gen, dev)
            re, im = x.real.contiguous(), x.imag.contiguous()
            tre, tim = re.T.contiguous(), im.T.contiguous()
            for inverse in (False, True):
                p = dft_plain64(x, inverse)
                y = md.dft_matmul(x, inverse)
                diffs = {"complex": rel_diff(y.to(p.dtype), p),
                         "bm": rel_diff(as_c128(md.dft_matmul_bm(re, im, inverse)), p),
                         "nb": rel_diff(as_c128(md.dft_matmul_nb(tre, tim, inverse)).T, p)}
                worst = max(worst, *diffs.values())
                check(max(diffs.values()) <= KERNEL_LIMIT,
                      f"dft n={n} batch={batch} inverse={inverse}: kernel vs plain {diffs}")
                e = max_rel(y, c128(x, inverse))
                check(e <= MAX_REL["float32"], f"dft n={n} batch={batch} inverse={inverse}: "
                                               f"{e:.3e} vs torch.fft c128")
                f32 = rel_diff(y, md.plain_dft_matmul(x, None, inverse, layout="complex"))
                worst_f32 = max(worst_f32, f32)
                for key, v in ((f"batch_{batch}_max_rel_diff", max(diffs.values())),
                               (f"batch_{batch}_max_rel_vs_torch_fft_c128", e),
                               (f"batch_{batch}_rel_diff_vs_plain_f32", f32)):
                    line[key] = max(line.get(key, 0.0), v)
        t = torch.arange(n, device=dev, dtype=torch.float64)
        basis = torch.exp(2j * torch.pi * torch.outer(t, t) / n).to(torch.complex64)
        eye = n * torch.eye(n, device=dev, dtype=torch.complex64)
        line["per_bin_err"] = per_bin = (md.dft_matmul(basis) - eye).abs().max().item()
        check(per_bin < PER_BIN["float32"](n), f"dft n={n}: per-bin error {per_bin:.3e}")
        print(json.dumps(line), flush=True)
    print(json.dumps({"phase": "dft_kernels_vs_plain", "sizes": len(DFT_SIZES),
                      "max_rel_diff": worst, "max_rel_diff_vs_plain_f32": worst_f32}),
          flush=True)


def phase_dft_main_path(dev, gen) -> dict:
    """#20's own path (the JAX planner routes no call to it): dft_matmul_nb,
    the JAX signature, forward and inverse on time-major [n, 2^22/n] planes
    and dft_matmul on the complex64 layout, at n = 128 and 16, each run
    with its launch count."""
    out = {}
    for n in DFT_ROWS:
        b = POINTS // n
        x = rand_complex((b, n), gen, dev)
        re_t, im_t = x.real.T.contiguous(), x.imag.T.contiguous()

        def calls():
            fwd = torch.complex(*wtt.dft_matmul_nb(re_t, im_t)).T
            inv = torch.complex(*wtt.dft_matmul_nb(re_t, im_t, inverse=True)).T
            return fwd, inv, md.dft_matmul(x)
        out[n] = _bl_run(
            f"dft_matmul_nb on [{n}, {b}] forward and inverse, dft_matmul on [{b}, {n}]",
            calls, {"mxu_dft": 3},
            {"fwd_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[0], c128(x)),
             "inv_max_rel_vs_torch_fft_c128": lambda o: max_rel(o[1], c128(x, True)),
             "layouts_agree": lambda o: rel_diff(o[2], o[0]),
             "kernel_vs_plain_rel": lambda o: rel_diff(o[2].to(torch.complex128),
                                                       dft_plain64(x))},
            {"fwd_max_rel_vs_torch_fft_c128": MAX_REL["float32"],
             "inv_max_rel_vs_torch_fft_c128": MAX_REL["float32"],
             "layouts_agree": KERNEL_LIMIT, "kernel_vs_plain_rel": KERNEL_LIMIT},
            phase="dft_main_path")
    return out


def dft_bound(n: int, b: int) -> tuple[float, str]:
    """#20's least time as a 3xTF32 matmul: 16 bytes a point in and out
    against 3 * 8n^2 flops a transform (three TF32 products of the dense
    real form) over the tensor cores' TF32 rate. It bounds the dense product
    the kernel does, not the n-point DFT, whose least is the bytes alone
    (`dft_bytes_bound_ms`); at n <= 2, where the FP32 cores run it, the
    bytes bound either form."""
    return bound(16 * n * b, 3 * 8 * n * n * b, PEAK_FLOPS_TF32)


def dft_bytes_bound_ms(n: int, b: int) -> float:
    """The n-point DFT's own least time: 16 bytes a point over HBM."""
    return bound(16 * n * b, 0.0)[0]


@contextlib.contextmanager
def forced_mma():
    """#20's launches inside the block take the tensor-core kernel at every
    n, n <= md.SIMT_MAX_N too; the rule (`md.dft_launch`) restored after."""
    prev, md.SIMT_MAX_N = md.SIMT_MAX_N, 0
    try:
        yield
    finally:
        md.SIMT_MAX_N = prev


def phase_dft_times(dev, gen, name: str, limit: str) -> dict:
    """2^22 points a call at every power-of-two n = 2..128: #20 in three
    layouts and, on complex64, the tensor-core kernel forced where the rule
    takes the FP32 cores, the f32 c2c kernel (#1) on the same input, the
    plain version, torch.fft.fft (cuFFT) and the bound."""
    times = {}
    for n in DFT_TIME_SIZES:
        b = POINTS // n
        x = rand_complex((b, n), gen, dev)
        re, im = x.real.contiguous(), x.imag.contiguous()
        re_t, im_t = re.T.contiguous(), im.T.contiguous()
        fns = {"dft_complex": lambda: md.dft_matmul(x),
               "dft_complex_inv": lambda: md.dft_matmul(x, True),
               "dft_nb": lambda: md.dft_matmul_nb(re_t, im_t),
               "dft_bm": lambda: md.dft_matmul_bm(re, im),
               "c2c_complex": lambda: st.stockham_fft(x),
               "c2c_nb": lambda: st.stockham_fft_nb(re_t, im_t),
               "plain": lambda: md.plain_dft_matmul(x, None, layout="complex"),
               "lib_fft": lambda: torch.fft.fft(x)}
        row = {}
        for key, fn in fns.items():
            row[key + "_ms"] = time_ms(fn)[0]
        with forced_mma():
            row["dft_mma_ms"] = time_ms(fns["dft_complex"])[0]
        bnd = dft_bound(n, b)
        row.update(bound_ms=bnd[0], bound_by=bnd[1], bytes_bound_ms=dft_bytes_bound_ms(n, b),
                   kernel="simt" if n <= md.SIMT_MAX_N else "mma")
        times[n] = row
        print(json.dumps({"phase": "dft_times", "n": n, "batch": b, **row,
                          "bound_peaks": "HBM 3.35 TB/s; TF32 tensor cores 495 TFLOP/s "
                                         "(3xTF32: three passes)",
                          "card": name, "power_limit": limit}), flush=True)
    return times


def dft_kernel_rows(main: dict, dev, gen, name: str, limit: str) -> list:
    """#20 at n = 128 and 16 on 2^22 points (complex64 layout): held against
    its plain version summed in float64 there (`dft_plain64`) and timed, with
    the f32 plain version and torch.fft.fft on the same tensor."""
    rows = []
    for n in DFT_ROWS:
        b = POINTS // n
        x = rand_complex((b, n), gen, dev)
        k, p = md.dft_matmul(x).to(torch.complex128), dft_plain64(x)
        rel = rel_diff(k, p)
        check(rel <= KERNEL_LIMIT, f"mxu_dft at [{b}, {n}]: {rel:.3e} vs plain")
        bnd = dft_bound(n, b)
        rows.append({"name": "mxu_dft", "shape": f"[{b}, {n}] complex64", "route": "cuda",
                     "source": DFT_SRC, "replaces": "watfft_tpu/ops/mxu_dft.py:59",
                     "also_replaces": [], "launches": main[n]["launches"]["mxu_dft"],
                     "max_abs_err": (k - p).abs().max().item(),
                     "max_abs_err_of": "against the plain product summed in float64",
                     "ms": time_ms(lambda: md.dft_matmul(x))[0],
                     "plain_ms": time_ms(lambda: md.plain_dft_matmul(x, None,
                                                                     layout="complex"))[0],
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "bound_peak": "TF32 tensor cores 495 TFLOP/s; HBM 3.35 TB/s",
                     "bound_of": "the 3xTF32 matmul form (3 * 8n^2 flops a transform), "
                                 "not the n-point DFT, whose least is bytes_bound_ms",
                     "bytes_bound_ms": dft_bytes_bound_ms(n, b),
                     "library_ms": time_ms(lambda: torch.fft.fft(x))[0],
                     "library_call": "torch.fft.fft on the same complex64 tensor",
                     "card": name, "power_limit": limit})
    return rows


# -- #1's bf16 tiers --------------------------------------------------------------------------

@contextlib.contextmanager
def bf16_compute(on: bool):
    """config.BF16_COMPUTE set inside the block, restored after it."""
    prev, config.BF16_COMPUTE = config.BF16_COMPUTE, on
    try:
        yield
    finally:
        config.BF16_COMPUTE = prev


def rand_bf16(shape, gen, dev) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple((torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
                 for _ in range(2))


def bf16_rel(got, want) -> float:
    """max |got - want| / max |want| over a pair of bf16 planes, in f32."""
    return (max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            / max(w.float().abs().max().item() for w in want))


def c128_planes(re: torch.Tensor, im: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """torch.fft in complex128 of time-major [n, b] planes, along axis 0."""
    x = torch.complex(re.double(), im.double())
    return torch.fft.ifft(x, dim=0) if inverse else torch.fft.fft(x, dim=0)


def as_c128(planes) -> torch.Tensor:
    return torch.complex(planes[0].double(), planes[1].double())


def _bf16_vs_oracle(y, re, im, tier: str, inverse: bool, n: int) -> dict:
    """The bf16 output y of (re, im) against torch.fft in complex128 of the
    bf16 input, and the roundtrip back through the other direction."""
    e = rel_diff(as_c128(y), c128_planes(re, im, inverse))
    check(e < BF16_ORACLE[tier], f"bf16 {tier} n={n} inverse={inverse}: {e:.3e} vs c128")
    back = st.stockham_fft_nb(*y, not inverse)
    rt = max((back[0].float() - re.float()).abs().max().item(),
             (back[1].float() - im.float()).abs().max().item())
    check(rt < BF16_ROUNDTRIP[tier], f"bf16 {tier} n={n}: roundtrip {rt:.3e}")
    key = f"{tier}_{'inv' if inverse else 'fwd'}"
    return {f"{key}_rel_vs_torch_fft_c128": e, f"{key}_roundtrip_err": rt}


def phase_bf16_kernel_vs_plain(dev, gen) -> None:
    """Both bf16 tiers against their plain versions on the card, compared in
    bf16, at every power-of-two n = 2..4096, batch 3 and 2^22/n, in the
    layouts each serves: the compute tier on time-major [n, b] planes, the
    interop tier on [n, b], batch-major and (at batch 2^22/n) the folded
    [n, 8, W] view. At batch 3 also against torch.fft in complex128 of the
    bf16 input, and the roundtrip."""
    worst = {}
    for n in SIZES:
        line = {"phase": "bf16_kernel_vs_plain", "n": n}
        for batch in (3, POINTS // n):
            re, im = rand_bf16((n, batch), gen, dev)
            bre, bim = re.T.contiguous(), im.T.contiguous()
            folded = ((re.view(n, 8, batch // 8), im.view(n, 8, batch // 8))
                      if batch % 8 == 0 else None)
            for inverse in (False, True):
                diffs = {}
                for tier, on in (("interop", False), ("compute", True)):
                    with bf16_compute(on):
                        y = st.stockham_fft_nb(re, im, inverse)
                        check(y[0].dtype == torch.bfloat16, f"bf16 {tier}: {y[0].dtype} out")
                        diffs[tier + "_nb"] = bf16_rel(y, st.plain_fft_nb(re, im, inverse))
                        if batch == 3:
                            line.update(_bf16_vs_oracle(y, re, im, tier, inverse, n))
                diffs["interop_bm"] = bf16_rel(st.stockham_fft_bm(bre, bim, inverse),
                                               st.plain_fft_bm(bre, bim, inverse))
                if folded is not None:
                    diffs["interop_folded"] = bf16_rel(st.stockham_fft_nb(*folded, inverse),
                                                       st.plain_fft_nb(*folded, inverse))
                for key, d in diffs.items():
                    worst[key] = max(worst.get(key, 0.0), d)
                    line[f"{key}_max_rel_diff"] = max(line.get(f"{key}_max_rel_diff", 0.0), d)
                check(max(diffs.values()) <= BF16_KERNEL_LIMIT,
                      f"bf16 n={n} batch={batch} inverse={inverse}: kernel vs plain {diffs}")
        print(json.dumps(line), flush=True)
    print(json.dumps({"phase": "bf16_kernels_vs_plain", "max_rel_diff": worst,
                      "limit": BF16_KERNEL_LIMIT}), flush=True)


def phase_bf16_main_path(dev, gen) -> dict:
    """The bf16 planes of BASELINE config 4's shape, time-major [1024, 4096]
    (4096 transforms of n = 1024), through stockham_fft_nb in each tier:
    forward, inverse, roundtrip and a backward; in the interop tier also
    batch-major planes and the folded [n, 8, W] view. Each run with its
    launch counts: bf16 planes launch only their tier's instance."""
    n, b = MAIN_N, MAIN_B
    re, im = rand_bf16((n, b), gen, dev)
    g = rand_bf16((n, b), gen, dev)
    bre, bim = re.T.contiguous(), im.T.contiguous()
    fold = (re.view(n, 8, b // 8), im.view(n, 8, b // 8))
    ref, ref_inv = c128_planes(re, im), c128_planes(re, im, True)
    grad_ref = c128_planes(*g, True) * n  # the adjoint of the forward: n * IFFT
    out = {}
    for tier, on in (("interop", False), ("compute", True)):
        xg = (re.clone().requires_grad_(), im.clone().requires_grad_())

        def calls():
            y = st.stockham_fft_nb(re, im)
            outs = {"y": y, "xi": st.stockham_fft_nb(re, im, True),
                    "back": st.stockham_fft_nb(*y, True)}
            torch.autograd.backward(st.stockham_fft_nb(*xg), g)
            if not on:
                outs["bm"] = st.stockham_fft_bm(bre, bim)
                outs["fold"] = st.stockham_fft_nb(*fold)
            return outs
        key = "stockham_c2c_bf16c" if on else "stockham_c2c_bf16"
        checks = {
            "fwd_rel_vs_torch_fft_c128": lambda o: rel_diff(as_c128(o["y"]), ref),
            "inv_rel_vs_torch_fft_c128": lambda o: rel_diff(as_c128(o["xi"]), ref_inv),
            "roundtrip_err": lambda o: (as_c128(o["back"]) - torch.complex(
                re.double(), im.double())).abs().max().item(),
            "grad_rel_vs_torch_fft_c128": lambda o: rel_diff(
                torch.complex(xg[0].grad.double(), xg[1].grad.double()), grad_ref),
            "kernel_vs_plain_rel": lambda o: bf16_rel(o["y"], st.plain_fft_nb(re, im))}
        limits = {"fwd_rel_vs_torch_fft_c128": BF16_ORACLE[tier],
                  "inv_rel_vs_torch_fft_c128": BF16_ORACLE[tier],
                  "roundtrip_err": BF16_ROUNDTRIP[tier],
                  "grad_rel_vs_torch_fft_c128": BF16_ORACLE[tier],
                  "kernel_vs_plain_rel": BF16_KERNEL_LIMIT}
        if not on:
            checks["layouts_vs_nb"] = lambda o: max(
                bf16_rel((o["bm"][0].T, o["bm"][1].T), o["y"]),
                bf16_rel((o["fold"][0].reshape(n, b), o["fold"][1].reshape(n, b)), o["y"]))
            limits["layouts_vs_nb"] = BF16_KERNEL_LIMIT
        with bf16_compute(on):
            # 5 calls (the backward one) in the compute tier; 7 in the interop
            out[tier] = _bl_run(f"stockham_fft_nb on bf16 [{n}, {b}], {tier} tier", calls,
                                {key: 5 if on else 7}, checks, limits, phase="bf16_main_path")
    return out


def phase_bf16_times(dev, gen, name: str, limit: str) -> dict:
    """2^22 points a call at every n: both bf16 tiers (time-major planes),
    the f32 kernel on the same values in f32, the plain versions,
    torch.fft.fft on complex32 (the nearest library call: fp16, no torch
    call computes a bf16 FFT) and on complex64, and a device copy of the
    bf16 planes."""
    times = {}
    for n in SIZES:
        b = POINTS // n
        re, im = rand_bf16((n, b), gen, dev)
        re32, im32 = re.float(), im.float()
        x64 = torch.complex(re32, im32).T.contiguous()
        x32 = x64.to(torch.complex32)
        t16 = st.device_tables(n, False, dev, torch.bfloat16)  # the compute tier, given
        out_re, out_im = torch.empty_like(re), torch.empty_like(im)
        fns = {"interop": lambda: st.stockham_fft_nb(re, im),
               "compute": lambda: st.stockham_fft_nb(re, im, tables=t16),
               "f32_nb": lambda: st.stockham_fft_nb(re32, im32),
               "f32_complex": lambda: st.stockham_fft(x64),
               "lib_fft_complex32": lambda: torch.fft.fft(x32),
               "lib_fft_complex64": lambda: torch.fft.fft(x64),
               "copy": lambda: (out_re.copy_(re), out_im.copy_(im))}
        row = {key + "_ms": time_ms(fn)[0] for key, fn in fns.items()}
        row["plain_interop_ms"] = time_ms(lambda: st.plain_fft_nb(re, im), reps=3, warmup=1)[0]
        row["plain_compute_ms"] = time_ms(lambda: st.plain_fft_nb(re, im, tables=t16), reps=3,
                                          warmup=1)[0]
        bnd = bound(8 * n * b, 5 * n * (n.bit_length() - 1) * b)
        row.update(bound_ms=bnd[0], bound_by=bnd[1])
        times[n] = row
        print(json.dumps({"phase": "bf16_times", "n": n, "batch": b, **row, "card": name,
                          "power_limit": limit}), flush=True)
    return times


def bf16_kernel_rows(main: dict, times: dict, dev, gen, name: str, limit: str) -> list:
    """The two bf16 instances at the main shape, time-major bf16 [1024, 4096]:
    each held against its plain version there (its max |diff|), with the
    times of phase_bf16_times at that shape. Bytes: 4 read and 4 written a
    point."""
    n, b = MAIN_N, MAIN_B
    t = times[n]
    re, im = rand_bf16((n, b), gen, dev)
    t16 = st.device_tables(n, False, dev, torch.bfloat16)
    bnd = bound(8 * n * b, 5 * n * (n.bit_length() - 1) * b)
    rows = []
    for key, tier, tables, also in (
            ("stockham_c2c_bf16", "interop", None, ["watfft_tpu/ops/pallas_stockham.py:355",
                                                     "watfft_tpu/ops/pallas_stockham.py:435"]),
            ("stockham_c2c_bf16c", "compute", t16, [])):
        k = st.stockham_fft_nb(re, im, tables=tables)
        p = st.plain_fft_nb(re, im, tables=tables)
        rel = bf16_rel(k, p)
        check(rel <= BF16_KERNEL_LIMIT, f"{key} at [{n}, {b}]: {rel:.3e} vs plain")
        rows.append({"name": key, "route": "cuda",
                     "source": "watfft_tpu_torch/ops/csrc/stockham.cu",
                     "replaces": "watfft_tpu/ops/pallas_stockham.py:260",
                     "also_replaces": also,
                     "launches": main[tier]["launches"][key],
                     "max_abs_err": max((a.float() - c.float()).abs().max().item()
                                        for a, c in zip(k, p)),
                     "ms": t[f"{tier}_ms"], "plain_ms": t[f"plain_{tier}_ms"],
                     "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                     "library_note": "no torch call computes a bf16 FFT; torch.fft.fft on "
                                     f"complex32 (fp16) took {t['lib_fft_complex32_ms']} ms",
                     "card": name, "power_limit": limit})
    return rows


# -- the matmul surface's precision ladder -------------------------------------------------

def phase_ladder(dev, gen, name: str, limit: str) -> dict:
    """forward_planes_fourstep (the matmul surface, no kernel) at n = 2^16
    and the fftlib ladder case (n = 256), under config.MXU_PRECISION
    "highest" and "default": the error against torch.fft in complex128 and
    the device time; the caller's TF32 setting is back after each call.
    Where the case must show the switch, "default" has to be
    LADDER_TF32_GAIN times further off than "highest"."""
    out = {}
    setting = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    prev = config.MXU_PRECISION
    try:
        for n, b, shows in LADDER_CASES:
            ctx = create_fft_f32(n, device="cuda")
            x = rand_complex((b, n), gen, dev)
            re, im = x.real.contiguous(), x.imag.contiguous()
            want = c128(x)
            row = {}
            for ladder in ("highest", "default"):
                config.MXU_PRECISION = ladder
                torch.cuda.synchronize()
                zero_counts()
                y = torch.complex(*ctx.forward_planes_fourstep(re, im))
                torch.cuda.synchronize()
                check(counts() == expect(), f"ladder n={n}: launches {counts()}")
                check((torch.get_float32_matmul_precision(),
                       torch.backends.cuda.matmul.allow_tf32) == setting,
                      f"ladder {ladder}: the caller's matmul setting was not restored")
                row[f"{ladder}_max_rel_vs_torch_fft_c128"] = max_rel(y, want)
                row[f"{ladder}_rel_to_max"] = rel_diff(y, want)
                row[f"{ladder}_ms"] = time_ms(lambda: ctx.forward_planes_fourstep(re, im))[0]
            out[(n, b)] = row
            print(json.dumps({"phase": "ladder", "n": n, "batch": b, **row, "card": name,
                              "power_limit": limit}), flush=True)
            check(row["highest_max_rel_vs_torch_fft_c128"] <= MAX_REL["float32"],
                  f"ladder n={n}: highest {row['highest_max_rel_vs_torch_fft_c128']:.3e}")
            check(row["default_rel_to_max"] <= LADDER_DEFAULT_LIMIT,
                  f"ladder n={n}: default {row['default_rel_to_max']:.3e}")
            if shows:
                check(row["default_rel_to_max"]
                      >= LADDER_TF32_GAIN * row["highest_rel_to_max"],
                      f"ladder n={n}: default {row['default_rel_to_max']:.3e} against "
                      f"highest {row['highest_rel_to_max']:.3e}: TF32 was not turned on")
    finally:
        config.MXU_PRECISION = prev
    return out


# -- the column tile -------------------------------------------------------------

@contextlib.contextmanager
def column_tile(setting):
    """config.COLUMN_TILE set inside the block (0: the engine's T on every
    launch), restored after it."""
    prev, config.COLUMN_TILE = config.COLUMN_TILE, setting
    try:
        yield
    finally:
        config.COLUMN_TILE = prev


def at_t(fn):
    """fn() with every launch at the engine's own T (no column tile)."""
    with column_tile(0):
        return fn()


def wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def planes_rel(got, want) -> float:
    """max |got - want| / max |want| over pairs of tensors, in double."""
    return (max((wide(g) - wide(w)).abs().max().item() for g, w in zip(got, want))
            / max(wide(w).abs().max().item() for w in want))


def held_tile(what: str, kernel, plain, limit: float, checks: dict) -> float:
    """The kept tile's launch against the same launch at C = T (torch.equal)
    and against the plain version (relative to its largest output)."""
    got = kernel()
    same = all(torch.equal(a, b) for a, b in zip(got, at_t(kernel)))
    rel = planes_rel(got, plain())
    check(same, f"column tile {what}: differs from the launch at C = T")
    check(rel <= limit, f"column tile {what}: {rel:.3e} vs plain (limit {limit:.0e})")
    checks[what] = rel
    return max((wide(g) - wide(w)).abs().max().item() for g, w in zip(got, plain()))


def tile_times(fn) -> dict:
    """Device ms of fn at C = T and at the kept C."""
    return {"ms_at_T": at_t(lambda: time_ms(fn)[0]), "ms": time_ms(fn)[0]}


def phase_column_tile(dev, gen, name: str, limit: str) -> dict:
    """The column-tile instances (csrc/stockham.cu, csrc/large.cu, COLS): each
    held against the same launch at C = T with torch.equal and against its
    plain version (1e-6 f32, 1e-12 FP64, 2^-7 bf16 of the largest output),
    at full size and on an odd tail (C * 132 + 3 columns), forward and
    inverse; then timed once at C = T and at the kept C. The c2c kernel's
    four instances on time-major planes at n = 512..4096 (2^22 points);
    the strided kernel through fft2_cols on native [h, w, B] (h = 512..4096,
    w = 2, 16, 4096), fft2_k2 on native [2, 4096, 2048], the pipe2 stages on
    [n2, n1, b] blocks of [16, 2^20] and [1, 2^24], pipe2 and fft2 whole.
    Then the path run: counts set to 0, ctx.forward_planes_nb on time-major
    [n, 2^22/n] at each n and fft2 on one 4096 x 4096 image, counts read."""
    checks, out = {}, {"c2c": {}, "strided": {}}
    for tier, dtype, tdtype, lim in COL_TIERS:
        for n in COL_SIZES:
            C, threads = st.tile_shape(n, dtype.itemsize, 2 * tdtype.itemsize,
                                       batch=POINTS // n)
            T = st.engine_transforms(n)
            err = 0.0
            for batch in (POINTS // n, C * st.SMS + 3):
                re, im = (t.to(dtype) for t in (rand_real((n, batch), gen, dev),
                                                  rand_real((n, batch), gen, dev)))
                for inverse in (False, True):
                    tabs = st.device_tables(n, inverse, dev, tdtype)
                    err = max(err, held_tile(
                        f"{tier} n={n} batch={batch} inverse={inverse}",
                        lambda: st.stockham_fft_nb(re, im, inverse, tabs),
                        lambda: st.plain_fft_nb(re, im, inverse, tabs), lim, checks))
            b = POINTS // n
            re, im = (t.to(dtype) for t in (rand_real((n, b), gen, dev),
                                              rand_real((n, b), gen, dev)))
            tabs = st.device_tables(n, False, dev, tdtype)
            row = {"C": C, "threads": threads, "T": T, "max_abs_err": err,
                   **tile_times(lambda: st.stockham_fft_nb(re, im, tables=tabs))}
            if tier == "f32":
                xt = torch.complex(re, im)
                row["library_ms"] = time_ms(lambda: torch.fft.fft(xt, dim=0))[0]
                row["plain_ms"] = time_ms(lambda: st.plain_fft_nb(re, im), reps=3, warmup=1)[0]
            out["c2c"][(tier, n)] = row
            print(json.dumps({"phase": "column_tile", "kernel": f"stockham_c2c_{tier}",
                              "layout": "time-major", "n": n, "batch": b, **row,
                              "card": name, "power_limit": limit}), flush=True)

    def strided(key, shape, fn, pfn, n, split=None):
        err = 0.0
        for inverse in (False, True):
            x = rand_complex(shape, gen, dev)
            err = max(err, held_tile(f"{key} {list(shape)} inverse={inverse}",
                                     lambda: fn(x, inverse), lambda: pfn(x, inverse),
                                     KERNEL_LIMIT, checks))
        x = rand_complex(shape, gen, dev)
        row = {"n": n, "max_abs_err": err, **tile_times(lambda: fn(x, False))}
        out["strided"][(key, tuple(shape))] = row
        print(json.dumps({"phase": "column_tile", "kernel": key, "shape": list(shape), **row,
                          "card": name, "power_limit": limit}), flush=True)

    def nb(fn):
        """fn on the native [h, w, B] planes of a complex [h, w, B] tensor."""
        return lambda x, inv: fn(x.real.contiguous(), x.imag.contiguous(), inv)

    for h in COL_SIZES:
        for w in COL_FFT2_WIDTHS:
            for b in sorted({max(1, POINTS // (h * w)), max(1, 8 * st.SMS // w) + 1}):
                if h * w * b > FFT2_TIME_POINTS:
                    continue
                strided("fft2_cols", (h, w, b), nb(f2.fft2_cols), nb(f2.plain_fft2_cols), h)
    strided("fft2_k2", COL_K2_SHAPE, nb(f2.fft2_k2), nb(f2.plain_fft2_k2), COL_K2_SHAPE[1])
    for seq, n in COL_PIPE2:
        n1, n2 = lg.large_split(n)
        strided("large_stage1", (n2, n1, seq), nb(lg.stage1), nb(lg.plain_stage1), n2)
        strided("large_stage2", (n2, n1, seq), nb(lg.stage2), nb(lg.plain_stage2), n1)
    strided("pipe2", (LARGE_B, LARGE_N),
            lambda x, inv: (lg.fft_large_complex(x, inv, mode="pipe2"),),
            lambda x, inv: (lg.plain_fft_large(x, inv),), LARGE_N)
    m = FFT2_MAIN
    strided("fft2", (1, m, m), lambda x, inv: (f2._complex_route(x, inv, "fft2-2pass"),),
            lambda x, inv: (f2.plain_fft2(x, inv),), m)
    xm = rand_complex((m, m), gen, dev)
    col, _, c, _ = _passes(xm, m, m, 1)
    col()
    kept = [t.clone() for t in c]
    at_t(col)
    check(all(torch.equal(a, b) for a, b in zip(kept, c)),
          "column tile: the 4096^2 column pass differs from the launch at C = T")
    out["fft2_cols_main"] = {**tile_times(col),
                             "library_ms": time_ms(lambda: torch.fft.fft(xm, dim=-2))[0],
                             "plain_ms": time_ms(lambda: col(plain=True), reps=3, warmup=1)[0],
                             "C": st.tile_shape(m, 4, 8, batch=m)[0],
                             "threads": st.tile_shape(m, 4, 8, batch=m)[1]}
    print(json.dumps({"phase": "column_tile", "kernel": "fft2_cols", "shape": [m, m],
                      **out["fft2_cols_main"], "card": name, "power_limit": limit}),
          flush=True)

    # the path: the time-major transforms and one 4096^2 fft2, counts read after
    ctxs = {n: create_fft_f32(n, device="cuda") for n in COL_SIZES}
    xs = {n: (rand_real((n, POINTS // n), gen, dev), rand_real((n, POINTS // n), gen, dev))
          for n in COL_SIZES}
    torch.cuda.synchronize()
    zero_counts()
    ys = {n: ctxs[n].forward_planes_nb(*xs[n]) for n in COL_SIZES}
    yf = wtt.fft2(xm)
    torch.cuda.synchronize()
    got = counts()
    check(got == expect(stockham_c2c=len(COL_SIZES) + 1, fft2_cols=1, fft2_rows=1),
          f"column-tile path: launches {got}")
    for n in COL_SIZES:
        check(all(bool(torch.isfinite(t).all()) for t in ys[n]), f"column-tile path n={n}")
    check(max_rel(yf, c128_2d(xm)) <= MAX_REL["float32"], "column-tile path: fft2 4096^2")
    out["launches"] = got
    print(json.dumps({"phase": "column_tile_path", "launches": got,
                      "checks": len(checks), "worst_rel": max(checks.values())}), flush=True)
    return out


def column_tile_rows(tile: dict, name: str, limit: str) -> list:
    """The kernels line's rows for the column walk: #2 time-major at
    n = 512..4096 (f32 planes, 2^22 points) and the 2D column pass
    at one 4096^2 image, each with its kept C and its time at C = T."""
    rows = []
    for n in COL_SIZES:
        r = tile["c2c"][("f32", n)]
        b = POINTS // n
        bnd = bound(16 * n * b, 5 * n * (n.bit_length() - 1) * b)
        rows.append({"name": f"stockham_c2c_time_major_n{n}", "route": "cuda",
                     "source": "watfft_tpu_torch/ops/csrc/stockham.cu",
                     "replaces": "watfft_tpu/ops/pallas_stockham.py:355", "also_replaces": [],
                     "launches": tile["launches"]["stockham_c2c"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "ms_at_T": r["ms_at_T"],
                     "cols": r["C"], "threads": r["threads"], "plain_ms": r["plain_ms"],
                     "bound_ms": bnd[0],
                     "bound_by": bnd[1], "library_ms": r["library_ms"], "card": name,
                     "power_limit": limit})
    m = FFT2_MAIN
    r, s = tile["fft2_cols_main"], tile["strided"][("fft2", (1, m, m))]
    bnd = bound(16 * m * m, 5 * m * m * (m.bit_length() - 1))
    rows.append({"name": "fft2_cols_4096x4096", "route": "cuda", "source": LARGE_SRC,
                 "replaces": "watfft_tpu/ops/large.py:136",
                 "also_replaces": ["watfft_tpu/ops/fft2.py:191"],
                 "launches": tile["launches"]["fft2_cols"], "max_abs_err": s["max_abs_err"],
                 "ms": r["ms"], "ms_at_T": r["ms_at_T"], "cols": r["C"],
                 "threads": r["threads"], "plain_ms": r["plain_ms"], "bound_ms": bnd[0], "bound_by": bnd[1],
                 "library_ms": r["library_ms"], "card": name, "power_limit": limit})
    return rows


# -- the redesigned kernels --------------------------------------------------------

@contextlib.contextmanager
def forced_walk(walk: int, direct: int | None = None):
    """The c2c, r2c, f32 c2r and 2D cube wrappers forced to one walk at every
    n inside the block: st.WALK_ENGINE (the kernels before the redesign, no
    pairs), st.WALK_RESIDENT or st.WALK_BLOCK, with the pairs the rules
    give for that walk. A c2c launch that takes a column tile or walks down
    columns, and a bf16 one, keeps what the rule gives; the r2c has one
    redesigned walk a precision (f32 resident blocks, FP64 a block a tile),
    the f32 c2r one (resident blocks) and the 2D cube one (a block a tile),
    which each takes for either. `direct` forces where the cube's row pass
    stores (1: its last stage)."""
    c2c, r2c, c2r, cube2 = st.c2c_launch, rf.r2c_launch, rf.c2r_launch, f2.cube2_launch

    def c2c_forced(n, dtype, cols, x, y):
        got = c2c(n, dtype, cols, x, y)
        if not got or cols != (0, 0) or x[2] > x[3] or y[2] > y[3]:
            return got
        if walk == st.WALK_ENGINE:
            return walk, 0, 0
        return walk, *(int(st.complex_pairs(*s, dtype.itemsize)) for s in (x, y))

    def r2c_forced(n, x, y, size=4):
        return (walk, 0, 0) if walk == st.WALK_ENGINE else r2c(1 << 13, x, y, size)

    def c2r_forced(n, x, y):
        if walk == st.WALK_ENGINE:
            return walk, 0, 0
        return st.WALK_RESIDENT, *rf.c2r_pairs(x, y)

    def cube2_forced(h, w, x, y, radix=None):
        if walk == st.WALK_ENGINE:
            return walk, 0, 0, 0
        got = f2.cube2_block(h, w, x, y, radix)
        return (*got[:3], got[3] if direct is None else direct)
    st.c2c_launch, rf.r2c_launch = c2c_forced, r2c_forced
    rf.c2r_launch, f2.cube2_launch = c2r_forced, cube2_forced
    try:
        yield
    finally:
        st.c2c_launch, rf.r2c_launch, rf.c2r_launch, f2.cube2_launch = c2c, r2c, c2r, cube2


def phase_resident(dev, gen, name: str, limit: str) -> dict:
    """The redesigned kernels (csrc/large.cu cube_kernel, #12; csrc/rfft.cu
    rfft_r2c_resident_kernel, #9) at their main shapes. The cube on
    [2048, 8192] and [256, 16384] complex64, both directions: torch.equal
    to pipe2's kernels (the same operations in two passes) and within
    KERNEL_LIMIT of the plain version; timed beside pipe2. The r2c at every
    n = 4..8192 (2^22 real points and batch 3; complex and batch-major
    layouts): the resident kernel torch.equal to the engine's walk (the
    kernel before the redesign) and within KERNEL_LIMIT of the plain
    version; timed in both walks."""
    out = {"cube": {}, "r2c": {}}
    for b, n in CUBE_SHAPES:
        x = rand_complex((b, n), gen, dev)
        row = {"threads": lg.cube_threads(n), "max_rel_diff": 0.0}
        for inverse in (False, True):
            got = lg.fft_large_complex(x, inverse, mode="cube")
            check(torch.equal(got, lg.fft_large_complex(x, inverse, mode="pipe2")),
                  f"cube [{b}, {n}] inverse={inverse}: differs from pipe2")
            rel = rel_diff(got, lg.plain_fft_large(x, inverse))
            check(rel <= KERNEL_LIMIT, f"cube [{b}, {n}] inverse={inverse}: {rel:.3e} vs plain")
            row["max_rel_diff"] = max(row["max_rel_diff"], rel)
        row["ms"] = time_ms(lambda: lg.fft_large_complex(x, mode="cube"))[0]
        row["pipe2_ms"] = time_ms(lambda: lg.fft_large_complex(x, mode="pipe2"))[0]
        out["cube"][(b, n)] = row
        print(json.dumps({"phase": "resident", "kernel": "cube", "shape": [b, n], **row,
                          "card": name, "power_limit": limit}), flush=True)
    for n in REAL_SIZES:
        row = {"max_rel_diff": 0.0}
        for batch in (3, POINTS // n):
            x = rand_real((batch, n), gen, dev)
            want = rf.plain_rfft(x)
            for layout, fn in (("complex", lambda: (rf.rfft(x),)), ("bm", lambda: rf.rfft_bm(x))):
                with forced_walk(rf.WALK_RESIDENT):
                    got = fn()
                with forced_walk(rf.WALK_ENGINE):
                    engine = fn()
                check(all(torch.equal(a, c) for a, c in zip(got, engine)),
                      f"r2c n={n} batch={batch} {layout}: resident differs from the engine walk")
                y = got[0] if len(got) == 1 else torch.complex(*got)
                rel = rel_diff(y, want)
                check(rel <= KERNEL_LIMIT, f"r2c n={n} batch={batch} {layout}: {rel:.3e}")
                row["max_rel_diff"] = max(row["max_rel_diff"], rel)
        row["walk"] = "engine" if n <= rf.R2C_ENGINE_MAX_N else "resident"
        for walk, key in ((rf.WALK_RESIDENT, "resident_ms"), (rf.WALK_ENGINE, "engine_ms")):
            with forced_walk(walk):
                row[key] = time_ms(lambda: rf.rfft(x))[0]
        out["r2c"][n] = row
        print(json.dumps({"phase": "resident", "kernel": "rfft_r2c", "n": n,
                          "batch": POINTS // n, **row, "card": name, "power_limit": limit}),
              flush=True)
    return out


def resident_rows(rows: list, resident: dict) -> None:
    """The kernels line's #12 and #9 rows are the redesigned kernels: each
    gains what phase_resident held it to and its time in the other walk
    (the cube's in pipe2; the r2c's in the engine's walk, the kernel
    before the redesign)."""
    by_name = {r["name"]: r for r in rows}
    cube = resident["cube"][(CUBE_B, CUBE_N)]
    by_name["large_cube"].update(
        threads=cube["threads"], equal_to_old_walk=True, old_walk="pipe2",
        old_walk_ms=cube["pipe2_ms"])
    r2c = resident["r2c"][MAIN_N]
    by_name["rfft_r2c_fused"].update(
        walk=r2c["walk"], equal_to_old_walk=True, old_walk="engine",
        old_walk_ms=r2c["engine_ms"])


def walk_layouts(x: torch.Tensor, inverse: bool) -> dict:
    """The c2c wrapper's batch-major layouts on the complex [batch, n] x,
    each a function returning its output tensors: interleaved complex (one
    copy and one store a point), split planes, views one scalar off
    alignment on the input (pairs refused there) and the real core's views,
    the even and odd rows of a contiguous signal (pairs on the input).
    Every layout holds x's values, so each computes DFT(x)."""
    batch, n = x.shape
    real = x.real.dtype
    re, im = x.real.contiguous(), x.imag.contiguous()
    tabs = st.device_tables(n, inverse, x.device, real)
    flat = torch.empty(2 * batch * n + 1, dtype=real, device=x.device)
    flat[1:].view(batch, n, 2).copy_(torch.view_as_real(x))
    xv = torch.view_as_real(x).reshape(batch, 2 * n).T       # [2n, batch]

    def misaligned():
        out = torch.empty(batch, n, 2, dtype=real, device=x.device)
        views = [torch.as_strided(flat, (n, batch), (2, 2 * n), 1 + k) for k in (0, 1)]
        st.fft_views(*views, out[..., 0].T, out[..., 1].T, inverse, tabs)
        return (torch.view_as_complex(out),)

    def real_core():
        zre, zim = (torch.empty(batch, n, dtype=real, device=x.device) for _ in range(2))
        st.fft_views(xv[0::2], xv[1::2], zre.T, zim.T, inverse, tabs)
        return zre, zim
    return {"complex": lambda: (st.stockham_fft(x, inverse),),
            "bm": lambda: st.stockham_fft_bm(re, im, inverse),
            "misaligned": misaligned, "real_core": real_core}


def as_complex(out) -> torch.Tensor:
    return out[0] if len(out) == 1 else torch.complex(*out)


def held_walks(what: str, fn, want, limit: float, walks=WALKS) -> float:
    """fn's outputs in every walk of `walks`: the redesigned walks
    torch.equal to the engine's, and within `limit` of `want` relative to
    its largest value."""
    outs = {}
    for key, walk in walks:
        with forced_walk(walk):
            outs[key] = fn()
    for key in list(outs)[1:]:
        check(all(torch.equal(a, b) for a, b in zip(outs[key], outs["engine"])),
              f"{what}: the {key} walk differs from the engine's")
    rel = rel_diff(as_complex(outs["resident"]), want)
    check(rel <= limit, f"{what}: {rel:.3e} vs plain")
    return rel


def walk_times(fn, walks=WALKS, rounds: int = 1) -> dict:
    """fn's device ms in each walk of `walks`, in turns (engine, resident,
    block, then the same in reverse, `rounds` times), each the median of
    its turns."""
    ms = {key: [] for key, _ in walks}
    for key, walk in (walks + walks[::-1]) * rounds:
        with forced_walk(walk):
            ms[key].append(time_ms(fn)[0])
    return {key: statistics.median(v) for key, v in ms.items()}


def phase_c2c_walk(dev, gen, name: str, limit: str) -> dict:
    """The redesigned batch-major walk of the c2c kernel (csrc/stockham.cu
    stockham_c2c_resident_kernel) and of the FP64 r2c kernel
    (csrc/rfft.cu rfft_r2c_block_f64_kernel), each forced in every walk
    (`forced_walk`): the engine's, the resident blocks and a block a tile.
    The c2c at every n = 2..4096 in f32 and FP64, both directions, in the
    four layouts of `walk_layouts`, at batch 1, a tail under one tile, more
    tiles than the resident grid by a tail, and 2^22 points; the rows pass
    of one 4096^2 image (#16); the FP64 r2c at every n = 4..8192 in four
    layouts (rows one float64 off alignment among them) at the same kinds of
    batch. The redesigned walks torch.equal to the engine's, within 1e-6
    (f32) / 1e-12 (FP64) of the plain version; each timed in the three walks
    at 2^22 points (complex and batch-major, both directions); the real
    core at n = 1024 batch-major (this walk) and time-major (the column
    tile); and the end-to-end calls `create_fft_f32(1024)`,
    `create_fft(1024)` on [4096, 1024] and fft2 on one 4096^2 image."""
    out = {"c2c": {}, "r2c_f64": {}}
    for tier, cdtype, lim in WALK_TIERS:
        for n in SIZES:
            T = st.engine_transforms(n, max(r for r, _ in st.stage_plan(n)))
            row = {"max_rel_diff": 0.0}
            for batch in (1, T // 2 + 1, 2 * st.SMS * T + T // 2 + 1, POINTS // n):
                x = rand_complex((batch, n), gen, dev).to(cdtype)
                for inverse in (False, True):
                    want = st.plain_fft(x, inverse)
                    for layout, fn in walk_layouts(x, inverse).items():
                        rel = held_walks(f"c2c {tier} n={n} batch={batch} {layout} "
                                         f"inverse={inverse}", fn, want, lim)
                        row["max_rel_diff"] = max(row["max_rel_diff"], rel)
            for inverse in (False, True):
                fns = walk_layouts(x, inverse)
                for layout in ("complex", "bm"):
                    for key, ms in walk_times(fns[layout]).items():
                        row[f"{layout}_{'inv' if inverse else 'fwd'}_{key}_ms"] = ms
            p, size = x.data_ptr(), x.element_size() // 2
            side = (p, p + size, 2, 2 * n)
            row["walk"] = st.c2c_launch(n, x.real.dtype, (0, 0), side, side)[0]
            out["c2c"][(tier, n)] = row
            print(json.dumps({"phase": "c2c_walk", "tier": tier, "n": n, "batch": POINTS // n,
                              **row, "card": name, "power_limit": limit}), flush=True)
    m = FFT2_MAIN
    xm = rand_complex((m, m), gen, dev)
    row = {"max_rel_diff": 0.0}
    for inverse in (False, True):
        col, rows, _, img = _passes(xm, m, m, 1, inverse)
        col()
        rows(plain=True)
        want = img.clone()

        def kernel():
            rows()
            return (img.clone(),)
        rel = held_walks(f"fft2 rows {m}^2 inverse={inverse}", kernel, want, KERNEL_LIMIT)
        row["max_rel_diff"] = max(row["max_rel_diff"], rel)
    rows = _passes(xm, m, m, 1)[1]
    row.update({f"{k}_ms": v for k, v in walk_times(rows).items()})
    out["rows"] = row
    print(json.dumps({"phase": "c2c_walk", "case": "fft2_rows", "shape": [m, m], **row,
                      "card": name, "power_limit": limit}), flush=True)
    for n in REAL_SIZES:
        m_ = n // 2
        T = st.engine_transforms(m_, max(r for r, _ in st.stage_plan(m_)))
        row = {"max_rel_diff": 0.0}
        for batch in (1, 3, 2 * st.SMS * T + T // 2 + 1, POINTS // n):
            flat = rand_f64((batch * n + 1,), gen, dev)
            x, xm_ = flat[:-1].view(batch, n), flat[1:].view(batch, n)
            xt = x.T.contiguous()
            for layout, fn, src in (
                    ("complex", lambda: (rf.rfft(x),), x), ("bm", lambda: rf.rfft_bm(x), x),
                    ("nb", lambda: tuple(t.T for t in rf.rfft_nb_fused(xt)), x),
                    ("misaligned", lambda: (rf.rfft(xm_),), xm_)):
                rel = held_walks(f"r2c f64 n={n} batch={batch} {layout}", fn,
                                 rf.plain_rfft(src), F64_KERNEL_LIMIT)
                row["max_rel_diff"] = max(row["max_rel_diff"], rel)
        row.update({f"{k}_ms": v for k, v in walk_times(lambda: rf.rfft(x)).items()})
        row["walk"] = rf.r2c_launch(n, (x.data_ptr(), 1, n), (0, 8, 2, n + 2), 8)[0]
        out["r2c_f64"][n] = row
        print(json.dumps({"phase": "c2c_walk", "case": "r2c_f64", "n": n, "batch": POINTS // n,
                          **row, "card": name, "power_limit": limit}), flush=True)
    # the real core (#5 / #6) alone, batch-major (this walk) and time-major
    # (the column tile), the hybrid route around it, and end-to-end calls
    n, b, m = MAIN_N, MAIN_B, MAIN_N // 2
    xr = rand_real((b, n), gen, dev)
    spec = rf.rfft(xr)
    sre, sim = spec.real.contiguous(), spec.imag.contiguous()
    xt, tre, tim = xr.T.contiguous(), sre.T.contiguous(), sim.T.contiguous()
    c, ci = rf.device_rtables(n, False, dev).core, rf.device_rtables(n, True, dev).core
    xv = xr.T
    zre, zim = (torch.empty(b, m, device=dev).T for _ in range(2))
    tzre, tzim = (torch.empty(m, b, device=dev) for _ in range(2))
    zv = torch.view_as_real(rand_complex((b, m), gen, dev))
    sig, sig_t = torch.empty(b, n, device=dev), torch.empty(n, b, device=dev)
    x32, x64 = rand_complex((b, n), gen, dev), rand_c128((b, n), gen, dev)
    ctx32, ctx64 = create_fft_f32(n, device=dev), create_fft(n, device=dev)
    xi = rand_complex((FFT2_MAIN, FFT2_MAIN), gen, dev)
    for key, fn in (("core_fwd_bm", lambda: st.fft_views(xv[0::2], xv[1::2], zre, zim, False, c)),
                    ("core_inv_bm", lambda: st.fft_views(zv[..., 0].T, zv[..., 1].T,
                                                         sig.T[0::2], sig.T[1::2], True, ci)),
                    ("core_fwd_nb", lambda: st.fft_views(xt[0::2], xt[1::2], tzre, tzim, False,
                                                         c)),
                    ("core_inv_nb", lambda: st.fft_views(tzre, tzim, sig_t[0::2], sig_t[1::2],
                                                         True, ci)),
                    ("hybrid_fwd_bm", lambda: rf.rfft_bm(xr, fused=False)),
                    ("hybrid_inv_bm", lambda: rf.irfft_bm(sre, sim, fused=False)),
                    ("hybrid_fwd_nb", lambda: rf.rfft_nb(xt)),
                    ("hybrid_inv_nb", lambda: rf.irfft_nb(tre, tim)),
                    ("create_fft_f32_fwd", lambda: ctx32.forward(x32)),
                    ("create_fft_f32_inv", lambda: ctx32.inverse(x32)),
                    ("create_fft_fwd", lambda: ctx64.forward(x64)),
                    ("fft2_4096", lambda: wtt.fft2(xi))):
        out[key] = walk_times(fn)
        print(json.dumps({"phase": "c2c_walk", "case": key, **out[key], "card": name,
                          "power_limit": limit}), flush=True)
    return out


def walk_rows(rows: list, walk: dict) -> None:
    """The kernels line's rows on the redesigned walk (#1/#4, the real core
    #5/#6, #16, #19 and the FP64 r2c) gain the walk the rule takes at their
    shape and their time in the engine's walk (the kernel before the
    redesign), from phase_c2c_walk."""
    by_name = {r["name"]: r for r in rows}
    names = {st.WALK_ENGINE: "engine", st.WALK_RESIDENT: "resident", st.WALK_BLOCK: "block"}
    for key, tier in (("stockham_c2c", "f32"), ("stockham_c2c_f64", "f64")):
        row = walk["c2c"][(tier, MAIN_N)]
        by_name[key].update(walk=names[row["walk"]], old_walk="engine",
                            old_walk_ms=row["complex_fwd_engine_ms"])
    by_name["fft2_rows"].update(walk=names[walk["c2c"][("f32", FFT2_MAIN)]["walk"]],
                                old_walk="engine", old_walk_ms=walk["rows"]["engine_ms"])
    by_name["rfft_r2c_fused_f64"].update(walk=names[walk["r2c_f64"][MAIN_N]["walk"]],
                                         old_walk="engine",
                                         old_walk_ms=walk["r2c_f64"][MAIN_N]["engine_ms"])
    for key, case in (("stockham_c2c_real_core_fwd", "core_fwd_bm"),
                      ("stockham_c2c_real_core_inv", "core_inv_bm")):
        by_name[key].update(walk=names[st.c2c_walk(MAIN_N // 2, torch.float32)],
                            old_walk="engine", old_walk_ms=walk[case]["engine"])


def c2r_layouts(spec: torch.Tensor) -> dict:
    """The c2r wrapper's layouts of the complex [batch, m+1] spectrum, each
    a function returning its [batch, n] signal as a 1-tuple: interleaved
    complex (one copy and one store a point), split planes, time-major
    planes, and, through `_launch_c2r`, the interleaved spectrum one scalar
    off its point's alignment into signal rows one scalar off theirs (pairs
    refused on both sides)."""
    batch, m1 = spec.shape
    n, real, dev = 2 * (m1 - 1), spec.real.dtype, spec.device
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    tre, tim = re.T.contiguous(), im.T.contiguous()
    flat = torch.zeros(2 * batch * m1 + 1, dtype=real, device=dev)
    flat[1:].view(batch, m1, 2).copy_(torch.view_as_real(spec))
    rt = rf.device_rtables(n, True, dev, real)

    def misaligned():
        out = torch.zeros(batch * n + 1, dtype=real, device=dev)
        p, size = flat.data_ptr() + real.itemsize, real.itemsize
        rf._launch_c2r(flat, p, p + size, 2, 2 * m1, out[1:], 1, n, n, batch, rt)
        return (out[1:].view(batch, n),)
    return {"complex": lambda: (rf.irfft(spec),), "bm": lambda: (rf.irfft_bm(re, im),),
            "nb": lambda: (rf.irfft_nb_fused(tre, tim).T,), "misaligned": misaligned}


def cube2_layouts(x: torch.Tensor, inverse: bool) -> dict:
    """The 2D cube's layouts of the complex [batch, h, w] x on its own
    route, each a pair (call, image): call() returns the route's own
    outputs as a tuple (what is timed and compared bit for bit), image(out)
    the complex [batch, h, w] they hold. Interleaved complex64, batch-major
    planes, native [h, w, B] planes, and the packed real layout (rfft2's
    input read as complex, irfft2's output written as real)."""
    re, im = x.real.contiguous(), x.imag.contiguous()
    nre, nim = re.permute(1, 2, 0).contiguous(), im.permute(1, 2, 0).contiguous()
    packed = torch.view_as_real(x).reshape(*x.shape[:-1], 2 * x.shape[-1])
    if inverse:
        real = (lambda: (f2._transform(re, im, True, "bm", "real", "fft2-cube", None),),
                lambda out: torch.view_as_complex(out[0].view(*x.shape, 2)))
    else:
        real = (lambda: f2._transform(packed, None, False, "real", "bm", "fft2-cube", None),
                lambda out: torch.complex(*out))
    return {"complex": (lambda: (f2._complex_route(x, inverse, "fft2-cube"),),
                        lambda out: out[0]),
            "bm": (lambda: f2._planes_route(re, im, inverse, "fft2-cube"),
                   lambda out: torch.complex(*out)),
            "nb": (lambda: f2._nb_route(nre, nim, inverse, "fft2-cube"),
                   lambda out: torch.complex(*out).permute(2, 0, 1)),
            "real": real}


CUBE2_CASES = (("engine", st.WALK_ENGINE, None), ("back", st.WALK_BLOCK, 0),
               ("direct", st.WALK_BLOCK, 1))


def held_cube2(what: str, fn, image, want) -> float:
    """fn's outputs in the engine's walk and in a block a tile storing after
    the row pass and from its last stage: both torch.equal to the engine's,
    whose image is within KERNEL_LIMIT of `want`."""
    outs = {}
    for key, walk, direct in CUBE2_CASES:
        with forced_walk(walk, direct):
            outs[key] = fn()
    for key in ("back", "direct"):
        check(all(torch.equal(a, b) for a, b in zip(outs[key], outs["engine"])),
              f"{what}: the redesigned walk ({key}) differs from the engine's")
    rel = rel_diff(image(outs["engine"]), want)
    check(rel <= KERNEL_LIMIT, f"{what}: {rel:.3e} vs plain")
    return rel


def cube2_times(fn) -> dict:
    """fn's device ms in the engine's walk and in a block a tile with each
    store (`CUBE2_CASES`), in turns (then the same in reverse), each the
    mean of its two turns."""
    cases = CUBE2_CASES
    ms = {key: [] for key, _, _ in cases}
    for key, walk, direct in cases + cases[::-1]:
        with forced_walk(walk, direct):
            ms[key].append(time_ms(fn)[0])
    return {key: sum(v) / 2 for key, v in ms.items()}


C2R_WALKS = WALKS[:2]       # the f32 c2r's walks: the engine's and resident blocks


def phase_c2r_cube2(dev, gen, name: str, limit: str) -> dict:
    """The redesigned f32 c2r (csrc/rfft.cu irfft_c2r_resident_kernel) and
    2D cube (csrc/fft2.cu fft2_cube_block_kernel), each forced in every
    walk (`forced_walk`): the engine's (the kernels before the redesign),
    and the c2r's resident blocks, the cube's block a tile with its row
    pass storing after the pass and from its last stage. The c2r at every
    n = 4..8192, four layouts (`c2r_layouts`), batch 1, 3, past the
    resident grid by a tail and 2^22 real points; the cube at every
    h*w <= 2^14 in four layouts (`cube2_layouts`) at batch 1, 5 and past
    the SMs by a tail, both directions: every redesigned walk torch.equal
    to the engine's, within 1e-6 of the plain version. Times in each walk,
    in turns: the c2r at every n (2^22 points, complex layout), the cube at
    the squares 16..128 (2^24 points; complex, batch-major and native
    planes), rfft2 / irfft2 there, and the end-to-end
    `create_rfft_f32(1024).inverse` on [4096, 1024], the STFT's inverse
    (phase 9's size) and its frames' transform alone (`inverse_planes`;
    each the median of five rounds of turns) and fft2 on
    [1024, 128, 128]; `create_rfft(1024)`'s inverse (the FP64 c2r, the
    engine's walk); and `torch.fft.fft` / `ifft` along dim 0 of the
    time-major real core's complex [512, 4096] (the library calls beside #7
    and #8)."""
    out = {"c2r": {}, "cube2": {}}
    for n in REAL_SIZES:
        m1 = n // 2 + 1
        T = st.engine_transforms(n // 2, max(r for r, _ in st.stage_plan(n // 2)))
        row = {"max_rel_diff": 0.0}
        for batch in (1, 3, 2 * st.SMS * T + T // 2 + 1, POINTS // n):
            spec = torch.complex(rand_real((batch, m1), gen, dev),
                                 rand_real((batch, m1), gen, dev))
            want = rf.plain_irfft(spec)
            for layout, fn in c2r_layouts(spec).items():
                rel = held_walks(f"c2r n={n} batch={batch} {layout}", fn, want, KERNEL_LIMIT,
                                 C2R_WALKS)
                row["max_rel_diff"] = max(row["max_rel_diff"], rel)
        row.update({f"{k}_ms": v
                    for k, v in walk_times(c2r_layouts(spec)["complex"], C2R_WALKS).items()})
        row["walk"] = rf.c2r_launch(n, (0, 4, 2, 2 * m1), (0, 1, n))[0]
        out["c2r"][n] = row
        print(json.dumps({"phase": "c2r_cube2", "kernel": "irfft_c2r_f32", "n": n,
                          "batch": POINTS // n, **row, "card": name, "power_limit": limit}),
              flush=True)
    for h, w in FFT2_PAIRS:
        row = {"max_rel_diff": 0.0}
        for batch in (1, 5, 2 * st.SMS + 5 if h * w >= 1024 else 300):
            x = rand_complex((batch, h, w), gen, dev)
            for inverse in (False, True):
                want = f2.plain_fft2(x, inverse)
                for layout, (fn, image) in cube2_layouts(x, inverse).items():
                    rel = held_cube2(f"cube {h}x{w} batch={batch} {layout} inverse={inverse}",
                                     fn, image, want)
                    row["max_rel_diff"] = max(row["max_rel_diff"], rel)
        out["cube2"][(h, w)] = row
    worst = max(r["max_rel_diff"] for r in out["cube2"].values())
    print(json.dumps({"phase": "c2r_cube2", "kernel": "fft2_cube", "pairs": len(FFT2_PAIRS),
                      "max_rel_diff": worst}), flush=True)
    for k in range(4, 8):
        h = w = 1 << k
        b = FFT2_TIME_POINTS // (h * w)
        x = rand_complex((b, h, w), gen, dev)
        fns = cube2_layouts(x, False)
        xr = rand_real((b, h, 2 * w), gen, dev)
        spec = wtt.rfft2(xr)
        row = {"launch": list(f2.cube2_launch(h, w, (0, 4, 2 * w, 2, 2 * h * w),
                                              (0, 4, 2 * w, 2, 2 * h * w)))}
        for key, fn in (("complex", fns["complex"][0]), ("bm", fns["bm"][0]),
                        ("nb", fns["nb"][0]), ("rfft2", lambda: wtt.rfft2(xr)),
                        ("irfft2", lambda: wtt.irfft2(spec))):
            row[key] = cube2_times(fn)
        row["lib_fft2_ms"] = time_ms(lambda: torch.fft.fft2(x))[0]
        row["lib_rfft2_ms"] = time_ms(lambda: torch.fft.rfft2(xr))[0]
        out["cube2"][(h, w)].update(row)
        print(json.dumps({"phase": "c2r_cube2", "kernel": "fft2_cube", "shape": [b, h, w],
                          **out["cube2"][(h, w)], "card": name, "power_limit": limit}),
              flush=True)
    # end-to-end calls in each walk
    n, b = MAIN_N, MAIN_B
    spec32 = torch.fft.rfft(rand_real((b, n), gen, dev))
    spec64 = torch.fft.rfft(rand_f64((b, n), gen, dev))
    ctx32, ctx64 = create_rfft_f32(n, device=dev), create_rfft(n, device=dev)
    sig = rand_real(((MAIN_B - 1) * STFT_HOP + n,), gen, dev)
    sre, sim = wstft.stft(sig, n_fft=n, hop=STFT_HOP)
    xc = rand_complex(FFT2_CUBE_SHAPE, gen, dev)
    out["irfft_f32"] = walk_times(lambda: ctx32.inverse(spec32), C2R_WALKS)
    out["istft"] = walk_times(lambda: wstft.istft(sre, sim, n_fft=n, hop=STFT_HOP), C2R_WALKS,
                              rounds=5)
    # the STFT inverse's own transform (its frames' batch-major planes), the
    # rest of it being torch's overlap-add
    out["istft_frames"] = walk_times(lambda: ctx32.inverse_planes(sre, sim), C2R_WALKS,
                                     rounds=5)
    out["irfft_f64"] = {"engine": time_ms(lambda: ctx64.inverse(spec64))[0]}
    out["fft2_cube_shape"] = cube2_times(lambda: wtt.fft2(xc))
    for key in ("irfft_f32", "istft", "istft_frames", "irfft_f64", "fft2_cube_shape"):
        print(json.dumps({"phase": "c2r_cube2", "case": key, **out[key], "card": name,
                          "power_limit": limit}), flush=True)
    # the library calls beside the time-major real core (#7, #8): fft / ifft
    # along dim 0 of the complex [m, B] the core transforms, z[j] = x[2j] +
    # i x[2j+1] of the time-major [n, B] signal
    xt = rand_real((n, b), gen, dev)
    z = torch.complex(xt[0::2], xt[1::2])
    out["lib_core_nb"] = {"fwd_ms": time_ms(lambda: torch.fft.fft(z, dim=0))[0],
                          "inv_ms": time_ms(lambda: torch.fft.ifft(z, dim=0))[0]}
    print(json.dumps({"phase": "c2r_cube2", "case": "lib_core_nb", "shape": [n // 2, b],
                      **out["lib_core_nb"], "card": name, "power_limit": limit}), flush=True)
    return out


def c2r_cube2_rows(rows: list, res: dict) -> None:
    """The kernels line's f32 c2r and 2D cube rows are the redesigned
    kernels: each gains the walk the rule takes at its main shape, what
    phase_c2r_cube2 held it to and its time in the engine's walk (the
    kernel before the redesign). The FP64 c2r runs the engine's walk, its
    redesign not kept: its row says so, with the time of the walk it
    runs."""
    by_name = {r["name"]: r for r in rows}
    names = {st.WALK_ENGINE: "engine", st.WALK_RESIDENT: "resident", st.WALK_BLOCK: "block"}
    row = res["c2r"][MAIN_N]
    by_name["irfft_c2r_fused"].update(
        walk=names[row["walk"]], equal_to_old_walk=True, old_walk="engine",
        old_walk_ms=row["engine_ms"], walk_ms={k: row[f"{k}_ms"] for k, _ in C2R_WALKS})
    by_name["irfft_c2r_fused_f64"].update(walk="engine", redesign="not kept (PERF.md)",
                                          old_walk="engine",
                                          old_walk_ms=res["irfft_f64"]["engine"])
    b, h, w = FFT2_CUBE_SHAPE
    launch = res["cube2"][(h, w)]["launch"]
    by_name["fft2_cube"].update(walk=names[launch[0]], equal_to_old_walk=True,
                                old_walk="engine",
                                old_walk_ms=res["fft2_cube_shape"]["engine"])


# -- the sharded faces (watfft_tpu_torch/parallel) ---------------------------------

SHARDED_SEED = 15
SHARDED_RANKS = 4
SHARDED_RANKS_TIMEOUT = 300.0
FFT2_BATCH_AXIS_SHAPE = (4, 1024, 1024)
SHARDED_LARGE_N, SHARDED_REAL_N = 1 << 24, 1 << 25


@contextlib.contextmanager
def no_library_fft():
    """torch.fft's functions raise while the block runs: no library call
    hides in a sharded face."""
    saved = {k: v for k, v in vars(torch.fft).items()
             if callable(v) and not isinstance(v, type) and not k.startswith("_")}

    def refuse(*args, **kwargs):
        raise Failed("a torch.fft call inside a sharded face")

    for k in saved:
        setattr(torch.fft, k, refuse)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.fft, k, v)


def _planes(z: torch.Tensor):
    return z.real.contiguous(), z.imag.contiguous()


def _sharded_face(face: str, shape, run, launched: dict, single, oracle, limit_oracle: float,
                  roundtrip=None) -> tuple[dict, object]:
    """One face at world 1: its launch counts (torch.fft refused), its output
    against the port's single-device function (KERNEL_LIMIT of the largest
    output) and the f64 oracle (max_rel), a round trip's largest error, and
    the times of the face and of the single-device function (CUDA events,
    median)."""
    torch.cuda.synchronize()
    zero_counts()
    with no_library_fft():
        out = run()
        torch.cuda.synchronize()
    launches = counts()
    want_counts = expect(**launched)
    check(launches == want_counts, f"sharded {face}: launches {launches}, expected {want_counts}")
    got, ref = (torch.complex(*o) if isinstance(o, tuple) else o for o in (out, single()))
    got, ref = got.reshape(-1), ref.reshape(-1)
    err = rel_diff(got, ref)
    check(err <= KERNEL_LIMIT, f"sharded {face}: {err:.3e} of the single-device function")
    rec = {"face": face, "shape": list(shape),
           "launches": {k: v for k, v in launches.items() if v},
           "max_rel_vs_single": err,
           "max_rel_vs_torch_fft_f64": max_rel(got, oracle().reshape(-1))}
    check(rec["max_rel_vs_torch_fft_f64"] <= limit_oracle,
          f"sharded {face}: max rel {rec['max_rel_vs_torch_fft_f64']:.3e} vs torch.fft")
    if roundtrip is not None:
        rec["roundtrip_err"] = roundtrip(out)
        check(rec["roundtrip_err"] < ROUNDTRIP["float32"],
              f"sharded {face}: roundtrip {rec['roundtrip_err']:.3e}")
    with no_library_fft():
        rec["ms"] = time_ms(run)[0]
    rec["single_ms"] = time_ms(single)[0]
    return rec, out


def phase_sharded_one(dev, gen, name: str, limit: str) -> dict:
    """Every sharded face at its BASELINE shape on a world-1 NCCL group (an
    in-memory store): held against the single-device function, torch.fft
    in float64 and the launch counts, timed beside the single-device
    function; the exchange's pack, all-to-all and unpack timed apart; the
    faces of `dryrun` at the mid sizes of `sharded_ranks`, world 1, for
    that phase to hold its ranks against."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from watfft_tpu_torch.parallel import dryrun
    from watfft_tpu_torch.parallel import large_sharded as pls
    from watfft_tpu_torch.parallel import real_sharded as prs
    from watfft_tpu_torch.parallel import sharded as psh

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = psh.make_mesh(1)
        mesh2 = init_device_mesh("cuda", (1, 1), mesh_dim_names=("b", "t"))
        group = mesh.get_group("x")
        f32 = MAX_REL["float32"]
        faces = []

        x = rand_complex((MAIN_B, MAIN_N), gen, dev)
        xre, xim = _planes(x)
        faces.append(_sharded_face(
            "fft_batch", x.shape, lambda: psh.fft_batch_sharded(xre, xim, mesh),
            {"stockham_c2c": 1}, lambda: wtt.fft(x), lambda: c128(x), f32)[0])
        xr = rand_real((MAIN_B, MAIN_N), gen, dev)
        rec, spec = _sharded_face(
            "rfft_batch", xr.shape, lambda: psh.rfft_batch_sharded(xr, mesh),
            {"rfft_r2c_fused": 1}, lambda: wtt.rfft(xr), lambda: torch.fft.rfft(xr.double()), f32)
        faces.append(rec)
        sc = torch.complex(*spec)
        faces.append(_sharded_face(
            "irfft_batch", sc.shape, lambda: psh.irfft_batch_sharded(*spec, mesh),
            {"irfft_c2r_fused": 1}, lambda: wtt.irfft(sc),
            lambda: torch.fft.irfft(sc.to(torch.complex128)), f32,
            lambda y: (y - xr).abs().max().item())[0])

        img = rand_complex((FFT2_MAIN, FFT2_MAIN), gen, dev)
        ire, iim = _planes(img)
        rec, fwd = _sharded_face(
            "fft2", img.shape, lambda: psh.fft2_sharded(ire, iim, mesh),
            {"stockham_c2c": 1, "fft2_cols": 1}, lambda: wtt.fft2(img), lambda: c128_2d(img),
            f32, lambda o: (torch.complex(*psh.fft2_sharded(*o, mesh, inverse=True)) - img)
            .abs().max().item())
        faces.append(rec)
        imr = rand_real((FFT2_MAIN, FFT2_MAIN), gen, dev)
        rec, rspec = _sharded_face(
            "rfft2", imr.shape, lambda: prs.rfft2_sharded(imr, mesh),
            {"rfft_r2c_fused": 1, "fft2_cols": 2}, lambda: wtt.rfft2(imr),
            lambda: torch.fft.rfft2(imr.double()), f32)
        faces.append(rec)
        rsc = torch.complex(*rspec)
        faces.append(_sharded_face(
            "irfft2", rsc.shape, lambda: prs.irfft2_sharded(*rspec, mesh),
            {"fft2_cols": 2, "irfft_c2r_fused": 1}, lambda: wtt.irfft2(rsc),
            lambda: torch.fft.irfft2(rsc.to(torch.complex128)), f32,
            lambda y: (y - imr).abs().max().item())[0])
        xb = rand_complex(FFT2_BATCH_AXIS_SHAPE, gen, dev)
        bre, bim = _planes(xb)
        faces.append(_sharded_face(
            "fft2_batch_axis", xb.shape,
            lambda: psh.fft2_sharded(bre, bim, mesh2, axis="t", batch_axis="b"),
            {"stockham_c2c": 1, "fft2_cols": 1}, lambda: wtt.fft2(xb), lambda: c128_2d(xb),
            f32)[0])

        n1, n2 = lg.large_split(SHARDED_LARGE_N)
        xl = rand_complex((SHARDED_LARGE_N,), gen, dev)
        lre, lim = (t.view(n2, n1) for t in _planes(xl))
        faces.append(_sharded_face(
            "fft_large", xl.shape, lambda: pls.fft_large_sharded(lre, lim, mesh),
            {"large_postmul": 1, "large_outer": 1}, lambda: lg.fft_large(*_planes(xl)),
            lambda: c128(xl), f32,
            lambda o: (torch.complex(*pls.fft_large_sharded(*o, mesh, inverse=True)).reshape(-1)
                       - xl).abs().max().item())[0])
        m1, m2 = lg.large_split(SHARDED_REAL_N // 2)
        xrl = rand_real((SHARDED_REAL_N,), gen, dev)
        rec, lspec = _sharded_face(
            "rfft_large", xrl.shape, lambda: prs.rfft_large_sharded(xrl.view(m2, 2 * m1), mesh),
            {"large_postmul": 1, "large_outer": 1},
            lambda: wtt.rfft_large_nb(xrl[:, None]),
            lambda: torch.fft.rfft(xrl.double()), f32)
        faces.append(rec)
        faces.append(_sharded_face(
            "irfft_large", (SHARDED_REAL_N // 2 + 1,),
            lambda: prs.irfft_large_sharded(*lspec, mesh),
            {"large_postmul": 1, "large_outer": 1},
            lambda: wtt.irfft_large_nb(lspec[0][:, None], lspec[1][:, None]),
            lambda: torch.fft.irfft(torch.complex(*lspec).to(torch.complex128)), f32,
            lambda y: (y.reshape(-1) - xrl).abs().max().item())[0])
        sig = rand_real((1, (MAIN_B - 1) * STFT_HOP + MAIN_N), gen, dev)
        w = torch.as_tensor(wstft.get_window("hann", MAIN_N), device=dev, dtype=torch.float64)
        faces.append(_sharded_face(
            "stft", sig.shape, lambda: prs.stft_sharded(sig, mesh, n_fft=MAIN_N, hop=STFT_HOP),
            {"rfft_r2c_fused": 1},
            lambda: wstft.stft(sig, n_fft=MAIN_N, hop=STFT_HOP),
            lambda: torch.fft.rfft(sig.double().unfold(-1, MAIN_N, STFT_HOP) * w), f32)[0])

        # the fft2 backward at the energy's cotangent 2 X / (h w), whose
        # gradient is 2x (Parseval); fft2's backward gets the same cotangent
        def grad_of(fn, cot):
            a, b = ire.clone().requires_grad_(True), iim.clone().requires_grad_(True)
            torch.autograd.backward(fn(a, b), cot)
            return a.grad, b.grad

        cot = tuple(2 * t / img.numel() for t in psh.fft2_sharded(ire, iim, mesh))
        torch.cuda.synchronize()
        zero_counts()
        with no_library_fft():
            gre, gim = grad_of(lambda a, b: psh.fft2_sharded(a, b, mesh), cot)
            torch.cuda.synchronize()
        launches = counts()
        check(launches == expect(stockham_c2c=2, fft2_cols=2),
              f"sharded fft2 backward: launches {launches}")
        sre, sim = grad_of(lambda a, b: _planes(wtt.fft2(torch.complex(a, b))), cot)
        g_err = max(rel_diff(gre, sre), rel_diff(gim, sim))
        g_2x = max((gre - 2 * ire).abs().max().item(), (gim - 2 * iim).abs().max().item())
        check(g_err <= KERNEL_LIMIT, f"sharded fft2 backward: {g_err:.3e} of fft2's")
        check(g_2x < 1e-3, f"sharded fft2 backward: {g_2x:.3e} from 2x")
        faces.append({"face": "fft2_backward", "shape": list(img.shape),
                      "launches": {k: v for k, v in launches.items() if v},
                      "max_rel_vs_single": g_err, "max_abs_vs_2x": g_2x})

        # the exchange of one 4096^2 plane apart: at world 1 the pack and the
        # unpack are views; as four ranks would lay them out they are copies
        rows = torch.empty(1, FFT2_MAIN, FFT2_MAIN, device=dev)
        buf = psh.pack(rows, 1).contiguous()
        exchange = {"shape": [FFT2_MAIN, FFT2_MAIN], "bytes_a_plane": rows.numel() * 4,
                    "pack_is_view": buf.data_ptr() == rows.data_ptr(),
                    "a2a_ms": time_ms(lambda: psh.exchange(buf, group))[0],
                    "pack_d4_ms": time_ms(lambda: psh.pack(rows, 4).contiguous())[0],
                    "unpack_d4_ms": time_ms(lambda: psh.unpack(buf, rows.shape, 4,
                                                               reverse=True))[0],
                    "copy_ms": time_ms(lambda: rows.clone())[0]}
        world1 = dryrun.assemble([dryrun.faces(mesh, dryrun.inputs(dryrun.MID_SIZES,
                                                                   SHARDED_SEED),
                                               dryrun.MID_SIZES)])
    finally:
        dist.destroy_process_group()
    print(json.dumps({"phase": "sharded", "world": 1, "backend": "nccl", "faces": faces,
                      "exchange": exchange, "seconds": time.perf_counter() - t0,
                      "card": name, "power_limit": limit}), flush=True)
    return world1


def phase_sharded_ranks(name: str, limit: str, world1: dict) -> None:
    """dryrun's faces on SHARDED_RANKS ranks of one card (gloo with CUDA
    tensors: NCCL refuses two ranks on one GPU), on a (4,) mesh and a
    (2, 2) mesh, at the mid sizes; the ranks' outputs put together held
    against the same faces at world 1 (KERNEL_LIMIT of the largest
    output). The kernels are built before the ranks start."""
    import numpy as np

    from watfft_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        said = dryrun.spawn(SHARDED_RANKS, "gloo", "cuda", dryrun.rank_faces, dryrun.MID_SIZES,
                            SHARDED_SEED, tmp, "cuda", timeout=SHARDED_RANKS_TIMEOUT)
        shards = []
        for r in range(SHARDED_RANKS):
            with np.load(f"{tmp}/rank{r}.npz") as f:
                shards.append(dict(f))
    got = dryrun.assemble(shards)
    errs = {k: float(np.max(np.abs(got[k] - v)) / np.max(np.abs(v))) for k, v in world1.items()}
    worst = max(errs, key=errs.get)
    print(json.dumps({"phase": "sharded_ranks", "world": SHARDED_RANKS, "backend": "gloo",
                      "device": "cuda", "outputs": len(errs), "worst": worst,
                      "max_rel_vs_world1": errs[worst], "refusals": said[0],
                      "seconds": time.perf_counter() - t0, "card": name,
                      "power_limit": limit}), flush=True)
    check(set(got) == set(world1), "sharded_ranks: the ranks' outputs differ from world 1's")
    check(errs[worst] <= KERNEL_LIMIT,
          f"sharded_ranks: {worst} {errs[worst]:.3e} of the world-1 result")


def bound(nbytes: float, flops: float, peak: float = PEAK_FLOPS) -> tuple[float, str]:
    """The least time in ms the card could take: bytes over its memory rate
    or flops over its peak rate for their type (FP32 unless given),
    whichever is larger, and which one."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_line(c2c: dict, real_launches: dict, real_errs: dict, times: dict,
                 real_times: dict, large_rows: list, fft2_rows: list, name: str,
                 limit: str) -> dict:
    """Each kernel at the main path's shape, 4096 transforms of n = 1024
    (the large kernels at theirs, `large_kernel_rows`, the 2D kernels at
    theirs, `fft2_kernel_rows`): bytes count each
    input read once and each output written once; flops are 5 m log2 m per
    m-point complex FFT, 10 per bin of the Hermitian post or pre and 6 per
    point of a complex multiply."""
    n, b, m = MAIN_N, MAIN_B, MAIN_N // 2
    log_m = m.bit_length() - 1
    c2c_t, rt = times[n], real_times[n]
    real_bytes = 4 * n * b + 8 * (m + 1) * b       # f32 signal + complex64 spectrum
    core_bytes = 4 * n * b + 8 * m * b             # f32 signal + complex64 core planes
    rows = [
        ("stockham_c2c", "watfft_tpu_torch/ops/csrc/stockham.cu",
         "watfft_tpu/ops/pallas_stockham.py:260", ["watfft_tpu/ops/pallas_stockham.py:355",
                                                   "watfft_tpu/ops/pallas_stockham.py:435"],
         c2c["launches"], c2c["max_abs_err"], c2c_t["kernel_fwd_ms"], c2c_t["plain_fwd_ms"],
         bound(16 * n * b, 5 * n * (n.bit_length() - 1) * b), c2c_t["cufft_fwd_ms"]),
        ("stockham_c2c_real_core_fwd", "watfft_tpu_torch/ops/csrc/stockham.cu",
         "watfft_tpu/ops/pallas_rfft.py:167", ["watfft_tpu/ops/pallas_rfft.py:288"],
         real_launches["real_core_fwd"], real_errs["real_core_fwd"], rt["core_fwd_ms"],
         rt["plain_core_fwd_ms"], bound(core_bytes, 5 * m * log_m * b), rt["lib_core_fwd_ms"]),
        ("stockham_c2c_real_core_inv", "watfft_tpu_torch/ops/csrc/stockham.cu",
         "watfft_tpu/ops/pallas_rfft.py:193", ["watfft_tpu/ops/pallas_rfft.py:304"],
         real_launches["real_core_inv"], real_errs["real_core_inv"], rt["core_inv_ms"],
         rt["plain_core_inv_ms"], bound(core_bytes, 5 * m * log_m * b), rt["lib_core_inv_ms"]),
        ("rfft_r2c_fused", "watfft_tpu_torch/ops/csrc/rfft.cu",
         "watfft_tpu/ops/pallas_rfft.py:563", [],
         real_launches["rfft_r2c_fused"], real_errs["rfft_r2c_fused"], rt["r2c_fused_ms"],
         rt["plain_r2c_ms"], bound(real_bytes, (5 * m * log_m + 10 * (m + 1)) * b),
         rt["lib_rfft_ms"]),
        ("irfft_c2r_fused", "watfft_tpu_torch/ops/csrc/rfft.cu",
         "watfft_tpu/ops/pallas_rfft.py:604", [],
         real_launches["irfft_c2r_fused"], real_errs["irfft_c2r_fused"], rt["c2r_fused_ms"],
         rt["plain_c2r_ms"], bound(real_bytes, (5 * m * log_m + 10 * m) * b), rt["lib_irfft_ms"]),
        *large_rows,
        *fft2_rows,
    ]
    return {"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": repl,
         "also_replaces": also, "launches": launches, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
         "card": name, "power_limit": limit}
        for kname, src, repl, also, launches, err, ms, plain_ms, bnd, lib_ms in rows]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name, limit = card()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {nvcc}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"build: {time.perf_counter() - t0:.1f} s -> {info['path']}", flush=True)
    for ln in info["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("  ptxas:", ln.strip(), flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    try:
        phase_kernel_vs_plain(dev, gen)
        launches, max_abs_err = phase_main_path(dev, gen)
        times = phase_times(dev, gen, name, limit)
        phase_host(dev, gen, name, limit)
        phase_real_kernel_vs_plain(dev, gen)
        real_launches, real_errs = phase_real_main_path(dev, gen)
        phase_stft(dev, gen)
        real_times = phase_real_times(dev, gen, name, limit)
        phase_large_kernel_vs_plain(dev, gen)
        main, cube = phase_large_main_path(dev, gen)
        phase_large_real_main_path(dev, gen)
        single = phase_large_single(dev, gen)
        large_times = phase_large_times(dev, gen, name, limit)
        phase_large_crossover(dev, gen, name, limit)
        phase_large_real_times(dev, gen, name, limit)
        large_rows = large_kernel_rows(main, cube, single, large_times, dev, gen)
        phase_fft2_kernel_vs_plain(dev, gen)
        fft2_main = phase_fft2_main_path(dev, gen)
        fft2_times = phase_fft2_times(dev, gen, name, limit)
        fft2_rows = fft2_kernel_rows(fft2_main, fft2_times, dev, gen)
        phase_bluestein_kernel_vs_plain(dev, gen)
        bl_main = phase_bluestein_main_path(dev, gen)
        phase_bluestein_times(dev, gen, name, limit)
        bl_rows = bluestein_kernel_rows(bl_main, dev, gen, name, limit)
        phase_f64_kernel_vs_plain(dev, gen)
        f64_main = phase_f64_main_path(dev, gen)
        phase_f64_times(dev, gen, name, limit)
        f64_rows = f64_kernel_rows(f64_main, dev, gen, name, limit)
        phase_dft_kernel_vs_plain(dev, gen)
        dft_main = phase_dft_main_path(dev, gen)
        phase_dft_times(dev, gen, name, limit)
        dft_rows = dft_kernel_rows(dft_main, dev, gen, name, limit)
        phase_bf16_kernel_vs_plain(dev, gen)
        bf16_main = phase_bf16_main_path(dev, gen)
        bf16_times = phase_bf16_times(dev, gen, name, limit)
        bf16_rows = bf16_kernel_rows(bf16_main, bf16_times, dev, gen, name, limit)
        phase_ladder(dev, gen, name, limit)
        tile_rows = column_tile_rows(phase_column_tile(dev, gen, name, limit), name, limit)
        resident = phase_resident(dev, gen, name, limit)
        walk = phase_c2c_walk(dev, gen, name, limit)
        c2r_cube2 = phase_c2r_cube2(dev, gen, name, limit)
        phase_sharded_ranks(name, limit, phase_sharded_one(dev, gen, name, limit))
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    line = kernels_line({"launches": launches, "max_abs_err": max_abs_err}, real_launches,
                        real_errs, times, real_times, large_rows, fft2_rows, name, limit)
    line["kernels"].extend(bl_rows)
    line["kernels"].extend(f64_rows)
    line["kernels"].extend(dft_rows)
    line["kernels"].extend(bf16_rows)
    line["kernels"].extend(tile_rows)
    resident_rows(line["kernels"], resident)
    walk_rows(line["kernels"], walk)
    c2r_cube2_rows(line["kernels"], c2r_cube2)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
