// The inverse STFT's overlap-add for Hopper (sm_90a), float32: the synthesis
// window, the overlap-add of the frames and the division by the overlap-added
// squared window (COLA normalization) in one pass,
//
//   out[b, s] = sum_j f[b, j, s - j*hop] w[s - j*hop] / max(sum_j w[s - j*hop]^2, 1e-8)
//
// over the frames j that cover sample s (0 <= s - j*hop < n_fft), for the
// samples s < len of each clip b.
//
// Replaces no TPU kernel: the JAX package leaves the overlap-add to XLA
// (watfft_tpu/stft.py, `istft`). The port's plain version is four torch
// passes after the c2r (#10): `frames * w`, an `index_add_` of the frames
// and one of the squared window, and the clamped division
// (watfft_tpu_torch/stft.py, `_overlap_add`). Those passes read and write
// the frames twice, take an int64 index a clip row and add with atomics into
// the output; this kernel reads the frames once and writes the signal once.
//
// What bounds it: bytes. A sample reads its n_fft/hop frame values and
// writes one, 4 (B num n_fft + B len) bytes a launch for no more than
// 4 flop a frame value, far under the card's ridge. So its design is the
// one of a copy:
//  * a gather, not a scatter: each thread owns its output samples and sums
//    the frames that cover them in ascending j, so there are no atomics, no
//    index and no norm table, and two runs give the same bits. Every frame
//    value maps to exactly one sample, so each is read once;
//  * consecutive threads take consecutive samples, so each frame row is read
//    and each output row written coalesced; where hop % 4 == 0 a thread takes
//    4 consecutive samples (V = 4) that share their covering frames (s % 4 ==
//    0, and n_fft and hop are multiples of 4), read and written as 16-byte
//    vectors; otherwise one sample at a time (V = 1);
//  * the window is read through the read-only path, where its n_fft floats
//    stay in L1 (staging it in shared memory gained 0.3% on an H100 at the
//    STFT cell's shape, 120.4 against 120.8 us, and was dropped);
//  * a block takes kOlaVecs vectors a thread, kOlaThreads apart.
//
// The sums are taken as the plain version's CPU run takes them: the products
// rounded (no FMA contraction), added from 0 in ascending j, and an IEEE
// division, so the kernel equals the plain version run on the same frames on
// the CPU bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham.cuh"

namespace {

constexpr int kOlaThreads = 256;
constexpr int kOlaVecs = 4;
constexpr float kOlaClamp = 1e-8f;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ float lane(const float& v, int) { return v; }
__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set_lane(float& v, int, float x) { v = x; }
__device__ __forceinline__ void set_lane(float4& v, int i, float x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

// One block: kOlaThreads * kOlaVecs * V consecutive samples of one clip
// (blockIdx.x = clip * tiles + tile). frames: [batch, num, n_fft]
// contiguous; out: [batch, len] contiguous.
template <int V>
__global__ void __launch_bounds__(kOlaThreads)
istft_ola_kernel(const float* __restrict__ frames, const float* __restrict__ w,
                 float* __restrict__ out, int64_t num, int n_fft, int64_t hop, int64_t len,
                 int64_t tiles) {
  using T = typename Vec<V>::T;
  const int64_t b = blockIdx.x / tiles;
  const int64_t s0 = (blockIdx.x - b * tiles) * (int64_t)(kOlaThreads * kOlaVecs * V);
  const float* fb = frames + b * num * n_fft;
  float* ob = out + b * len;
#pragma unroll
  for (int v = 0; v < kOlaVecs; ++v) {
    const int64_t s = s0 + (int64_t)(v * kOlaThreads + threadIdx.x) * V;
    if (s >= len) break;  // s grows with v; with V = 4, len % 4 == 0
    // the covering frames: ceil((s - n_fft + 1) / hop) .. floor(s / hop)
    const int64_t jhi = s / hop < num ? s / hop : num - 1;
    const int64_t jlo = s < n_fft ? 0 : (s - n_fft) / hop + 1;
    float acc[V], norm[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = norm[i] = 0.0f;
#pragma unroll 4
    for (int64_t j = jlo; j <= jhi; ++j) {
      const int64_t k = s - j * hop;  // in [0, n_fft - V], a multiple of V
      const T f = __ldcs(reinterpret_cast<const T*>(fb + j * n_fft + k));
      const T g = __ldg(reinterpret_cast<const T*>(w + k));
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float wi = lane(g, i);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(lane(f, i), wi));
        norm[i] = __fadd_rn(norm[i], __fmul_rn(wi, wi));
      }
    }
    T y;
#pragma unroll
    for (int i = 0; i < V; ++i) set_lane(y, i, __fdiv_rn(acc[i], fmaxf(norm[i], kOlaClamp)));
    *reinterpret_cast<T*>(ob + s) = y;
  }
}

}  // namespace

extern "C" {

// out[b, s] for s < len of `batch` clips from frames [batch, num, n_fft] and
// the window w [n_fft], all float32 and contiguous; len <= (num - 1) * hop +
// n_fft. vec: 4 (16-byte loads and stores: hop and len multiples of 4, and
// the three tensors 16-byte aligned) or 1. Returns 0, kErrArgs or a CUDA
// error.
int watfft_istft_ola(const float* frames, const float* w, float* out, int64_t batch,
                     int64_t num, int n_fft, int64_t hop, int64_t len, int vec, void* stream) {
  if (n_fft < 4 || (n_fft & (n_fft - 1)) || hop < 1 || num < 1 || batch < 1 || len < 1 ||
      len > (num - 1) * hop + n_fft) {
    return kErrArgs;
  }
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if (vec == 4) {
    if (hop % 4 || len % 4 || !aligned(frames) || !aligned(w) || !aligned(out)) return kErrArgs;
  } else if (vec != 1) {
    return kErrArgs;
  }
  const int64_t tile = (int64_t)kOlaThreads * kOlaVecs * vec;
  const int64_t tiles = (len + tile - 1) / tile;
  if (batch > 0x7fffffff / tiles) return kErrArgs;
  const unsigned blocks = (unsigned)(batch * tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    istft_ola_kernel<4><<<blocks, kOlaThreads, 0, st>>>(frames, w, out, num, n_fft, hop, len,
                                                        tiles);
  } else {
    istft_ola_kernel<1><<<blocks, kOlaThreads, 0, st>>>(frames, w, out, num, n_fft, hop, len,
                                                        tiles);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
