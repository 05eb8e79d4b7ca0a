// The spectrometer's power detection for Hopper (sm_90a): the power of
// every stream of a chunk, summed into one integration's row of the
// accumulator in place,
//
//   row[c, k] += sum_s (re^2 + im^2)(x[c, s, k])
//
// for the spectra x, complex64 [chans, S, nfft] and contiguous (S the
// polarisations times the chunk's spectra), and the row, float32
// [chans, nfft] with its bins contiguous and its channels row_stride floats
// apart (one integration of the accumulator [chans, nout, nfft]).
//
// Replaces no TPU kernel: the JAX package has no spectrometer. The
// port's plain version is four torch passes after the transform
// (watfft_tpu_torch/ops/detect.py, `plain_detect`): `square` of the real
// parts, `addcmul_` of the imaginary parts, the sum over the streams and the
// add into the row. Those passes read the spectra twice and write and reread
// two temporaries; this kernel reads the spectra once and the row once and
// writes the row once, 8 S + 8 bytes a bin.
//
// What bounds it: bytes. Three flops a point against 8 bytes, far under the
// card's ridge. So its design is the one of a copy:
//  * each thread owns V consecutive bins of one channel and sums their
//    streams itself: no atomics, no shared memory, and two runs give the
//    same bits. Consecutive threads take consecutive bins, so every stream's
//    row and the accumulator's row are read coalesced;
//  * where nfft and the row's stride are multiples of 4 and both pointers
//    16-byte aligned, V = 4: two 16-byte loads of x a stream and one 16-byte
//    read-modify-write of the row; otherwise V = 1 (8- and 4-byte accesses);
//  * the loads of kDetectGroup streams and of the row are issued before any
//    arithmetic (the group's last stream clamped to the last stream, and its
//    power left out, where S is odd), so a thread has all of them in flight
//    at once; at the rawspec cell (S = 2) that is every load the thread makes;
//  * the spectra are read once and are many times the 50 MB L2, so they are
//    read with streaming loads (`__ldcs`), which do not displace the row.
//
// The sums keep the plain version's order: each stream's re*re rounded,
// im*im added to it in one fused multiply-add (torch's `square`, then
// `addcmul_`), the streams added from 0 in ascending s, then the sum added
// to the row. On an H100 the kernel so equals the plain version bit for
// bit, run on the card or on the CPU, at S = 2, 3 and 4; with the products
// rounded apart (no FMA) it was one ulp off.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham.cuh"

namespace {

constexpr int kDetectThreads = 256;
constexpr int kDetectGroup = 2;

__device__ __forceinline__ float bin_power(float re, float im) {
  return __fmaf_rn(im, im, __fmul_rn(re, re));
}

// V complex points of one stream: two float4 (V = 4) or one float2 (V = 1).
template <int V>
struct Points;
template <>
struct Points<4> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float power(int i) const {
    return i == 0 ? bin_power(a.x, a.y) : i == 1 ? bin_power(a.z, a.w)
         : i == 2 ? bin_power(b.x, b.y) : bin_power(b.z, b.w);
  }
};
template <>
struct Points<1> {
  float2 a;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ float power(int) const { return bin_power(a.x, a.y); }
};

// V bins of the row: one float4 or one float.
template <int V>
struct Bins;
template <>
struct Bins<4> {
  using T = float4;
  __device__ __forceinline__ static float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ __forceinline__ static void set(T& v, int i, float f) {
    if (i == 0) v.x = f;
    else if (i == 1) v.y = f;
    else if (i == 2) v.z = f;
    else v.w = f;
  }
};
template <>
struct Bins<1> {
  using T = float;
  __device__ __forceinline__ static float get(const T& v, int) { return v; }
  __device__ __forceinline__ static void set(T& v, int, float f) { v = f; }
};

// One thread: bins j*V .. j*V+V-1 of channel c, for j = blockIdx.x *
// kDetectThreads + threadIdx.x below nfft / V, and c = blockIdx.y,
// blockIdx.y + gridDim.y, ... below chans. x: [chans, streams, nfft]
// complex64 as floats; row: [chans, nfft], channels row_stride apart.
template <int V>
__global__ void __launch_bounds__(kDetectThreads)
spec_detect_kernel(const float* __restrict__ x, float* __restrict__ row, int64_t chans,
                   int64_t streams, int64_t nfft, int64_t row_stride) {
  using B = Bins<V>;
  using T = typename B::T;
  const int64_t j = (int64_t)blockIdx.x * kDetectThreads + threadIdx.x;
  if (j * V >= nfft) return;
  for (int64_t c = blockIdx.y; c < chans; c += gridDim.y) {
    T* r = reinterpret_cast<T*>(row + c * row_stride + j * V);
    const float* xc = x + 2 * (c * streams * nfft + j * V);
    const T old = *r;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int64_t s0 = 0; s0 < streams; s0 += kDetectGroup) {
      Points<V> p[kDetectGroup];
#pragma unroll
      for (int g = 0; g < kDetectGroup; ++g) {
        const int64_t s = s0 + g < streams ? s0 + g : streams - 1;
        p[g].load(xc + 2 * s * nfft);
      }
#pragma unroll
      for (int g = 0; g < kDetectGroup; ++g) {
        if (s0 + g < streams) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], p[g].power(i));
        }
      }
    }
    T out;
#pragma unroll
    for (int i = 0; i < V; ++i) B::set(out, i, __fadd_rn(B::get(old, i), acc[i]));
    *r = out;
  }
}

}  // namespace

extern "C" {

// row[c, k] += sum_s |x[c, s, k]|^2 for x complex64 [chans, streams, nfft]
// contiguous (as floats) and row float32 [chans, nfft], bins contiguous,
// channels row_stride floats apart (row_stride >= nfft where chans > 1).
// vec: 4 (16-byte accesses: nfft and row_stride multiples of 4, both
// pointers 16-byte aligned) or 1. Returns 0, kErrArgs or a CUDA error.
int watfft_spec_detect(const float* x, float* row, int64_t chans, int64_t streams, int64_t nfft,
                       int64_t row_stride, int vec, void* stream) {
  if (chans < 1 || streams < 1 || nfft < 1 || (chans > 1 && row_stride < nfft)) {
    return kErrArgs;
  }
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if (vec == 4) {
    if (nfft % 4 || row_stride % 4 || !aligned(x) || !aligned(row)) return kErrArgs;
  } else if (vec != 1) {
    return kErrArgs;
  }
  const int64_t tiles = (nfft / vec + kDetectThreads - 1) / kDetectThreads;
  if (tiles > 0x7fffffff) return kErrArgs;
  const dim3 grid((unsigned)tiles, (unsigned)(chans < 65535 ? chans : 65535));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    spec_detect_kernel<4><<<grid, kDetectThreads, 0, st>>>(x, row, chans, streams, nfft,
                                                           row_stride);
  } else {
    spec_detect_kernel<1><<<grid, kDetectThreads, 0, st>>>(x, row, chans, streams, nfft,
                                                           row_stride);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
