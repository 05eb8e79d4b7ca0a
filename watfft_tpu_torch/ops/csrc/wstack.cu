// The w-stacking inversion's accumulation for Hopper (sm_90a): a chunk of
// inverse-transformed w-planes summed under their w-screens into the image,
// in one read of the planes,
//
//   acc[y, x]   = sum_k Re( e^{2 pi i w_k (n(l, m) - 1)} * P_k[(y + N/2) % N, (x + N/2) % N] )
//   image[y, x] = (first ? 0 : image[y, x]) + (-1)^(x + y) * acc[y, x]
//   and, where last, image[y, x] *= n(l, m) / (taper[y] * taper[x])
//
// for the planes P, complex64 [layers, N, N] contiguous, as the port's
// ifft2 leaves them (no centring shift), w float64 [layers], taper float32
// [N] and the image float32 [N, N]; l = (x - N/2) * pixel_scale, m = (y -
// N/2) * pixel_scale, n = sqrt(1 - l^2 - m^2), and pixels with l^2 + m^2 >= 1
// are 0. For even N, fftshift(ifft2(ifftshift(G)))[y, x] = (-1)^(x + y)
// ifft2(G)[(y + N/2) % N, (x + N/2) % N]: both centring shifts are this
// kernel's indexing and one sign a pixel, so no pass moves the planes.
//
// Replaces no TPU kernel: the JAX package has no imager. The port's plain
// version is torch ops (watfft_tpu_torch/ops/wstack.py, `plain_accum`): a
// roll of the planes, the screen and the sum a plane.
//
// What bounds it: bytes. A pixel of a plane is read once (8 B) against ~15
// flops and one float64 product, far under the card's ridge; the image is
// read and written once a chunk (8 B a pixel over the chunk's planes). So
// its design is the one of a copy:
//  * each thread owns V consecutive pixels of one row and sums their planes
//    itself: no atomics, no shared memory, and two runs give the same bits.
//    Consecutive threads take consecutive pixels, and N/2 is a multiple of
//    V, so a thread's V pixels stay consecutive in every plane after the
//    shift: every plane's row is read coalesced;
//  * where N is a multiple of 8 and the planes and the image 16-byte
//    aligned, V = 4: two 16-byte loads a plane and one 16-byte
//    read-modify-write of the image; otherwise V = 1;
//  * the loads of kWGroup planes are issued before any arithmetic (the
//    group's tail clamped to the last plane and left out of the sum), so a
//    thread has them all in flight at once;
//  * the planes are read once and are many times the 50 MB L2, so they are
//    read with streaming loads (`__ldcs`).
//
// The phase is w_k (n - 1) turns, up to ~80 at a wide field's corners: n - 1
// is computed once a pixel in float64 as -r^2 / (1 + sqrt(1 - r^2)), which
// does not cancel near the centre; the product is float64 and reduced mod 1
// (round half to even by adding and subtracting 1.5 * 2^52) before the
// float32 `sincospif`. Either factor in float32 would lose ~5e-6 turns.
// The sums keep the plain version's order and roundings: re*cos and im*sin
// rounded apart, their difference, the planes added from 0 in ascending k,
// then the signed sum added to the image, then the epilogue's scale
// (float64, rounded to float32) multiplied in. Only sincospif (1 ulp)
// differs from the plain version's float64 cos and sin rounded to float32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham.cuh"

namespace {

constexpr int kWThreads = 256;
constexpr int kWGroup = 4;
constexpr double kRoundMagic = 6755399441055744.0;  // 1.5 * 2^52

// V complex points of one plane: two float4 (V = 4) or one float2 (V = 1).
template <int V>
struct Plane;
template <>
struct Plane<4> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float re(int i) const {
    return i == 0 ? a.x : i == 1 ? a.z : i == 2 ? b.x : b.z;
  }
  __device__ __forceinline__ float im(int i) const {
    return i == 0 ? a.y : i == 1 ? a.w : i == 2 ? b.y : b.w;
  }
};
template <>
struct Plane<1> {
  float2 a;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ float re(int) const { return a.x; }
  __device__ __forceinline__ float im(int) const { return a.y; }
};

// V pixels of the image: one float4 or one float.
template <int V>
struct Pixels;
template <>
struct Pixels<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Pixels<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
  __device__ __forceinline__ void store(float* p) const { *p = v[0]; }
};

// Re(e^{2 pi i phase} * (re + i im)) for phase = w * nm1 turns.
__device__ __forceinline__ float screened(double w, double nm1, float re, float im) {
  const double p = __dmul_rn(w, nm1);
  const double turns = __dsub_rn(p, __dsub_rn(__dadd_rn(p, kRoundMagic), kRoundMagic));
  float s, c;
  sincospif(__double2float_rn(__dmul_rn(2.0, turns)), &s, &c);
  return __fsub_rn(__fmul_rn(re, c), __fmul_rn(im, s));
}

// One thread: pixels x0 .. x0 + V - 1 of row y, for t = blockIdx.x *
// kWThreads + threadIdx.x below N * N / V (x0 = (t % (N / V)) * V).
template <int V>
__global__ void __launch_bounds__(kWThreads)
wstack_accum_kernel(const float* __restrict__ planes, float* __restrict__ image,
                    const double* __restrict__ w, const float* __restrict__ taper,
                    int64_t layers, int64_t n, double pixel_scale, int first, int last) {
  const int64_t t = (int64_t)blockIdx.x * kWThreads + threadIdx.x;
  const int64_t per_row = n / V;
  if (t >= n * per_row) return;
  const int64_t y = t / per_row;
  const int64_t x0 = (t - y * per_row) * V;
  const int64_t half = n / 2;
  const int64_t ys = y < half ? y + half : y - half;
  const int64_t xs = x0 < half ? x0 + half : x0 - half;
  const double m = __dmul_rn((double)(y - half), pixel_scale);
  const double m2 = __dmul_rn(m, m);
  double r2[V], nm1[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const double l = __dmul_rn((double)(x0 + i - half), pixel_scale);
    r2[i] = __dadd_rn(__dmul_rn(l, l), m2);
    nm1[i] = r2[i] < 1.0 ? -r2[i] / (1.0 + sqrt(1.0 - r2[i])) : 0.0;
  }
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  const float* p = planes + 2 * (ys * n + xs);
  const int64_t plane_floats = 2 * n * n;
  for (int64_t k0 = 0; k0 < layers; k0 += kWGroup) {
    Plane<V> q[kWGroup];
#pragma unroll
    for (int g = 0; g < kWGroup; ++g) {
      const int64_t k = k0 + g < layers ? k0 + g : layers - 1;
      q[g].load(p + k * plane_floats);
    }
#pragma unroll
    for (int g = 0; g < kWGroup; ++g) {
      if (k0 + g < layers) {
        const double wk = __ldg(w + k0 + g);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[i] = __fadd_rn(acc[i], screened(wk, nm1[i], q[g].re(i), q[g].im(i)));
        }
      }
    }
  }
  float* out = image + y * n + x0;
  Pixels<V> px;
  if (!first) px.load(out);
  const float ty = last ? __ldg(taper + y) : 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (r2[i] >= 1.0) {
      px.v[i] = 0.0f;
      continue;
    }
    const float signed_acc = ((x0 + i + y) & 1) ? -acc[i] : acc[i];
    float v = first ? signed_acc : __fadd_rn(px.v[i], signed_acc);
    if (last) {
      const double scale = sqrt(1.0 - r2[i]) / ((double)ty * (double)__ldg(taper + x0 + i));
      v = __fmul_rn(v, __double2float_rn(scale));
    }
    px.v[i] = v;
  }
  px.store(out);
}

}  // namespace

extern "C" {

// The chunk's planes, complex64 [layers, n, n] contiguous (as floats), summed
// under their w-screens into image, float32 [n, n] contiguous; w float64
// [layers] and taper float32 [n] on the device. first: the image is not
// read (the chunk starts it); last: the epilogue scales by n / taper^2.
// vec: 4 (n a multiple of 8, planes and image 16-byte aligned) or 1.
// Returns 0, kErrArgs or a CUDA error.
int watfft_wstack_accum(const float* planes, float* image, const double* w, const float* taper,
                        int64_t layers, int64_t n, double pixel_scale, int first, int last,
                        int vec, void* stream) {
  if (layers < 1 || n < 2 || (n & (n - 1)) || !(pixel_scale > 0.0)) return kErrArgs;
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if (vec == 4) {
    if (n % 8 || !aligned(planes) || !aligned(image)) return kErrArgs;
  } else if (vec != 1) {
    return kErrArgs;
  }
  const int64_t blocks = (n * n / vec + kWThreads - 1) / kWThreads;
  if (blocks > 0x7fffffff) return kErrArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    wstack_accum_kernel<4><<<(unsigned)blocks, kWThreads, 0, st>>>(
        planes, image, w, taper, layers, n, pixel_scale, first, last);
  } else {
    wstack_accum_kernel<1><<<(unsigned)blocks, kWThreads, 0, st>>>(
        planes, image, w, taper, layers, n, pixel_scale, first, last);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
