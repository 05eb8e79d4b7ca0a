// The difference map's four passes over diffraction frames for Hopper
// (sm_90a): difference-map ptychography (Thibault et al. 2009,
// Ultramicroscopy 109:338; PtyPy's DM engine) with one probe mode and
// integer-pixel views. For frames j at offsets (r_j, c_j) into the object
// O, complex64 [H, W], the probe P, complex64 [M, M], the exit waves psi_j
// and the measured magnitudes a_j, float32 [M, M] in the transform's order:
//
//   exit     t_j = 2 phi_j - psi_j,            phi_j = P * O[r_j + y, c_j + x]
//   fourier  F_j <- a_j F_j / |F_j| (a_j where |F_j| = 0), in place, and
//            err_j = mean over pixels of (|F_j| - a_j)^2
//   update   out_j = (psi_j + b_j) - phi_j, for b_j the inverse transform
//            of the projected F_j; and into the object's sums, at each
//            view pixel, conj(P) * out_j and |P|^2
//   probe    into the probe's sums, at each probe pixel, over every frame,
//            conj(O_j) * psi_j and |O_j|^2
//
// The transforms between them are the port's fft2 and ifft2 (the cube,
// fft2.cu, at 128^2); the two divisions that finish the object and the
// probe are the caller's (watfft_tpu_torch/ptycho.py). Replaces no TPU
// kernel: the JAX package has no ptychography. The port's plain versions
// are torch ops (watfft_tpu_torch/ops/ptycho.py).
//
// Arrays: every complex array is interleaved complex64 (float2), contiguous;
// frames j are M * M points apart; the positions are int32 [J, 2] (row,
// column: int2); the object's sums are float32 [H, W, 4] (the numerator's
// real and imaginary parts, the denominator, and a lane that stays 0 so
// that one 16-byte atomic adds a pixel's three sums), the probe's likewise
// [M, M, 4]. A view that does not lie inside the object [H, W] is never
// read or written: the kernels check each position against H and W, skip
// the points of such a frame (exit and update leave its points of t and
// out unwritten, no sum takes them) and, given a flag, set it to 1 for the
// caller to raise on. The object and the probe are small (37 MB at 2160^2,
// 128 KB) and read through the read-only path; a chunk's views cover a
// band of the object that the 50 MB L2 holds.
//
// What bounds them: bytes. Each frame pixel is read and written once a
// pass, against a dozen flops, far under the card's ridge. So each pass is
// written as a copy: a thread takes kPItems points kPThreads apart (each
// warp's accesses coalesce), issues every load before any arithmetic, and
// reads what it reads once with streaming loads (`__ldcs`).
//  * exit, update: a thread's points are the flat index e = j M^2 + y M + x;
//    M^2 is a power of two, so j, y and x are shifts and masks.
//  * fourier: one block a frame, so err_j is a block's sum in a fixed
//    order (each thread's points in ascending order, then a tree over the
//    threads in shared memory): two runs give the same bits.
//  * update: the object's sums take one vector atomicAdd (float4, native
//    on sm_90) a frame pixel. A gather over the views that cover an object
//    pixel would need, for arbitrary positions, a list of them a pixel
//    built every call; with the atomics, the view of a pixel of frame j is
//    an address, and a chunk's addresses stay in the L2. Up to M^2 / step^2
//    frames (64 in the raster of the benchmark) add into one object pixel;
//    the order of the adds is the hardware's, so the sums are not the same
//    bits from run to run.
//  * probe: a thread owns one probe pixel and sums kProbeFrames frames of
//    it (kPItems frames' loads in flight), then adds its sums into the
//    probe's with one atomic; a block holds 256 pixels of one group of
//    frames, so the grid is (pixels / 256) x (frames / kProbeFrames).
//
// The products and sums are written with the round-to-nearest intrinsics,
// which the compiler does not contract into FMAs, in the plain version's
// order: exit, the projection and out_j are the plain version's bits; the
// sums (err, the object's and the probe's) differ from it in their order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham.cuh"

namespace {

constexpr int kPThreads = 256;
constexpr int kPItems = 4;
constexpr int kProbeFrames = 64;

// a * b, each product rounded
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// conj(a) * b, each product rounded
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float norm2(float2 a) {
  return __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y));
}

// whether the m x m view at rc lies inside the object [obj_h, obj_w]; if not,
// sets the caller's flag (if any)
__device__ __forceinline__ bool inside(int2 rc, int m, int64_t obj_h, int64_t obj_w,
                                       int* bad) {
  const bool ok = rc.x >= 0 && rc.y >= 0 && (int64_t)rc.x + m <= obj_h &&
                  (int64_t)rc.y + m <= obj_w;
  if (!ok && bad) *bad = 1;
  return ok;
}

// a pixel's three sums with one 16-byte atomic (float4 atomicAdd: sm_90)
__device__ __forceinline__ void add_sums(float* sums, float re, float im, float d) {
  atomicAdd(reinterpret_cast<float4*>(sums), make_float4(re, im, d, 0.0f));
}

// The points of frames [0, total >> 2 lm) a thread takes: e = base + i *
// kPThreads for i < kPItems; frame j = e >> 2 lm, row y and column x of it.
struct Point {
  int64_t e, j;
  int y, x;
  __device__ __forceinline__ void at(int64_t e_, int lm) {
    e = e_;
    j = e >> (2 * lm);
    const int q = (int)(e & ((int64_t(1) << (2 * lm)) - 1));
    y = q >> lm;
    x = q & ((1 << lm) - 1);
  }
  __device__ __forceinline__ int q(int lm) const { return (y << lm) | x; }
};

__global__ void __launch_bounds__(kPThreads)
ptycho_exit_kernel(const float2* __restrict__ psi, const float2* __restrict__ obj,
                   const float2* __restrict__ probe, const int2* __restrict__ pos,
                   float2* __restrict__ t, int* bad, int64_t total, int lm, int64_t obj_h,
                   int64_t obj_w) {
  const int64_t base = (int64_t)blockIdx.x * (kPThreads * kPItems) + threadIdx.x;
  Point pt[kPItems];
  float2 s[kPItems], o[kPItems], p[kPItems];
  bool ok[kPItems];
#pragma unroll
  for (int i = 0; i < kPItems; ++i) {
    pt[i].at(base + i * kPThreads, lm);
    ok[i] = false;
    if (pt[i].e < total) {  // the frame's loads do not wait for the view's check
      const int2 rc = __ldg(pos + pt[i].j);
      s[i] = __ldcs(psi + pt[i].e);
      p[i] = __ldg(probe + pt[i].q(lm));
      ok[i] = inside(rc, 1 << lm, obj_h, obj_w, bad);
      if (ok[i]) o[i] = __ldg(obj + (int64_t)(rc.x + pt[i].y) * obj_w + rc.y + pt[i].x);
    }
  }
#pragma unroll
  for (int i = 0; i < kPItems; ++i) {
    if (ok[i]) {
      const float2 phi = cmul(p[i], o[i]);
      t[pt[i].e] = make_float2(__fsub_rn(__fmul_rn(2.0f, phi.x), s[i].x),
                               __fsub_rn(__fmul_rn(2.0f, phi.y), s[i].y));
    }
  }
}

// One block a frame (blockIdx.x = j), mm = M^2 points.
__global__ void __launch_bounds__(kPThreads)
ptycho_fourier_kernel(float2* __restrict__ f, const float* __restrict__ amp,
                      float* __restrict__ err, int64_t mm) {
  __shared__ float part[kPThreads];
  float2* fj = f + (int64_t)blockIdx.x * mm;
  const float* aj = amp + (int64_t)blockIdx.x * mm;
  float acc = 0.0f;
  for (int64_t q0 = threadIdx.x; q0 < mm; q0 += kPThreads * kPItems) {
    float2 v[kPItems];
    float a[kPItems];
#pragma unroll
    for (int i = 0; i < kPItems; ++i) {
      const int64_t q = q0 + i * kPThreads;
      if (q < mm) {
        v[i] = __ldcs(fj + q);
        a[i] = __ldcs(aj + q);
      }
    }
#pragma unroll
    for (int i = 0; i < kPItems; ++i) {
      const int64_t q = q0 + i * kPThreads;
      if (q < mm) {
        const float mag = __fsqrt_rn(norm2(v[i]));
        const float d = __fsub_rn(mag, a[i]);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
        if (mag > 0.0f) {
          const float s = __fdiv_rn(a[i], mag);
          fj[q] = make_float2(__fmul_rn(v[i].x, s), __fmul_rn(v[i].y, s));
        } else {
          fj[q] = make_float2(a[i], 0.0f);
        }
      }
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kPThreads / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) part[threadIdx.x] = __fadd_rn(part[threadIdx.x],
                                                            part[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) err[blockIdx.x] = __fdiv_rn(part[0], (float)mm);
}

// psi and out may be the same array (the in-place update): each point is
// read before it is written, by the thread that writes it.
__global__ void __launch_bounds__(kPThreads)
ptycho_update_kernel(const float2* psi, const float2* __restrict__ back,
                     const float2* __restrict__ obj, const float2* __restrict__ probe,
                     const int2* __restrict__ pos, float2* out, float* __restrict__ sums,
                     int* bad, int64_t total, int lm, int64_t obj_h, int64_t obj_w) {
  const int64_t base = (int64_t)blockIdx.x * (kPThreads * kPItems) + threadIdx.x;
  Point pt[kPItems];
  float2 s[kPItems], b[kPItems], o[kPItems], p[kPItems];
  int64_t at[kPItems];
  bool ok[kPItems];
#pragma unroll
  for (int i = 0; i < kPItems; ++i) {
    pt[i].at(base + i * kPThreads, lm);
    ok[i] = false;
    if (pt[i].e < total) {  // the frame's loads do not wait for the view's check
      const int2 rc = __ldg(pos + pt[i].j);
      s[i] = __ldcs(psi + pt[i].e);
      b[i] = __ldcs(back + pt[i].e);
      p[i] = __ldg(probe + pt[i].q(lm));
      ok[i] = inside(rc, 1 << lm, obj_h, obj_w, bad);
      if (ok[i]) {
        at[i] = (int64_t)(rc.x + pt[i].y) * obj_w + rc.y + pt[i].x;
        o[i] = __ldg(obj + at[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPItems; ++i) {
    if (ok[i]) {
      const float2 phi = cmul(p[i], o[i]);
      const float2 n = make_float2(__fsub_rn(__fadd_rn(s[i].x, b[i].x), phi.x),
                                   __fsub_rn(__fadd_rn(s[i].y, b[i].y), phi.y));
      __stcs(out + pt[i].e, n);
      const float2 c = cmulc(p[i], n);
      add_sums(sums + 4 * at[i], c.x, c.y, norm2(p[i]));
    }
  }
}

// blockIdx.x: 256 probe pixels; blockIdx.y: frames [y kProbeFrames, (y + 1)
// kProbeFrames) of `frames`.
__global__ void __launch_bounds__(kPThreads)
ptycho_probe_kernel(const float2* __restrict__ psi, const float2* __restrict__ obj,
                    const int2* __restrict__ pos, float* __restrict__ sums, int* bad,
                    int64_t frames, int lm, int64_t obj_h, int64_t obj_w) {
  const int64_t mm = int64_t(1) << (2 * lm);
  const int q = blockIdx.x * kPThreads + threadIdx.x;
  if (q >= mm) return;
  const int y = q >> lm, x = q & ((1 << lm) - 1);
  const int64_t j0 = (int64_t)blockIdx.y * kProbeFrames;
  const int64_t j1 = j0 + kProbeFrames < frames ? j0 + kProbeFrames : frames;
  float nr = 0.0f, ni = 0.0f, d = 0.0f;
  for (int64_t j = j0; j < j1; j += kPItems) {
    float2 s[kPItems], o[kPItems];
    bool ok[kPItems];
#pragma unroll
    for (int i = 0; i < kPItems; ++i) {
      const int64_t k = j + i < j1 ? j + i : j1 - 1;  // the group's tail: loaded, not summed
      const int2 rc = __ldg(pos + k);
      s[i] = __ldcs(psi + k * mm + q);  // does not wait for the view's check
      ok[i] = inside(rc, 1 << lm, obj_h, obj_w, bad) && j + i < j1;
      if (ok[i]) o[i] = __ldg(obj + (int64_t)(rc.x + y) * obj_w + rc.y + x);
    }
#pragma unroll
    for (int i = 0; i < kPItems; ++i) {
      if (ok[i]) {
        const float2 c = cmulc(o[i], s[i]);
        nr = __fadd_rn(nr, c.x);
        ni = __fadd_rn(ni, c.y);
        d = __fadd_rn(d, norm2(o[i]));
      }
    }
  }
  add_sums(sums + 4 * (int64_t)q, nr, ni, d);
}

// log2 of a power-of-two M in [2, 128] (M^2 <= 2^14, the cube's largest
// image), else -1.
int log2_side(int64_t m) {
  if (m < 2 || m > 128 || (m & (m - 1))) return -1;
  int lm = 0;
  while ((int64_t(1) << lm) < m) ++lm;
  return lm;
}

bool aligned(const void* p, uintptr_t to) { return (uintptr_t)p % to == 0; }

}  // namespace

extern "C" {

// t = 2 P O_j - psi for `frames` frames of psi, complex64 [frames, m, m],
// into t (the same shape), with the object complex64 [., obj_w] and the
// probe complex64 [m, m]; pos int32 [frames, 2], 8-byte aligned. A frame
// whose view is not inside the object [obj_h, obj_w] is skipped (its t
// unwritten) and sets *bad to 1 (bad may be null). Returns 0, kErrArgs or
// a CUDA error.
int watfft_ptycho_exit(const float* psi, const float* obj, const float* probe, const int* pos,
                       float* t, int* bad, int64_t frames, int64_t m, int64_t obj_h,
                       int64_t obj_w, void* stream) {
  const int lm = log2_side(m);
  if (lm < 0 || frames < 1 || obj_h < m || obj_w < m || !aligned(pos, 8)) return kErrArgs;
  const int64_t total = frames * m * m;
  const int64_t blocks = (total + kPThreads * kPItems - 1) / (kPThreads * kPItems);
  if (blocks > 0x7fffffff) return kErrArgs;
  ptycho_exit_kernel<<<(unsigned)blocks, kPThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(psi), reinterpret_cast<const float2*>(obj),
      reinterpret_cast<const float2*>(probe), reinterpret_cast<const int2*>(pos),
      reinterpret_cast<float2*>(t), bad, total, lm, obj_h, obj_w);
  return (int)cudaGetLastError();
}

// The projection of `frames` transformed frames f, complex64 [frames, m,
// m], onto the magnitudes amp, float32 [frames, m, m], in place, and
// err[j], float32 [frames]. Returns 0, kErrArgs or a CUDA error.
int watfft_ptycho_fourier(float* f, const float* amp, float* err, int64_t frames, int64_t m,
                          void* stream) {
  if (log2_side(m) < 0 || frames < 1 || frames > 0x7fffffff) return kErrArgs;
  ptycho_fourier_kernel<<<(unsigned)frames, kPThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float2*>(f), amp, err, m * m);
  return (int)cudaGetLastError();
}

// out = (psi + back) - P O_j for `frames` frames (out may be psi), and
// conj(P) out, |P|^2 added at each view pixel into sums, float32 [obj_h,
// obj_w, 4], 16-byte aligned. A frame whose view is not inside the object
// is skipped (its out unwritten, nothing summed) and sets *bad to 1 (bad
// may be null). Returns 0, kErrArgs or a CUDA error.
int watfft_ptycho_update(const float* psi, const float* back, const float* obj,
                         const float* probe, const int* pos, float* out, float* sums, int* bad,
                         int64_t frames, int64_t m, int64_t obj_h, int64_t obj_w,
                         void* stream) {
  const int lm = log2_side(m);
  if (lm < 0 || frames < 1 || obj_h < m || obj_w < m || !aligned(pos, 8) ||
      !aligned(sums, 16)) {
    return kErrArgs;
  }
  const int64_t total = frames * m * m;
  const int64_t blocks = (total + kPThreads * kPItems - 1) / (kPThreads * kPItems);
  if (blocks > 0x7fffffff) return kErrArgs;
  ptycho_update_kernel<<<(unsigned)blocks, kPThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(psi), reinterpret_cast<const float2*>(back),
      reinterpret_cast<const float2*>(obj), reinterpret_cast<const float2*>(probe),
      reinterpret_cast<const int2*>(pos), reinterpret_cast<float2*>(out), sums, bad, total,
      lm, obj_h, obj_w);
  return (int)cudaGetLastError();
}

// conj(O_j) psi_j and |O_j|^2 summed over `frames` frames into sums, float32
// [m, m, 4], 16-byte aligned. A frame whose view is not inside the object
// [obj_h, obj_w] adds nothing and sets *bad to 1 (bad may be null). Returns
// 0, kErrArgs or a CUDA error.
int watfft_ptycho_probe(const float* psi, const float* obj, const int* pos, float* sums,
                        int* bad, int64_t frames, int64_t m, int64_t obj_h, int64_t obj_w,
                        void* stream) {
  const int lm = log2_side(m);
  if (lm < 0 || frames < 1 || obj_h < m || obj_w < m || !aligned(pos, 8) ||
      !aligned(sums, 16)) {
    return kErrArgs;
  }
  const int64_t groups = (frames + kProbeFrames - 1) / kProbeFrames;
  if (groups > 65535) return kErrArgs;
  const dim3 grid((unsigned)((m * m + kPThreads - 1) / kPThreads), (unsigned)groups);
  ptycho_probe_kernel<<<grid, kPThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(psi), reinterpret_cast<const float2*>(obj),
      reinterpret_cast<const int2*>(pos), sums, bad, frames, lm, obj_h, obj_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
