// Fused real FFT kernels for Hopper (sm_90a), float32: r2c (forward) and
// c2r (normalized inverse) of n = 2m real points, in one pass each.
//
// rfft_r2c_kernel replaces watfft_tpu/ops/pallas_rfft.py::_rfft_fused_kernel
// (deinterleave + m-point stages + Hermitian mirror + post-twiddle) and
// irfft_c2r_kernel replaces ::_irfft_fused_kernel (mirror + pre-process +
// m-point inverse stages with 1/m folded + re-interleave). They compute
// what the TPU kernels compute, in the same row conventions:
//
//   forward  z[j] = x[2j] + i x[2j+1], Z = DFT_m(z),
//            X[k] = E + w_n^k O with E = (A + conj B)/2, O = -i (A - conj B)/2,
//            A = Z[k], B = Z[m-k] (k = 1..m-1); X[0] = Re Z0 + Im Z0 and
//            X[m] = Re Z0 - Im Z0, with imaginary parts exactly 0.
//   inverse  Z[k] = E + w_n^-k O with E = (A + B)/2, O = i (A - B)/2,
//            A = X[k], B = conj X[m-k] (k = 0..m-1, so Z[0] reads the
//            imaginary parts of the DC and Nyquist rows), z = IDFT_m(Z),
//            o[2j] = Re z[j], o[2j+1] = Im z[j].
//
// The post twiddles w_n^{-+k} come from the host table of
// watfft_tpu_torch/ops/rfft.py (rfft_post_twiddles); the m-point stages are
// the engine of stockham.cuh with the m-point plan and twiddle pack.
//
// What bounds them: 8 bytes of device memory per real point (4 read, and
// about 4 written as (m+1) complex bins per n reals), against about
// 2.5*log2(n) + 5 flop per real point — far under the card's FP32 ridge,
// so they are memory-bound. The design therefore reads each input once and
// writes each output once, and keeps everything between in shared memory.
//
// Design:
//  * What the TPU needed and Hopper does not. Mosaic cannot reverse rows
//    or gather with a stride inside a kernel, so the TPU kernels deinterleave
//    with a reshape or bf16x3 selection matmuls and mirror Z[m-k] with a
//    blocked 0/1 matmul (pallas_rfft.py:46-160, :489-560). Here a thread
//    simply addresses row m-k of the transform in shared memory, and the
//    deinterleave is the load itself: z[j] is read from x[2j] and x[2j+1]
//    straight into shared memory.
//  * The mirror pair in one thread. Forward: after the stages, one thread
//    takes the pair (k, m-k), reads Z[k] and Z[m-k] once, and writes X[k]
//    and X[m-k] (and X[0], X[m] for k = 0; X[m/2] alone for k = m/2).
//    Inverse: in the load phase one thread reads X[k] and X[m-k] from
//    device memory and writes the pre-processed Z[k] and Z[m-k] to shared
//    memory. Row m of the spectrum therefore never needs a slot in shared
//    memory, whose per-transform stride is sized for the m rows of Z.
//  * Block shape, stages, bank padding and the walk along the smaller
//    stride are those of the c2c kernel (stockham.cu), with n replaced by m.
//  * Layouts are strides: the real side has an element stride along n and
//    one along the batch, the spectrum side separate re and im pointers
//    with their own pair, so interleaved complex64 (stride 2), split planes,
//    batch-major [B, n] and time-major [n, B] (the [n, 8, W] view too) all
//    take one launch.
//
// C interface (loaded with ctypes): watfft_rfft_r2c and watfft_irfft_c2r
// launch on the given stream, allocate nothing, and return
// cudaGetLastError() after the launch, or a negative code (the kErr codes
// of stockham.cuh, printed by watfft_error_string) for arguments they
// refuse before launching.

#include "stockham.cuh"

namespace {

// X = E + w O for the forward pair (A, B) = (Z[k], Z[m-k]).
__device__ __forceinline__ float2 post_fwd(float2 a, float2 b, float2 w) {
  const float ere = 0.5f * (a.x + b.x), eim = 0.5f * (a.y - b.y);
  const float ore = 0.5f * (a.y + b.y), oim = -0.5f * (a.x - b.x);
  return make_float2(ere + w.x * ore - w.y * oim, eim + w.x * oim + w.y * ore);
}

// Z = E + w O for the inverse pair A = X[k], B = conj(xb), xb = X[m-k].
__device__ __forceinline__ float2 pre_inv(float2 a, float2 xb, float2 w) {
  const float bre = xb.x, bim = -xb.y;
  const float ere = 0.5f * (a.x + bre), eim = 0.5f * (a.y + bim);
  const float ore = -0.5f * (a.y - bim), oim = 0.5f * (a.x - bre);
  return make_float2(ere + w.x * ore - w.y * oim, eim + w.x * oim + w.y * ore);
}

// Calls f(t, k, g) for the mirror pairs (k, m-k), k = 0..m/2, of transform
// t of the block's tile, g being the offset of the transform's row 0 in
// device memory. Walks along the smaller stride, as for_tile does.
template <typename F>
__device__ __forceinline__ void for_pairs(int m, int T, int count, int64_t first,
                                          int64_t sn, int64_t sb, F f) {
  const int h = m / 2 + 1, units = T * h;
  if (sn <= sb) {
    for (int e = threadIdx.x; e < units; e += blockDim.x) {
      const int t = e / h, k = e - t * h;
      if (t < count) f(t, k, (first + t) * sb);
    }
  } else {
    for (int e = threadIdx.x; e < units; e += blockDim.x) {
      const int k = e / T, t = e - k * T;
      if (t < count) f(t, k, (first + t) * sb);
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kBlockThreads, min_blocks(P))
rfft_r2c_kernel(const float* __restrict__ x, int64_t x_sn, int64_t x_sb,
                float* __restrict__ yre, float* __restrict__ yim,
                int64_t y_sn, int64_t y_sb, int64_t batch, int T, int S,
                const float* __restrict__ twre, const float* __restrict__ twim,
                const float* __restrict__ wre, const float* __restrict__ wim,
                Plan plan) {
  extern __shared__ float2 smem[];
  const int m = 1 << plan.log2n;
  const int tpt = m / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  // z[j] = x[2j] + i x[2j+1]: complex point j sits 2j real strides in
  for_tile(plan.log2n, T, count, first, 2 * x_sn, x_sb, [&](int t, int j, int64_t g) {
    smem[t * S + pad(j)] = make_float2(x[g], x[g + x_sn]);
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, false>(smem + t * S, th, tpt, plan, twre, twim);

  // Hermitian post, one mirror pair per thread (the stages ended with a sync)
  for_pairs(m, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
    const float2* c = smem + t * S;
    if (k == 0) {
      const float2 z0 = c[0];
      yre[g] = z0.x + z0.y;
      yim[g] = 0.0f;
      yre[g + m * y_sn] = z0.x - z0.y;
      yim[g + m * y_sn] = 0.0f;
      return;
    }
    const float2 a = c[pad(k)], b = c[pad(m - k)];
    const float2 xk = post_fwd(a, b, make_float2(__ldg(wre + k), __ldg(wim + k)));
    yre[g + k * y_sn] = xk.x;
    yim[g + k * y_sn] = xk.y;
    if (2 * k != m) {
      const int j = m - k;
      const float2 xj = post_fwd(b, a, make_float2(__ldg(wre + j), __ldg(wim + j)));
      yre[g + j * y_sn] = xj.x;
      yim[g + j * y_sn] = xj.y;
    }
  });
}

template <int P>
__global__ void __launch_bounds__(kBlockThreads, min_blocks(P))
irfft_c2r_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                 int64_t x_sn, int64_t x_sb, float* __restrict__ y,
                 int64_t y_sn, int64_t y_sb, int64_t batch, int T, int S,
                 const float* __restrict__ twre, const float* __restrict__ twim,
                 const float* __restrict__ wre, const float* __restrict__ wim,
                 Plan plan) {
  extern __shared__ float2 smem[];
  const int m = 1 << plan.log2n;
  const int tpt = m / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  // Hermitian pre-process in the load, one mirror pair per thread: Z[0]
  // from X[0] and X[m], Z[k] and Z[m-k] from X[k] and X[m-k]
  for_pairs(m, T, count, first, x_sn, x_sb, [&](int t, int k, int64_t g) {
    float2* c = smem + t * S;
    const int j = k == 0 ? m : m - k;
    const float2 a = make_float2(xre[g + k * x_sn], xim[g + k * x_sn]);
    const float2 b = make_float2(xre[g + j * x_sn], xim[g + j * x_sn]);
    c[pad(k)] = pre_inv(a, b, make_float2(__ldg(wre + k), __ldg(wim + k)));
    if (k != 0 && 2 * k != m) {
      c[pad(j)] = pre_inv(b, a, make_float2(__ldg(wre + j), __ldg(wim + j)));
    }
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, true>(smem + t * S, th, tpt, plan, twre, twim);

  // o[2j] = Re z[j], o[2j+1] = Im z[j] (the stages ended with a sync)
  for_tile(plan.log2n, T, count, first, 2 * y_sn, y_sb, [&](int t, int j, int64_t g) {
    const float2 z = smem[t * S + pad(j)];
    y[g] = z.x;
    y[g + y_sn] = z.y;
  });
}

// Shared-memory bytes and grid of a launch over `batch` transforms.
struct Grid {
  int S;
  size_t smem;
  unsigned blocks;
};

inline Grid grid_for(const Plan& plan, int64_t batch, int T) {
  const int S = smem_stride(1 << plan.log2n);
  return {S, (size_t)T * S * sizeof(float2), (unsigned)((batch + T - 1) / T)};
}

}  // namespace

extern "C" {

// X = rfft_n(x) for each of `batch` real sequences: element j of sequence b
// sits at j*x_sn + b*x_sb; bin k of the m+1 = n/2+1 at k*y_sn + b*y_sb of
// the planes yre and yim. The m-point forward plan is given as its radices
// and twiddle-pack offsets; wre/wim hold w_n^k, k = 0..m. y must not
// overlap x.
int watfft_rfft_r2c(const float* x, int64_t x_sn, int64_t x_sb,
                    float* yre, float* yim, int64_t y_sn, int64_t y_sb,
                    int n, int64_t batch, const float* twre, const float* twim,
                    const int* radices, const int* twoffsets, int nstages,
                    const float* wre, const float* wim, void* stream) {
  Plan plan;
  int maxr, T;
  if (n < 4 || (n & (n - 1))) return kErrArgs;
  if (const int err = make_plan(n / 2, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  const Grid g = grid_for(plan, batch, T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WATFFT_LAUNCH(P)                                                         \
  rfft_r2c_kernel<P><<<g.blocks, kBlockThreads, g.smem, st>>>(                  \
      x, x_sn, x_sb, yre, yim, y_sn, y_sb, batch, T, g.S, twre, twim, wre, wim, plan)
  switch (maxr) {
    case 2:  WATFFT_LAUNCH(2); break;
    case 4:  WATFFT_LAUNCH(4); break;
    case 8:  WATFFT_LAUNCH(8); break;
    default: WATFFT_LAUNCH(16); break;
  }
#undef WATFFT_LAUNCH
  return (int)cudaGetLastError();
}

// y = irfft_n(X) for each of `batch` spectra of m+1 bins (bin k of spectrum
// b at k*x_sn + b*x_sb of xre and xim), normalized by 1/n; sample j at
// j*y_sn + b*y_sb. The m-point inverse plan (1/m folded into its last
// stage) is given as its radices and twiddle-pack offsets; wre/wim hold
// w_n^-k, k = 0..m-1. y must not overlap X.
int watfft_irfft_c2r(const float* xre, const float* xim, int64_t x_sn, int64_t x_sb,
                     float* y, int64_t y_sn, int64_t y_sb,
                     int n, int64_t batch, const float* twre, const float* twim,
                     const int* radices, const int* twoffsets, int nstages,
                     const float* wre, const float* wim, void* stream) {
  Plan plan;
  int maxr, T;
  if (n < 4 || (n & (n - 1))) return kErrArgs;
  if (const int err = make_plan(n / 2, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  const Grid g = grid_for(plan, batch, T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WATFFT_LAUNCH(P)                                                         \
  irfft_c2r_kernel<P><<<g.blocks, kBlockThreads, g.smem, st>>>(                 \
      xre, xim, x_sn, x_sb, y, y_sn, y_sb, batch, T, g.S, twre, twim, wre, wim, plan)
  switch (maxr) {
    case 2:  WATFFT_LAUNCH(2); break;
    case 4:  WATFFT_LAUNCH(4); break;
    case 8:  WATFFT_LAUNCH(8); break;
    default: WATFFT_LAUNCH(16); break;
  }
#undef WATFFT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
