// The Bluestein chirp-z transform's two kernels for Hopper (sm_90a),
// float32: any length n as a circular convolution of power-of-two length
// m >= 2n - 1,
//
//   X = c . IFFT_m(FFT_m(c . x zero-extended to m) . B)[0..n),
//
// with the chirp c and the convolution kernel's spectrum B built on the host
// (watfft_tpu_torch/ops/bluestein.py, chirp_tables).
//
// Replaces, in watfft_tpu/ops/bluestein.py:
//  * _bl_fwd_kernel (#17): the chirp multiply of the n input rows, the
//    zero extension to m rows, the m-point forward stages and the multiply
//    by B in the store;
//  * _bl_inv_kernel (#18): the m-point inverse stages (1/m folded into the
//    last stage, as in every inverse of the engine), the first n rows kept
//    and multiplied by the final chirp in the store. For the Bluestein
//    inverse the host folds its extra 1/n into that chirp table
//    (bluestein.py:202-206), so no scale is applied here twice.
//
// Each is the c2c kernel of stockham.cu with three changes: a complex
// multiply in the load or the store, and a mask on the point index k of the
// tile walk. #17 walks all m points of a transform but reads x only for
// k < n and writes zeros to the rows n..m-1; #18 walks m points and stores
// only k < n. No address past row n-1 of a sequence is ever read or
// written, so x and y may be any strides: the batch-major complex64
// sequences sit 2n floats apart (n odd included), time-major planes 1 apart.
// The chirp and B are single columns read through the read-only cache with
// stride 0 over the batch: no tiled copy exists.
//
// What bounds them: memory, like the c2c kernel. #17 reads 8n and writes
// 8m bytes per transform, #18 reads 8m and writes 8n, against about
// 5 m log2 m + 6 (n + m) flop: at n = 1000, m = 2048, some 4 flop/B, far
// under the card's FP32 ridge near 20. The wrapper keeps the m-point
// intermediate batch-major, [batch, m] planes, so #17's store and #18's
// load coalesce whatever the caller's layout. The stage engine's rate
// (PERF.md) is the first limit in practice.
//
// A block holds T = 256 * P / m whole transforms in shared memory (at most
// 4096 points, 34.8 KB, under the 48 KB a launch gets without opting in).
//
// C interface (loaded with ctypes): each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the
// launch, or a negative code (stockham.cuh) for arguments it refuses:
// kErrArgs for n < 1 or n > m, kErrTooLong for m past one block.

#include "stockham.cuh"

namespace {

template <int P>
__global__ void __launch_bounds__(kBlockThreads, min_blocks(P))
bluestein_fwd_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                     float* __restrict__ yre, float* __restrict__ yim,
                     int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                     int n, int64_t batch, int T, int S,
                     const float* __restrict__ cre, const float* __restrict__ cim,
                     const float* __restrict__ bre, const float* __restrict__ bim,
                     const float* __restrict__ twre, const float* __restrict__ twim,
                     Plan plan) {
  extern __shared__ float2 smem[];
  const int tpt = (1 << plan.log2n) / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  // rows k < n: x times the chirp; rows n..m-1: zero, nothing read
  for_tile(plan.log2n, T, count, first, x_sn, x_sb, [&](int t, int k, int64_t g) {
    float2 v = make_float2(0.0f, 0.0f);
    if (k < n) v = cmul(make_float2(xre[g], xim[g]), make_float2(__ldg(cre + k), __ldg(cim + k)));
    smem[t * S + pad(k)] = v;
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, false>(smem + t * S, th, tpt, plan, twre, twim);

  // every row of the spectrum, times B
  for_tile(plan.log2n, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
    const float2 z = cmul(smem[t * S + pad(k)], make_float2(__ldg(bre + k), __ldg(bim + k)));
    yre[g] = z.x;
    yim[g] = z.y;
  });
}

template <int P>
__global__ void __launch_bounds__(kBlockThreads, min_blocks(P))
bluestein_inv_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                     float* __restrict__ yre, float* __restrict__ yim,
                     int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                     int n, int64_t batch, int T, int S,
                     const float* __restrict__ cre, const float* __restrict__ cim,
                     const float* __restrict__ twre, const float* __restrict__ twim,
                     Plan plan) {
  extern __shared__ float2 smem[];
  const int tpt = (1 << plan.log2n) / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  for_tile(plan.log2n, T, count, first, x_sn, x_sb, [&](int t, int k, int64_t g) {
    smem[t * S + pad(k)] = make_float2(xre[g], xim[g]);
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, true>(smem + t * S, th, tpt, plan, twre, twim);

  // the first n rows only, times the final chirp
  for_tile(plan.log2n, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
    if (k < n) {
      const float2 z = cmul(smem[t * S + pad(k)], make_float2(__ldg(cre + k), __ldg(cim + k)));
      yre[g] = z.x;
      yim[g] = z.y;
    }
  });
}

// Checks n against m and the m-point plan; fills plan, maxr, T and the
// shared memory per block. Returns 0 or a kErr code.
int prepare(int n, int m, int64_t batch, const int* radices, const int* twoffsets, int nstages,
            Plan& plan, int& maxr, int& T, int& S, size_t& smem) {
  if (n < 1 || n > m) return kErrArgs;
  if (const int err = make_plan(m, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  S = smem_stride(m);
  smem = (size_t)T * S * sizeof(float2);
  return 0;
}

}  // namespace

extern "C" {

// y = FFT_m(c . x, zero-extended to m rows) . B for each of `batch`
// sequences of n points; element (k, b) of x sits at k*x_sn + b*x_sb
// (k < n), of y at k*y_sn + b*y_sb (k < m). cre/cim: the chirp, n values;
// bre/bim: B, m values; the plan is the m-point forward one.
int watfft_bluestein_fwd(const float* xre, const float* xim, float* yre, float* yim,
                         int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                         int n, int m, int64_t batch,
                         const float* cre, const float* cim, const float* bre, const float* bim,
                         const float* twre, const float* twim, const int* radices,
                         const int* twoffsets, int nstages, void* stream) {
  Plan plan;
  int maxr, T, S;
  size_t smem;
  if (const int err = prepare(n, m, batch, radices, twoffsets, nstages, plan, maxr, T, S, smem)) {
    return err;
  }
  const unsigned blocks = (unsigned)((batch + T - 1) / T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WATFFT_LAUNCH(P)                                                                    \
  bluestein_fwd_kernel<P><<<blocks, kBlockThreads, smem, st>>>(                              \
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, T, S, cre, cim, bre, bim, twre, \
      twim, plan)
  switch (maxr) {
    case 2:  WATFFT_LAUNCH(2); break;
    case 4:  WATFFT_LAUNCH(4); break;
    case 8:  WATFFT_LAUNCH(8); break;
    default: WATFFT_LAUNCH(16); break;
  }
#undef WATFFT_LAUNCH
  return (int)cudaGetLastError();
}

// y[k] = IFFT_m(x)[k] . c[k] for k < n, for each of `batch` sequences of m
// points; x at k*x_sn + b*x_sb (k < m), y at k*y_sn + b*y_sb (k < n).
// cre/cim: the final chirp, n values (1/n folded in by the host for the
// Bluestein inverse); the plan is the m-point inverse one (1/m folded in).
int watfft_bluestein_inv(const float* xre, const float* xim, float* yre, float* yim,
                         int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                         int n, int m, int64_t batch, const float* cre, const float* cim,
                         const float* twre, const float* twim, const int* radices,
                         const int* twoffsets, int nstages, void* stream) {
  Plan plan;
  int maxr, T, S;
  size_t smem;
  if (const int err = prepare(n, m, batch, radices, twoffsets, nstages, plan, maxr, T, S, smem)) {
    return err;
  }
  const unsigned blocks = (unsigned)((batch + T - 1) / T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WATFFT_LAUNCH(P)                                                                     \
  bluestein_inv_kernel<P><<<blocks, kBlockThreads, smem, st>>>(                               \
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, T, S, cre, cim, twre, twim, plan)
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
