// The Bluestein chirp-z transform's kernels for Hopper (sm_90a), float32:
// any length n as a circular convolution of power-of-two length m >= 2n - 1,
//
//   X = c . IFFT_m(FFT_m(c . x zero-extended to m) . B)[0..n),
//
// with the chirp c and the convolution kernel's spectrum B built on the host
// (watfft_tpu_torch/ops/bluestein.py, chirp_tables).
//
// Replaces, in watfft_tpu/ops/bluestein.py:
//  * _bl_fwd_kernel (#17, bluestein_fwd_kernel): the chirp multiply of the
//    n input rows, the zero extension to m rows, the m-point forward stages
//    and the multiply by B in the store;
//  * _bl_inv_kernel (#18, bluestein_inv_kernel): the m-point inverse stages
//    (1/m folded into the last stage, as in every inverse of the engine),
//    the first n rows kept and multiplied by the final chirp in the store.
//    For the Bluestein inverse the host folds its extra 1/n into that chirp
//    table (bluestein.py:202-206), so no scale is applied here twice;
//  * _bluestein_fused (:192), #17 then #18 through device memory:
//    bluestein_onepass_kernel, the whole transform in one pass, which the
//    fused route launches.
//
// The pair: each is the c2c kernel of stockham.cu with three changes: a
// complex multiply in the load or the store, and a mask on the point index
// k of the tile walk. #17 walks all m points of a transform but reads x
// only for k < n and writes zeros to the rows n..m-1; #18 walks m points
// and stores only k < n. No address past row n-1 of a sequence is ever
// read or written, so x and y may be any strides: the batch-major complex64
// sequences sit 2n floats apart (n odd included), time-major planes 1
// apart. The chirp and B are single columns read through the read-only
// cache with stride 0 over the batch: no tiled copy exists.
//
// What bounds them. The transform moves 16n bytes per sequence (n points
// in, n out) against 10 m log2 m + 6 (2n + m) flop: at n = 1000, m = 2048,
// some 6 flop/B, under the card's FP32 ridge near 20, so bytes bound it.
// The pair moves 8 (n + m) bytes in each kernel, three times the
// transform's; the one-pass kernel moves the transform's alone, since a
// 4096-point transform (34.8 KB) never needs to leave the SM. In practice
// the stage engine bounds all three, not the bytes (PERF.md: at
// [4096, 1000] about 36 us for the load, the two stages that touch device
// memory and the store, about 11 us for each further m-point stage, 13%
// in twiddle loads, 2% in syncs).
//
// The one-pass kernel does the pair's operations in the same order, so its
// output equals theirs bit for bit, with three round trips fewer:
//  * the first forward stage reads its input rows straight from device
//    memory into registers, times the chirp (rows k >= n are zeros, never
//    read; the stage's rows p*q + i are consecutive in i across threads);
//  * the last forward stage writes its outputs times B to shared memory,
//    where the inverse stages read them;
//  * the last inverse stage writes its rows k < n, times the final chirp,
//    straight to device memory (rows i + s*m/R, consecutive in i).
// Interleaved complex64 is read and written 8 bytes a point. Time-major
// planes, whose batch stride is the smaller, keep the pair's tile walks
// along the batch through shared memory. Measured on the H100 and not kept
// (PERF.md): two shared buffers a stage (no sync between a stage's reads
// and writes) with the spectrum handed from the last forward to the first
// inverse stage in registers, 128-register blocks, 128-thread blocks, and
// persistent blocks that prefetch the next tile's rows with cp.async: each
// within 6% of this design at m = 2048, slower elsewhere.
//
// A block holds T = 256 * P / m whole transforms in shared memory (at most
// 4096 points, 34.8 KB, under the 48 KB a launch gets without opting in).
//
// C interface (loaded with ctypes): each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the
// launch, or a negative code (stockham.cuh) for arguments it refuses:
// kErrArgs for n < 1 or n > m, kErrTooLong for m past one block, kErrPlan
// for one-pass plans whose radices differ.

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

// The one-pass transform (#17 then #18 in one kernel, the JAX package's
// _bluestein_fused): the m-point data of each transform stays in shared
// memory from the chirp multiply to the final chirp. ROWS (the point
// stride no larger than the batch stride in x and y: interleaved complex64
// and batch-major planes): the first forward stage reads x and the last
// inverse stage writes y, 8 bytes a point where re and im are adjacent
// (`pairs_x`, `pairs_y`). Otherwise (time-major planes) the tile walks of
// the pair's kernels move the data along the batch. Either way the
// multiply by B is folded into the last forward stage's writes.
template <int P, bool ROWS>
__global__ void __launch_bounds__(kBlockThreads, min_blocks(P))
bluestein_onepass_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                         float* __restrict__ yre, float* __restrict__ yim,
                         int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                         bool pairs_x, bool pairs_y, int n, int64_t batch, int T, int S,
                         const float* __restrict__ cre, const float* __restrict__ cim,
                         const float* __restrict__ bre, const float* __restrict__ bim,
                         const float* __restrict__ fre, const float* __restrict__ fim,
                         const float* __restrict__ ftwre, const float* __restrict__ ftwim,
                         Plan fplan,
                         const float* __restrict__ itwre, const float* __restrict__ itwim,
                         Plan iplan) {
  extern __shared__ float2 smem[];
  const int log2m = fplan.log2n, m = 1 << log2m;
  const int tpt = m / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);
  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  float2* const c = smem + t * S;
  const bool live = t < count;
  const int64_t xo = (first + t) * x_sb, yo = (first + t) * y_sb;

  auto from_c = [&](int k) { return c[pad(k)]; };
  auto to_c = [&](int k, float2 z) { c[pad(k)] = z; };
  auto to_c_b = [&](int k, float2 z) {
    c[pad(k)] = cmul(z, make_float2(__ldg(bre + k), __ldg(bim + k)));
  };
  // x times the chirp at rows k < n, zero past them
  auto from_x = [&](int k) {
    float2 v = make_float2(0.0f, 0.0f);
    if (live && k < n) {
      const int64_t g = xo + (int64_t)k * x_sn;
      const float2 a = pairs_x ? *reinterpret_cast<const float2*>(xre + g)
                               : make_float2(xre[g], xim[g]);
      v = cmul(a, make_float2(__ldg(cre + k), __ldg(cim + k)));
    }
    return v;
  };
  // rows k < n times the final chirp
  auto to_y = [&](int k, float2 z) {
    if (live && k < n) {
      const int64_t g = yo + (int64_t)k * y_sn;
      z = cmul(z, make_float2(__ldg(fre + k), __ldg(fim + k)));
      if (pairs_y) {
        *reinterpret_cast<float2*>(yre + g) = z;
      } else {
        yre[g] = z.x;
        yim[g] = z.y;
      }
    }
  };

  const int ns = fplan.nstages;
  if constexpr (!ROWS) {
    for_tile(log2m, T, count, first, x_sn, x_sb, [&](int t, int k, int64_t g) {
      float2 v = make_float2(0.0f, 0.0f);
      if (k < n) v = cmul(make_float2(xre[g], xim[g]), make_float2(__ldg(cre + k), __ldg(cim + k)));
      smem[t * S + pad(k)] = v;
    });
    __syncthreads();
  }
  // the forward stages; the first reads x (ROWS), the last writes times B
  if (ns == 1) {
    if constexpr (ROWS) stage_at<P, false>(fplan, 0, th, tpt, ftwre, ftwim, false, from_x, to_c_b);
    else stage_at<P, false>(fplan, 0, th, tpt, ftwre, ftwim, true, from_c, to_c_b);
  } else {
    if constexpr (ROWS) stage_at<P, false>(fplan, 0, th, tpt, ftwre, ftwim, false, from_x, to_c);
    else stage_at<P, false>(fplan, 0, th, tpt, ftwre, ftwim, true, from_c, to_c);
    __syncthreads();
    for (int s = 1; s < ns - 1; ++s) {
      stage_at<P, false>(fplan, s, th, tpt, ftwre, ftwim, true, from_c, to_c);
      __syncthreads();
    }
    stage_at<P, false>(fplan, ns - 1, th, tpt, ftwre, ftwim, true, from_c, to_c_b);
  }
  __syncthreads();
  // the inverse stages; the last writes y (ROWS)
  for (int s = 0; s < ns - 1; ++s) {
    stage_at<P, true>(iplan, s, th, tpt, itwre, itwim, true, from_c, to_c);
    __syncthreads();
  }
  if constexpr (ROWS) {
    stage_at<P, true>(iplan, ns - 1, th, tpt, itwre, itwim, false, from_c, to_y);
  } else {
    stage_at<P, true>(iplan, ns - 1, th, tpt, itwre, itwim, true, from_c, to_c);
    __syncthreads();
    for_tile(log2m, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
      if (k < n) {
        const float2 z = cmul(smem[t * S + pad(k)], make_float2(__ldg(fre + k), __ldg(fim + k)));
        yre[g] = z.x;
        yim[g] = z.y;
      }
    });
  }
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

// y = DFT_n(x) for each of `batch` sequences of n points in one pass: the
// function of watfft_bluestein_fwd then watfft_bluestein_inv, with no
// intermediate in device memory. x at k*x_sn + b*x_sb, y at k*y_sn + b*y_sb
// (k < n). cre/cim: the chirp; bre/bim: B; fre/fim: the final chirp (1/n
// folded in for the Bluestein inverse); then the m-point forward plan and
// the m-point inverse plan, whose radices must be the same.
int watfft_bluestein_onepass(const float* xre, const float* xim, float* yre, float* yim,
                             int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                             int n, int m, int64_t batch,
                             const float* cre, const float* cim, const float* bre,
                             const float* bim, const float* fre, const float* fim,
                             const float* ftwre, const float* ftwim, const int* fradices,
                             const int* ftwoffsets, int fnstages,
                             const float* itwre, const float* itwim, const int* iradices,
                             const int* itwoffsets, int instages, void* stream) {
  Plan fplan, iplan;
  int maxr, T, S;
  size_t smem;
  if (const int err = prepare(n, m, batch, fradices, ftwoffsets, fnstages, fplan, maxr, T, S,
                              smem)) {
    return err;
  }
  int imaxr, iT;
  if (const int err = make_plan(m, batch, iradices, itwoffsets, instages, iplan, imaxr, iT)) {
    return err;
  }
  if (instages != fnstages) return kErrPlan;
  for (int s = 0; s < fnstages; ++s) {
    if (iradices[s] != fradices[s]) return kErrPlan;
  }
  // re and im 4 bytes apart in 8-byte aligned points: one 8-byte access
  auto pairs = [](const float* re, const float* im, int64_t sn, int64_t sb) {
    return im == re + 1 && sn % 2 == 0 && sb % 2 == 0 && (uintptr_t)re % 8 == 0;
  };
  const bool rows = x_sn <= x_sb && y_sn <= y_sb;
  const bool px = pairs(xre, xim, x_sn, x_sb), py = pairs(yre, yim, y_sn, y_sb);
  const unsigned blocks = (unsigned)((batch + T - 1) / T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WATFFT_LAUNCH(P, ROWS)                                                               \
  bluestein_onepass_kernel<P, ROWS><<<blocks, kBlockThreads, smem, st>>>(                     \
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, px, py, n, batch, T, S, cre, cim, bre, bim, \
      fre, fim, ftwre, ftwim, fplan, itwre, itwim, iplan)
#define WATFFT_LAUNCH_ROWS(P)         \
  if (rows) {                         \
    WATFFT_LAUNCH(P, true);           \
  } else {                            \
    WATFFT_LAUNCH(P, false);          \
  }
  switch (maxr) {
    case 2:  WATFFT_LAUNCH_ROWS(2); break;
    case 4:  WATFFT_LAUNCH_ROWS(4); break;
    case 8:  WATFFT_LAUNCH_ROWS(8); break;
    default: WATFFT_LAUNCH_ROWS(16); break;
  }
#undef WATFFT_LAUNCH_ROWS
#undef WATFFT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
