// The four-step large-N FFT for Hopper (sm_90a), float32: N = n1 * n2,
// x[j1 + n1*j2] -> X[k1*n2 + k2].
//
// Replaces, in watfft_tpu/ops/:
//  * large.py::_stage1_kernel (#11): the n2-point FFTs down the columns of
//    the [n2, n1] view of each sequence, batched over (j1, s);
//  * large.py::_stage2_kernel (#13): C[k2, j1] times the four-step twiddle
//    T[k2, j1] = w_N^{j1*k2} in the load, the n1-point FFT over j1, and the
//    store of D[k1, k2] at row k1*n2 + k2 (the transpose is only the
//    store's addressing);
//  * pallas_stockham.py::_kernel_postmul (#3): the c2c stages followed by
//    out = y * pm in the store (the "2d" mode's first pass and fft_large);
//  * large.py::_cube_kernel (#12): the whole four-step of one sequence in
//    one block (n2-point pass, twiddle, n1-point pass, one store).
//
// #11, #13, #3 and the "2d" mode's second pass are one kernel,
// `strided_c2c_kernel`: the c2c kernel of stockham.cu with a batch over two
// axes (Batch2: the batch entry b is (b % inner, b / inner), each axis with
// its own stride in x, in y and in the multiplier) and an optional complex
// multiply by pm in the load (MUL = kMulLoad) or the store (kMulStore). The
// multiplier has its own strides, so the four-step twiddle [n2, n1] is read
// with a stride of 0 over the sequences: no tiled copy of it is made (the
// JAX package's _TwCacheTiled exists because Mosaic cannot broadcast a
// column). Each launch has its own counter on the Python side.
//
// What bounds them: like the c2c kernel, memory. Each pass moves 16 bytes
// per point (the multiplier adds 8 more, from L2 while the [n2, n1] table
// fits its 50 MB, i.e. N <= 2^22); the pipe2 and 2d modes make two passes,
// the cube one. The stage engine's rate (PERF.md) is the first limit in
// practice. Where a pass walks down columns (stage 1 and the 2D column
// pass: rows n1 or w points apart; stage 2's transposed store: D[k1, k2]
// along k2, rows n2 apart), the host asks for a column tile, as for the
// time-major c2c layout (stockham.cu): strided_cols_kernel stages C > T
// adjacent columns of the inner batch axis (or of both axes, where the
// outer continues the inner) and reads or writes each row's run of C whole
// (the load by cp.async unless it multiplies); a side whose rows are
// contiguous (stage 2's load) keeps the engine's walk over the same C
// transforms. The tile opts in past 48 KB of shared memory.
//
// The cube holds one whole N <= 2^14 transform in dynamic shared memory
// (N + N/16 float2: 68 KB at 2^13, 136 KB at 2^14, over the 48 KB a launch
// gets by default, so the launch opts in with cudaFuncSetAttribute). Its
// layout is the sequence's own order, point j = j1 + n1*j2 at pad(j): the
// n2-point pass reads column j1 at rows j1 + k*n1 (Strided rows), the
// n1-point pass reads row k2 at k2*n1 + k (contiguous), and the store reads
// D[k1, k2] at k2*n1 + k1. There is no room for a second buffer to
// transpose into, and none is needed. The strided pass's rows are n1 + n1/16
// float2 apart (136 at n1 = 128: 2-way bank conflicts). Every thread runs
// the same number of column groups, so each __syncthreads inside
// run_stages is reached by the whole block: N/16 is a multiple of the
// block's 512 threads for every N >= 8192.
//
// C interface (loaded with ctypes): each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the
// launch, or a negative code (stockham.cuh) for arguments it refuses.
// watfft_strided_c2c's last two arguments are the column tile C (0: none)
// and its block's threads.

#include "stockham.cuh"

namespace {

constexpr int kMulNone = 0, kMulLoad = 1, kMulStore = 2;
constexpr int kCubeThreads = 512;
constexpr int kCubeP = 16;  // threads per transform = n / 16 in both passes

template <int P, bool INV, int MUL>
__global__ void __launch_bounds__(kBlockThreads, min_blocks(P))
strided_c2c_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                   float* __restrict__ yre, float* __restrict__ yim,
                   int64_t x_sn, Batch2 xb, int64_t y_sn, Batch2 yb,
                   const float* __restrict__ pmre, const float* __restrict__ pmim,
                   int64_t m_sn, Batch2 mb, int64_t batch, int T, int S,
                   const float* __restrict__ twre, const float* __restrict__ twim,
                   Plan plan) {
  extern __shared__ float2 smem[];
  const int n = 1 << plan.log2n;
  const int tpt = n / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  for_tile_b(plan.log2n, T, count, first, x_sn, xb, [&](int t, int k, int64_t g) {
    float2 v = make_float2(xre[g], xim[g]);
    if constexpr (MUL == kMulLoad) {
      const int64_t w = mb(first + t) + (int64_t)k * m_sn;
      v = cmul(v, make_float2(__ldg(pmre + w), __ldg(pmim + w)));
    }
    smem[t * S + pad(k)] = v;
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, INV>(smem + t * S, th, tpt, plan, twre, twim);

  for_tile_b(plan.log2n, T, count, first, y_sn, yb, [&](int t, int k, int64_t g) {
    float2 z = smem[t * S + pad(k)];
    if constexpr (MUL == kMulStore) {
      const int64_t w = mb(first + t) + (int64_t)k * m_sn;
      z = cmul(z, make_float2(__ldg(pmre + w), __ldg(pmim + w)));
    }
    yre[g] = z.x;
    yim[g] = z.y;
  });
}

// The column-tile instances (P = 16): T = C columns a block of 256 or 512
// threads, the stages on its groups in turn (see stockham.cu's
// stockham_cols_kernel).
template <bool INV, int MUL>
__global__ void __launch_bounds__(kColsThreads, 1)
strided_cols_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                    float* __restrict__ yre, float* __restrict__ yim,
                    int64_t x_sn, Batch2 xb, int64_t y_sn, Batch2 yb,
                    const float* __restrict__ pmre, const float* __restrict__ pmim,
                    int64_t m_sn, Batch2 mb, int64_t batch, int T, int S,
                    const float* __restrict__ twre, const float* __restrict__ twim,
                    Plan plan) {
  extern __shared__ float2 smem[];
  const int n = 1 << plan.log2n;
  const int tpt = n / 16;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);
  const int log2c = 31 - __clz(T);
  // the multiplier's offset of the thread's column in the column walk
  const int64_t mcol = MUL == kMulNone ? 0 : mb(first + (threadIdx.x & (T - 1)));

  const auto put = [&](int t, int k, float2 v) { smem[t * S + pad(k)] = v; };
  if (MUL != kMulLoad && x_sn > xb.sb) {
    copy_cols(plan.log2n, log2c, count, first, x_sn, xb, xre, xim, smem, S);
  } else if (x_sn > xb.sb) {
    load_cols(plan.log2n, log2c, count, first, x_sn, xb, [&](int k, int64_t g) {
      float2 v = make_float2(xre[g], xim[g]);
      if constexpr (MUL == kMulLoad) {
        const int64_t w = mcol + (int64_t)k * m_sn;
        v = cmul(v, make_float2(__ldg(pmre + w), __ldg(pmim + w)));
      }
      return v;
    }, put);
  } else {
    for_tile_b(plan.log2n, T, count, first, x_sn, xb, [&](int t, int k, int64_t g) {
      float2 v = make_float2(xre[g], xim[g]);
      if constexpr (MUL == kMulLoad) {
        const int64_t w = mb(first + t) + (int64_t)k * m_sn;
        v = cmul(v, make_float2(__ldg(pmre + w), __ldg(pmim + w)));
      }
      put(t, k, v);
    });
  }
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  for (int c = t; c < T; c += blockDim.x / tpt) {
    run_stages<16, INV>(smem + c * S, th, tpt, plan, twre, twim);
  }

  // point k of column t to y at g, times pm at w + k*m_sn for kMulStore
  const auto store = [&](int t, int k, int64_t w, int64_t g) {
    float2 z = smem[t * S + pad(k)];
    if constexpr (MUL == kMulStore) {
      w += (int64_t)k * m_sn;
      z = cmul(z, make_float2(__ldg(pmre + w), __ldg(pmim + w)));
    }
    yre[g] = z.x;
    yim[g] = z.y;
  };
  if (y_sn > yb.sb) {
    for_cols(plan.log2n, log2c, count, first, y_sn, yb,
             [&](int t, int k, int64_t g) { store(t, k, mcol, g); });
  } else {
    for_tile_b(plan.log2n, T, count, first, y_sn, yb, [&](int t, int k, int64_t g) {
      store(t, k, MUL == kMulNone ? 0 : mb(first + t), g);
    });
  }
}

template <int P, bool INV, int MUL, bool COLS>
int launch_strided(const float* xre, const float* xim, float* yre, float* yim,
                   int64_t x_sn, Batch2 xb, int64_t y_sn, Batch2 yb,
                   const float* pmre, const float* pmim, int64_t m_sn, Batch2 mb,
                   int64_t batch, const float* twre, const float* twim,
                   const Plan& plan, int T, cudaStream_t stream, int threads) {
  const int S = smem_stride(1 << plan.log2n);
  const size_t smem = (size_t)T * S * sizeof(float2);
  const int64_t blocks = (batch + T - 1) / T;
  auto kernel = strided_c2c_kernel<P, INV, MUL>;
  if constexpr (COLS) kernel = strided_cols_kernel<INV, MUL>;
  if (const int err = opt_in_smem(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      xre, xim, yre, yim, x_sn, xb, y_sn, yb, pmre, pmim, m_sn, mb, batch, T, S, twre, twim,
      plan);
  return 0;
}

template <int P, bool INV, bool COLS = false>
int launch_mul(int mul, const float* xre, const float* xim, float* yre, float* yim,
               int64_t x_sn, Batch2 xb, int64_t y_sn, Batch2 yb,
               const float* pmre, const float* pmim, int64_t m_sn, Batch2 mb,
               int64_t batch, const float* twre, const float* twim,
               const Plan& plan, int T, cudaStream_t st, int threads = kBlockThreads) {
#define WATFFT_LAUNCH(MUL)                                                                  \
  return launch_strided<P, INV, MUL, COLS>(xre, xim, yre, yim, x_sn, xb, y_sn, yb, pmre,   \
                                           pmim, m_sn, mb, batch, twre, twim, plan, T, st, \
                                           threads)
  switch (mul) {
    case kMulLoad:  WATFFT_LAUNCH(kMulLoad);
    case kMulStore: WATFFT_LAUNCH(kMulStore);
    default:        WATFFT_LAUNCH(kMulNone);
  }
#undef WATFFT_LAUNCH
}

// One block per sequence s: the four-step of N = n1*n2 points (p1: the
// n2-point plan, p2: the n1-point plan) with the twiddle pm [n2, n1].
template <bool INV>
__global__ void __launch_bounds__(kCubeThreads, 1)
cube_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
            float* __restrict__ yre, float* __restrict__ yim,
            int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
            const float* __restrict__ pmre, const float* __restrict__ pmim,
            const float* __restrict__ t1re, const float* __restrict__ t1im, Plan p1,
            const float* __restrict__ t2re, const float* __restrict__ t2im, Plan p2) {
  extern __shared__ float2 smem[];
  const int log2n1 = p2.log2n, log2n2 = p1.log2n;
  const int n1 = 1 << log2n1, n2 = 1 << log2n2, nn = n1 * n2;
  const int64_t xs = (int64_t)blockIdx.x * x_sb, ys = (int64_t)blockIdx.x * y_sb;

  // point j = j1 + n1*j2 to pad(j): row j2, column j1 of the [n2, n1] block
  for (int j = threadIdx.x; j < nn; j += blockDim.x) {
    const int64_t g = xs + (int64_t)j * x_sn;
    smem[pad(j)] = make_float2(xre[g], xim[g]);
  }
  __syncthreads();

  // n2-point FFTs down the n1 columns, `per` columns at a time
  {
    const int tpt = n2 / kCubeP, per = kCubeThreads / tpt;
    const int c0 = threadIdx.x / tpt, th = threadIdx.x - c0 * tpt;
    for (int c = c0; c < n1; c += per) {
      run_stages<kCubeP, INV>(smem, th, tpt, p1, t1re, t1im, Strided{c, log2n1});
    }
  }

  // C[k2, j1] *= T[k2, j1]
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = pad(e);
    smem[i] = cmul(smem[i], make_float2(__ldg(pmre + e), __ldg(pmim + e)));
  }
  __syncthreads();

  // n1-point FFTs along the n2 rows
  {
    const int tpt = n1 / kCubeP, per = kCubeThreads / tpt;
    const int r0 = threadIdx.x / tpt, th = threadIdx.x - r0 * tpt;
    for (int r = r0; r < n2; r += per) {
      run_stages<kCubeP, INV>(smem + pad(r << log2n1), th, tpt, p2, t2re, t2im);
    }
  }

  // D[k1, k2] (at k2*n1 + k1) to output row k1*n2 + k2
  for (int q = threadIdx.x; q < nn; q += blockDim.x) {
    const int k1 = q >> log2n2, k2 = q & (n2 - 1);
    const float2 z = smem[pad((k2 << log2n1) + k1)];
    const int64_t g = ys + (int64_t)q * y_sn;
    yre[g] = z.x;
    yim[g] = z.y;
  }
}

}  // namespace

extern "C" {

// y = DFT_n(x), then y *= pm (mul = 2), or DFT_n(x * pm) (mul = 1), for
// each of `batch` sequences. Batch entry b is (i, o) = (b % inner,
// b / inner); element (k, i, o) of x sits at k*x_sn + i*x_sa + o*x_sb floats
// past xre and xim (y and pm likewise; pm is read only when mul != 0). y
// must not overlap x. The plan is given as its radices and twiddle-pack
// offsets, stage by stage. cols: the column tile C over the inner axis, a
// power of two >= T (0: the engine's T); threads: its block, 256 or 512
// (0: 256).
int watfft_strided_c2c(const float* xre, const float* xim, float* yre, float* yim,
                       int64_t x_sn, int64_t x_sa, int64_t x_sb,
                       int64_t y_sn, int64_t y_sa, int64_t y_sb,
                       const float* pmre, const float* pmim,
                       int64_t m_sn, int64_t m_sa, int64_t m_sb, int mul,
                       int n, int64_t inner, int64_t batch,
                       const float* twre, const float* twim,
                       const int* radices, const int* twoffsets, int nstages,
                       int inverse, void* stream, int cols, int threads) {
  Plan plan;
  int maxr, T, C, NT;
  bool tiled;
  if (const int err = make_plan(n, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  if (inner < 1 || inner > 0x7fffffff || batch > 0x7fffffff || mul < kMulNone ||
      mul > kMulStore) {
    return kErrArgs;
  }
  if (const int err = tile_shape(cols, threads, n, maxr, T, batch, sizeof(float2), C, NT,
                                 tiled)) {
    return err;
  }
  const uint32_t in = (uint32_t)inner;
  const Batch2 xb{x_sa, x_sb, in}, yb{y_sa, y_sb, in}, mb{m_sa, m_sb, in};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (tiled) {  // the column-tile instances: P = 16 (tile_shape checked)
    err = inverse ? launch_mul<16, true, true>(mul, xre, xim, yre, yim, x_sn, xb, y_sn, yb,
                                               pmre, pmim, m_sn, mb, batch, twre, twim, plan,
                                               C, st, NT)
                  : launch_mul<16, false, true>(mul, xre, xim, yre, yim, x_sn, xb, y_sn, yb,
                                                pmre, pmim, m_sn, mb, batch, twre, twim, plan,
                                                C, st, NT);
    return err ? err : (int)cudaGetLastError();
  }
#define WATFFT_LAUNCH(P, INV)                                                                 \
  err = launch_mul<P, INV>(mul, xre, xim, yre, yim, x_sn, xb, y_sn, yb, pmre, pmim, m_sn, mb, \
                           batch, twre, twim, plan, T, st)
  switch (maxr * 2 + (inverse ? 1 : 0)) {
    case 4:  WATFFT_LAUNCH(2, false); break;
    case 5:  WATFFT_LAUNCH(2, true); break;
    case 8:  WATFFT_LAUNCH(4, false); break;
    case 9:  WATFFT_LAUNCH(4, true); break;
    case 16: WATFFT_LAUNCH(8, false); break;
    case 17: WATFFT_LAUNCH(8, true); break;
    case 32: WATFFT_LAUNCH(16, false); break;
    default: WATFFT_LAUNCH(16, true); break;
  }
#undef WATFFT_LAUNCH
  return err ? err : (int)cudaGetLastError();
}

// y = DFT_N(x) by the four-step in one block per sequence, N = n1*n2:
// point j of sequence s at j*x_sn + s*x_sb floats past xre and xim, output
// row r at r*y_sn + s*y_sb. pm holds T[k2, j1] at k2*n1 + j1. The n2-point
// plan (p1: radices, offsets, count, twiddle pack t1) and the n1-point plan
// (p2, t2) are of the direction asked for.
int watfft_large_cube(const float* xre, const float* xim, float* yre, float* yim,
                      int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                      int n1, int n2, int64_t batch,
                      const float* pmre, const float* pmim,
                      const float* t1re, const float* t1im,
                      const int* r1, const int* o1, int ns1,
                      const float* t2re, const float* t2im,
                      const int* r2, const int* o2, int ns2,
                      int inverse, void* stream) {
  Plan p1, p2;
  int maxr, T;
  if (const int err = make_plan(n2, 1, r1, o1, ns1, p1, maxr, T)) return err;
  if (const int err = make_plan(n1, 1, r2, o2, ns2, p2, maxr, T)) return err;
  if (batch < 1 || batch > 0x7fffffff) return kErrArgs;
  const int64_t nn = (int64_t)n1 * n2;
  if (n1 < kCubeP || n2 < kCubeP || nn < kCubeThreads * kCubeP) return kErrSplit;
  const size_t smem = (size_t)(nn + nn / 16) * sizeof(float2);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return kErrSplit;
  auto kernel = inverse ? cube_kernel<true> : cube_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)batch, kCubeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, pmre, pmim, t1re, t1im, p1, t2re, t2im, p2);
  return (int)cudaGetLastError();
}

}  // extern "C"
