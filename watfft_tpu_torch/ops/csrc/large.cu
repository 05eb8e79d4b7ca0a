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
//    one block (n2-point pass, twiddle, n1-point pass, one store):
//    cube_kernel.
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
// n2-point pass reads column j1 at rows j1 + k*n1 (Strided rows) and the
// n1-point pass row k2 at k2*n1 + k. What bounded the first cube (one
// block a sequence: 356 us at [2048, 8192] against 80 us of bytes) was
// that a block ran load, passes and store in turn with its SM's memory
// idle between, the load one scalar read at a time. cube_kernel<INV, NT>
// keeps the arithmetic and changes the walk (PERF.md has each step's time
// on the H100: 167 us at [2048, 8192]):
//  * blocks of 256 threads at N = 8192, two an SM (what the SM's shared
//    memory holds), and of 512 at 16384, one a sequence. A second buffer,
//    so the next sequence lands during the passes, fits only one block of
//    512 at 8192 and measured slower than two blocks of one buffer, and
//    resident blocks looping over sequences slower than a block a
//    sequence: neither is kept;
//  * the sequence lands by cp.async, all of a thread's copies in flight at
//    once, 8 bytes a point where re and im are adjacent;
//  * the column pass runs the column fastest across a warp (rows n1 + n1/16
//    slots apart put a warp's threads of one column on the same banks);
//  * the twiddle T multiplies each point in the row pass's first stage
//    (l = 1, which has no twiddle of its own), as the load of stage 2
//    (#13) does: the same product, without a pass over shared memory and
//    its sync;
//  * the row pass's last stage writes D[k1, k2] straight to output row
//    k1*n2 + k2, its threads mapped so a warp covers 8 adjacent rows k2:
//    each store instruction writes runs of 8 points (64 bytes interleaved,
//    32 a plane). A transposed read of shared memory before a coalesced
//    store, or a last stage mapped like the others, measured slower.
// Every thread runs the same number of column and row groups (N/16 is a
// multiple of the block's threads for every N >= 8192), so each
// __syncthreads is reached by the whole block.

// C interface (loaded with ctypes): each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the
// launch, or a negative code (stockham.cuh) for arguments it refuses.
// watfft_strided_c2c's last two arguments are the column tile C (0: none)
// and its block's threads; watfft_large_cube's last three are the cube's
// threads and whether it copies and stores 8 bytes a point.

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

// The cube (#12): the whole four-step of N = n1*n2 points of sequence
// blockIdx.x in one block (p1: the n2-point plan, p2: the n1-point plan,
// pm: the twiddle T[k2, j1] at k2*n1 + j1). The sequence lands by
// cp.async, 8 bytes a point where the host asks for pairs (`pairs_x`: re
// and im adjacent in 8-byte aligned points, as in interleaved complex64 and
// the real route's even and odd rows), else 4 bytes per plane; the output
// is stored 8 bytes a point where it asks for them (`pairs_y`). NT threads
// a block: 256 at two blocks an SM or 512 at one, 128 registers a thread
// either way.
constexpr int cube_min_blocks(int NT) { return NT == kCubeThreads ? 1 : 2; }
constexpr int kCubeStoreRows = 8;  // rows a warp's stores of the last row stage cover

// The sequence at xs (point j at xs + j*x_sn) into c by cp.async, point
// j = j1 + n1*j2 at pad(j); ends with the thread's wait.
__device__ __forceinline__ void cube_copy(float2* c, const float* __restrict__ xre,
                                          const float* __restrict__ xim, int64_t xs,
                                          int64_t x_sn, int nn, bool pairs) {
  if (pairs) {
    for (int j = threadIdx.x; j < nn; j += blockDim.x) {
      copy_async<8>(c + pad(j), xre + xs + (int64_t)j * x_sn);
    }
  } else {
    for (int j = threadIdx.x; j < nn; j += blockDim.x) {
      const int64_t g = xs + (int64_t)j * x_sn;
      float* d = reinterpret_cast<float*>(c + pad(j));
      copy_async<4>(d, xre + g);
      copy_async<4>(d + 1, xim + g);
    }
  }
  copy_commit();
  copy_wait<0>();
}

template <bool INV, int NT>
__global__ void __launch_bounds__(NT, cube_min_blocks(NT))
cube_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
            float* __restrict__ yre, float* __restrict__ yim,
            int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb, bool pairs_x, bool pairs_y,
            const float* __restrict__ pmre, const float* __restrict__ pmim,
            const float* __restrict__ t1re, const float* __restrict__ t1im, Plan p1,
            const float* __restrict__ t2re, const float* __restrict__ t2im, Plan p2) {
  extern __shared__ float2 c[];
  const int log2n1 = p2.log2n, log2n2 = p1.log2n;
  const int n1 = 1 << log2n1, n2 = 1 << log2n2, nn = n1 * n2;
  // The n2-point pass: ctpt threads a column, cper columns at a time, the
  // column fastest across a warp (rows n1 + n1/16 slots apart would put a
  // warp's threads of one column on the same banks).
  const int ctpt = n2 / kCubeP, cper = NT / ctpt;
  const int c0 = threadIdx.x % cper, cth = threadIdx.x / cper;
  // The n1-point pass, rper rows at a time: its stages in shared memory with
  // the thread's point of its row fastest (r0, rth); its last stage, which
  // stores, with groups of g adjacent rows fastest (s0, sth), so a warp's
  // stores fill runs of g points of the output.
  const int rtpt = n1 / kCubeP, rper = NT / rtpt;
  const int r0 = threadIdx.x / rtpt, rth = threadIdx.x - r0 * rtpt;
  const int g = min(kCubeStoreRows, rper);
  const int s0 = threadIdx.x % g + threadIdx.x / (g * rtpt) * g;
  const int sth = threadIdx.x / g % rtpt;
  const int last = p2.nstages - 1;

  const int64_t s = blockIdx.x;
  cube_copy(c, xre, xim, s * x_sb, x_sn, nn, pairs_x);
  __syncthreads();

  // n2-point FFTs down the n1 columns (row j2, column j1 at pad(j1 + n1*j2))
  for (int col = c0; col < n1; col += cper) {
    run_stages<kCubeP, INV>(c, cth, ctpt, p1, t1re, t1im, Strided{col, log2n1});
  }

  // n1-point FFTs along the n2 rows: the first stage reads C[k2, j1] times
  // T[k2, j1] (l = 1, which has no twiddle of its own), the last writes
  // D[k1, k2] straight to output row k1*n2 + k2
  const int64_t ys = s * y_sb;
  for (int base = 0; base < n2; base += rper) {
    const auto row_of = [&](int r) { return c + pad(r << log2n1); };
    float2* const row = row_of(base + r0);
    const float* const wre = pmre + ((base + r0) << log2n1);
    const float* const wim = pmim + ((base + r0) << log2n1);
    const auto twiddled = [&](int k) {
      return cmul(row[pad(k)], make_float2(__ldg(wre + k), __ldg(wim + k)));
    };
    const auto from_row = [&](int k) { return row[pad(k)]; };
    const auto to_row = [&](int k, float2 z) { row[pad(k)] = z; };
    const int k2 = base + s0;
    const float2* const srow = row_of(k2);
    const auto from_srow = [&](int k) { return srow[pad(k)]; };
    const auto to_y = [&](int k1, float2 z) {
      const int64_t o = ys + (int64_t)((k1 << log2n2) + k2) * y_sn;
      if (pairs_y) {
        *reinterpret_cast<float2*>(yre + o) = z;
      } else {
        yre[o] = z.x;
        yim[o] = z.y;
      }
    };
    if (last == 0) {
      // one stage: the twiddled load and the store in one thread mapping
      const float* const swre = pmre + (k2 << log2n1);
      const float* const swim = pmim + (k2 << log2n1);
      stage_at<kCubeP, INV>(p2, 0, sth, rtpt, t2re, t2im, false, [&](int k) {
        return cmul(srow[pad(k)], make_float2(__ldg(swre + k), __ldg(swim + k)));
      }, to_y);
    } else {
      stage_at<kCubeP, INV>(p2, 0, rth, rtpt, t2re, t2im, true, twiddled, to_row);
      __syncthreads();
      for (int st = 1; st < last; ++st) {
        stage_at<kCubeP, INV>(p2, st, rth, rtpt, t2re, t2im, true, from_row, to_row);
        __syncthreads();
      }
      stage_at<kCubeP, INV>(p2, last, sth, rtpt, t2re, t2im, false, from_srow, to_y);
    }
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
// (p2, t2) are of the direction asked for. threads: the block, 256 or 512
// (kErrCube otherwise); pairs_x, pairs_y: 8-byte copies of the input and
// stores of the output, refused (kErrPairs) where re and im are not
// adjacent in 8-byte aligned points.
int watfft_large_cube(const float* xre, const float* xim, float* yre, float* yim,
                      int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                      int n1, int n2, int64_t batch,
                      const float* pmre, const float* pmim,
                      const float* t1re, const float* t1im,
                      const int* r1, const int* o1, int ns1,
                      const float* t2re, const float* t2im,
                      const int* r2, const int* o2, int ns2,
                      int inverse, void* stream, int threads, int pairs_x, int pairs_y) {
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
  if (threads != kCubeThreads && threads != kCubeThreads / 2) return kErrCube;
  if ((pairs_x && !complex_pairs(xre, xim, x_sn, x_sb)) ||
      (pairs_y && !complex_pairs(yre, yim, y_sn, y_sb))) {
    return kErrPairs;
  }
  auto kernel = threads == kCubeThreads
                    ? (inverse ? cube_kernel<true, kCubeThreads> : cube_kernel<false, kCubeThreads>)
                    : (inverse ? cube_kernel<true, kCubeThreads / 2>
                               : cube_kernel<false, kCubeThreads / 2>);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, pairs_x != 0, pairs_y != 0, pmre, pmim, t1re,
      t1im, p1, t2re, t2im, p2);
  return (int)cudaGetLastError();
}

}  // extern "C"
