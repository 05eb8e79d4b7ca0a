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
// transforms, its reads batched in the PAIRS instances, which store
// interleaved complex64 8 bytes a point. The tile opts in past 48 KB of
// shared memory.
//
// The cluster tile (strided_cluster_kernel) replaces that tile where a
// column is so long that it holds one block an SM: at n = 2048 and 4096 a
// column takes 17.4 and 34.8 KB, the tile falls to C = 8 and 4 columns in
// 512 threads (ops/stockham.py `tile_shape`), and the 2D column pass (#11
// as fft2's column pass, the wstack cell's) then reads 32-byte runs of
// interleaved complex64 a row and writes 16-byte runs a plane, while the
// SM's one block loads, runs its stages and stores in turn, its memory
// traffic stopped during the stages (2.52 ms at [8, 4096, 4096], 315 us a
// plane against 80 of bytes). What bounds the pass is memory: 16 bytes a
// point (each point's complex64 read and written once; the twiddle's 32 KB
// table stays in L1 and L2). The cluster spreads one tile of 8 columns over
// K = n / 512 blocks on neighbouring SMs (the portable cluster of 8 at
// 4096, 4 at 2048): block r holds rows r + K*i of the 8 columns, 34 KB, so
// six blocks share an SM and one tile's copies run during other tiles'
// stages and exchanges. Its 256-point FFTs run in its own shared memory;
// the 2K-point DFTs that finish the n-point transform read their inputs
// from the other blocks' shared memory (distributed shared memory, after a
// cluster barrier), so no pass goes through device memory in between; a
// row copied or stored is 64 bytes of complex64, 32 a plane. The host
// takes it (`stockham.cluster_tile`, counted in `strided.cluster_tile`)
// for launches without a multiplier whose two sides walk down columns.
// On the H100 at [8, 4096, 4096] (inverse column pass of ifft2, in turns;
// PERF.md), in ms, against the one-SM tile's 2.41-2.58:
//  * kept: 8 columns, 128 threads, six blocks an SM, two 256-point halves
//    a column: 1.314 (0.160 at [4, 2048, 2048] against 0.201);
//  * one 512-point FFT a column and a K-point exchange: 1.313-1.320, the
//    same (0.165-0.167 at 2048, slower), and not the one-SM tile's bits;
//  * 16 columns in 256 threads, three blocks an SM (68 KB): 1.684 (0.184);
//    the same with the exchange in place by stores into the other blocks'
//    shared memory (XOR partners, a barrier a group of partners) in place
//    of reads: 1.672-1.684 (0.207), and 1.51 at 8 columns;
//  * 8 columns reading two DFTs' inputs a thread at a time: 1.408;
//    4 columns in 64 threads, twelve blocks an SM: 3.00; the tile
//    row-major (a warp's stages across 4 columns, its remote reads 4 whole
//    rows): 1.320 (0.181 at 2048, slower);
//  * a cluster of 16 (non-portable) blocks of one 256-point half each: 1.68
//    at 16 columns, 1.98-3.23 at 32;
//  * what the 16-column design spent (1.684): the stages 0.37 (1.32 without
//    them), the reads of other blocks' shared memory 0.62 (1.07 reading its
//    own), the twiddle's loads nothing (1.69 without them); what the
//    512-point design spends (1.314): the copy 0.34 (0.976 without it),
//    the remote reads 0.15, the stages 0.12, each partly hidden behind the
//    others: the stage engine, not the bytes, is the limit now.
// The copy is cp.async with all of a thread's copies in flight; TMA was not
// built: its box lands the tile's rows row-major and unpadded, where the
// stages walk each column through the engine's padded rows (the row-major
// tile above, which the engine can walk, measured no faster).
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
// watfft_strided_c2c's last three arguments are the column tile C (0:
// none), its block's threads and whether it stores 8 bytes a point;
// watfft_strided_cluster's are the cluster's blocks and whether it copies
// and stores 8 bytes a point; watfft_large_cube's last three are the
// cube's threads and whether it copies and stores 8 bytes a point.

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
//
// PAIRS: the instances the host takes where the store walks down columns
// into interleaved points (`complex_pairs`) from a block of 256 threads:
// pipe2's stage 2 (#13) and the "2d" mode's outer pass into complex64, or
// a 2D column pass launched into it. Each point is one 8-byte store, not
// a store a plane 4 bytes apart; a load that walks along rows (stage 2's,
// the outer pass's) issues kColsLoads reads a thread before their writes
// (load_rows), the twiddle's with the point's; and the register bound of
// the engine's P = 16 (min_blocks: 80 registers) lets three blocks share
// an SM, as the tile's shared memory does (ops/stockham.py `tile_shape`).
// On the H100 at pipe2's [128, 2^20] (PERF.md), #13 took 2.27 ms, 2.21
// with the 8-byte store alone, 1.44 with the batched load besides and
// 1.28 at three blocks: its load, one read a thread in flight, was what
// bounded it. A tile of 16 columns (512 threads, whole 128-byte lines a
// row) and 16-byte stores of two adjacent points measured slower or no
// faster. The arithmetic is the other instances': the load's product is
// theirs written out (cmul_fma), so the outputs are bit for bit the same.

// cmul(a, w) with the contraction nvcc gives it in the load's product of
// the other instances (re: fma(a.x, w.x, -a.y*w.y), im: fma(a.y, w.x,
// a.x*w.y)), fixed, where a batched load takes the product apart from
// the reads.
__device__ __forceinline__ float2 cmul_fma(float2 a, float2 w) {
  return make_float2(__fmaf_rn(a.x, w.x, -__fmul_rn(a.y, w.y)),
                     __fmaf_rn(a.y, w.x, __fmul_rn(a.x, w.y)));
}

template <bool INV, int MUL, bool PAIRS>
__global__ void __launch_bounds__(PAIRS ? kBlockThreads : kColsThreads, PAIRS ? min_blocks(16) : 1)
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
  } else if constexpr (PAIRS) {
    // the point and its multiplier read as they are, the product taken
    // where the point is written to the tile
    load_rows(plan.log2n, T, count, first, x_sn, xb, [&](int t, int k, int64_t g) {
      float4 v = make_float4(xre[g], xim[g], 0.f, 0.f);
      if constexpr (MUL == kMulLoad) {
        const int64_t w = mb(first + t) + (int64_t)k * m_sn;
        v.z = __ldg(pmre + w);
        v.w = __ldg(pmim + w);
      }
      return v;
    }, [&](int t, int k, float4 v) {
      float2 z = make_float2(v.x, v.y);
      if constexpr (MUL == kMulLoad) z = cmul_fma(z, make_float2(v.z, v.w));
      put(t, k, z);
    });
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
    store_point(yre + g, yim + g, z, PAIRS);
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

template <int P, bool INV, int MUL, bool COLS, bool PAIRS = false>
int launch_strided(const float* xre, const float* xim, float* yre, float* yim,
                   int64_t x_sn, Batch2 xb, int64_t y_sn, Batch2 yb,
                   const float* pmre, const float* pmim, int64_t m_sn, Batch2 mb,
                   int64_t batch, const float* twre, const float* twim,
                   const Plan& plan, int T, cudaStream_t stream, int threads) {
  const int S = smem_stride(1 << plan.log2n);
  const size_t smem = (size_t)T * S * sizeof(float2);
  const int64_t blocks = (batch + T - 1) / T;
  auto kernel = strided_c2c_kernel<P, INV, MUL>;
  if constexpr (COLS) kernel = strided_cols_kernel<INV, MUL, PAIRS>;
  if (const int err = opt_in_smem(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      xre, xim, yre, yim, x_sn, xb, y_sn, yb, pmre, pmim, m_sn, mb, batch, T, S, twre, twim,
      plan);
  return 0;
}

template <int P, bool INV, bool COLS = false, bool PAIRS = false>
int launch_mul(int mul, const float* xre, const float* xim, float* yre, float* yim,
               int64_t x_sn, Batch2 xb, int64_t y_sn, Batch2 yb,
               const float* pmre, const float* pmim, int64_t m_sn, Batch2 mb,
               int64_t batch, const float* twre, const float* twim,
               const Plan& plan, int T, cudaStream_t st, int threads = kBlockThreads) {
#define WATFFT_LAUNCH(MUL)                                                                 \
  return launch_strided<P, INV, MUL, COLS, PAIRS>(xre, xim, yre, yim, x_sn, xb, y_sn, yb, \
                                                  pmre, pmim, m_sn, mb, batch, twre, twim, \
                                                  plan, T, st, threads)
  switch (mul) {
    case kMulLoad:  WATFFT_LAUNCH(kMulLoad);
    case kMulStore: WATFFT_LAUNCH(kMulStore);
    default:        WATFFT_LAUNCH(kMulNone);
  }
#undef WATFFT_LAUNCH
}

// The cluster tile: kClusterCols columns of n = 2K * M points (M =
// kClusterFft) held by a cluster of K blocks, block r the rows r + K*i
// (i < 2M) of every column, as two halves: the rows of even and of odd i,
// x[s + 2K*i] for s = r and s = r + K. With X[k1 + M*k2] (k1 < M,
// k2 < 2K), X[k1 + M*k2] = sum_s w_2K^{s*k2} w_n^{s*k1} Y_s[k1], Y_s the
// M-point DFT of x[s + 2K*i] over i: each block runs its halves' M-point
// FFTs in its own shared memory (the engine's stages, 1/M folded into the
// inverse's last), and after the cluster's barrier block r' reads the
// Y_s[k1] of its k1 in [r'*M/K, (r'+1)*M/K) from every block's shared
// memory (Y_s in block s % K, half s / K), multiplies by the twiddle
// T[s, k1] = w_n^{s*k1} (pm, at s*M + k1), runs the 2K-point DFTs (1/2K
// for the inverse) and stores X[k1 + M*k2]. A second barrier keeps every
// block's shared memory until the others have read it. At n = 4096 this is
// the split of the engine's own plan [16, 16, 16], so the outputs are the
// one-SM tile's bit for bit.
constexpr int kClusterFft = 256;
constexpr int kClusterCols = 8;       // 34 KB of shared memory a block
constexpr int kClusterThreads = 128;  // the M-point FFTs of 8 halves at a time
constexpr int kClusterBlocks = 6;     // blocks an SM (its shared memory): 80 registers

// The block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Every thread of the cluster's blocks arrives, then waits for all: what
// each wrote to the cluster's shared memory before is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster-window address of p (in this block's shared memory) in block
// `rank`'s shared memory, and one 8-byte read there.
__device__ __forceinline__ uint32_t cluster_map(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ float2 cluster_load(uint32_t a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

template <bool INV, int K>
__global__ void __launch_bounds__(kClusterThreads, kClusterBlocks)
strided_cluster_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                       float* __restrict__ yre, float* __restrict__ yim,
                       int64_t x_sn, Batch2 xb, int64_t y_sn, Batch2 yb, int64_t batch,
                       bool pairs_x, bool pairs_y,
                       const float* __restrict__ pmre, const float* __restrict__ pmim,
                       const float* __restrict__ twre, const float* __restrict__ twim,
                       Plan plan) {
  extern __shared__ float2 smem[];
  constexpr int C = kClusterCols, M = kClusterFft, R = 2 * K, J = M / K;
  constexpr int H = (M + M / 16) | 1, S = 2 * H;  // a half's slots, a column's
  constexpr int step = kClusterThreads / C;       // rows a pass of the block's threads covers
  const int r = cluster_rank();
  const int64_t first = (int64_t)(blockIdx.x / K) * C;
  const int count = (int)min((int64_t)C, batch - first);
  // thread i takes column i % C, so a warp's copies and stores cover
  // 32 / C rows of C adjacent columns
  const int t = threadIdx.x % C;
  float2* const col = smem + t * S;

  // rows r + K*i of the thread's column (row i at pad(i / 2) of half i % 2),
  // every copy in flight before the wait
  if (t < count) {
    const int64_t g = xb(first + t) + (int64_t)r * x_sn, rs = (int64_t)K * x_sn;
    for (int i = threadIdx.x / C; i < 2 * M; i += step) {
      copy_point(col + (i & 1) * H + pad(i >> 1), xre + g + i * rs, xim + g + i * rs,
                 pairs_x);
    }
  }
  copy_commit();
  copy_wait<0>();
  __syncthreads();

  // the M-point FFTs of the tile's 2C halves, kClusterThreads / (M/16) at a time
  constexpr int tpt = M / 16;
  const int th = threadIdx.x % tpt;
  for (int c = threadIdx.x / tpt; c < 2 * C; c += kClusterThreads / tpt) {
    run_stages<16, INV>(smem + (c >> 1) * S + (c & 1) * H, th, tpt, plan, twre, twim);
  }
  cluster_sync();

  // the 2K-point DFTs of this block's k1, their inputs read from every
  // block's shared memory
  if (t < count) {
    uint32_t part[K];
#pragma unroll
    for (int q = 0; q < K; ++q) part[q] = cluster_map(col, q);
    const int64_t g = yb(first + t);
    for (int k1 = r * J + threadIdx.x / C; k1 < (r + 1) * J; k1 += step) {
      float2 v[R], out[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        v[s] = cluster_load(part[s % K] + ((s / K) * H + pad(k1)) * sizeof(float2));
      }
#pragma unroll
      for (int s = 1; s < R; ++s) {
        v[s] = cmul(v[s], make_float2(__ldg(pmre + s * M + k1), __ldg(pmim + s * M + k1)));
      }
      small_dft<R, 1, INV, float>(v, out);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int64_t o = g + (int64_t)(k1 + s * M) * y_sn;
        store_point(yre + o, yim + o, INV ? cscale(out[s], 1.0f / R) : out[s], pairs_y);
      }
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

constexpr int kMaxDevices = 64;

template <bool INV, int K>
int launch_cluster(const float* xre, const float* xim, float* yre, float* yim,
                   int64_t x_sn, Batch2 xb, int64_t y_sn, Batch2 yb, int64_t batch,
                   bool pairs_x, bool pairs_y, const float* pmre, const float* pmim,
                   const float* twre, const float* twim, const Plan& plan, cudaStream_t stream) {
  const auto kernel = strided_cluster_kernel<INV, K>;
  constexpr int C = kClusterCols;
  constexpr size_t smem = (size_t)C * 2 * ((kClusterFft + kClusterFft / 16) | 1) * sizeof(float2);
  const int64_t blocks = (batch + C - 1) / C * K;
  if (blocks > 0x7fffffff) return kErrArgs;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // once per device and instance: the shared memory's opt-in, and whether
  // a cluster fits the card at all (a launch of none would never run)
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return kErrArgs;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int fit = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (fit < 1) return kErrCluster;
    ready[dev] = true;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, xre, xim, yre, yim, x_sn, xb, y_sn, yb, batch,
                                 pairs_x, pairs_y, pmre, pmim, twre, twim, plan);
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
// (0: 256). pairs: the PAIRS instances (8-byte stores of y), refused
// (kErrPairs) unless the launch takes a column tile of 256 threads whose
// store walks down columns (y_sn over y_sa) into re and im adjacent in
// aligned points (`complex_pairs` on y_sn and y_sa; y_sb even where the
// batch spans more than one outer entry).
int watfft_strided_c2c(const float* xre, const float* xim, float* yre, float* yim,
                       int64_t x_sn, int64_t x_sa, int64_t x_sb,
                       int64_t y_sn, int64_t y_sa, int64_t y_sb,
                       const float* pmre, const float* pmim,
                       int64_t m_sn, int64_t m_sa, int64_t m_sb, int mul,
                       int n, int64_t inner, int64_t batch,
                       const float* twre, const float* twim,
                       const int* radices, const int* twoffsets, int nstages,
                       int inverse, void* stream, int cols, int threads, int pairs) {
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
  if (pairs && (!tiled || NT != kBlockThreads || y_sn <= y_sa ||
                !complex_pairs(yre, yim, y_sn, y_sa) || (batch > inner && y_sb % 2))) {
    return kErrPairs;
  }
  const uint32_t in = (uint32_t)inner;
  const Batch2 xb{x_sa, x_sb, in}, yb{y_sa, y_sb, in}, mb{m_sa, m_sb, in};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (tiled) {  // the column-tile instances: P = 16 (tile_shape checked)
#define WATFFT_LAUNCH(INV, PAIRS)                                                         \
  err = launch_mul<16, INV, true, PAIRS>(mul, xre, xim, yre, yim, x_sn, xb, y_sn, yb, pmre, \
                                         pmim, m_sn, mb, batch, twre, twim, plan, C, st, NT)
    switch ((pairs ? 2 : 0) + (inverse ? 1 : 0)) {
      case 0:  WATFFT_LAUNCH(false, false); break;
      case 1:  WATFFT_LAUNCH(true, false); break;
      case 2:  WATFFT_LAUNCH(false, true); break;
      default: WATFFT_LAUNCH(true, true); break;
    }
#undef WATFFT_LAUNCH
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

// y = DFT_n(x) as watfft_strided_c2c computes it without a multiplier, on
// the cluster tile of `cluster` blocks: n = cluster * 512, cluster 4 or 8,
// both sides walking down columns. pm holds T[s, k1] = w_n^{s*k1} at
// s*256 + k1 (s < 2 * cluster); the plan is the 256-point one, of the
// direction asked for. pairs_x, pairs_y: 8-byte copies of x and stores of
// y, refused (kErrPairs) where re and im are not adjacent in aligned points
// (`complex_pairs` on the point and inner strides; an even outer stride
// where the batch spans more than one outer entry).
int watfft_strided_cluster(const float* xre, const float* xim, float* yre, float* yim,
                           int64_t x_sn, int64_t x_sa, int64_t x_sb,
                           int64_t y_sn, int64_t y_sa, int64_t y_sb,
                           int n, int64_t inner, int64_t batch,
                           const float* pmre, const float* pmim,
                           const float* twre, const float* twim,
                           const int* radices, const int* twoffsets, int nstages,
                           int inverse, void* stream, int cluster, int pairs_x, int pairs_y) {
  Plan plan;
  int maxr, T;
  if (const int err = make_plan(kClusterFft, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  if (inner < 1 || inner > 0x7fffffff || batch > 0x7fffffff) return kErrArgs;
  if ((cluster != 4 && cluster != 8) || n != 2 * cluster * kClusterFft || maxr != 16) {
    return kErrCluster;
  }
  const auto pairs_ok = [&](const float* re, const float* im, int64_t sn, int64_t sa,
                            int64_t sb) {
    return complex_pairs(re, im, sn, sa) && (batch <= inner || sb % 2 == 0);
  };
  if ((pairs_x && !pairs_ok(xre, xim, x_sn, x_sa, x_sb)) ||
      (pairs_y && !pairs_ok(yre, yim, y_sn, y_sa, y_sb))) {
    return kErrPairs;
  }
  const uint32_t in = (uint32_t)inner;
  const Batch2 xb{x_sa, x_sb, in}, yb{y_sa, y_sb, in};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WATFFT_LAUNCH(INV, K)                                                                 \
  return launch_cluster<INV, K>(xre, xim, yre, yim, x_sn, xb, y_sn, yb, batch, pairs_x != 0, \
                                pairs_y != 0, pmre, pmim, twre, twim, plan, st)
  switch ((cluster == 8 ? 2 : 0) + (inverse ? 1 : 0)) {
    case 0:  WATFFT_LAUNCH(false, 4);
    case 1:  WATFFT_LAUNCH(true, 4);
    case 2:  WATFFT_LAUNCH(false, 8);
    default: WATFFT_LAUNCH(true, 8);
  }
#undef WATFFT_LAUNCH
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
