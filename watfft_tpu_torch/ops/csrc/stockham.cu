// Batched mixed-radix Stockham c2c FFT for Hopper (sm_90a), float32,
// float64 and the two bf16 tiers.
//
// Replaces watfft_tpu/ops/pallas_stockham.py::_kernel (the [n, b] plane
// kernel) and ::_kernel_dma3d (the same transform on the [n, 8, W] view);
// its FP64 instance replaces watfft_tpu/ops/doublefloat.py::_df_kernel,
// the f64 tier, which the TPU computes on hi/lo f32 pairs with error-free
// arithmetic for want of f64 units. Hopper has FP64 units, so the f64 tier
// is the same engine on double2, with the same plan, twiddle layout and
// 1/n fold; none of the hi/lo machinery is ported. Its two bf16 instances
// are #1's bf16 tiers (pallas_stockham.py:_kernel on bf16 planes): the
// interop tier keeps bf16 planes in device memory around the f32 stages
// (loads widen, stores round to nearest; the tables and shared memory stay
// f32), and the compute tier runs the engine itself on __nv_bfloat16 with
// a bf16 twiddle pack, 4 bytes a point in shared memory. Either moves 8
// bytes a point, half the f32 kernel's.
// Both compute the n-point DFT of each of B sequences, forward (w = e^-i)
// or inverse (w = e^+i, 1/n folded into the last stage), with the stage
// plan and the packed twiddle columns that watfft_tpu_torch/ops/stockham.py
// builds on the host. The TPU layouts become strides: each of the re and im
// pointers has an element stride along n and one along the batch, so one
// kernel serves interleaved complex64 (stride 2, im = re + 1), split planes
// (stride 1), batch-major [B, n] and time-major [n, B] (which covers the
// free [n, 8, W] view).
//
// What bounds it: 16 bytes of device memory per point (8 read, 8 written)
// against about 5*log2(n) flop per point, about 3 flop/B at n=1024 — far
// under the FP32 ridge of the card (67 TFLOP/s over 3.35 TB/s, ~20 flop/B).
// The kernel is memory-bound, so the design keeps every stage on chip: one
// thread block holds T whole transforms in shared memory, the data is read
// once and written once, and all stages run between the two.
//
// Design:
//  * Block shape. Each thread owns P points per stage (P = the plan's
//    largest radix), i.e. P/R radix-R butterflies of every stage, so a
//    transform takes n/P threads and a block of 256 threads holds
//    T = 256*P/n transforms. At n=4096 one transform of 32 KB fills a
//    block; at n <= 16 a block holds 256 transforms.
//  * Stages in place. A thread loads its butterflies' inputs from shared
//    memory into registers and applies the twiddles; the block syncs; it
//    runs the radix-2 network of _small_dft in registers and writes the
//    outputs to their interleaved Stockham rows; the block syncs again.
//    One buffer instead of a ping-pong pair keeps shared memory under the
//    48 KB a launch gets without cudaFuncSetAttribute: T * n <= 256 * 16
//    points of ~1.06 float2 each, at most 34.8 KB.
//  * Bank conflicts. Row k of a transform sits at k + k/16, and transforms
//    sit an odd number of float2 apart, so the stride-R writes of the l=1
//    stage and the one-transform-per-thread loops at small n do not pile
//    up on one bank.
//  * Global access. Loads and stores walk the tile along whichever of the
//    two strides is smaller, so neighbouring threads touch neighbouring
//    addresses in batch-major layouts and, where T allows, in time-major.
//    Where it does not (time-major planes at n >= 1024: T <= 4 columns, 4-16
//    bytes of each 32-byte sector), the host asks for a column tile, and
//    takes it at every n >= 16 of a walk down columns, where it measured
//    faster too: a block of stockham_cols_kernel stages C > T adjacent
//    transforms (ops/stockham.py `tile_shape`: the widest tile that leaves
//    room for three blocks an SM, in 256 threads, where its rows fill a
//    sector, else the widest the opt-in shared memory holds, 139 KB, in 512
//    threads), reads each row's run of C columns whole (cp.async straight
//    into shared memory where the planes hold the stages' scalar, batched
//    register loads for bf16 planes), and runs the stages on its groups of
//    transforms in turn. Each transform's operations are the engine's, so
//    the outputs do not change; the instances without the tile compile to
//    what they did before it.
//  * The batch-major walk redesigned (stockham_c2c_resident_kernel, f32 and
//    FP64). The engine's walk holds an f32 P = 16 thread to 80 registers
//    (three blocks an SM; ~100 bytes of spills), loads and stores one scalar
//    at a time, and leaves memory idle while a block runs its stages. Where
//    both sides walk along their rows and no column tile is asked for, the
//    host takes the redesigned kernel: 256 threads at 128 registers (no f32
//    spill; FP64 P = 16 spills 80 bytes, as its engine instance does 64-72),
//    tiles copied by cp.async straight into their padded slots, one copy and
//    one store a point where re and im are adjacent (complex64, complex128,
//    the real core's even and odd rows), and each transform's stages
//    exactly as the engine runs them, so the outputs do not change. Resident
//    blocks, two an SM, each with a second buffer for its next tile, on f32
//    past n = 4; a block a tile on FP64 (two buffers of a P = 16 tile would
//    leave one block an SM) and on f32 at n <= 4 (ops/stockham.py
//    `c2c_walk`; PERF.md has the times). The stockham_c2c_kernel instances
//    keep their text, and with it their registers; they serve the bf16
//    planes and the layouts where a side walks down columns without a tile.
//  * Twiddles come from the packed table through the read-only cache; the
//    largest pack (n=4096) is 2 x 7680 floats and stays in L2.
//  * Constants of the radix-2 network are the f32 roundings of the f64
//    values the JAX kernel uses (the f64 values themselves in the FP64
//    instance), and the w = -+i shortcut and the 1/n fold follow
//    pallas_stockham.py:_small_dft and :_stage.
//  * FP64. A point takes 16 bytes, so a P = 16 block holds 69.6 KB and
//    the launch opts in past the 48 KB default (cudaFuncSetAttribute), as
//    the four-step cube does. Capping the FP64 plan at radix 8 would halve
//    the block but not reach n = 4096: one transform of 4096 points at 8
//    per thread needs 512 threads, over the engine's 256. The instance
//    keeps radix 16 and its own register bound (min_blocks_f64). 32 bytes
//    of traffic per point against the same flops puts it further under the
//    card's FP64 ridge (34 TFLOP/s over 3.35 TB/s, ~10 flop/B).
//
// The stage engine, the tile walk and the plan check live in stockham.cuh,
// which the real-FFT kernels (rfft.cu) and the four-step kernels (large.cu)
// share; the hybrid real path also drives this kernel itself, through
// strides (watfft_tpu_torch/ops/rfft.py).
//
// C interface (loaded with ctypes): watfft_stockham_c2c (float),
// watfft_stockham_c2c_f64 (double), watfft_stockham_c2c_bf16 (bf16 planes,
// f32 stages) and watfft_stockham_c2c_bf16c (bf16 throughout) launch on
// the given stream, allocate nothing, and return cudaGetLastError() after
// the launch, or a negative code for arguments they refuse before
// launching. Their arguments after the stream are the column tile C (0:
// none) and its block's threads, and for the f32 and FP64 entries the
// walk and its pairs, which the host picks (ops/stockham.py `c2c_launch`).

#include "stockham.cuh"

namespace {

// Real: the scalar of the stages, the tables and shared memory; Store: that
// of the planes in device memory (Real, or bf16 around f32 stages).
template <typename Real, typename Store, int P, bool INV>
__global__ void __launch_bounds__(kBlockThreads, min_blocks_of<Real>(P))
stockham_c2c_kernel(const Store* __restrict__ xre, const Store* __restrict__ xim,
                    Store* __restrict__ yre, Store* __restrict__ yim,
                    int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                    int64_t batch, int T, int S,
                    const Real* __restrict__ twre, const Real* __restrict__ twim,
                    Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  cplx<Real>* smem = reinterpret_cast<cplx<Real>*>(smem_bytes);
  const int n = 1 << plan.log2n;
  const int tpt = n / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  // device memory -> shared memory; transforms past the batch stay unset
  // and their results are never stored
  for_tile(plan.log2n, T, count, first, x_sn, x_sb, [&](int t, int k, int64_t g) {
    smem[t * S + pad(k)] = make_c(widen<Real>(xre[g]), widen<Real>(xim[g]));
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, INV>(smem + t * S, th, tpt, plan, twre, twim);

  // shared memory -> device memory (the last stage ended with a sync)
  for_tile(plan.log2n, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
    const cplx<Real> z = smem[t * S + pad(k)];
    yre[g] = narrow<Store>(z.x);
    yim[g] = narrow<Store>(z.y);
  });
}

// The column-tile instances (P = 16): a block of 256 or 512 threads stages
// T = C columns, C/T' groups of T' = blockDim * 16 / n transforms, each run
// as the engine runs it. A side whose rows lie further apart than its
// columns takes the column walk; the other keeps the engine's walk over the
// tile.
template <typename Real, typename Store, bool INV>
__global__ void __launch_bounds__(kColsThreads, 1)
stockham_cols_kernel(const Store* __restrict__ xre, const Store* __restrict__ xim,
                     Store* __restrict__ yre, Store* __restrict__ yim,
                     int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                     int64_t batch, int T, int S,
                     const Real* __restrict__ twre, const Real* __restrict__ twim,
                     Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  cplx<Real>* smem = reinterpret_cast<cplx<Real>*>(smem_bytes);
  const int n = 1 << plan.log2n;
  const int tpt = n / 16;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);
  const int log2c = 31 - __clz(T);
  const Batch1 xb{x_sb}, yb{y_sb};

  const auto put = [&](int t, int k, cplx<Real> v) { smem[t * S + pad(k)] = v; };
  if (x_sn > x_sb) {
    if constexpr (sizeof(Store) == sizeof(Real) && sizeof(Real) >= 4) {
      copy_cols(plan.log2n, log2c, count, first, x_sn, xb, xre, xim, smem, S);
    } else {
      load_cols(plan.log2n, log2c, count, first, x_sn, xb, [&](int, int64_t g) {
        return make_c(widen<Real>(xre[g]), widen<Real>(xim[g]));
      }, put);
    }
  } else {
    for_tile_b(plan.log2n, T, count, first, x_sn, xb, [&](int t, int k, int64_t g) {
      put(t, k, make_c(widen<Real>(xre[g]), widen<Real>(xim[g])));
    });
  }
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  for (int c = t; c < T; c += blockDim.x / tpt) {
    run_stages<16, INV>(smem + c * S, th, tpt, plan, twre, twim);
  }

  const auto store = [&](int t, int k, int64_t g) {
    const cplx<Real> z = smem[t * S + pad(k)];
    yre[g] = narrow<Store>(z.x);
    yim[g] = narrow<Store>(z.y);
  };
  if (y_sn > y_sb) {
    for_cols(plan.log2n, log2c, count, first, y_sn, yb, store);
  } else {
    for_tile_b(plan.log2n, T, count, first, y_sn, yb, store);
  }
}

// The batch-major walk redesigned (f32 and FP64): tiles of the engine's T
// transforms, each copied by cp.async straight into its padded slots (one
// copy a point where `pairs_x`: complex64 or complex128 storage, or the
// real core's even and odd rows of a contiguous signal; else one a plane),
// run as the engine runs them (run_stages) and stored one point at a time
// where `pairs_y`, else one plane at a time. Two blocks of 256 threads an
// SM leave a P = 16 thread 128 registers, where the f32 engine's bound of
// 80 spills. bufs = 2: resident blocks, each looping over tiles with the
// next one landing in a second buffer; bufs = 1: a block a tile (the grid
// is `tiles_grid`'s, from the walk the host picked).
template <typename Real, int P, bool INV>
__global__ void __launch_bounds__(kBlockThreads, kResidentBlocks)
stockham_c2c_resident_kernel(const Real* __restrict__ xre, const Real* __restrict__ xim,
                             Real* __restrict__ yre, Real* __restrict__ yim,
                             int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                             int64_t batch, int T, int S, int bufs, bool pairs_x, bool pairs_y,
                             const Real* __restrict__ twre, const Real* __restrict__ twim,
                             Plan plan) {
  using C = cplx<Real>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  C* smem = reinterpret_cast<C*>(smem_bytes);
  const int n = 1 << plan.log2n;
  const int tpt = n / P;
  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  const auto count = [&](int64_t tile) { return (int)min((int64_t)T, batch - tile * T); };

  // transforms past the batch are not copied, and their results not stored
  const auto copy = [&](C* c, int64_t tile) {
    for_tile(plan.log2n, T, count(tile), tile * T, x_sn, x_sb, [&](int t, int k, int64_t g) {
      copy_point(c + t * S + pad(k), xre + g, xim + g, pairs_x);
    });
    copy_commit();
  };
  const auto work = [&](C* c, int64_t tile) {
    run_stages<P, INV>(c + t * S, th, tpt, plan, twre, twim);
    // the last stage ended with a sync
    for_tile(plan.log2n, T, count(tile), tile * T, y_sn, y_sb, [&](int t, int k, int64_t g) {
      store_point(yre + g, yim + g, c[t * S + pad(k)], pairs_y);
    });
  };
  for_tiles(smem, T * S, (batch + T - 1) / T, bufs, copy, work);
}

template <typename Real, int P, bool INV>
int launch_resident(const Real* xre, const Real* xim, Real* yre, Real* yim,
                    int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                    int64_t batch, const Real* twre, const Real* twim,
                    const Plan& plan, int T, cudaStream_t stream, int walk, bool pairs_x,
                    bool pairs_y) {
  const int S = smem_stride(1 << plan.log2n);
  const int bufs = walk == kWalkResident ? 2 : 1;
  const size_t smem = (size_t)bufs * T * S * sizeof(cplx<Real>);
  auto kernel = stockham_c2c_resident_kernel<Real, P, INV>;
  if (const int err = opt_in_smem(kernel, smem)) return err;
  unsigned grid;
  if (const int err = tiles_grid(kernel, smem, (batch + T - 1) / T, walk, grid)) return err;
  kernel<<<grid, kBlockThreads, smem, stream>>>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb,
                                                batch, T, S, bufs, pairs_x, pairs_y, twre, twim,
                                                plan);
  return (int)cudaGetLastError();
}

template <typename Real, typename Store, int P, bool INV, bool COLS = false>
int launch(const Store* xre, const Store* xim, Store* yre, Store* yim,
           int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
           int64_t batch, const Real* twre, const Real* twim,
           const Plan& plan, int T, cudaStream_t stream, int threads = kBlockThreads) {
  const int S = smem_stride(1 << plan.log2n);
  const size_t smem = (size_t)T * S * sizeof(cplx<Real>);
  const int64_t blocks = (batch + T - 1) / T;
  auto kernel = stockham_c2c_kernel<Real, Store, P, INV>;
  if constexpr (COLS) kernel = stockham_cols_kernel<Real, Store, INV>;
  if (const int err = opt_in_smem(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, batch, T, S, twre, twim, plan);
  return (int)cudaGetLastError();
}

template <typename Real, typename Store>
int c2c(const Store* xre, const Store* xim, Store* yre, Store* yim,
        int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
        int n, int64_t batch, const Real* twre, const Real* twim,
        const int* radices, const int* twoffsets, int nstages, int inverse, void* stream,
        int cols, int threads, int walk = kWalkEngine, int pairs_x = 0, int pairs_y = 0) {
  Plan plan;
  int maxr, T, C, NT;
  bool tiled;
  if (const int err = make_plan(n, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  if (const int err = tile_shape(cols, threads, n, maxr, T, batch, sizeof(cplx<Real>), C, NT,
                                 tiled)) {
    return err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (walk != kWalkEngine) {
    // the redesigned walk: f32 and FP64 planes, no column tile
    constexpr bool kResident = sizeof(Store) == sizeof(Real) && sizeof(Real) >= 4;
    if (!kResident || (walk != kWalkResident && walk != kWalkBlock) || tiled) return kErrArgs;
    if constexpr (kResident) {
      if ((pairs_x && !complex_pairs(xre, xim, x_sn, x_sb)) ||
          (pairs_y && !complex_pairs(yre, yim, y_sn, y_sb))) {
        return kErrPairs;
      }
#define WATFFT_RESIDENT(P, INV)                                                          \
  return launch_resident<Real, P, INV>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, batch, \
                                       twre, twim, plan, T, st, walk, pairs_x != 0,        \
                                       pairs_y != 0)
      switch (maxr * 2 + (inverse ? 1 : 0)) {
        case 4:  WATFFT_RESIDENT(2, false);
        case 5:  WATFFT_RESIDENT(2, true);
        case 8:  WATFFT_RESIDENT(4, false);
        case 9:  WATFFT_RESIDENT(4, true);
        case 16: WATFFT_RESIDENT(8, false);
        case 17: WATFFT_RESIDENT(8, true);
        case 32: WATFFT_RESIDENT(16, false);
        default: WATFFT_RESIDENT(16, true);
      }
#undef WATFFT_RESIDENT
    }
  }
  if (pairs_x || pairs_y) return kErrPairs;  // the engine's walk copies plane by plane
  if (tiled) {  // the column-tile instances: P = 16 (tile_shape checked)
    if (inverse) {
      return launch<Real, Store, 16, true, true>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb,
                                                 batch, twre, twim, plan, C, st, NT);
    }
    return launch<Real, Store, 16, false, true>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb,
                                                batch, twre, twim, plan, C, st, NT);
  }
#define WATFFT_LAUNCH(P, INV)                                                            \
  return launch<Real, Store, P, INV>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, batch, \
                                     twre, twim, plan, T, st)
  switch (maxr * 2 + (inverse ? 1 : 0)) {
    case 4:  WATFFT_LAUNCH(2, false);
    case 5:  WATFFT_LAUNCH(2, true);
    case 8:  WATFFT_LAUNCH(4, false);
    case 9:  WATFFT_LAUNCH(4, true);
    case 16: WATFFT_LAUNCH(8, false);
    case 17: WATFFT_LAUNCH(8, true);
    case 32: WATFFT_LAUNCH(16, false);
    default: WATFFT_LAUNCH(16, true);
  }
#undef WATFFT_LAUNCH
}

}  // namespace

extern "C" {

// y = DFT_n(x) for each of `batch` sequences; element (k, b) of a plane sits
// at k*x_sn + b*x_sb (y likewise). y must not overlap x. The plan is given
// as its radices and twiddle-pack offsets, stage by stage. cols: the column
// tile C, a power of two >= T (0: the engine's T); threads: its block, 256
// or 512 (0: 256). walk: 1 the engine's walk (stockham_c2c_kernel, or the
// column tile), 2 resident blocks of stockham_c2c_resident_kernel with two
// buffers, 3 a block a tile of it with one (refused with a column tile:
// kErrArgs); pairs_x, pairs_y: its copies of the input and stores of the
// output one point at a time, refused (kErrPairs) where re and im are not
// adjacent in aligned points or on the engine's walk. The bf16 entries
// below take the engine's walk and none of the three.
int watfft_stockham_c2c(const float* xre, const float* xim, float* yre, float* yim,
                        int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                        int n, int64_t batch, const float* twre, const float* twim,
                        const int* radices, const int* twoffsets, int nstages,
                        int inverse, void* stream, int cols, int threads, int walk,
                        int pairs_x, int pairs_y) {
  return c2c<float, float>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, twre,
                           twim, radices, twoffsets, nstages, inverse, stream, cols, threads,
                           walk, pairs_x, pairs_y);
}

// The same on float64 planes with a float64 twiddle pack (pairs: 16 bytes).
int watfft_stockham_c2c_f64(const double* xre, const double* xim, double* yre, double* yim,
                            int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                            int n, int64_t batch, const double* twre, const double* twim,
                            const int* radices, const int* twoffsets, int nstages,
                            int inverse, void* stream, int cols, int threads, int walk,
                            int pairs_x, int pairs_y) {
  return c2c<double, double>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, twre,
                             twim, radices, twoffsets, nstages, inverse, stream, cols, threads,
                             walk, pairs_x, pairs_y);
}

// The bf16 interop tier: bfloat16 planes, float32 stages and twiddle pack.
int watfft_stockham_c2c_bf16(const __nv_bfloat16* xre, const __nv_bfloat16* xim,
                             __nv_bfloat16* yre, __nv_bfloat16* yim,
                             int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                             int n, int64_t batch, const float* twre, const float* twim,
                             const int* radices, const int* twoffsets, int nstages,
                             int inverse, void* stream, int cols, int threads) {
  return c2c<float, __nv_bfloat16>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch,
                                   twre, twim, radices, twoffsets, nstages, inverse, stream,
                                   cols, threads);
}

// The bf16 compute tier: bfloat16 planes, stages and twiddle pack.
int watfft_stockham_c2c_bf16c(const __nv_bfloat16* xre, const __nv_bfloat16* xim,
                              __nv_bfloat16* yre, __nv_bfloat16* yim,
                              int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                              int n, int64_t batch, const __nv_bfloat16* twre,
                              const __nv_bfloat16* twim, const int* radices,
                              const int* twoffsets, int nstages, int inverse, void* stream,
                              int cols, int threads) {
  return c2c<__nv_bfloat16, __nv_bfloat16>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n,
                                           batch, twre, twim, radices, twoffsets, nstages,
                                           inverse, stream, cols, threads);
}

const char* watfft_error_string(int code) {
  switch (code) {
    case kErrArgs: return "n, batch, stage count or walk out of range";
    case kErrPlan: return "stage plan has a radix outside {2,4,8,16} or does not multiply to n";
    case kErrTooLong: return "transform too long for one thread block";
    case kErrSplit: return "four-step factors outside the cube kernel's range (16 <= n1, n2; "
                           "8192 <= n1*n2, and its shared memory within the card's limit)";
    case kErrDirect: return "n outside the DFT-matmul kernel's range 1..128";
    case kErrTile: return "column tile refused: C must be a power of two, at least the "
                          "engine's transforms per block, within the card's opt-in shared "
                          "memory, and above that only on plans whose largest radix is 16";
    case kErrCube: return "cube block refused: 256 or 512 threads";
    case kErrPairs: return "8-byte pairs refused: re and im must be adjacent (4 bytes apart in "
                           "8-byte aligned points, 8 in 16-byte aligned points for float64), "
                           "with even point and batch strides, on a walk that takes pairs";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
