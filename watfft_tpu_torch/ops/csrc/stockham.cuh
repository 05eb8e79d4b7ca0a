// The Stockham stage engine shared by the port's kernels (stockham.cu,
// rfft.cu): the stage plan, the radix-2 network, one radix-R stage on a
// transform in shared memory, the stage loop, the tile walk between device
// and shared memory, and the host-side plan check and block shape.
//
// A block holds T whole transforms of N = 2^log2n points in shared memory,
// S complex slots apart (row k of a transform at pad(k)); each transform
// takes N/P threads (P = the plan's largest radix), each doing P/R radix-R
// butterflies per stage. See stockham.cu for the design and what bounds it.
//
// The arithmetic is generic over its scalar `Real`: float (complex float2,
// every f32 kernel), double (complex double2, the FP64 instances of the
// c2c and real kernels) or __nv_bfloat16 (complex __nv_bfloat162, the c2c
// kernel's bf16 compute tier). The double instances differ only in the
// radix-2 network's constants (the f64 values, not their f32 roundings)
// and in their register bound (min_blocks_f64). The bf16 instance rounds
// after every operation, through the round-to-nearest intrinsics, which
// the compiler does not contract into FMAs: the plain version's bf16 ops
// round so.
//
// Three policies widen the engine for the four-step kernels (large.cu)
// without changing what the c2c and real kernels compile to: the rows of a
// transform in shared memory (`Contig`, or `Strided` for the cube's column
// pass), the batch offset in device memory (`Batch1`, or `Batch2` for a
// batch over two axes) and, in large.cu, a complex multiply in the load or
// the store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 16;
constexpr int kBlockThreads = 256;

constexpr int kErrArgs = -1;      // n, batch, stage count or walk out of range
constexpr int kErrPlan = -2;      // radix not in {2,4,8,16}, or product != n
constexpr int kErrTooLong = -3;   // a transform needs more than one block
constexpr int kErrSplit = -4;     // four-step factors out of the cube's range
constexpr int kErrDirect = -5;    // n outside the DFT-matmul kernel's 1..128
constexpr int kErrTile = -6;      // column tile not a power of two, below T, too large, or
                                  // not held by its block of threads
constexpr int kErrCube = -7;      // cube block not 256 or 512 threads
constexpr int kErrPairs = -8;     // pairs asked for where re and im are not adjacent in
                                  // aligned points, or on a walk that takes none

struct Plan {
  int log2n;
  int nstages;
  int radix[kMaxStages];
  int log2l[kMaxStages];   // l = product of the radices of earlier stages
  int twoff[kMaxStages];   // offset into the twiddle pack, -1: twiddle-free
};

// Row k of a transform in shared memory: one slot of padding every 16.
__device__ __forceinline__ int pad(int k) { return k + (k >> 4); }

// Where row k of the transform at c sits, as an index into c: its own
// padded rows (every kernel's default), or every 2^log2rs-th slot from
// `base` of a larger padded array (a column of the cube's [n2, n1] block).
struct Contig {
  __device__ __forceinline__ int operator()(int k) const { return pad(k); }
};
struct Strided {
  int base, log2rs;
  __device__ __forceinline__ int operator()(int k) const { return pad(base + (k << log2rs)); }
};

// Offset in device memory of batch entry b: b*sb (one batch axis), or
// (b % inner)*sb + (b / inner)*sb2 (two axes, `inner` entries along the
// first). `sb` is the stride the tile walk compares with the row stride.
struct Batch1 {
  int64_t sb;
  __device__ __forceinline__ int64_t operator()(int64_t b) const { return b * sb; }
};
struct Batch2 {
  int64_t sb, sb2;
  uint32_t inner;
  __device__ __forceinline__ int64_t operator()(int64_t b) const {
    const uint32_t u = (uint32_t)b, o = u / inner;
    return (int64_t)(u - o * inner) * sb + (int64_t)o * sb2;
  }
};

// The complex type of a scalar (float2, double2 or __nv_bfloat162) and its
// constructor.
template <typename Real> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };
template <> struct Cplx<__nv_bfloat16> { using type = __nv_bfloat162; };
template <typename Real> using cplx = typename Cplx<Real>::type;

__device__ __forceinline__ float2 make_c(float x, float y) { return make_float2(x, y); }
__device__ __forceinline__ double2 make_c(double x, double y) { return make_double2(x, y); }
__device__ __forceinline__ __nv_bfloat162 make_c(__nv_bfloat16 x, __nv_bfloat16 y) {
  return __halves2bfloat162(x, y);
}

// Complex product, sum, difference and scaling. float and double use the
// operators (the compiler may contract a product and a sum into an FMA);
// bf16 rounds each product, sum and difference on its own, as the plain
// version's bf16 ops do.
template <typename C>
__device__ __forceinline__ C cmul(C a, C w) {
  return make_c(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
template <typename C>
__device__ __forceinline__ C cadd(C a, C b) { return make_c(a.x + b.x, a.y + b.y); }
template <typename C>
__device__ __forceinline__ C csub(C a, C b) { return make_c(a.x - b.x, a.y - b.y); }
template <typename C, typename Real>
__device__ __forceinline__ C cscale(C a, Real s) { return make_c(a.x * s, a.y * s); }

__device__ __forceinline__ __nv_bfloat162 cmul(__nv_bfloat162 a, __nv_bfloat162 w) {
  return make_c(__hsub_rn(__hmul_rn(a.x, w.x), __hmul_rn(a.y, w.y)),
                __hadd_rn(__hmul_rn(a.x, w.y), __hmul_rn(a.y, w.x)));
}
__device__ __forceinline__ __nv_bfloat162 cadd(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hadd2_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat162 csub(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hsub2_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat162 cscale(__nv_bfloat162 a, __nv_bfloat16 s) {
  return __hmul2_rn(a, __bfloat162bfloat162(s));
}

// 1/n in the scalar (exact: n is a power of two).
template <typename Real>
__device__ __forceinline__ Real recip(int n) { return Real(1) / n; }
template <>
__device__ __forceinline__ __nv_bfloat16 recip<__nv_bfloat16>(int n) {
  return __float2bfloat16_rn(1.0f / n);
}

// A value of the planes in device memory (`Store`) as the scalar the stages
// run in (`Real`), and back: the identity, or bf16 planes around f32
// stages (the bf16 interop tier), rounded to nearest on the way out.
template <typename Real, typename Store>
__device__ __forceinline__ Real widen(Store x) { return x; }
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename Store, typename Real>
__device__ __forceinline__ Store narrow(Real x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float x) {
  return __float2bfloat16_rn(x);
}

// w16^j = exp(-2 pi i j / 16) for j < 8. Index j = q * 16 / R for the
// R-point network's w_R^q; j = 0 and 4 take the network's shortcuts.
template <typename Real>
__device__ __forceinline__ cplx<Real> w16(int j, bool inverse);

// f32: the constants of pallas_stockham.py:_small_dft (math.cos/sin of the
// f64 angle, taken as weak-typed f32).
template <>
__device__ __forceinline__ float2 w16<float>(int j, bool inverse) {
  constexpr float kRe[8] = {1.0f, 0.9238795042037964f, 0.7071067690849304f,
                            0.3826834261417389f, 0.0f, -0.3826834261417389f,
                            -0.7071067690849304f, -0.9238795042037964f};
  constexpr float kIm[8] = {-0.0f, -0.3826834261417389f, -0.7071067690849304f,
                            -0.9238795042037964f, -1.0f, -0.9238795042037964f,
                            -0.7071067690849304f, -0.3826834261417389f};
  return make_float2(kRe[j], inverse ? -kIm[j] : kIm[j]);
}

// f64: math.cos/sin of the same f64 angle, unrounded (the values the JAX
// df network splits into hi/lo pairs, doublefloat.py:249-250, and the
// plain version's Python floats).
template <>
__device__ __forceinline__ double2 w16<double>(int j, bool inverse) {
  constexpr double kRe[8] = {1.0, 0.9238795325112867, 0.7071067811865476,
                             0.38268343236508984, 0.0, -0.3826834323650897,
                             -0.7071067811865475, -0.9238795325112867};
  constexpr double kIm[8] = {-0.0, -0.3826834323650898, -0.7071067811865475,
                             -0.9238795325112867, -1.0, -0.9238795325112867,
                             -0.7071067811865476, -0.3826834323650899};
  return make_double2(kRe[j], inverse ? -kIm[j] : kIm[j]);
}

// bf16: the f32 constants above rounded to bf16 (as bit patterns), the
// values the JAX codelet's weak-typed scalars take on bf16 arrays and the
// plain version's 0-d bf16 constants.
template <>
__device__ __forceinline__ __nv_bfloat162 w16<__nv_bfloat16>(int j, bool inverse) {
  constexpr unsigned short kRe[8] = {0x3f80, 0x3f6d, 0x3f35, 0x3ec4,
                                     0x0000, 0xbec4, 0xbf35, 0xbf6d};
  constexpr unsigned short kIm[8] = {0x8000, 0xbec4, 0xbf35, 0xbf6d,
                                     0xbf80, 0xbf6d, 0xbf35, 0xbec4};
  return make_c(__ushort_as_bfloat16(kRe[j]),
                __ushort_as_bfloat16((unsigned short)(inverse ? kIm[j] ^ 0x8000 : kIm[j])));
}

// R-point DFT of in[0], in[S], ..., in[(R-1)S] into out[0..R), by the
// recursive radix-2 network of pallas_stockham.py:_small_dft (even terms,
// odd terms, combine). Fully unrolled: every index is a constant.
template <int R, int S, bool INV, typename Real>
__device__ __forceinline__ void small_dft(const cplx<Real>* in, cplx<Real>* out) {
  using C = cplx<Real>;
  if constexpr (R == 1) {
    out[0] = in[0];
  } else {
    constexpr int H = R / 2;
    C e[H], o[H];
    small_dft<H, 2 * S, INV, Real>(in, e);
    small_dft<H, 2 * S, INV, Real>(in + S, o);
#pragma unroll
    for (int q = 0; q < H; ++q) {
      C t;
      if (q == 0) {
        t = o[0];
      } else if (4 * q == R) {  // w = -+i: (re, im) -> (+-im, -+re)
        t = INV ? make_c(-o[q].y, o[q].x) : make_c(o[q].y, -o[q].x);
      } else {
        t = cmul(o[q], w16<Real>(q * (16 / R), INV));
      }
      out[q] = cadd(e[q], t);
      out[q + H] = csub(e[q], t);
    }
  }
}

// One radix-R stage of an n-point transform, thread th of its tpt. The
// thread does butterflies i = th + m*tpt, m < P/R, of the q = n/R in the
// stage: input rows p*q + i, read through ld(row), output rows
// j*R*l + s*l + k (i = j*l + k), written through st(row, value).
// `in_place`: the stage reads and writes the same shared rows, so every
// read waits for the block's others before any write. No sync after the
// writes: the caller syncs where a later stage reads them.
template <int R, int P, bool INV, typename Real, typename Ld, typename St>
__device__ __forceinline__ void stage_io(int th, int tpt, int n, int log2l, int twoff, bool fold,
                                         const Real* __restrict__ twre,
                                         const Real* __restrict__ twim, bool in_place, Ld ld,
                                         St st) {
  using C = cplx<Real>;
  constexpr int M = P / R;
  const int q = n / R;
  const Real inv_n = recip<Real>(n);
  C v[P];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = th + m * tpt;
#pragma unroll
    for (int p = 0; p < R; ++p) v[m * R + p] = ld(p * q + i);
    if (twoff >= 0) {
#pragma unroll
      for (int p = 1; p < R; ++p) {
        const int w = twoff + (p - 1) * q + i;
        v[m * R + p] = cmul(v[m * R + p], make_c(__ldg(twre + w), __ldg(twim + w)));
      }
    }
    if (fold) {  // inverse final stage: the p >= 1 twiddles already hold 1/n
#pragma unroll
      for (int p = 0; p < R; ++p) {
        if (p == 0 || twoff < 0) v[m * R + p] = cscale(v[m * R + p], inv_n);
      }
    }
  }
  if (in_place) __syncthreads();  // every read of this stage is done before any write
  const int lmask = (1 << log2l) - 1;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = th + m * tpt;
    const int base = ((i >> log2l) * R << log2l) + (i & lmask);
    C out[R];
    small_dft<R, 1, INV, Real>(v + m * R, out);
#pragma unroll
    for (int s = 0; s < R; ++s) st(base + (s << log2l), out[s]);
  }
}

// One radix-R stage on the transform at c (shared memory), in place, row
// r at c[rows(r)]; ends with a block sync.
template <int R, int P, bool INV, typename Rows, typename Real>
__device__ __forceinline__ void stage(cplx<Real>* c, Rows rows, int th, int tpt, int n,
                                      int log2l, int twoff, bool fold,
                                      const Real* __restrict__ twre,
                                      const Real* __restrict__ twim) {
  using C = cplx<Real>;
  stage_io<R, P, INV, Real>(
      th, tpt, n, log2l, twoff, fold, twre, twim, true, [&](int r) { return c[rows(r)]; },
      [&](int r, C z) { c[rows(r)] = z; });
  __syncthreads();
}

template <int R, int P, bool INV, typename Rows, typename Real>
__device__ __forceinline__ void stage_if(int radix, cplx<Real>* c, Rows rows, int th, int tpt,
                                         int n, int log2l, int twoff, bool fold,
                                         const Real* __restrict__ twre,
                                         const Real* __restrict__ twim) {
  if constexpr (R <= P) {
    if (radix == R) {
      stage<R, P, INV, Rows, Real>(c, rows, th, tpt, n, log2l, twoff, fold, twre, twim);
    }
  }
}

template <int R, int P, bool INV, typename Ld, typename St>
__device__ __forceinline__ void stage_io_if(int radix, int th, int tpt, int m, int log2l,
                                            int twoff, bool fold, const float* __restrict__ twre,
                                            const float* __restrict__ twim, bool in_place, Ld ld,
                                            St st) {
  if constexpr (R <= P) {
    if (radix == R) {
      stage_io<R, P, INV, float>(th, tpt, m, log2l, twoff, fold, twre, twim, in_place, ld, st);
    }
  }
}

// Stage s of the plan through stage_io, its
// radix picked at run time: the rows move through ld and st.
template <int P, bool INV, typename Ld, typename St>
__device__ __forceinline__ void stage_at(const Plan& plan, int s, int th, int tpt,
                                         const float* __restrict__ twre,
                                         const float* __restrict__ twim, bool in_place, Ld ld,
                                         St st) {
  const int m = 1 << plan.log2n, r = plan.radix[s], ll = plan.log2l[s], off = plan.twoff[s];
  const bool fold = INV && s == plan.nstages - 1;
  stage_io_if<2, P, INV>(r, th, tpt, m, ll, off, fold, twre, twim, in_place, ld, st);
  stage_io_if<4, P, INV>(r, th, tpt, m, ll, off, fold, twre, twim, in_place, ld, st);
  stage_io_if<8, P, INV>(r, th, tpt, m, ll, off, fold, twre, twim, in_place, ld, st);
  stage_io_if<16, P, INV>(r, th, tpt, m, ll, off, fold, twre, twim, in_place, ld, st);
}

// Every stage of the plan on the transform at c, thread th of its tpt; the
// inverse folds 1/n into the last stage. Ends with a block sync, so every
// thread of the block must call it. Real is the twiddle pack's scalar.
template <int P, bool INV, typename Rows = Contig, typename Real = float>
__device__ __forceinline__ void run_stages(cplx<Real>* c, int th, int tpt, const Plan& plan,
                                           const Real* __restrict__ twre,
                                           const Real* __restrict__ twim,
                                           Rows rows = Rows{}) {
  const int n = 1 << plan.log2n;
  for (int s = 0; s < plan.nstages; ++s) {
    const int r = plan.radix[s], ll = plan.log2l[s], off = plan.twoff[s];
    const bool fold = INV && s == plan.nstages - 1;
    stage_if<2, P, INV, Rows, Real>(r, c, rows, th, tpt, n, ll, off, fold, twre, twim);
    stage_if<4, P, INV, Rows, Real>(r, c, rows, th, tpt, n, ll, off, fold, twre, twim);
    stage_if<8, P, INV, Rows, Real>(r, c, rows, th, tpt, n, ll, off, fold, twre, twim);
    stage_if<16, P, INV, Rows, Real>(r, c, rows, th, tpt, n, ll, off, fold, twre, twim);
  }
}

// Calls f(t, k, g) for point k of transform t of the block's tile, g being
// its element offset in device memory (batch entry first + t at bat(...)).
// The walk runs along whichever of the row stride and the batch stride
// bat.sb is smaller, so neighbouring threads touch neighbouring addresses;
// transforms past the end of the batch are skipped. Where the batch stride
// is the smaller, a warp covers 32/T rows of only T adjacent columns: at
// n >= 1024 (T <= 4) that is 4-16 bytes of each 32-byte sector on f32
// planes. Those layouts take the column tile below instead, where the
// host asks for it.
template <typename B, typename F>
__device__ __forceinline__ void for_tile_b(int log2n, int T, int count, int64_t first,
                                           int64_t sn, B bat, F f) {
  const int n = 1 << log2n, tile = T << log2n;
  if (sn <= bat.sb) {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int t = e >> log2n, k = e & (n - 1);
      if (t < count) f(t, k, bat(first + t) + (int64_t)k * sn);
    }
  } else {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int k = e / T, t = e - k * T;
      if (t < count) f(t, k, bat(first + t) + (int64_t)k * sn);
    }
  }
}

template <typename F>
__device__ __forceinline__ void for_tile(int log2n, int T, int count, int64_t first,
                                         int64_t sn, int64_t sb, F f) {
  for_tile_b(log2n, T, count, first, sn, Batch1{sb}, f);
}

// The column tile: a block stages C = 2^log2c adjacent transforms (columns)
// of a layout whose rows lie further apart than its columns, C > T, so that
// each row's run of C columns fills (or comes nearer to filling) a 32-byte
// sector. The stages run the tile's C/T' groups of T' = blockDim * P / n
// transforms in turn, each exactly as the engine runs them (run_stages), so
// every transform's arithmetic is the same as without the tile. A block
// has kColsThreads threads or half as many (the host's choice at launch);
// the bound of kColsThreads at one block an SM leaves a P = 16 thread 128
// registers either way, where the engine's bound of 80 spills. C > T means
// C * n >= 2 * 256 * 16, a multiple of kColsLoads * kColsThreads, which the
// batched load below relies on.
constexpr int kColsThreads = 512;
constexpr int kColsLoads = 8;   // device-memory reads a thread issues before their writes

// The column walk of a C-wide tile, C = 2^log2c <= blockDim: thread i takes
// column i % C at every (blockDim/C)-th row from row i / C, so a warp reads
// 32/C rows of C adjacent columns. A thread's column is fixed, so its batch
// offset is computed once. ld(k, g) reads point k of the thread's column
// at element offset g; put(t, k, v) writes it to the tile. Each thread
// issues kColsLoads reads before their writes, so one block per SM keeps
// enough reads in flight. Columns past the batch (t >= count) are skipped.
template <typename B, typename Ld, typename Put>
__device__ __forceinline__ void load_cols(int log2n, int log2c, int count, int64_t first,
                                          int64_t sn, B bat, Ld ld, Put put) {
  const int t = threadIdx.x & ((1 << log2c) - 1);
  if (t >= count) return;
  const int step = blockDim.x >> log2c;
  const int64_t base = bat(first + t);
  for (int k0 = threadIdx.x >> log2c; k0 < (1 << log2n); k0 += kColsLoads * step) {
    decltype(ld(0, base)) v[kColsLoads];
#pragma unroll
    for (int u = 0; u < kColsLoads; ++u) {
      const int k = k0 + u * step;
      v[u] = ld(k, base + (int64_t)k * sn);
    }
#pragma unroll
    for (int u = 0; u < kColsLoads; ++u) put(t, k0 + u * step, v[u]);
  }
}

// The same load by cp.async, where the planes hold the tile's own scalar
// (Real == Store, 4 or 8 bytes): each re and im value is copied from device
// memory straight into its complex slot, every copy of the thread in flight
// before the wait; no registers are staged. Ends with the thread's wait; the
// caller syncs the block.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(B));
}

// Host side: im one scalar past re in points aligned to a whole point (8
// bytes of float, 16 of double), with even point and batch strides (in
// scalars): each point one 8- or 16-byte access.
template <typename Real>
inline bool complex_pairs(const Real* re, const Real* im, int64_t sn, int64_t sb) {
  return im == re + 1 && sn % 2 == 0 && sb % 2 == 0 && (uintptr_t)re % (2 * sizeof(Real)) == 0;
}

// The copies issued since the last commit become one group; the wait
// returns once all but the N most recent groups have landed.
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One point (re, im) into its complex slot d by cp.async: one copy of the
// whole point where the host asked for pairs (re and im adjacent in aligned
// points, `complex_pairs`), else one copy a plane.
template <typename Real>
__device__ __forceinline__ void copy_point(cplx<Real>* d, const Real* re, const Real* im,
                                           bool pairs) {
  if (pairs) {
    copy_async<sizeof(cplx<Real>)>(d, re);
  } else {
    copy_async<sizeof(Real)>(&d->x, re);
    copy_async<sizeof(Real)>(&d->y, im);
  }
}

// One point z to (re, im): one store of the whole point where pairs, else
// one a plane.
template <typename Real>
__device__ __forceinline__ void store_point(Real* re, Real* im, cplx<Real> z, bool pairs) {
  if (pairs) {
    *reinterpret_cast<cplx<Real>*>(re) = z;
  } else {
    *re = z.x;
    *im = z.y;
  }
}

// The batch-major walks of the c2c and r2c kernels, which the host picks
// for each launch and passes (`walk`; ops/stockham.py `c2c_launch`,
// ops/rfft.py `r2c_launch`): the engine's (a block a tile, the kernels
// before the redesign), resident blocks (the card's SMs times the blocks an
// SM holds, at most kResidentBlocks, each looping over tiles while the next
// lands in a second buffer) or a block a tile copied in by cp.async, at
// kResidentBlocks an SM.
constexpr int kWalkEngine = 1, kWalkResident = 2, kWalkBlock = 3;
constexpr int kResidentBlocks = 2;  // 128 registers a thread: P = 16 does not spill

// The tile loop of the redesigned walks (the c2c kernel's batch-major walk
// and the c2r): the block takes tiles blockIdx.x, blockIdx.x + gridDim.x,
// ... of `tiles`. copy(c, tile) issues a tile's cp.async copies into the
// buffer c (tile_slots slots) and commits them; work(c, tile) runs the
// stages and the store on it. bufs = 2: tile i + 1 lands in the other
// buffer while work runs on tile i; bufs = 1: one buffer, copied once the
// work is done. Every thread runs the same trip count, so the syncs are
// uniform.
template <typename C, typename Copy, typename Work>
__device__ __forceinline__ void for_tiles(C* smem, int tile_slots, int64_t tiles, int bufs,
                                          Copy copy, Work work) {
  const int64_t step = gridDim.x;
  int64_t tile = blockIdx.x;
  if (tile < tiles) copy(smem, tile);
  for (int it = 0; tile < tiles; tile += step, ++it) {
    C* const c = smem + (it & (bufs - 1)) * tile_slots;
    copy_wait<0>();
    __syncthreads();  // the tile is in c, and every read of the other buffer is done
    const int64_t next = tile + step;
    if (bufs == 2 && next < tiles) copy(smem + ((it + 1) & 1) * tile_slots, next);
    work(c, tile);
    if (bufs == 1 && next < tiles) {
      __syncthreads();  // every read of c is done
      copy(smem, next);
    }
  }
}

template <typename Real, typename B>
__device__ __forceinline__ void copy_cols(int log2n, int log2c, int count, int64_t first,
                                          int64_t sn, B bat, const Real* __restrict__ xre,
                                          const Real* __restrict__ xim, cplx<Real>* tile,
                                          int S) {
  const int t = threadIdx.x & ((1 << log2c) - 1);
  if (t < count) {
    const int step = blockDim.x >> log2c;
    const int64_t base = bat(first + t);
    for (int k = threadIdx.x >> log2c; k < (1 << log2n); k += step) {
      const int64_t g = base + (int64_t)k * sn;
      Real* d = reinterpret_cast<Real*>(tile + t * S + pad(k));
      copy_async<sizeof(Real)>(d, xre + g);
      copy_async<sizeof(Real)>(d + 1, xim + g);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// The same walk calling f(t, k, g) for every point of the tile (the store).
template <typename B, typename F>
__device__ __forceinline__ void for_cols(int log2n, int log2c, int count, int64_t first,
                                         int64_t sn, B bat, F f) {
  const int t = threadIdx.x & ((1 << log2c) - 1);
  if (t >= count) return;
  const int step = blockDim.x >> log2c;
  const int64_t base = bat(first + t);
  for (int k = threadIdx.x >> log2c; k < (1 << log2n); k += step) {
    f(t, k, base + (int64_t)k * sn);
  }
}

// Blocks per SM each instance must fit, i.e. its register budget. Measured
// on the H100 (one card, in turns): P = 16 at 3 blocks (80 registers, ~100
// bytes of spills) ran 10% faster at n >= 16 than unbounded (128
// registers, 2 blocks), and 4 blocks spilled twice as much for no gain.
// The P <= 8 instances keep the counts they take unbounded (62 and 32
// registers); naming any bound at all let the compiler take 80 and 48,
// and n = 8 and n = 4 ran 22% and 14% slower.
constexpr int min_blocks(int P) { return P == 16 ? 3 : P == 8 ? 4 : 8; }

// The FP64 instances' bound. A P = 16 thread holds double2 v[16], 64
// registers before the network's; under the f32 bound (80 registers) it
// would spill most of them. Their blocks hold 256 * P points of 16 bytes
// (69.6 KB at P = 16), so shared memory admits 3 blocks per SM at P = 16
// anyway; the bounds below leave 128 registers at P = 16, 80 at P = 8 and
// 64 below (chip_smoke.py prints ptxas's registers and spills).
constexpr int min_blocks_f64(int P) { return P == 16 ? 2 : P == 8 ? 3 : 4; }

// The bf16 instances take the f32 bound: a bf16 compute thread holds half
// the f32 registers of data, a bf16 interop thread the f32 one's.
template <typename Real>
constexpr int min_blocks_of(int P) { return sizeof(Real) == 8 ? min_blocks_f64(P) : min_blocks(P); }

// Dynamic shared memory past the 48 KB a launch gets by default needs the
// kernel's opt-in (cudaFuncSetAttribute) first; 0 or the CUDA error.
template <typename K>
inline int opt_in_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Host side: the grid of a launch of `kernel` (kBlockThreads threads,
// `smem` bytes of shared memory a block, opted in already) over `tiles`
// tiles on the walk the host picked: a block a tile (kWalkBlock), or the
// card's SMs times the blocks an SM holds, at most kResidentBlocks, and no
// more than the tiles (kWalkResident). 0 or a CUDA error.
template <typename K>
inline int tiles_grid(K kernel, size_t smem, int64_t tiles, int walk, unsigned& grid) {
  grid = (unsigned)tiles;
  if (walk != kWalkResident) return 0;
  int dev = 0, sms = 0, fit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kBlockThreads, smem);
  }
  if (e != cudaSuccess) return (int)e;
  const int blocks = fit < 1 ? 1 : fit < kResidentBlocks ? fit : kResidentBlocks;
  const int64_t resident = (int64_t)sms * blocks;
  if (resident < tiles) grid = (unsigned)resident;
  return 0;
}

// Host side: checks a plan given as its radices and twiddle-pack offsets
// for an n-point transform and fills `plan`, the largest radix `maxr` and
// the transforms per block `T`. Returns 0 or a kErr code.
inline int make_plan(int n, int64_t batch, const int* radices, const int* twoffsets,
                     int nstages, Plan& plan, int& maxr, int& T) {
  if (n < 2 || (n & (n - 1)) || batch < 1 || nstages < 1 || nstages > kMaxStages) {
    return kErrArgs;
  }
  plan = Plan{};
  plan.nstages = nstages;
  int log2l = 0;
  maxr = 1;
  for (int s = 0; s < nstages; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 4 && r != 8 && r != 16) return kErrPlan;
    plan.radix[s] = r;
    plan.log2l[s] = log2l;
    plan.twoff[s] = twoffsets[s];
    log2l += __builtin_ctz(r);
    maxr = r > maxr ? r : maxr;
  }
  if ((1 << log2l) != n) return kErrPlan;
  plan.log2n = log2l;
  const int tpt = n / maxr;  // threads per transform
  if (tpt > kBlockThreads) return kErrTooLong;
  T = kBlockThreads / tpt;  // transforms per block
  if ((batch + T - 1) / T > 0x7fffffff) return kErrArgs;
  return 0;
}

// Complex slots per transform in shared memory: odd, so transforms start on
// distinct banks.
inline int smem_stride(int n) { return (n + (n >> 4)) | 1; }

// Host side: the tile a launch takes. `cols` is the caller's C (0: the
// engine's T, no column tile), `threads` its block (0: kColsThreads / 2).
// Refuses (kErrTile) a C that is not a power of two, is below T, or whose
// C * S slots of `point` bytes exceed the card's opt-in shared memory; a C
// above T also needs the plan's largest radix to be 16 (the column-tile
// instances are P = 16), a block of kColsThreads or half as many threads,
// C to hold whole groups of them, and no more columns than threads (the
// column walk gives each thread one column). Sets C, the block's threads NT and
// whether it is a column tile; 0, kErrTile or a CUDA error.
inline int tile_shape(int cols, int threads, int n, int maxr, int T, int64_t batch,
                      size_t point, int& C, int& NT, bool& tiled) {
  C = T;
  NT = kBlockThreads;
  tiled = false;
  if (cols == 0 || cols == T) return 0;
  if (threads == 0) threads = kColsThreads / 2;
  if (cols < T || (cols & (cols - 1)) || maxr != 16 ||
      (threads != kColsThreads && threads != kColsThreads / 2) || cols < threads * maxr / n ||
      cols > threads) {
    return kErrTile;
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if ((size_t)cols * smem_stride(n) * point > (size_t)optin) return kErrTile;
  if ((batch + cols - 1) / cols > 0x7fffffff) return kErrArgs;
  C = cols;
  NT = threads;
  tiled = true;
  return 0;
}

}  // namespace
