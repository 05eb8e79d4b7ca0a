// Batched small-n DFT as one real matrix product, for Hopper (sm_90a), float32.
//
// Replaces watfft_tpu/ops/mxu_dft.py::_kernel, which computes, for each
// column of time-major planes, the n-point DFT as one real product on the
// TPU's matrix unit (MXU):
//
//   Y[2n, b] = W[2n, 2n] @ concat(xre, xim)[2n, b],
//   W = [[Wre, -Wim], [Wim, Wre]],  Wre + i Wim = exp(-+2 pi i k j / n),
//
// the inverse conjugated with 1/n folded into W, at HIGHEST precision (a
// multi-pass split of bf16 passes, f32-class). n is any of 1..128, a power
// of two or not. Two kernels, the host's choice at each launch (`kernel`;
// ops/mxu_dft.py `dft_launch`):
//
// dft_mma_kernel, the tensor cores in 3xTF32 (every n > 2). Plain TF32
// misses MAX_REL 5e-6, so each operand v is split into hi = tf32(v) and
// lo = tf32(v - hi) (to nearest, ties away from zero), and each product is
// lo*hi + hi*lo + hi*hi, issued in that order, as CUTLASS's 3xTF32 does.
//  * The product: mma.sync m16n8k8 TF32 with f32 sums. The quadrants of W
//    hold only Wre and +-Wim, so A streams Wre and Wim (hi and lo) and each
//    A fragment serves two products, Yre = Wre xre - Wim xim and Yim = Wim
//    xre + Wre xim (-Wim: a sign flip in registers).
//  * W is split on the host, once per (n, direction, device), into the hi
//    and lo planes of Wre and Wim, zero-padded to whole 16 x 8 tiles and
//    laid out in A-fragment order (mxu_dft.py `mma_fragments`): a lane loads
//    its four values of a plane with one 16-byte load from L2, the next
//    k-tile's in flight. W never passes through shared memory.
//  * x is split in registers as its B fragments are read from the tile.
//  * A warp owns 16 output rows (an m-tile) and 4 n-tiles of 8 transforms;
//    each A fragment is loaded once a tile and serves the 4 n-tiles (W's
//    L2 reads at n = 128: 256 KB a tile of 32 transforms). Two blocks of
//    256 threads an SM, 128 registers a thread.
//  * The mma truncates each sum it returns. One sum over all of k biases
//    the outputs by up to an ulp an mma and misses 1e-6 of the plain
//    version from n = 64; so each k-tile's products start from zero and
//    are added to the running sums in f32.
//  * The walk: resident blocks (the SMs times the blocks an SM holds,
//    stockham.cuh tiles_grid) loop over tiles (stockham.cuh for_tiles); the next tile's
//    points land by cp.async in a second buffer while the product runs on
//    this one, one 8-byte copy a point where re and im are adjacent in
//    aligned points (pairs_x), else one a plane. Rows n..KP of the tile
//    (n rounded up to whole k-tiles) hold zeros; padded output rows are
//    never stored. The sums go back through the tile and leave with one
//    8-byte store a point where pairs_y holds.
//
// dft_matmul_kernel, the FP32 cores (n <= 2, where it measured faster: an
// mma tile is 1/8 or less of work there). A block of 256 threads stages its
// tile in shared memory, streams W^T (from the host, [2n, 2n] row-major)
// through shared memory in double-buffered chunks of k, and each thread
// accumulates an MR x CN register tile in ascending k order. Its instances
// for larger n went with the tensor-core kernel (their times: PERF.md).
//
// What bounds it: 16 bytes a point in and out (16n a transform) against
// 3 * 8n^2 flops a transform in 3xTF32: at 495 TFLOP/s (the data sheet's
// dense TF32 rate) the bytes up to n = 64, the flops at n = 128 (12.9 GFLOP
// for 2^22 points: 26.0 us against 20.0 us of bytes).
//
// C interface (loaded with ctypes): watfft_dft_matmul launches on the given
// stream, allocates nothing, and returns cudaGetLastError() after the
// launch, or a negative code for arguments it refuses before launching.

#include "stockham.cuh"

namespace {

constexpr int kDftMaxN = 128;
constexpr int kDftChunk = 16;  // k values of W^T per pass through shared memory

// N consecutive floats from shared memory (16-byte aligned when N % 4 == 0,
// 8-byte when N == 2).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// The tile geometry of one instance: TY x TX threads, MR x CN outputs each.
template <int TY, int MR, int CN>
struct DftTile {
  static constexpr int TX = kBlockThreads / TY;
  static constexpr int T = TX * CN;                 // transforms per block
  static constexpr int MP = TY * MR;                // output rows, >= 2n
  static constexpr int KC = MP < kDftChunk ? MP : kDftChunk;
  static constexpr int XS = T + 4;                  // tile row stride, floats
  __host__ __device__ static int kp(int n) { return (2 * n + KC - 1) / KC * KC; }
  static size_t smem(int n) {
    return ((size_t)kp(n) * XS + 2 * (size_t)KC * MP) * sizeof(float);
  }
};

// 4 bytes from device to shared memory, asynchronously (cp.async); zeros
// where !valid (nothing is read then). Its groups are committed and
// awaited by stockham.cuh's copy_commit and copy_wait.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// Rows k0 .. k0+KC of W^T into ws ([KC][MP]), zero past 2n, asynchronously.
template <int KC, int MP>
__device__ __forceinline__ void copy_chunk(float* ws, const float* __restrict__ wt, int k0,
                                           int K) {
  for (int e = threadIdx.x; e < KC * MP; e += blockDim.x) {
    const int kk = e / MP, r = e - kk * MP, k = k0 + kk;
    const bool valid = k < K && r < K;
    copy_async(ws + e, valid ? wt + (int64_t)k * K + r : wt, valid);
  }
  copy_commit();
}

// Calls f(k, t, g) for row k < 2n (re rows, then im rows) of transform t <
// count of the block's tile, g being the element's offset in its plane
// (row k mod n of batch entry first + t). Walks along the smaller stride.
template <int T, typename F>
__device__ __forceinline__ void for_dft_tile(int n, int count, int64_t first, int64_t sn,
                                             int64_t sb, F f) {
  const int K = 2 * n;
  if (sn <= sb) {  // along k: element e = t*K + k, stepping e by the block's threads
    const int dt = kBlockThreads / K, dk = kBlockThreads - dt * K;
    int t = threadIdx.x / K, k = threadIdx.x - t * K;
    while (t < count) {
      f(k, t, (first + t) * sb + (int64_t)(k < n ? k : k - n) * sn);
      t += dt;
      k += dk;
      if (k >= K) {
        k -= K;
        ++t;
      }
    }
  } else {         // along the batch
    for (int e = threadIdx.x; e < K * T; e += kBlockThreads) {
      const int k = e / T, t = e - k * T;
      const int row = k < n ? k : k - n;
      if (t < count) f(k, t, (first + t) * sb + (int64_t)row * sn);
    }
  }
}

template <int TY, int MR, int CN>
__global__ void __launch_bounds__(kBlockThreads, 2)
dft_matmul_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  float* __restrict__ yre, float* __restrict__ yim,
                  int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                  int n, int64_t batch, const float* __restrict__ wt) {
  using G = DftTile<TY, MR, CN>;
  constexpr int T = G::T, MP = G::MP, KC = G::KC, XS = G::XS, TX = G::TX;
  extern __shared__ __align__(16) float dft_smem[];
  const int K = 2 * n, KP = G::kp(n);
  float* xs = dft_smem;                 // [KP][XS]: the tile, zero rows past K
  float* ws = dft_smem + KP * XS;       // 2 x [KC][MP]: k0 + kk of W^T, zero past 2n
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);
  copy_chunk<KC, MP>(ws, wt, 0, K);     // the first chunk flies while the tile loads

  // device memory -> the tile; columns past the batch stay unset, their
  // sums are never stored
  for_dft_tile<T>(n, count, first, x_sn, x_sb, [&](int k, int t, int64_t g) {
    xs[k * XS + t] = k < n ? xre[g] : xim[g];
  });
  for (int e = threadIdx.x; e < (KP - K) * XS; e += blockDim.x) xs[K * XS + e] = 0.0f;

  const int ty = threadIdx.x / TX, tx = threadIdx.x - ty * TX;
  float acc[MR][CN];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0, buf = 0; k0 < KP; k0 += KC, buf ^= 1) {
    if (k0 + KC < KP) {  // the next chunk into the other buffer, then wait for this one
      copy_chunk<KC, MP>(ws + (buf ^ 1) * KC * MP, wt, k0 + KC, K);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();  // this chunk (and, the first time, the tile) is in
    const float* w = ws + buf * KC * MP;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[MR], b[CN];
      load_row<MR>(w + kk * MP + ty * MR, a);
      load_row<CN>(xs + (k0 + kk) * XS + tx * CN, b);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // every read of this chunk's buffer (and, at the end, of the tile) is done
  }

  // the sums -> the tile's rows -> device memory
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = ty * MR + i;
    if (r < K) {
#pragma unroll
      for (int j = 0; j < CN; ++j) xs[r * XS + tx * CN + j] = acc[i][j];
    }
  }
  __syncthreads();
  for_dft_tile<T>(n, count, first, y_sn, y_sb, [&](int k, int t, int64_t g) {
    (k < n ? yre : yim)[g] = xs[k * XS + t];
  });
}

template <int TY, int MR, int CN>
int launch_dft(const float* xre, const float* xim, float* yre, float* yim, int64_t x_sn,
               int64_t x_sb, int64_t y_sn, int64_t y_sb, int n, int64_t batch,
               const float* wt, cudaStream_t stream) {
  using G = DftTile<TY, MR, CN>;
  const size_t smem = G::smem(n);
  const int64_t blocks = (batch + G::T - 1) / G::T;
  if (blocks > 0x7fffffff) return kErrArgs;
  auto kernel = dft_matmul_kernel<TY, MR, CN>;
  if (const int err = opt_in_smem(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, kBlockThreads, smem, stream>>>(
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, wt);
  return (int)cudaGetLastError();
}


// -- the tensor-core kernel ------------------------------------------------------------

constexpr int kDftSimt = 1, kDftMma = 2;  // the entry's `kernel` argument
constexpr int kDftSimtMaxN = 2;            // the FP32-core kernel's n (ops/mxu_dft.py SIMT_MAX_N)
constexpr int kMmaWarps = kBlockThreads / 32;
constexpr int kMmaNTiles = 4;   // n-tiles of 8 transforms a warp owns
constexpr int kMmaBlocks = 2;   // blocks an SM: 128 registers a thread

// The geometry of one instance: the block's 8 warps form WM x WN; warp w
// owns the 16 output rows of m-tile w % WM and kMmaNTiles n-tiles of 8
// transforms from column (w / WM) * 32, so each A fragment of W is loaded
// from L2 once a tile and serves 4 n-tiles. A tile holds T transforms.
// (8 n-tiles a warp at one block an SM, 208 registers, halves W's L2 reads
// but ran slower from n = 48: two warps a scheduler left the mma's latency
// exposed.)
template <int WM>
struct MmaTile {
  static constexpr int WN = kMmaWarps / WM;
  static constexpr int T = WN * kMmaNTiles * 8;
  // Point (k, t) of a tile at slot k*ks + t*ts (complex slots), for k < KP
  // (n rounded up to whole k-tiles; rows n..KP hold zeros): a transform's
  // points adjacent (stride KP + 4) where the input walks along k, else a
  // row's transforms (stride T + 4). Either stride is 4 mod 8, so the B
  // reads of a half-warp (t = lane % 4 a row apart, g = lane / 4 a column
  // apart) fall on 16 distinct 8-byte bank pairs. A buffer holds the larger
  // of the two layouts.
  __host__ __device__ static int slots(int kp) {
    return T * (kp + 4) > kp * (T + 4) ? T * (kp + 4) : kp * (T + 4);
  }
};

// v split into hi = tf32(v), its low 13 bits cleared so that v - hi is
// exact, and lo = tf32(v - hi), each rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero: half a TF32 ulp added to the magnitude's
// bits, the 13 bits below it cut), in integer arithmetic; lo's low bits are
// left to the mma, which ignores them. The compiler's cvt adds a guard for
// Inf and NaN, two more instructions a value, and the same outputs: an
// Inf keeps its bits here, and a NaN reaches the sums through lo.
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// d += a b on one 16 x 8 x 8 tile (A row-major 16 x 8, B 8 x 8), f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: lo*hi, hi*lo, then hi*hi (the small terms first).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void as_bits(const float4& v, uint32_t (&a)[4]) {
  a[0] = __float_as_uint(v.x);
  a[1] = __float_as_uint(v.y);
  a[2] = __float_as_uint(v.z);
  a[3] = __float_as_uint(v.w);
}

// Calls f(k, t, g) for every point k < n of transform t < count of the tile
// from batch entry `first`, g being its offset in a plane; walks along the
// smaller of the two strides, so neighbouring threads touch neighbouring
// addresses.
template <int T, typename F>
__device__ __forceinline__ void for_mma_tile(int n, int count, int64_t first, int64_t sn,
                                             int64_t sb, F f) {
  if (sn <= sb) {  // along k: point e = t*n + k, stepping e by the block's threads
    const int dt = kBlockThreads / n, dk = kBlockThreads - dt * n;
    int t = threadIdx.x / n, k = threadIdx.x - t * n;
    while (t < count) {
      f(k, t, (first + t) * sb + (int64_t)k * sn);
      t += dt;
      k += dk;
      if (k >= n) {
        k -= n;
        ++t;
      }
    }
  } else {         // along the batch: point e = k*T + t
    for (int e = threadIdx.x; e < n * T; e += kBlockThreads) {
      const int k = e / T, t = e - k * T;
      if (t < count) f(k, t, (first + t) * sb + (int64_t)k * sn);
    }
  }
}

template <int WM>
__global__ void __launch_bounds__(kBlockThreads, kMmaBlocks)
dft_mma_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
               float* __restrict__ yre, float* __restrict__ yim, int64_t x_sn, int64_t x_sb,
               int64_t y_sn, int64_t y_sb, int n, int64_t batch,
               const float4* __restrict__ frag, int pairs_x, int pairs_y) {
  using G = MmaTile<WM>;
  constexpr int T = G::T, NTW = kMmaNTiles;
  extern __shared__ __align__(16) float2 mma_smem[];
  const int KT = (n + 7) >> 3, KP = 8 * KT, MT = (n + 15) >> 4;
  const bool along_k = x_sn <= x_sb;
  const int ks = along_k ? 1 : T + 4, ts = along_k ? KP + 4 : 1;
  const int slots = G::slots(KP);
  // rows n..KP of both buffers hold zeros: no copy or sum writes them
  for (int e = threadIdx.x; e < (KP - n) * T; e += kBlockThreads) {
    const int k = n + e / T, t = e % T;
    mma_smem[k * ks + t * ts] = make_float2(0.0f, 0.0f);
    mma_smem[slots + k * ks + t * ts] = make_float2(0.0f, 0.0f);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mt = warp % WM, col0 = warp / WM * NTW * 8;
  // this warp's A fragments: [KT][Wre hi, Wre lo, Wim hi, Wim lo][lane]
  const float4* fa = frag + (size_t)mt * KT * 4 * 32 + lane;

  for_tiles(
      mma_smem, slots, (batch + T - 1) / T, 2,
      [&](float2* c, int64_t tile) {
        const int64_t first = tile * T;
        const int count = (int)min((int64_t)T, batch - first);
        for_mma_tile<T>(n, count, first, x_sn, x_sb, [&](int k, int t, int64_t off) {
          copy_point(c + k * ks + t * ts, xre + off, xim + off, pairs_x);
        });
        copy_commit();
      },
      [&](float2* c, int64_t tile) {
        float acc[2][NTW][4];  // [Yre, Yim][n-tile]
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[0][j][i] = acc[1][j][i] = 0.0f;
        }
        if (mt < MT) {
          float4 nxt[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) nxt[p] = __ldg(fa + p * 32);
          for (int kt = 0; kt < KT; ++kt) {
            uint32_t rh[4], rl[4], ih[4], il[4], mh[4], ml[4];  // Wre, Wim, -Wim
            as_bits(nxt[0], rh);
            as_bits(nxt[1], rl);
            as_bits(nxt[2], ih);
            as_bits(nxt[3], il);
            const int kn = kt + 1 < KT ? kt + 1 : kt;  // the next k-tile's, in flight
#pragma unroll
            for (int p = 0; p < 4; ++p) nxt[p] = __ldg(fa + (kn * 4 + p) * 32);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mh[i] = ih[i] ^ 0x80000000u;
              ml[i] = il[i] ^ 0x80000000u;
            }
            const float2* r0 = c + (kt * 8 + q) * ks;  // B rows q and q + 4
            const float2* r1 = r0 + 4 * ks;
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
              const int col = (col0 + j * 8 + g) * ts;
              const float2 p0 = r0[col], p1 = r1[col];
              uint32_t bre_h[2], bre_l[2], bim_h[2], bim_l[2];
              tf32_split(p0.x, bre_h[0], bre_l[0]);
              tf32_split(p1.x, bre_h[1], bre_l[1]);
              tf32_split(p0.y, bim_h[0], bim_l[0]);
              tf32_split(p1.y, bim_h[1], bim_l[1]);
              // This k-tile's sums from zero, then added to the running sums:
              // the mma truncates each sum it returns, and a fresh one a
              // k-tile keeps those errors at the k-tile's scale and unbiased
              // across k-tiles (one sum over all of k misses 1e-6 of the
              // plain version from n = 64).
              float dre[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dim[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_3xtf32(dre, rh, rl, bre_h, bre_l);  // Yre = Wre xre - Wim xim
              mma_3xtf32(dre, mh, ml, bim_h, bim_l);
              mma_3xtf32(dim, ih, il, bre_h, bre_l);  // Yim = Wim xre + Wre xim
              mma_3xtf32(dim, rh, rl, bim_h, bim_l);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[0][j][i] += dre[i];
                acc[1][j][i] += dim[i];
              }
            }
          }
        }
        __syncthreads();  // every read of the tile is done
        // the sums -> rows m < n of the tile: c0, c1 at row g, columns 2q
        // and 2q + 1 of the n-tile, c2, c3 at row g + 8
        if (mt < MT) {
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            const int col = col0 + j * 8 + 2 * q;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = mt * 16 + g + 8 * h;
              if (m < n) {
                c[m * ks + col * ts] = make_float2(acc[0][j][2 * h], acc[1][j][2 * h]);
                c[m * ks + (col + 1) * ts] =
                    make_float2(acc[0][j][2 * h + 1], acc[1][j][2 * h + 1]);
              }
            }
          }
        }
        __syncthreads();
        const int64_t first = tile * T;
        const int count = (int)min((int64_t)T, batch - first);
        for_mma_tile<T>(n, count, first, y_sn, y_sb, [&](int k, int t, int64_t off) {
          store_point(yre + off, yim + off, c[k * ks + t * ts], pairs_y);
        });
      });
}

template <int WM>
int launch_mma(const float* xre, const float* xim, float* yre, float* yim, int64_t x_sn,
               int64_t x_sb, int64_t y_sn, int64_t y_sb, int n, int64_t batch,
               const float* frag, int pairs_x, int pairs_y, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)MmaTile<WM>::slots(8 * ((n + 7) / 8)) * sizeof(float2);
  const int64_t tiles = (batch + MmaTile<WM>::T - 1) / MmaTile<WM>::T;
  auto kernel = dft_mma_kernel<WM>;
  if (const int err = opt_in_smem(kernel, smem)) return err;
  unsigned grid = 0;
  if (const int err = tiles_grid(kernel, smem, tiles, kWalkResident, grid)) return err;
  kernel<<<grid, kBlockThreads, smem, stream>>>(
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch,
      reinterpret_cast<const float4*>(frag), pairs_x, pairs_y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = DFT_n(x) for each of `batch` sequences of n = 1..128 points, as the
// product with W. Element (k, b) of a plane sits at k*x_sn + b*x_sb (y
// likewise); y must not overlap x. `kernel` picks the product: kDftSimt,
// on the FP32 cores at n <= 2, reads wt, W's transpose ([2n, 2n]
// row-major: wt[k*2n + r] = W[r, k]; the inverse's with 1/n folded in), and
// takes no pairs;
// kDftMma, on the tensor cores, reads frag (the host's hi and lo planes of
// Wre and Wim in A-fragment order, ops/mxu_dft.py `mma_fragments`) and runs
// resident blocks, with one 8-byte copy (pairs_x) and store (pairs_y) a
// point where re and im are adjacent in aligned points.
int watfft_dft_matmul(const float* xre, const float* xim, float* yre, float* yim,
                      int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                      int n, int64_t batch, const float* wt, void* stream,
                      const float* frag, int kernel, int pairs_x, int pairs_y) {
  if (n < 1 || n > kDftMaxN) return kErrDirect;
  if (batch < 1) return kErrArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == kDftSimt) {
    if (pairs_x || pairs_y) return kErrPairs;
    if (n > kDftSimtMaxN) return kErrArgs;
    return launch_dft<1, 4, 1>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, wt, st);
  }
  if (kernel != kDftMma) return kErrArgs;
  if ((pairs_x && !complex_pairs(xre, xim, x_sn, x_sb)) ||
      (pairs_y && !complex_pairs(yre, yim, y_sn, y_sb))) {
    return kErrPairs;
  }
#define WATFFT_MMA(WM)                                                                    \
  return launch_mma<WM>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, frag, pairs_x, \
                        pairs_y, st)
  if (n <= 16) WATFFT_MMA(1);
  if (n <= 32) WATFFT_MMA(2);
  if (n <= 64) WATFFT_MMA(4);
  WATFFT_MMA(8);
#undef WATFFT_MMA
}

}  // extern "C"
