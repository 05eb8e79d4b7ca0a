// Batched small-n DFT as one real matrix product, for Hopper (sm_90a), float32.
//
// Replaces watfft_tpu/ops/mxu_dft.py::_kernel, which computes, for each
// column of time-major planes, the n-point DFT as one real product on the
// TPU's matrix unit (MXU):
//
//   Y[2n, b] = W[2n, 2n] @ concat(xre, xim)[2n, b],
//   W = [[Wre, -Wim], [Wim, Wre]],  Wre + i Wim = exp(-+2 pi i k j / n),
//
// the inverse conjugated with 1/n folded into W, at HIGHEST precision
// (f32-class). Hopper has no MXU, and its tensor cores reach f32 accuracy
// only through a split (3xTF32; plain TF32 misses MAX_REL 5e-6), so this
// kernel runs the product on the FP32 cores: every output is a sum
// of 2n f32 FMAs in ascending k order. The matrix is the host's (the wrapper
// passes W^T, [2n, 2n] row-major); n is any of 1..128, a power of two or
// not, as in the JAX function.
//
// What bounds it: 8n^2 flops per transform (4n^2 multiply-adds) against 16n
// bytes (each point read and written once), n/2 flop/B: under the FP32
// ridge of the card (67 TFLOP/s over 3.35 TB/s, ~20 flop/B) up to n = 32,
// operation-bound from n = 64 (at n = 128, 4.29 GFLOP for 2^22 points:
// 64.1 us against 20.0 us of bytes).
//
// Design (a register-tiled SIMT product):
//  * A block of 256 threads takes T transforms. It stages their input tile,
//    [2n, T] f32 (re rows, then im rows), in shared memory once, read along
//    whichever of the two strides is smaller so neighbouring threads touch
//    neighbouring addresses.
//  * W^T streams through shared memory in chunks of KC rows of k (W is
//    256 KB at n = 128: it does not fit beside the tile, but every block
//    reads the same matrix, which stays in L2), double-buffered: the next
//    chunk's copy (cp.async, zero-filled past 2n) is in flight while the
//    block multiplies the current one, so the L2 latency hides behind the
//    FMAs.
//  * The threads form a TY x TX grid; each accumulates an MR x CN register
//    tile of outputs (rows ty*MR.., columns tx*CN..), reading MR values of
//    the W chunk and CN of the tile per k with vector loads: MR*CN FMAs per
//    MR + CN shared-memory reads (64 per 16 at n > 32).
//  * The output tile goes back through the input tile's shared memory and
//    leaves along the smaller stride, like the input.
//  * The tile is padded to MP = TY*MR rows and KP (a multiple of KC) k
//    values; the padding holds zeros and is never stored.
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

}  // namespace

extern "C" {

// y = DFT_n(x) for each of `batch` sequences of n = 1..128 points, as the
// product with W, whose transpose wt is given ([2n, 2n] row-major: wt[k*2n
// + r] = W[r, k]; the inverse's with 1/n folded in). Element (k, b) of a
// plane sits at k*x_sn + b*x_sb (y likewise); y must not overlap x.
int watfft_dft_matmul(const float* xre, const float* xim, float* yre, float* yim,
                      int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                      int n, int64_t batch, const float* wt, void* stream) {
  if (n < 1 || n > kDftMaxN) return kErrDirect;
  if (batch < 1) return kErrArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = 2 * n;
#define WATFFT_DFT(TY, MR, CN) \
  return launch_dft<TY, MR, CN>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, n, batch, wt, st)
  if (K <= 4) WATFFT_DFT(1, 4, 1);
  if (K <= 8) WATFFT_DFT(1, 8, 1);
  if (K <= 16) WATFFT_DFT(2, 8, 2);
  if (K <= 32) WATFFT_DFT(4, 8, 4);
  if (K <= 64) WATFFT_DFT(8, 8, 4);
  if (K <= 128) WATFFT_DFT(16, 8, 8);
  WATFFT_DFT(32, 8, 8);
#undef WATFFT_DFT
}

}  // extern "C"
