// Batched mixed-radix Stockham c2c FFT for Hopper (sm_90a), float32.
//
// Replaces watfft_tpu/ops/pallas_stockham.py::_kernel (the [n, b] plane
// kernel) and ::_kernel_dma3d (the same transform on the [n, 8, W] view).
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
//  * Twiddles come from the packed table through the read-only cache; the
//    largest pack (n=4096) is 2 x 7680 floats and stays in L2.
//  * Constants of the radix-2 network are the f32 roundings of the f64
//    values the JAX kernel uses, and the w = -+i shortcut and the 1/n fold
//    follow pallas_stockham.py:_small_dft and :_stage.
//
// C interface (loaded with ctypes): watfft_stockham_c2c launches on the
// given stream, allocates nothing, and returns cudaGetLastError() after the
// launch, or a negative code for arguments it refuses before launching.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 16;
constexpr int kBlockThreads = 256;

constexpr int kErrArgs = -1;      // n, batch or stage count out of range
constexpr int kErrPlan = -2;      // radix not in {2,4,8,16}, or product != n
constexpr int kErrTooLong = -3;   // a transform needs more than one block

struct Plan {
  int log2n;
  int nstages;
  int radix[kMaxStages];
  int log2l[kMaxStages];   // l = product of the radices of earlier stages
  int twoff[kMaxStages];   // offset into the twiddle pack, -1: twiddle-free
};

// Row k of a transform in shared memory: one float2 of padding every 16.
__device__ __forceinline__ int pad(int k) { return k + (k >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// w16^j = exp(-2 pi i j / 16) for j < 8, rounded to f32 (the constants of
// pallas_stockham.py:_small_dft: math.cos/sin of the f64 angle, taken as
// weak-typed f32). Index j = q * 16 / R for the R-point network's w_R^q.
__device__ __forceinline__ float2 w16(int j, bool inverse) {
  constexpr float kRe[8] = {1.0f, 0.9238795042037964f, 0.7071067690849304f,
                            0.3826834261417389f, 0.0f, -0.3826834261417389f,
                            -0.7071067690849304f, -0.9238795042037964f};
  constexpr float kIm[8] = {-0.0f, -0.3826834261417389f, -0.7071067690849304f,
                            -0.9238795042037964f, -1.0f, -0.9238795042037964f,
                            -0.7071067690849304f, -0.3826834261417389f};
  return make_float2(kRe[j], inverse ? -kIm[j] : kIm[j]);
}

// R-point DFT of in[0], in[S], ..., in[(R-1)S] into out[0..R), by the
// recursive radix-2 network of pallas_stockham.py:_small_dft (even terms,
// odd terms, combine). Fully unrolled: every index is a constant.
template <int R, int S, bool INV>
__device__ __forceinline__ void small_dft(const float2* in, float2* out) {
  if constexpr (R == 1) {
    out[0] = in[0];
  } else {
    constexpr int H = R / 2;
    float2 e[H], o[H];
    small_dft<H, 2 * S, INV>(in, e);
    small_dft<H, 2 * S, INV>(in + S, o);
#pragma unroll
    for (int q = 0; q < H; ++q) {
      float2 t;
      if (q == 0) {
        t = o[0];
      } else if (4 * q == R) {  // w = -+i: (re, im) -> (+-im, -+re)
        t = INV ? make_float2(-o[q].y, o[q].x) : make_float2(o[q].y, -o[q].x);
      } else {
        t = cmul(o[q], w16(q * (16 / R), INV));
      }
      out[q] = make_float2(e[q].x + t.x, e[q].y + t.y);
      out[q + H] = make_float2(e[q].x - t.x, e[q].y - t.y);
    }
  }
}

// One radix-R stage on the transform at c (shared memory), in place. The
// thread does butterflies i = th + m*tpt, m < P/R, of the q = n/R in the
// stage: inputs c[p*q + i], outputs to rows j*R*l + s*l + k (i = j*l + k).
template <int R, int P, bool INV>
__device__ __forceinline__ void stage(float2* c, int th, int tpt, int n,
                                      int log2l, int twoff, bool fold,
                                      const float* __restrict__ twre,
                                      const float* __restrict__ twim) {
  constexpr int M = P / R;
  const int q = n / R;
  const float inv_n = 1.0f / n;
  float2 v[P];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = th + m * tpt;
#pragma unroll
    for (int p = 0; p < R; ++p) v[m * R + p] = c[pad(p * q + i)];
    if (twoff >= 0) {
#pragma unroll
      for (int p = 1; p < R; ++p) {
        const int w = twoff + (p - 1) * q + i;
        v[m * R + p] = cmul(v[m * R + p], make_float2(__ldg(twre + w), __ldg(twim + w)));
      }
    }
    if (fold) {  // inverse final stage: the p >= 1 twiddles already hold 1/n
#pragma unroll
      for (int p = 0; p < R; ++p) {
        if (p == 0 || twoff < 0) {
          v[m * R + p].x *= inv_n;
          v[m * R + p].y *= inv_n;
        }
      }
    }
  }
  __syncthreads();  // every read of this stage is done before any write
  const int lmask = (1 << log2l) - 1;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = th + m * tpt;
    const int base = ((i >> log2l) * R << log2l) + (i & lmask);
    float2 out[R];
    small_dft<R, 1, INV>(v + m * R, out);
#pragma unroll
    for (int s = 0; s < R; ++s) c[pad(base + (s << log2l))] = out[s];
  }
  __syncthreads();
}

template <int R, int P, bool INV>
__device__ __forceinline__ void stage_if(int radix, float2* c, int th, int tpt,
                                         int n, int log2l, int twoff, bool fold,
                                         const float* __restrict__ twre,
                                         const float* __restrict__ twim) {
  if constexpr (R <= P) {
    if (radix == R) stage<R, P, INV>(c, th, tpt, n, log2l, twoff, fold, twre, twim);
  }
}

// Calls f(t, k, g) for point k of transform t of the block's tile, g being
// its element offset in device memory. The walk runs along whichever of the
// two strides is smaller, so neighbouring threads touch neighbouring
// addresses; transforms past the end of the batch are skipped.
template <typename F>
__device__ __forceinline__ void for_tile(int log2n, int T, int count, int64_t first,
                                         int64_t sn, int64_t sb, F f) {
  const int n = 1 << log2n, tile = T << log2n;
  if (sn <= sb) {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int t = e >> log2n, k = e & (n - 1);
      if (t < count) f(t, k, (first + t) * sb + (int64_t)k * sn);
    }
  } else {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int k = e / T, t = e - k * T;
      if (t < count) f(t, k, (first + t) * sb + (int64_t)k * sn);
    }
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

template <int P, bool INV>
__global__ void __launch_bounds__(kBlockThreads, min_blocks(P))
stockham_c2c_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                    float* __restrict__ yre, float* __restrict__ yim,
                    int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                    int64_t batch, int T, int S,
                    const float* __restrict__ twre, const float* __restrict__ twim,
                    Plan plan) {
  extern __shared__ float2 smem[];
  const int n = 1 << plan.log2n;
  const int tpt = n / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  // device memory -> shared memory; transforms past the batch stay unset
  // and their results are never stored
  for_tile(plan.log2n, T, count, first, x_sn, x_sb, [&](int t, int k, int64_t g) {
    smem[t * S + pad(k)] = make_float2(xre[g], xim[g]);
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  float2* c = smem + t * S;
  for (int s = 0; s < plan.nstages; ++s) {
    const int r = plan.radix[s], ll = plan.log2l[s], off = plan.twoff[s];
    const bool fold = INV && s == plan.nstages - 1;
    stage_if<2, P, INV>(r, c, th, tpt, n, ll, off, fold, twre, twim);
    stage_if<4, P, INV>(r, c, th, tpt, n, ll, off, fold, twre, twim);
    stage_if<8, P, INV>(r, c, th, tpt, n, ll, off, fold, twre, twim);
    stage_if<16, P, INV>(r, c, th, tpt, n, ll, off, fold, twre, twim);
  }

  // shared memory -> device memory (the last stage ended with a sync)
  for_tile(plan.log2n, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
    const float2 z = smem[t * S + pad(k)];
    yre[g] = z.x;
    yim[g] = z.y;
  });
}

template <int P, bool INV>
void launch(const float* xre, const float* xim, float* yre, float* yim,
            int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
            int64_t batch, const float* twre, const float* twim,
            const Plan& plan, int T, cudaStream_t stream) {
  const int n = 1 << plan.log2n;
  const int S = (n + (n >> 4)) | 1;  // odd: transforms start on distinct banks
  const size_t smem = (size_t)T * S * sizeof(float2);
  const int64_t blocks = (batch + T - 1) / T;
  auto kernel = stockham_c2c_kernel<P, INV>;
  kernel<<<(unsigned)blocks, kBlockThreads, smem, stream>>>(
      xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, batch, T, S, twre, twim, plan);
}

}  // namespace

extern "C" {

// y = DFT_n(x) for each of `batch` sequences; element (k, b) of a plane sits
// at k*x_sn + b*x_sb (y likewise). y must not overlap x. The plan is given
// as its radices and twiddle-pack offsets, stage by stage.
int watfft_stockham_c2c(const float* xre, const float* xim, float* yre, float* yim,
                        int64_t x_sn, int64_t x_sb, int64_t y_sn, int64_t y_sb,
                        int n, int64_t batch, const float* twre, const float* twim,
                        const int* radices, const int* twoffsets, int nstages,
                        int inverse, void* stream) {
  if (n < 2 || (n & (n - 1)) || batch < 1 || nstages < 1 || nstages > kMaxStages) {
    return kErrArgs;
  }
  Plan plan{};
  plan.nstages = nstages;
  int log2l = 0, maxr = 1;
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
  const int T = kBlockThreads / tpt;  // transforms per block
  if ((batch + T - 1) / T > 0x7fffffff) return kErrArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WATFFT_LAUNCH(P, INV) \
  launch<P, INV>(xre, xim, yre, yim, x_sn, x_sb, y_sn, y_sb, batch, twre, twim, plan, T, st)
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
  return (int)cudaGetLastError();
}

const char* watfft_error_string(int code) {
  switch (code) {
    case kErrArgs: return "n, batch or stage count out of range";
    case kErrPlan: return "stage plan has a radix outside {2,4,8,16} or does not multiply to n";
    case kErrTooLong: return "transform too long for one thread block";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
