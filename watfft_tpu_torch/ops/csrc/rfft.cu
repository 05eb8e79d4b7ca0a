// Fused real FFT kernels for Hopper (sm_90a), float32 and float64: r2c
// (forward) and c2r (normalized inverse) of n = 2m real points, in one pass
// each.
//
// rfft_r2c_resident_kernel (f32; rfft_r2c_kernel, its first form, at
// n <= 8) replaces watfft_tpu/ops/pallas_rfft.py::_rfft_fused_kernel
// (deinterleave + m-point stages + Hermitian mirror + post-twiddle) and
// irfft_c2r_resident_kernel (irfft_c2r_kernel, its first form, where the
// host keeps it) replaces ::_irfft_fused_kernel (mirror + pre-process +
// m-point inverse stages with 1/m folded + re-interleave). They compute
// what the TPU kernels compute, in the same row conventions:
//
//   forward  z[j] = x[2j] + i x[2j+1], Z = DFT_m(z),
//            X[k] = E + w_n^k O with E = (A + conj B)/2, O = -i (A - conj B)/2,
//            A = Z[k], B = Z[m-k] (k = 1..m-1); X[0] = Re Z0 + Im Z0 and
//            X[m] = Re Z0 - Im Z0, with imaginary parts exactly 0.
//   inverse  Z[k] = E + w_n^-k O with E = (A + B)/2, O = i (A - B)/2,
//            A = X[k], B = conj X[m-k] (k = 0..m-1, so Z[0] reads the
//            imaginary parts of the DC and Nyquist rows), z = IDFT_m(Z),
//            o[2j] = Re z[j], o[2j+1] = Im z[j].
//
// The post twiddles w_n^{-+k} come from the host table of
// watfft_tpu_torch/ops/rfft.py (rfft_post_twiddles); the m-point stages are
// the engine of stockham.cuh with the m-point plan and twiddle pack.
//
// The FP64 instances (watfft_rfft_r2c_f64, watfft_irfft_c2r_f64) replace
// watfft_tpu/ops/doublefloat.py::df_rfft_nb and ::df_irfft_nb, the f64
// real tier: the df kernel on the m = n/2-point core with the Hermitian
// post or pre in jnp beside it, on hi/lo f32 pairs. Here the same one-pass
// kernels run on double; their m = 4096 block (n = 8192) holds 69.6 KB and
// opts in past the 48 KB default, as the FP64 c2c kernel does. The FP64
// forward runs rfft_r2c_block_f64_kernel: the engine's arithmetic on the
// redesigned walk (a block a tile copied in by cp.async, 16-byte copies
// and stores where the layout allows).
//
// What bounds them: 8 bytes of device memory per real point (4 read, and
// about 4 written as (m+1) complex bins per n reals), against about
// 2.5*log2(n) + 5 flop per real point — far under the card's FP32 ridge,
// so they are memory-bound. The design therefore reads each input once and
// writes each output once, and keeps everything between in shared memory.
//
// Design:
//  * What the TPU needed and Hopper does not. Mosaic cannot reverse rows
//    or gather with a stride inside a kernel, so the TPU kernels deinterleave
//    with a reshape or bf16x3 selection matmuls and mirror Z[m-k] with a
//    blocked 0/1 matmul (pallas_rfft.py:46-160, :489-560). Here a thread
//    simply addresses row m-k of the transform in shared memory, and the
//    deinterleave is the load itself: z[j] is read from x[2j] and x[2j+1]
//    straight into shared memory.
//  * The mirror pair in one thread. Forward: after the stages, one thread
//    takes the pair (k, m-k), reads Z[k] and Z[m-k] once, and writes X[k]
//    and X[m-k] (and X[0], X[m] for k = 0; X[m/2] alone for k = m/2).
//    Inverse: in the load phase one thread reads X[k] and X[m-k] from
//    device memory and writes the pre-processed Z[k] and Z[m-k] to shared
//    memory. Row m of the spectrum therefore never needs a slot in shared
//    memory, whose per-transform stride is sized for the m rows of Z.
//  * Block shape, stages, bank padding and the walk along the smaller
//    stride are those of the c2c kernel (stockham.cu), with n replaced by m.
//  * The f32 forward as resident blocks (rfft_r2c_resident_kernel). The
//    first form, a block a tile at three blocks an SM, ran 4096 x 1024 in
//    40.1 us against 10.0 of bytes: 512 blocks in two waves, the second 29%
//    full, P = 16 spilling under the 85-register bound, scalar loads and
//    stores, and the load, stages and store of a block in turn. The
//    resident kernel keeps its arithmetic: two blocks of 256 threads an SM
//    (128 registers), each looping over tiles of T transforms with the next
//    tile landing by cp.async in a second buffer during the stages and the
//    post; z[j] = (x[2j], x[2j+1]) copied as one 8-byte pair, each bin
//    stored as one 8-byte pair, where the layout allows (PERF.md has the
//    times).
//  * The f32 c2r likewise (irfft_c2r_resident_kernel): its first form
//    held the P = 16 instance to 80 registers (132 bytes of spills) and
//    read four scalars a mirror pair; the redesigned kernel copies the raw
//    bins in by cp.async, runs the pre-process in place in shared memory
//    and stores each pair of samples as one point. The host keeps the
//    first form at n <= 16, and the FP64 c2r keeps it at every n: the
//    redesigned walk measured slower there (PERF.md).
//  * Layouts are strides: the real side has an element stride along n and
//    one along the batch, the spectrum side separate re and im pointers
//    with their own pair, so interleaved complex64 (stride 2), split planes,
//    batch-major [B, n] and time-major [n, B] (the [n, 8, W] view too) all
//    take one launch.
//
// C interface (loaded with ctypes): watfft_rfft_r2c and watfft_irfft_c2r
// (and their _f64 twins on double) launch on the given stream, allocate nothing, and return
// cudaGetLastError() after the launch, or a negative code (the kErr codes
// of stockham.cuh, printed by watfft_error_string) for arguments they
// refuse before launching. The r2c entries' and the f32 c2r's last three
// arguments are the walk and its pairs, which the host picks (ops/rfft.py
// `r2c_launch`, `c2r_launch`).

#include "stockham.cuh"

namespace {

// X = E + w O for the forward pair (A, B) = (Z[k], Z[m-k]).
template <typename C>
__device__ __forceinline__ C post_fwd(C a, C b, C w) {
  using Real = decltype(a.x);
  const Real h = 0.5;
  const Real ere = h * (a.x + b.x), eim = h * (a.y - b.y);
  const Real ore = h * (a.y + b.y), oim = -h * (a.x - b.x);
  return make_c(ere + w.x * ore - w.y * oim, eim + w.x * oim + w.y * ore);
}

// Z = E + w O for the inverse pair A = X[k], B = conj(xb), xb = X[m-k].
template <typename C>
__device__ __forceinline__ C pre_inv(C a, C xb, C w) {
  using Real = decltype(a.x);
  const Real h = 0.5;
  const Real bre = xb.x, bim = -xb.y;
  const Real ere = h * (a.x + bre), eim = h * (a.y + bim);
  const Real ore = -h * (a.y - bim), oim = h * (a.x - bre);
  return make_c(ere + w.x * ore - w.y * oim, eim + w.x * oim + w.y * ore);
}

// Calls f(t, k, g) for the mirror pairs (k, m-k), k = 0..m/2, of transform
// t of the block's tile, g being the offset of the transform's row 0 in
// device memory. Walks along the smaller stride, as for_tile does.
template <typename F>
__device__ __forceinline__ void for_pairs(int m, int T, int count, int64_t first,
                                          int64_t sn, int64_t sb, F f) {
  const int h = m / 2 + 1, units = T * h;
  if (sn <= sb) {
    for (int e = threadIdx.x; e < units; e += blockDim.x) {
      const int t = e / h, k = e - t * h;
      if (t < count) f(t, k, (first + t) * sb);
    }
  } else {
    for (int e = threadIdx.x; e < units; e += blockDim.x) {
      const int k = e / T, t = e - k * T;
      if (t < count) f(t, k, (first + t) * sb);
    }
  }
}

template <typename Real, int P>
__global__ void __launch_bounds__(kBlockThreads, min_blocks_of<Real>(P))
rfft_r2c_kernel(const Real* __restrict__ x, int64_t x_sn, int64_t x_sb,
                Real* __restrict__ yre, Real* __restrict__ yim,
                int64_t y_sn, int64_t y_sb, int64_t batch, int T, int S,
                const Real* __restrict__ twre, const Real* __restrict__ twim,
                const Real* __restrict__ wre, const Real* __restrict__ wim,
                Plan plan) {
  using C = cplx<Real>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  C* smem = reinterpret_cast<C*>(smem_bytes);
  const int m = 1 << plan.log2n;
  const int tpt = m / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  // z[j] = x[2j] + i x[2j+1]: complex point j sits 2j real strides in
  for_tile(plan.log2n, T, count, first, 2 * x_sn, x_sb, [&](int t, int j, int64_t g) {
    smem[t * S + pad(j)] = make_c(x[g], x[g + x_sn]);
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, false>(smem + t * S, th, tpt, plan, twre, twim);

  // Hermitian post, one mirror pair per thread (the stages ended with a sync)
  for_pairs(m, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
    const C* c = smem + t * S;
    if (k == 0) {
      const C z0 = c[0];
      yre[g] = z0.x + z0.y;
      yim[g] = Real(0);
      yre[g + m * y_sn] = z0.x - z0.y;
      yim[g + m * y_sn] = Real(0);
      return;
    }
    const C a = c[pad(k)], b = c[pad(m - k)];
    const C xk = post_fwd(a, b, make_c(__ldg(wre + k), __ldg(wim + k)));
    yre[g + k * y_sn] = xk.x;
    yim[g + k * y_sn] = xk.y;
    if (2 * k != m) {
      const int j = m - k;
      const C xj = post_fwd(b, a, make_c(__ldg(wre + j), __ldg(wim + j)));
      yre[g + j * y_sn] = xj.x;
      yim[g + j * y_sn] = xj.y;
    }
  });
}

template <typename Real, int P>
__global__ void __launch_bounds__(kBlockThreads, min_blocks_of<Real>(P))
irfft_c2r_kernel(const Real* __restrict__ xre, const Real* __restrict__ xim,
                 int64_t x_sn, int64_t x_sb, Real* __restrict__ y,
                 int64_t y_sn, int64_t y_sb, int64_t batch, int T, int S,
                 const Real* __restrict__ twre, const Real* __restrict__ twim,
                 const Real* __restrict__ wre, const Real* __restrict__ wim,
                 Plan plan) {
  using C = cplx<Real>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  C* smem = reinterpret_cast<C*>(smem_bytes);
  const int m = 1 << plan.log2n;
  const int tpt = m / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  // Hermitian pre-process in the load, one mirror pair per thread: Z[0]
  // from X[0] and X[m], Z[k] and Z[m-k] from X[k] and X[m-k]
  for_pairs(m, T, count, first, x_sn, x_sb, [&](int t, int k, int64_t g) {
    C* c = smem + t * S;
    const int j = k == 0 ? m : m - k;
    const C a = make_c(xre[g + k * x_sn], xim[g + k * x_sn]);
    const C b = make_c(xre[g + j * x_sn], xim[g + j * x_sn]);
    c[pad(k)] = pre_inv(a, b, make_c(__ldg(wre + k), __ldg(wim + k)));
    if (k != 0 && 2 * k != m) {
      c[pad(j)] = pre_inv(b, a, make_c(__ldg(wre + j), __ldg(wim + j)));
    }
  });
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, true>(smem + t * S, th, tpt, plan, twre, twim);

  // o[2j] = Re z[j], o[2j+1] = Im z[j] (the stages ended with a sync)
  for_tile(plan.log2n, T, count, first, 2 * y_sn, y_sb, [&](int t, int j, int64_t g) {
    const C z = smem[t * S + pad(j)];
    y[g] = z.x;
    y[g + y_sn] = z.y;
  });
}

// watfft_rfft_r2c's `walk` (stockham.cuh kWalk*): the engine's walk
// (rfft_r2c_kernel, a block a tile) or the resident kernel. The host takes
// the engine's walk at n <= 8 (one radix-m stage, 256 transforms a block),
// where it measured faster at eight blocks an SM than the resident kernel
// at two (PERF.md). The FP64 entry's redesigned walk is a block a tile.

// The f32 r2c kernel (#9) as resident blocks: the grid is the card's SMs
// times kResidentBlocks (P = 16's stages do not spill at 128 registers), and
// block b takes tiles b, b + grid, ... of T transforms; every thread runs
// the same trip count. While the stages and the Hermitian post run on
// tile i, tile i + grid lands in the second buffer by cp.async. The
// deinterleave is the copy: z[j] = (x[2j], x[2j+1]) moves as one 8-byte
// copy where the host asks for pairs (`pairs_x`: the signal's rows
// contiguous and 8-byte aligned), else as two 4-byte copies. Each bin is
// one 8-byte store where it asks for them (`pairs_y`: the spectrum
// interleaved complex64). The arithmetic is rfft_r2c_kernel's.
template <int P>
__global__ void __launch_bounds__(kBlockThreads, kResidentBlocks)
rfft_r2c_resident_kernel(const float* __restrict__ x, int64_t x_sn, int64_t x_sb,
                         float* __restrict__ yre, float* __restrict__ yim,
                         int64_t y_sn, int64_t y_sb, int64_t batch, int T, int S,
                         bool pairs_x, bool pairs_y,
                         const float* __restrict__ twre, const float* __restrict__ twim,
                         const float* __restrict__ wre, const float* __restrict__ wim,
                         Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float2* smem = reinterpret_cast<float2*>(smem_bytes);
  const int m = 1 << plan.log2n;
  const int tpt = m / P;
  const int64_t tiles = (batch + T - 1) / T, step = gridDim.x;
  const int tile_slots = T * S;
  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;

  // tile `tile` into buffer c: z[j] = x[2j] + i x[2j+1], complex point j
  // 2j real strides in; transforms past the batch are not copied
  const auto copy = [&](float2* c, int64_t tile) {
    const int64_t first = tile * T;
    const int count = (int)min((int64_t)T, batch - first);
    for_tile(plan.log2n, T, count, first, 2 * x_sn, x_sb, [&](int t, int j, int64_t g) {
      float2* d = c + t * S + pad(j);
      if (pairs_x) {
        copy_async<8>(d, x + g);
      } else {
        copy_async<4>(&d->x, x + g);
        copy_async<4>(&d->y, x + g + x_sn);
      }
    });
    copy_commit();
  };

  int64_t tile = blockIdx.x;
  if (tile < tiles) copy(smem, tile);
  for (int it = 0; tile < tiles; tile += step, ++it) {
    float2* const c = smem + (it & 1) * tile_slots;
    copy_wait<0>();
    __syncthreads();  // tile i is in c, and every read of the other buffer is done
    if (tile + step < tiles) copy(smem + ((it + 1) & 1) * tile_slots, tile + step);

    run_stages<P, false>(c + t * S, th, tpt, plan, twre, twim);

    // Hermitian post, one mirror pair per thread (the stages ended with a sync)
    const int64_t first = tile * T;
    const int count = (int)min((int64_t)T, batch - first);
    const auto put = [&](int64_t g, float2 v) {
      if (pairs_y) {
        *reinterpret_cast<float2*>(yre + g) = v;
      } else {
        yre[g] = v.x;
        yim[g] = v.y;
      }
    };
    for_pairs(m, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
      const float2* z = c + t * S;
      if (k == 0) {
        const float2 z0 = z[0];
        put(g, make_float2(z0.x + z0.y, 0.0f));
        put(g + m * y_sn, make_float2(z0.x - z0.y, 0.0f));
        return;
      }
      const float2 a = z[pad(k)], b = z[pad(m - k)];
      put(g + k * y_sn, post_fwd(a, b, make_float2(__ldg(wre + k), __ldg(wim + k))));
      if (2 * k != m) {
        const int j = m - k;
        put(g + j * y_sn, post_fwd(b, a, make_float2(__ldg(wre + j), __ldg(wim + j))));
      }
    });
  }
}

// The FP64 r2c kernel on the redesigned walk: a block a tile of T
// transforms, two blocks an SM (128 registers a thread), the tile copied
// by cp.async straight into its padded slots, z[j] = (x[2j], x[2j+1]) as
// one 16-byte copy where the host asks for pairs (`pairs_x`: the signal's
// rows contiguous and 16-byte aligned), else as two; each bin one 16-byte
// store where it asks for them (`pairs_y`: the spectrum interleaved
// complex128). The arithmetic is rfft_r2c_kernel<double>'s. Resident
// blocks with a second buffer fit one block an SM at P = 16 (a tile is
// 69.6 KB) and measured slower at every n (PERF.md).
template <int P>
__global__ void __launch_bounds__(kBlockThreads, kResidentBlocks)
rfft_r2c_block_f64_kernel(const double* __restrict__ x, int64_t x_sn, int64_t x_sb,
                          double* __restrict__ yre, double* __restrict__ yim,
                          int64_t y_sn, int64_t y_sb, int64_t batch, int T, int S,
                          bool pairs_x, bool pairs_y,
                          const double* __restrict__ twre, const double* __restrict__ twim,
                          const double* __restrict__ wre, const double* __restrict__ wim,
                          Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  double2* smem = reinterpret_cast<double2*>(smem_bytes);
  const int m = 1 << plan.log2n;
  const int tpt = m / P;
  const int64_t first = (int64_t)blockIdx.x * T;
  const int count = (int)min((int64_t)T, batch - first);

  // z[j] = x[2j] + i x[2j+1], complex point j 2j real strides in;
  // transforms past the batch are not copied
  for_tile(plan.log2n, T, count, first, 2 * x_sn, x_sb, [&](int t, int j, int64_t g) {
    copy_point(smem + t * S + pad(j), x + g, x + g + x_sn, pairs_x);
  });
  copy_commit();
  copy_wait<0>();
  __syncthreads();

  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  run_stages<P, false>(smem + t * S, th, tpt, plan, twre, twim);

  // Hermitian post, one mirror pair per thread (the stages ended with a sync)
  const auto put = [&](int64_t g, double2 v) { store_point(yre + g, yim + g, v, pairs_y); };
  for_pairs(m, T, count, first, y_sn, y_sb, [&](int t, int k, int64_t g) {
    const double2* z = smem + t * S;
    if (k == 0) {
      const double2 z0 = z[0];
      put(g, make_double2(z0.x + z0.y, 0.0));
      put(g + m * y_sn, make_double2(z0.x - z0.y, 0.0));
      return;
    }
    const double2 a = z[pad(k)], b = z[pad(m - k)];
    put(g + k * y_sn, post_fwd(a, b, make_double2(__ldg(wre + k), __ldg(wim + k))));
    if (2 * k != m) {
      const int j = m - k;
      put(g + j * y_sn, post_fwd(b, a, make_double2(__ldg(wre + j), __ldg(wim + j))));
    }
  });
}

// The f32 c2r kernel (#10) redesigned: irfft_c2r_kernel's arithmetic on
// the walk of the redesigned r2c, resident blocks (`tiles_grid`), 256
// threads at kResidentBlocks an SM (128 registers), each looping over tiles
// of T spectra with the next tile landing by cp.async in a second buffer
// while the current one runs. A tile's bins X[0..m-1] of spectrum t land
// straight in their padded slots (one copy a bin where the host asks for
// pairs, `pairs_x`: the spectrum interleaved complex64; else one a plane),
// and the Nyquist bin X[m], which has no slot of its own (pad(m) is S
// itself at m = 16), in slot T*S + t after the tile's transforms. The
// Hermitian pre-process then runs in place in shared memory, one mirror
// pair per thread, with the pre_inv calls the engine's load makes.
// (Reading Z[k] in the first stage's load instead, which saves the pass
// and a sync, let the compiler contract pre_inv's products into other
// FMAs: the outputs moved by an ulp, so it was not kept.) After the
// stages, o[2j], o[2j+1] = z[j] goes out as one store of the whole point
// where the host asks for it (`pairs_y`: the signal's rows contiguous and
// aligned to a point), else as two (ops/rfft.py `c2r_launch` picks the
// walk; PERF.md has the times that chose it).
template <int P>
__global__ void __launch_bounds__(kBlockThreads, kResidentBlocks)
irfft_c2r_resident_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                          int64_t x_sn, int64_t x_sb, float* __restrict__ y,
                          int64_t y_sn, int64_t y_sb, int64_t batch, int T, int S,
                          bool pairs_x, bool pairs_y,
                          const float* __restrict__ twre, const float* __restrict__ twim,
                          const float* __restrict__ wre, const float* __restrict__ wim,
                          Plan plan) {
  using C = float2;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  C* smem = reinterpret_cast<C*>(smem_bytes);
  const int m = 1 << plan.log2n;
  const int tpt = m / P, pairs = m / 2 + 1;
  const int t = threadIdx.x / tpt, th = threadIdx.x - t * tpt;
  const auto count = [&](int64_t tile) { return (int)min((int64_t)T, batch - tile * T); };

  // spectra past the batch are not copied, and their signals not stored
  const auto copy = [&](C* c, int64_t tile) {
    const int64_t first = tile * T;
    const int cnt = count(tile);
    for_tile(plan.log2n, T, cnt, first, x_sn, x_sb, [&](int t, int k, int64_t g) {
      copy_point(c + t * S + pad(k), xre + g, xim + g, pairs_x);
    });
    for (int u = threadIdx.x; u < cnt; u += blockDim.x) {
      const int64_t g = (first + u) * x_sb + (int64_t)m * x_sn;
      copy_point(c + T * S + u, xre + g, xim + g, pairs_x);
    }
    copy_commit();
  };
  const auto work = [&](C* c, int64_t tile) {
    // Z[0] from X[0] and X[m], Z[k] and Z[m-k] from X[k] and X[m-k], in
    // place, one mirror pair per thread
    for (int e = threadIdx.x; e < T * pairs; e += blockDim.x) {
      const int u = e / pairs, k = e - u * pairs;
      C* const z = c + u * S;
      const C a = z[pad(k)], b = k == 0 ? c[T * S + u] : z[pad(m - k)];
      z[pad(k)] = pre_inv(a, b, make_c(__ldg(wre + k), __ldg(wim + k)));
      if (k != 0 && 2 * k != m) {
        const int j = m - k;
        z[pad(j)] = pre_inv(b, a, make_c(__ldg(wre + j), __ldg(wim + j)));
      }
    }
    __syncthreads();
    run_stages<P, true>(c + t * S, th, tpt, plan, twre, twim);
    // o[2j] = Re z[j], o[2j+1] = Im z[j] (the stages ended with a sync)
    for_tile(plan.log2n, T, count(tile), tile * T, 2 * y_sn, y_sb,
             [&](int t, int j, int64_t g) {
               store_point(y + g, y + g + y_sn, c[t * S + pad(j)], pairs_y);
             });
  };
  for_tiles(smem, T * S + T, (batch + T - 1) / T, 2, copy, work);
}

// The grid of a launch over `batch` transforms, its shared memory, and the
// kernel's opt-in when that is past the default; 0 or an error code.
template <typename Real, typename K>
int launch_grid(K kernel, const Plan& plan, int64_t batch, int T, int& S, size_t& smem,
                unsigned& blocks) {
  S = smem_stride(1 << plan.log2n);
  smem = (size_t)T * S * sizeof(cplx<Real>);
  blocks = (unsigned)((batch + T - 1) / T);
  return opt_in_smem(kernel, smem);
}

template <typename Real>
int r2c(const Real* x, int64_t x_sn, int64_t x_sb, Real* yre, Real* yim, int64_t y_sn,
        int64_t y_sb, int n, int64_t batch, const Real* twre, const Real* twim,
        const int* radices, const int* twoffsets, int nstages, const Real* wre,
        const Real* wim, void* stream) {
  Plan plan;
  int maxr, T;
  if (n < 4 || (n & (n - 1))) return kErrArgs;
  if (const int err = make_plan(n / 2, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = maxr == 2 ? rfft_r2c_kernel<Real, 2> : maxr == 4 ? rfft_r2c_kernel<Real, 4>
              : maxr == 8 ? rfft_r2c_kernel<Real, 8> : rfft_r2c_kernel<Real, 16>;
  int S;
  size_t smem;
  unsigned blocks;
  if (const int err = launch_grid<Real>(kernel, plan, batch, T, S, smem, blocks)) return err;
  kernel<<<blocks, kBlockThreads, smem, st>>>(x, x_sn, x_sb, yre, yim, y_sn, y_sb, batch, T,
                                              S, twre, twim, wre, wim, plan);
  return (int)cudaGetLastError();
}

// The f32 r2c launch: resident blocks of rfft_r2c_resident_kernel,
// kResidentBlocks an SM (`tiles_grid`), each with two tiles of T transforms
// in shared memory.
int r2c_resident(const float* x, int64_t x_sn, int64_t x_sb, float* yre, float* yim,
                 int64_t y_sn, int64_t y_sb, int n, int64_t batch, const float* twre,
                 const float* twim, const int* radices, const int* twoffsets, int nstages,
                 const float* wre, const float* wim, void* stream, bool pairs_x, bool pairs_y) {
  Plan plan;
  int maxr, T;
  if (n < 4 || (n & (n - 1))) return kErrArgs;
  if (const int err = make_plan(n / 2, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  // z[j] = (x[2j], x[2j+1]): point j of the pairs (x, x + x_sn) at stride 2 x_sn
  if ((pairs_x && !complex_pairs(x, x + x_sn, 2 * x_sn, x_sb)) ||
      (pairs_y && !complex_pairs(yre, yim, y_sn, y_sb))) {
    return kErrPairs;
  }
  auto kernel = maxr == 2 ? rfft_r2c_resident_kernel<2> : maxr == 4 ? rfft_r2c_resident_kernel<4>
              : maxr == 8 ? rfft_r2c_resident_kernel<8> : rfft_r2c_resident_kernel<16>;
  const int S = smem_stride(n / 2);
  const size_t smem = 2 * (size_t)T * S * sizeof(float2);
  if (const int err = opt_in_smem(kernel, smem)) return err;
  unsigned grid;
  if (const int err = tiles_grid(kernel, smem, (batch + T - 1) / T, kWalkResident, grid)) {
    return err;
  }
  kernel<<<grid, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, x_sn, x_sb, yre, yim, y_sn, y_sb, batch, T, S, pairs_x, pairs_y, twre, twim, wre, wim,
      plan);
  return (int)cudaGetLastError();
}

// The FP64 r2c launch on the redesigned walk: a block a tile of
// rfft_r2c_block_f64_kernel.
int r2c_block_f64(const double* x, int64_t x_sn, int64_t x_sb, double* yre, double* yim,
                  int64_t y_sn, int64_t y_sb, int n, int64_t batch, const double* twre,
                  const double* twim, const int* radices, const int* twoffsets, int nstages,
                  const double* wre, const double* wim, void* stream, bool pairs_x,
                  bool pairs_y) {
  Plan plan;
  int maxr, T;
  if (n < 4 || (n & (n - 1))) return kErrArgs;
  if (const int err = make_plan(n / 2, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  // z[j] = (x[2j], x[2j+1]): point j of the pairs (x, x + x_sn) at stride 2 x_sn
  if ((pairs_x && !complex_pairs(x, x + x_sn, 2 * x_sn, x_sb)) ||
      (pairs_y && !complex_pairs(yre, yim, y_sn, y_sb))) {
    return kErrPairs;
  }
  auto kernel = maxr == 2 ? rfft_r2c_block_f64_kernel<2> : maxr == 4 ? rfft_r2c_block_f64_kernel<4>
              : maxr == 8 ? rfft_r2c_block_f64_kernel<8> : rfft_r2c_block_f64_kernel<16>;
  int S;
  size_t smem;
  unsigned blocks;
  if (const int err = launch_grid<double>(kernel, plan, batch, T, S, smem, blocks)) return err;
  kernel<<<blocks, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, x_sn, x_sb, yre, yim, y_sn, y_sb, batch, T, S, pairs_x, pairs_y, twre, twim, wre, wim,
      plan);
  return (int)cudaGetLastError();
}

template <typename Real>
int c2r(const Real* xre, const Real* xim, int64_t x_sn, int64_t x_sb, Real* y, int64_t y_sn,
        int64_t y_sb, int n, int64_t batch, const Real* twre, const Real* twim,
        const int* radices, const int* twoffsets, int nstages, const Real* wre,
        const Real* wim, void* stream) {
  Plan plan;
  int maxr, T;
  if (n < 4 || (n & (n - 1))) return kErrArgs;
  if (const int err = make_plan(n / 2, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = maxr == 2 ? irfft_c2r_kernel<Real, 2> : maxr == 4 ? irfft_c2r_kernel<Real, 4>
              : maxr == 8 ? irfft_c2r_kernel<Real, 8> : irfft_c2r_kernel<Real, 16>;
  int S;
  size_t smem;
  unsigned blocks;
  if (const int err = launch_grid<Real>(kernel, plan, batch, T, S, smem, blocks)) return err;
  kernel<<<blocks, kBlockThreads, smem, st>>>(xre, xim, x_sn, x_sb, y, y_sn, y_sb, batch, T,
                                              S, twre, twim, wre, wim, plan);
  return (int)cudaGetLastError();
}

// The f32 c2r launch on the redesigned walk: resident blocks of
// irfft_c2r_resident_kernel, each buffer T spectra and T Nyquist slots.
int c2r_resident(const float* xre, const float* xim, int64_t x_sn, int64_t x_sb, float* y,
                 int64_t y_sn, int64_t y_sb, int n, int64_t batch, const float* twre,
                 const float* twim, const int* radices, const int* twoffsets, int nstages,
                 const float* wre, const float* wim, void* stream, bool pairs_x, bool pairs_y) {
  Plan plan;
  int maxr, T;
  if (n < 4 || (n & (n - 1))) return kErrArgs;
  if (const int err = make_plan(n / 2, batch, radices, twoffsets, nstages, plan, maxr, T)) {
    return err;
  }
  // o[2j], o[2j+1] = z[j]: point j of the pairs (y, y + y_sn) at stride 2 y_sn
  if ((pairs_x && !complex_pairs(xre, xim, x_sn, x_sb)) ||
      (pairs_y && !complex_pairs(y, y + y_sn, 2 * y_sn, y_sb))) {
    return kErrPairs;
  }
  auto kernel = maxr == 2 ? irfft_c2r_resident_kernel<2>
              : maxr == 4 ? irfft_c2r_resident_kernel<4>
              : maxr == 8 ? irfft_c2r_resident_kernel<8>
                          : irfft_c2r_resident_kernel<16>;
  const int S = smem_stride(n / 2);
  const size_t smem = 2 * ((size_t)T * S + T) * sizeof(float2);
  if (const int err = opt_in_smem(kernel, smem)) return err;
  unsigned grid;
  if (const int err = tiles_grid(kernel, smem, (batch + T - 1) / T, kWalkResident, grid)) {
    return err;
  }
  kernel<<<grid, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, x_sn, x_sb, y, y_sn, y_sb, batch, T, S, pairs_x, pairs_y, twre, twim, wre, wim,
      plan);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X = rfft_n(x) for each of `batch` real sequences: element j of sequence b
// sits at j*x_sn + b*x_sb; bin k of the m+1 = n/2+1 at k*y_sn + b*y_sb of
// the planes yre and yim. The m-point forward plan is given as its radices
// and twiddle-pack offsets; wre/wim hold w_n^k, k = 0..m. y must not
// overlap x. walk: 1 the engine's walk (rfft_r2c_kernel), 2 the resident
// kernel; pairs_x, pairs_y: the resident kernel's 8-byte copies of the
// signal and stores of the spectrum, refused (kErrPairs) where the layout
// does not allow them or on the engine's walk.
int watfft_rfft_r2c(const float* x, int64_t x_sn, int64_t x_sb,
                    float* yre, float* yim, int64_t y_sn, int64_t y_sb,
                    int n, int64_t batch, const float* twre, const float* twim,
                    const int* radices, const int* twoffsets, int nstages,
                    const float* wre, const float* wim, void* stream, int walk, int pairs_x,
                    int pairs_y) {
  if (walk == kWalkEngine) {
    if (pairs_x || pairs_y) return kErrPairs;
    return r2c(x, x_sn, x_sb, yre, yim, y_sn, y_sb, n, batch, twre, twim, radices, twoffsets,
               nstages, wre, wim, stream);
  }
  if (walk != kWalkResident) return kErrArgs;
  return r2c_resident(x, x_sn, x_sb, yre, yim, y_sn, y_sb, n, batch, twre, twim, radices,
                      twoffsets, nstages, wre, wim, stream, pairs_x != 0, pairs_y != 0);
}

// The same on float64 signals, spectrum planes and tables, whose
// redesigned walk is 3, a block a tile of rfft_r2c_block_f64_kernel
// (16-byte pairs).
int watfft_rfft_r2c_f64(const double* x, int64_t x_sn, int64_t x_sb,
                        double* yre, double* yim, int64_t y_sn, int64_t y_sb,
                        int n, int64_t batch, const double* twre, const double* twim,
                        const int* radices, const int* twoffsets, int nstages,
                        const double* wre, const double* wim, void* stream, int walk,
                        int pairs_x, int pairs_y) {
  if (walk == kWalkEngine) {
    if (pairs_x || pairs_y) return kErrPairs;
    return r2c(x, x_sn, x_sb, yre, yim, y_sn, y_sb, n, batch, twre, twim, radices, twoffsets,
               nstages, wre, wim, stream);
  }
  if (walk != kWalkBlock) return kErrArgs;
  return r2c_block_f64(x, x_sn, x_sb, yre, yim, y_sn, y_sb, n, batch, twre, twim, radices,
                       twoffsets, nstages, wre, wim, stream, pairs_x != 0, pairs_y != 0);
}

// y = irfft_n(X) for each of `batch` spectra of m+1 bins (bin k of spectrum
// b at k*x_sn + b*x_sb of xre and xim), normalized by 1/n; sample j at
// j*y_sn + b*y_sb. The m-point inverse plan (1/m folded into its last
// stage) is given as its radices and twiddle-pack offsets; wre/wim hold
// w_n^-k, k = 0..m-1. y must not overlap X. walk: 1 the engine's walk
// (irfft_c2r_kernel), 2 resident blocks (irfft_c2r_resident_kernel), any
// other refused (kErrArgs); pairs_x, pairs_y: the resident walk's
// one-point copies of the spectrum and stores of the signal, refused
// (kErrPairs) where the layout does not allow them or on the engine's
// walk.
int watfft_irfft_c2r(const float* xre, const float* xim, int64_t x_sn, int64_t x_sb,
                     float* y, int64_t y_sn, int64_t y_sb,
                     int n, int64_t batch, const float* twre, const float* twim,
                     const int* radices, const int* twoffsets, int nstages,
                     const float* wre, const float* wim, void* stream, int walk, int pairs_x,
                     int pairs_y) {
  if (walk == kWalkEngine) {
    if (pairs_x || pairs_y) return kErrPairs;
    return c2r(xre, xim, x_sn, x_sb, y, y_sn, y_sb, n, batch, twre, twim, radices, twoffsets,
               nstages, wre, wim, stream);
  }
  if (walk != kWalkResident) return kErrArgs;
  return c2r_resident(xre, xim, x_sn, x_sb, y, y_sn, y_sb, n, batch, twre, twim, radices,
                      twoffsets, nstages, wre, wim, stream, pairs_x != 0, pairs_y != 0);
}

// The same on float64 spectrum planes, signals and tables, on the engine's
// walk.
int watfft_irfft_c2r_f64(const double* xre, const double* xim, int64_t x_sn, int64_t x_sb,
                         double* y, int64_t y_sn, int64_t y_sb,
                         int n, int64_t batch, const double* twre, const double* twim,
                         const int* radices, const int* twoffsets, int nstages,
                         const double* wre, const double* wim, void* stream) {
  return c2r(xre, xim, x_sn, x_sb, y, y_sn, y_sb, n, batch, twre, twim, radices, twoffsets,
             nstages, wre, wim, stream);
}

}  // extern "C"
