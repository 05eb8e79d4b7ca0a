// The 2D FFT of small images for Hopper (sm_90a), float32: for each image
// x[i, j] (i < h, j < w), X[k1, k2] = sum_{i,j} x[i, j] w_h^{i*k1} w_w^{j*k2},
// with 1/(h*w) folded into the inverse (1/h and 1/w into the last stage of
// each axis).
//
// Replaces watfft_tpu/ops/fft2.py::_fft2_cube_kernel (#15): the whole 2D
// transform of an image in one pass through device memory, for
// h*w <= 2^14 points. The TPU kernel ran the h-axis stages on an
// [h, w, 128] block, swapped the two axes in VMEM (Mosaic addresses no
// column), ran the w-axis stages and swapped back. Here a block keeps each
// image in its natural [h, w] order in shared memory and runs the h-point
// stages down the columns through `Strided` rows (stockham.cuh), then the
// w-point stages along the rows in place: no swap, no second buffer and no
// twiddle (a 2D FFT is the four-step of large.cu's cube without either).
// Element (i, j) of image s sits at i*x_sh + j*x_sw + s*x_sb floats past
// xre and xim (y likewise), so one entry serves batch-major planes
// [..., h, w], interleaved complex64 and the native [h, w, B] layout.
//
// Block shape. A block runs NT threads (256; 512 at 2^14 points, where one
// axis may be 8192 points long and take 512 threads; at least the n/P
// threads one transform of either axis takes, up to 512) on G images at once,
// G = max(1, NT * Pmax / (h*w)) (Pmax: the larger of the two plans' largest
// radices), so that small images fill the block: 128 images of 2x2, one of
// 64x64 and up. Every __syncthreads of run_stages must be reached by the
// whole block the same number of times, so each pass hands its G*w columns
// (G*h rows) to the threads in sweeps of NT/tpt transforms, tpt = n/P threads
// each; G*h*w >= NT*Pmax makes the count of sweeps an integer >= 1 for every
// thread in both passes, whatever h, w and their radices.
//
// Bank conflicts. The rows of a column are w + w/16 float2 apart, so the
// column pass hands neighbouring columns (not neighbouring rows of one
// column) to neighbouring threads: a stage's loads and stores of one row
// then fall on neighbouring float2. The row pass keeps the engine's usual
// order (neighbouring points of one row on neighbouring threads).
//
// What bounds it: memory, 16 bytes per point moved once each way (against
// about 5*log2(h*w) flop per point); in practice the stage engine's rate, as
// for every kernel of the port (PERF.md). The loads and stores walk a tile
// along whichever of the point stride and the image stride is smaller. In
// the native [h, w, B] layout with one image per block (h*w >= 4096) the
// block reads its image B floats apart, uncoalesced: the planner sends that
// layout to the two-pass route where it measured faster.
//
// The redesign (fft2_cube_block_kernel). fft2_cube_kernel, the first form
// (the engine's walk), loads with two scalar reads a point into registers
// and a store to shared memory, runs the load, the column pass, the row
// pass and a separate store loop in turn, and holds every instance to the
// 512-thread launch bound. The redesigned kernel keeps its arithmetic and
// changes the walk, as large.cu's cube did: each block size is an instance
// with its own bound (256 threads at two blocks an SM; 512 at 2^14 points,
// one block an SM either way), the tile lands by cp.async with one copy a
// point where re and im are adjacent, and the row pass's last stage stores
// straight to device memory where a row's threads fill a sector. The
// engine's walk stays where it measured faster: native planes whose images
// fill a block (PERF.md).
//
// C interface (loaded with ctypes): the entry launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch, or a
// negative code (stockham.cuh) for arguments it refuses. Its last four
// arguments are the walk and its pairs and store, which the host picks
// (ops/fft2.py `cube2_launch`); the entry sizes the block on either walk.

#include "stockham.cuh"

namespace {

constexpr int kCube2MaxPoints = 1 << 14;
constexpr int kCube2Threads = 512;   // the launch bound; most launches run 256

// Calls f(g, p, off) for point p = i*w + j of image g of the block's tile
// (images first .. first + count - 1), off being its element offset in
// device memory. Neighbouring threads take neighbouring points of an image,
// or neighbouring images where the image stride is the smaller one.
template <typename F>
__device__ __forceinline__ void for_images(int log2h, int log2w, int log2g, int count,
                                           int64_t first, int64_t sh, int64_t sw, int64_t sb,
                                           F f) {
  const int log2hw = log2h + log2w, tile = 1 << (log2hw + log2g);
  const int wmask = (1 << log2w) - 1;
  if (sw <= sb) {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int g = e >> log2hw, p = e & ((1 << log2hw) - 1);
      if (g < count) {
        f(g, p, (first + g) * sb + (int64_t)(p >> log2w) * sh + (int64_t)(p & wmask) * sw);
      }
    }
  } else {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int p = e >> log2g, g = e & ((1 << log2g) - 1);
      if (g < count) {
        f(g, p, (first + g) * sb + (int64_t)(p >> log2w) * sh + (int64_t)(p & wmask) * sw);
      }
    }
  }
}

// 2^log2g images per block, image g at smem + g*S, point (i, j) at
// pad(i*w + j); p1: the h-point plan, p2: the w-point plan.
template <int P1, int P2, bool INV>
__global__ void __launch_bounds__(kCube2Threads, 1)
fft2_cube_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                 float* __restrict__ yre, float* __restrict__ yim,
                 int64_t x_sh, int64_t x_sw, int64_t x_sb,
                 int64_t y_sh, int64_t y_sw, int64_t y_sb,
                 int64_t batch, int log2g, int S,
                 const float* __restrict__ t1re, const float* __restrict__ t1im, Plan p1,
                 const float* __restrict__ t2re, const float* __restrict__ t2im, Plan p2) {
  extern __shared__ float2 smem[];
  const int log2h = p1.log2n, log2w = p2.log2n;
  const int64_t first = (int64_t)blockIdx.x << log2g;
  const int count = (int)min((int64_t)1 << log2g, batch - first);
  const int nt = blockDim.x;

  for_images(log2h, log2w, log2g, count, first, x_sh, x_sw, x_sb,
             [&](int g, int p, int64_t o) { smem[g * S + pad(p)] = make_float2(xre[o], xim[o]); });
  __syncthreads();

  // h-point FFTs down the G*w columns, neighbouring columns on neighbouring
  // threads (per: columns a sweep runs, a power of two)
  {
    const int tpt = (1 << log2h) / P1, per = nt / tpt;
    const int c0 = threadIdx.x & (per - 1), th = threadIdx.x / per;
    const int wmask = (1 << log2w) - 1;
    for (int c = c0; c < (1 << (log2g + log2w)); c += per) {
      run_stages<P1, INV>(smem + (c >> log2w) * S, th, tpt, p1, t1re, t1im,
                          Strided{c & wmask, log2w});
    }
  }

  // w-point FFTs along the G*h rows, in place
  {
    const int tpt = (1 << log2w) / P2, per = nt / tpt;
    const int r0 = threadIdx.x / tpt, th = threadIdx.x - r0 * tpt;
    const int hmask = (1 << log2h) - 1;
    for (int r = r0; r < (1 << (log2g + log2h)); r += per) {
      run_stages<P2, INV>(smem + (r >> log2h) * S, th, tpt, p2, t2re, t2im,
                          Strided{(r & hmask) << log2w, 0});
    }
  }

  // run_stages ended with a block sync
  for_images(log2h, log2w, log2g, count, first, y_sh, y_sw, y_sb, [&](int g, int p, int64_t o) {
    const float2 z = smem[g * S + pad(p)];
    yre[o] = z.x;
    yim[o] = z.y;
  });
}

// The cube redesigned (#15): fft2_cube_kernel's arithmetic on the walk of
// large.cu's cube_kernel, a block a tile of G images as above. NT threads a
// block, as the engine's walk sizes it: 256 at two blocks an SM, 512 at
// one (2^14 points, or an axis whose transform takes more than 256
// threads), 128 registers a thread either way. The 512-thread instances
// are built for the radix pairs with a radix-16 axis, which the port's
// own plans give wherever a block takes 512 threads. The tile lands by cp.async, all of a thread's
// copies in flight at once, one copy a point where the host asks for pairs
// (`pairs_x`: re and im adjacent in 8-byte aligned points, as in
// interleaved complex64 and rfft2's packed real input), else one a plane.
// The column pass is fft2_cube_kernel's. The row pass runs its stages in
// shared memory; where the host asks for it (`direct`: the output's point
// stride is the smaller one and a row's threads span a 32-byte sector),
// its last stage stores straight to device memory, neighbouring points of
// a row on neighbouring threads, and otherwise a loop stores the tile
// along the smaller of the point and image strides after the pass. Stores
// move one point where `pairs_y`, else one plane at a time (ops/fft2.py
// `cube2_launch` picks the walk; PERF.md has the times that chose it).
// Resident blocks with a second buffer for the next tile measured slower
// than a block a tile at every h*w <= 2^13 (the next tile's copies add
// nothing where two blocks an SM already overlap one's copies with the
// other's passes): not kept.
constexpr int cube2_min_blocks(int NT) { return NT == kCube2Threads ? 1 : 2; }

template <int P1, int P2, bool INV, int NT>
__global__ void __launch_bounds__(NT, cube2_min_blocks(NT))
fft2_cube_block_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                       float* __restrict__ yre, float* __restrict__ yim,
                       int64_t x_sh, int64_t x_sw, int64_t x_sb,
                       int64_t y_sh, int64_t y_sw, int64_t y_sb,
                       int64_t batch, int log2g, int S, bool pairs_x, bool pairs_y, bool direct,
                       const float* __restrict__ t1re, const float* __restrict__ t1im, Plan p1,
                       const float* __restrict__ t2re, const float* __restrict__ t2im,
                       Plan p2) {
  extern __shared__ float2 smem[];
  const int log2h = p1.log2n, log2w = p2.log2n;
  const int hmask = (1 << log2h) - 1, wmask = (1 << log2w) - 1;
  const int64_t first = (int64_t)blockIdx.x << log2g;
  const int count = (int)min((int64_t)1 << log2g, batch - first);

  // images past the batch are not copied, and their results not stored
  for_images(log2h, log2w, log2g, count, first, x_sh, x_sw, x_sb,
             [&](int g, int p, int64_t o) {
               copy_point(smem + g * S + pad(p), xre + o, xim + o, pairs_x);
             });
  copy_commit();
  copy_wait<0>();
  __syncthreads();

  // h-point FFTs down the G*w columns, neighbouring columns on neighbouring
  // threads (ctpt threads a column, cper columns at a time)
  {
    const int ctpt = (1 << log2h) / P1, cper = NT / ctpt;
    const int c0 = threadIdx.x & (cper - 1), cth = threadIdx.x / cper;
    for (int col = c0; col < (1 << (log2g + log2w)); col += cper) {
      run_stages<P1, INV>(smem + (col >> log2w) * S, cth, ctpt, p1, t1re, t1im,
                          Strided{col & wmask, log2w});
    }
  }

  // w-point FFTs along the G*h rows, in place (rtpt threads a row, rper
  // rows at a time)
  const int rtpt = (1 << log2w) / P2, rper = NT / rtpt;
  const int r0 = threadIdx.x / rtpt, rth = threadIdx.x - r0 * rtpt;
  if (!direct) {
    for (int r = r0; r < (1 << (log2g + log2h)); r += rper) {
      run_stages<P2, INV>(smem + (r >> log2h) * S, rth, rtpt, p2, t2re, t2im,
                          Strided{(r & hmask) << log2w, 0});
    }
    // run_stages ended with a block sync
    for_images(log2h, log2w, log2g, count, first, y_sh, y_sw, y_sb,
               [&](int g, int p, int64_t o) {
                 store_point(yre + o, yim + o, smem[g * S + pad(p)], pairs_y);
               });
    return;
  }
  const int last = p2.nstages - 1;
  for (int base = 0; base < (1 << (log2g + log2h)); base += rper) {
    const int r = base + r0, g = r >> log2h, rb = (r & hmask) << log2w;
    float2* const row = smem + g * S;
    const auto from_row = [&](int k) { return row[pad(rb + k)]; };
    const auto to_row = [&](int k, float2 z) { row[pad(rb + k)] = z; };
    const int64_t yo = (first + g) * y_sb + (int64_t)(r & hmask) * y_sh;
    const bool live = g < count;
    const auto to_y = [&](int k, float2 z) {
      const int64_t o = yo + k * y_sw;
      if (live) store_point(yre + o, yim + o, z, pairs_y);
    };
    for (int st = 0; st < last; ++st) {
      stage_at<P2, INV>(p2, st, rth, rtpt, t2re, t2im, true, from_row, to_row);
      __syncthreads();
    }
    stage_at<P2, INV>(p2, last, rth, rtpt, t2re, t2im, false, from_row, to_y);
  }
}

struct Cube2Args {
  const float *xre, *xim;
  float *yre, *yim;
  int64_t x_sh, x_sw, x_sb, y_sh, y_sw, y_sb, batch;
  int log2g, S;
  const float *t1re, *t1im, *t2re, *t2im;
  Plan p1, p2;
};

template <int P1, int P2, bool INV>
int launch_cube2(const Cube2Args& a, int nt, int64_t blocks, size_t smem, cudaStream_t st) {
  auto kernel = fft2_cube_kernel<P1, P2, INV>;
  // over the default: opt in (at most 139 KB, at 2^14 points)
  if (const int err = opt_in_smem(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, nt, smem, st>>>(a.xre, a.xim, a.yre, a.yim, a.x_sh, a.x_sw, a.x_sb,
                                             a.y_sh, a.y_sw, a.y_sb, a.batch, a.log2g, a.S,
                                             a.t1re, a.t1im, a.p1, a.t2re, a.t2im, a.p2);
  return (int)cudaGetLastError();
}

template <int P1, bool INV>
int launch_p2(int P2, const Cube2Args& a, int nt, int64_t blocks, size_t smem, cudaStream_t st) {
  switch (P2) {
    case 2:  return launch_cube2<P1, 2, INV>(a, nt, blocks, smem, st);
    case 4:  return launch_cube2<P1, 4, INV>(a, nt, blocks, smem, st);
    case 8:  return launch_cube2<P1, 8, INV>(a, nt, blocks, smem, st);
    default: return launch_cube2<P1, 16, INV>(a, nt, blocks, smem, st);
  }
}

template <bool INV>
int launch_p1(int P1, int P2, const Cube2Args& a, int nt, int64_t blocks, size_t smem,
              cudaStream_t st) {
  switch (P1) {
    case 2:  return launch_p2<2, INV>(P2, a, nt, blocks, smem, st);
    case 4:  return launch_p2<4, INV>(P2, a, nt, blocks, smem, st);
    case 8:  return launch_p2<8, INV>(P2, a, nt, blocks, smem, st);
    default: return launch_p2<16, INV>(P2, a, nt, blocks, smem, st);
  }
}

// The redesigned walk's launch (fft2_cube_block_kernel), a block a tile.
struct Cube2Walk {
  bool pairs_x, pairs_y, direct;
};

template <int P1, int P2, bool INV, int NT>
int launch_block(const Cube2Args& a, const Cube2Walk& k, cudaStream_t st) {
  auto kernel = fft2_cube_block_kernel<P1, P2, INV, NT>;
  const size_t smem = ((size_t)a.S << a.log2g) * sizeof(float2);
  if (const int err = opt_in_smem(kernel, smem)) return err;
  const int64_t tiles = (a.batch + (1 << a.log2g) - 1) >> a.log2g;
  kernel<<<(unsigned)tiles, NT, smem, st>>>(a.xre, a.xim, a.yre, a.yim, a.x_sh, a.x_sw, a.x_sb,
                                            a.y_sh, a.y_sw, a.y_sb, a.batch, a.log2g, a.S,
                                            k.pairs_x, k.pairs_y, k.direct, a.t1re, a.t1im,
                                            a.p1, a.t2re, a.t2im, a.p2);
  return (int)cudaGetLastError();
}

template <int P1, bool INV, int NT>
int block_p2(int P2, const Cube2Args& a, const Cube2Walk& k, cudaStream_t st) {
  switch (P2) {
    case 2:  return launch_block<P1, 2, INV, NT>(a, k, st);
    case 4:  return launch_block<P1, 4, INV, NT>(a, k, st);
    case 8:  return launch_block<P1, 8, INV, NT>(a, k, st);
    default: return launch_block<P1, 16, INV, NT>(a, k, st);
  }
}

template <bool INV, int NT>
int block_p1(int P1, int P2, const Cube2Args& a, const Cube2Walk& k, cudaStream_t st) {
  switch (P1) {
    case 2:  return block_p2<2, INV, NT>(P2, a, k, st);
    case 4:  return block_p2<4, INV, NT>(P2, a, k, st);
    case 8:  return block_p2<8, INV, NT>(P2, a, k, st);
    default: return block_p2<16, INV, NT>(P2, a, k, st);
  }
}

// The 512-thread instances: only the radix pairs with a radix-16 axis.
template <bool INV>
int block_512(int P1, int P2, const Cube2Args& a, const Cube2Walk& k, cudaStream_t st) {
  constexpr int NT = kCube2Threads;
  switch (P1) {
    case 2:  return launch_block<2, 16, INV, NT>(a, k, st);
    case 4:  return launch_block<4, 16, INV, NT>(a, k, st);
    case 8:  return launch_block<8, 16, INV, NT>(a, k, st);
    default: return block_p2<16, INV, NT>(P2, a, k, st);
  }
}

// The card's opt-in shared memory a block; 0 or a CUDA error.
int optin_smem(int& optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return (int)e;
}

// The plan of one axis of the cube. make_plan refuses a plan whose
// transform takes more than kBlockThreads threads (kErrTooLong) after
// filling `plan` and `maxr`; the cube's blocks run up to kCube2Threads, so
// an axis of 8192 points (512 threads at radix 16) is taken here.
int axis_plan(int n, const int* radices, const int* offsets, int nstages, Plan& plan,
              int& maxr) {
  int T;
  const int err = make_plan(n, 1, radices, offsets, nstages, plan, maxr, T);
  return err == kErrTooLong && n / maxr <= kCube2Threads ? 0 : err;
}

}  // namespace

extern "C" {

// y = DFT2(x) for each of `batch` images of h x w points, h*w <= 2^14:
// element (i, j) of image s at i*x_sh + j*x_sw + s*x_sb floats past xre and
// xim, y likewise; y must not overlap x. The h-point plan (radices,
// offsets, stage count, twiddle pack t1) and the w-point plan (t2) are of
// the direction asked for. walk: 1 the engine's walk (fft2_cube_kernel; the
// last three arguments 0), 3 a block a tile of fft2_cube_block_kernel, any
// other refused (kErrArgs). Either walk's block is 256 threads, 512 at
// 2^14 points or where a transform of an axis takes more than 256; the
// redesigned walk refuses a 512-thread block on plans with no radix-16
// axis (kErrArgs: the port's own plans always have one there). pairs_x,
// pairs_y: its one-point copies of x and stores of y, refused (kErrPairs)
// where re and im are not adjacent in 8-byte aligned points with even
// strides; direct: its row pass's last stage stores y.
int watfft_fft2_cube(const float* xre, const float* xim, float* yre, float* yim,
                     int64_t x_sh, int64_t x_sw, int64_t x_sb,
                     int64_t y_sh, int64_t y_sw, int64_t y_sb,
                     int h, int w, int64_t batch,
                     const float* t1re, const float* t1im, const int* r1, const int* o1, int ns1,
                     const float* t2re, const float* t2im, const int* r2, const int* o2, int ns2,
                     int inverse, void* stream, int walk, int pairs_x, int pairs_y, int direct) {
  Cube2Args a{xre, xim, yre, yim, x_sh, x_sw, x_sb, y_sh, y_sw, y_sb, batch, 0, 0,
              t1re, t1im, t2re, t2im, Plan{}, Plan{}};
  int P1, P2;
  if (const int err = axis_plan(h, r1, o1, ns1, a.p1, P1)) return err;
  if (const int err = axis_plan(w, r2, o2, ns2, a.p2, P2)) return err;
  const int hw = h * w;
  if (hw > kCube2MaxPoints || batch < 1) return kErrArgs;
  // every transform of a pass needs its n/P threads in the block (a plan
  // with small radices, from the caller's tables, may take up to 512)
  const int tpt = h / P1 > w / P2 ? h / P1 : w / P2;
  const int pmax = P1 > P2 ? P1 : P2;
  int nt = hw == kCube2MaxPoints ? kCube2Threads : kBlockThreads;
  if (tpt > nt) nt = tpt;  // a power of two <= kCube2Threads (axis_plan)
  const int g = nt * pmax > hw ? nt * pmax / hw : 1;
  a.log2g = __builtin_ctz(g);
  a.S = smem_stride(hw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int optin = 0;
  if (walk != kWalkEngine) {
    if (walk != kWalkBlock || (nt == kCube2Threads && pmax != 16)) return kErrArgs;
    if ((pairs_x && !(complex_pairs(xre, xim, x_sw, x_sb) && x_sh % 2 == 0)) ||
        (pairs_y && !(complex_pairs(yre, yim, y_sw, y_sb) && y_sh % 2 == 0))) {
      return kErrPairs;
    }
    const Cube2Walk k{pairs_x != 0, pairs_y != 0, direct != 0};
    if ((batch + g - 1) / g > 0x7fffffff) return kErrArgs;
    if (const int err = optin_smem(optin)) return err;
    if ((size_t)g * a.S * sizeof(float2) > (size_t)optin) return kErrArgs;
    if (nt == kCube2Threads) {
      return inverse ? block_512<true>(P1, P2, a, k, st) : block_512<false>(P1, P2, a, k, st);
    }
    return inverse ? block_p1<true, kBlockThreads>(P1, P2, a, k, st)
                   : block_p1<false, kBlockThreads>(P1, P2, a, k, st);
  }
  if (pairs_x || pairs_y || direct) return kErrPairs;  // the engine's walk takes none
  const int64_t blocks = (batch + g - 1) / g;
  if (blocks > 0x7fffffff) return kErrArgs;
  const size_t smem = (size_t)g * a.S * sizeof(float2);
  if (smem > 48 * 1024) {
    if (const int err = optin_smem(optin)) return err;
    if (smem > (size_t)optin) return kErrArgs;
  }
  return inverse ? launch_p1<true>(P1, P2, a, nt, blocks, smem, st)
                 : launch_p1<false>(P1, P2, a, nt, blocks, smem, st);
}

}  // extern "C"
