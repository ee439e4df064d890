// Semi-global matching (SGM) over 2, 4 or 8 paths for Hopper (sm_90a): the
// cost volume with the down path, and one path direction per call.  The
// diagonal pairs are in sgm_diagonal.cu, winner-take-all in sgm_wta.cu and
// the path walk they share in sgm_walk.cuh; each is its own unit, so that
// ops/_build.py compiles them in parallel.
//
// Replaces two of the three TPU kernels of ros_gpu_stereo_processor_tpu/ops/
// sgm_pallas.py (launched by sgm_fused_raw):
//   sgm_cost_down  <- _cost_and_down (K4): the clamped SAD cost volume and the
//                     down path's excess L - C;
//   sgm_cost       <- K4's cost stage alone (2 paths walk no vertical path);
//   sgm_aggregate  <- _aggregate (K5): one path direction, forward or reverse,
//                     writing its excess or, given the opposite direction's,
//                     the pair sum.
// Plain versions: ops/sgm_kernel.py::cost_and_down_plain, cost_volume_plain
// and aggregate_plain.
//
// Layout: every volume is (H, W, nd), disparity innermost.  A walk in any of
// the four directions then reads and writes nd contiguous values per pixel,
// so the horizontal pair needs no transposed copy of the cost volume (the TPU
// version's swapaxes).  The recurrence, per pixel of a path line,
//   m = min_d L(d);  best = min(min(L(d), m + P2), min(L(d+1) + P1, L(d-1) + P1))
//   excess = best - m;  L(d) <- C(d) + excess
// with +1e9 guards at d = -1 and d = nd and the carry starting at 0 (the
// oracle's L0 = C0), is the plain version's, operation for operation.
//
// Storage (mode): 0 = uint16 cost + uint8 excess, 1 = uint16 cost + int16
// excess, 2 = float32 for both.  Modes 0 and 1 are chosen only when every
// stored value is an integer in range, so storage is exact.  The TPU version
// stores the same ranges biased into int16/int8 and stages blocks through
// float32 scratch, because Mosaic lowers only signed float<->int casts and no
// sub-32-bit reshapes; a GPU converts to and from unsigned types directly, so
// neither the bias nor the staging is carried over.  Nor are its band tiling
// (row bands sized to VMEM, carried across sequential grid steps, with padded
// rows and lanes that must stay neutral) and its cost transpose: here a walk
// covers the real H x W and nothing else.
//
// Exactness: the kernels do the plain versions' float32 operations in the
// same order where order matters (in mode 2 the SAD as a column sum over
// the block rows, top to bottom, then a row sum over the block columns, left
// to right), and the library builds with --fmad=false, so kernel and plain version agree bit for bit in every mode,
// float32 included.  In modes 0 and 1 the images are integer (the storage
// contract: uint16 cost only for integer input), every prefiltered value is
// an integer in [0, 2 cap] <= 126 and every partial SAD is an integer below
// 2^24, so float32 sums them exactly in any order: there the cost stage
// slides its sums.
//
// What bounds each on the H100 (752x480, 128 disparities, modes 0/1):
//   sgm_cost_down: device-memory bytes (it writes 46 MB of cost and 46 MB of
//     excess).  Cost stage, modes 0/1 (sgm_cost_slide_kernel): one warp per
//     (32-column segment, strip of rows, 32 consecutive disparities), lane =
//     d, the sad::sweep of sad_window.cuh: rows staged a step ahead by
//     cp.async, column sums sliding down the rows (in registers for block
//     15), window sums across the columns, O(1) per (pixel, d); per output
//     row, lane j writes pixel j's 32 costs, consecutive d, as four 16-byte
//     stores.  The strip height is chosen per shape (sad::pick_rows), so a
//     134-row band fills the card as the whole image does.  Mode 2
//     (sgm_cost_kernel): a block owns one row and 32 columns, stages the
//     window's L and R rows (R with the nd - 1 columns of disparity halo) in
//     shared memory, forms all nd x (32 + 2r) column sums top to bottom and
//     the row sums left to right (about 4 * block additions per (pixel, d)):
//     the plain version's order, on which mode 2's exactness rests.  The
//     down walk is a second launch of the walk kernel inside the same call.
//   sgm_aggregate (and the down walk): bytes (each call reads the cost and
//     the incoming excess once and writes one excess volume) -- but a walk
//     is a chain of dependent steps, one per pixel of a line, and one warp
//     per line gives only 480 (rows) or 752 (columns) warps, 3.6 or 5.7 per
//     SM (1.5 on a 198-row mesh band), too few to hide latency behind other
//     warps: the time is the line's length times one warp's step.  Loads
//     issued a few pixels ahead into registers left ~0.45 us a step, about
//     one device-memory round trip.  So each line stages its pixels through
//     a ring of shared-memory slots by 16-byte cp.async, D pixels ahead
//     (walk_depth: about 16 KB in flight per line), with one source pointer
//     per lane and no branch; a step issues the warp minimum
//     (__reduce_min_sync, on int32 carries in modes 0/1, order-preserving
//     keys in mode 2) and the neighbour shuffles first and uses them only
//     after the wait, the next pixel's reads and the next copy; outputs go
//     out as whole words.  What bounds the step then is its own ~90
//     instructions and the latency of the reduction and the shuffles, not
//     device memory.  On an H100 at 752 x
//     480 x 128 (mode 0) a step takes ~0.07 us on rows without an incoming
//     excess, ~0.09 with one, and ~0.14 on columns, where 752 warps share
//     the 528 SM sub-partitions, two to some.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "sad_window.cuh"
#include "sgm_walk.cuh"

namespace {

constexpr int kCostTileX = 32;          // output columns per block of the mode-2 cost kernel
constexpr int kCostThreads = 256;
constexpr int kSlideWarps = 4;          // most warp jobs per block of the sliding cost kernel
constexpr int kSmemDefault = 48 * 1024;

template <typename T>
__device__ __forceinline__ T st(float v) { return static_cast<T>(v); }

// cost[(y * W + x) * nd + dd] = the SAD of the block window at (y, x) for
// candidate d = mind + dd, or clampv where the right window leaves the image.
template <typename CostT>
__global__ void sgm_cost_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
                                CostT* __restrict__ cost, int H, int W, int nd, int mind,
                                int r, float clampv) {
  extern __shared__ float smem[];
  const int win = 2 * r + 1;
  const int cw = kCostTileX + 2 * r;    // L columns: x0 - r .. x0 + TX + r - 1
  const int rw = cw + nd - 1;           // R columns: x0 - r - mind - nd + 1 ..
  float* Ls = smem;                     // win x cw
  float* Rs = Ls + win * cw;            // win x rw
  float* vs = Rs + win * rw;            // nd x cw column sums

  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kCostTileX;
  const int lx0 = x0 - r;
  const int rx0 = x0 - r - mind - (nd - 1);
  for (int i = threadIdx.x; i < win * cw; i += blockDim.x) {
    const int ry = i / cw, cx = i - ry * cw;
    const int yy = y - r + ry, xx = lx0 + cx;
    Ls[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? lf[static_cast<long long>(yy) * W + xx] : 0.0f;
  }
  for (int i = threadIdx.x; i < win * rw; i += blockDim.x) {
    const int ry = i / rw, cx = i - ry * rw;
    const int yy = y - r + ry, xx = rx0 + cx;
    Rs[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? rf[static_cast<long long>(yy) * W + xx] : 0.0f;
  }
  __syncthreads();

  // column sums of |L - R_d| over the window rows, top to bottom; zero for a
  // column outside the image (the plain version's zero padding of the sums)
  for (int i = threadIdx.x; i < nd * cw; i += blockDim.x) {
    const int dd = i / cw, j = i - dd * cw;
    const int xg = lx0 + j;
    float s = 0.0f;
    if (xg >= 0 && xg < W) {
      const int jr = j + nd - 1 - dd;   // R column of image column xg - (mind + dd)
      s = fabsf(Ls[j] - Rs[jr]);
      for (int k = 1; k < win; ++k) s += fabsf(Ls[k * cw + j] - Rs[k * rw + jr]);
    }
    vs[i] = s;
  }
  __syncthreads();

  // row sums of the column sums, left to right; consecutive threads write
  // consecutive disparities of a pixel
  for (int i = threadIdx.x; i < kCostTileX * nd; i += blockDim.x) {
    const int t = i / nd, dd = i - t * nd;
    const int x = x0 + t;
    if (x >= W) break;                  // i grows with t: the rest are outside too
    const int d = mind + dd;
    const bool ok = (x - d >= r) && (x - d <= W - 1 - r);
    const float* row = vs + dd * cw + t;
    float c = row[0];
    for (int k = 1; k < win; ++k) c += row[k];
    cost[(static_cast<long long>(y) * W + x) * nd + dd] = st<CostT>(ok ? c : clampv);
  }
}

// Modes 0/1: cost[(y * W + x) * nd + dd] by sliding sums.  Warp job =
// (strip, segment, chunk of 32 disparities), chunk fastest, so a block's
// warps share their L columns and most R columns in L1.  Per output row,
// lane j first masks pixel x0 + j's row of the tile, then lane l writes
// candidate l of each pixel: one coalesced 64-byte store per pixel.
__global__ void __launch_bounds__(kSlideWarps * 32)
sgm_cost_slide_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
                      uint16_t* __restrict__ cost, int H, int W, int nd, int mind, int r,
                      int ty, float clampv) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = (nd + 31) >> 5;
  const int segs = (W + sad::kSeg - 1) / sad::kSeg, strips = (H + ty - 1) / ty;
  const long long job = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (job >= static_cast<long long>(segs) * strips * nchunks) return;   // whole warps
  const int chunk = static_cast<int>(job % nchunks);
  const long long tile = job / nchunks;
  const int x0 = static_cast<int>(tile % segs) * sad::kSeg;
  const int y0 = static_cast<int>(tile / segs) * ty;
  const int y1 = min(y0 + ty, H), ncols = min(sad::kSeg, W - x0);
  const int dd0 = chunk * 32, n = min(32, nd - dd0);   // 32, or 16 in a last half chunk
  float* scratch = smem + w * sad::scratch_floats(r);
  float* T = sad::tile(scratch, r);
  auto out_row = [&](int y) {
    if (lane < ncols)   // lane = pixel: mask its own row of the tile
      sad::mask_row(T + lane * sad::kT, x0 + lane, mind + dd0, r, W, n, clampv);
    __syncwarp();
    // lane = d: each pixel's 32 costs in one coalesced 64-byte store
    uint16_t* dst = cost + (static_cast<long long>(y) * W + x0) * nd + dd0 + lane;
    if (lane < n) {
#pragma unroll 8
      for (int j = 0; j < ncols; ++j)
        dst[static_cast<long long>(j) * nd] = st<uint16_t>(T[j * sad::kT + lane]);
    }
  };
  if (r == sad::kRegRadius)
    sad::sweep<true, sad::kRegRadius>(lf, rf, scratch, H, W, r, x0, ncols, y0, y1, mind + dd0,
                                      out_row);
  else
    sad::sweep<true>(lf, rf, scratch, H, W, r, x0, ncols, y0, y1, mind + dd0, out_row);
}

// K5 and K4's down walk: one warp per path line (a column when vertical,
// else a row), walked forward or in reverse, in 1-warp blocks.
template <int K, typename CostT, typename ExcT>
__global__ void __launch_bounds__(32)
sgm_walk_kernel(const CostT* __restrict__ cost, const ExcT* __restrict__ exc_in,
                ExcT* __restrict__ exc_out, int H, int W, int nd, float p1, float p2,
                int vertical, int reverse) {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  const int line = blockIdx.x;          // one warp, one line, per block
  const int len = vertical ? H : W;
  const long long stride = vertical ? static_cast<long long>(W) * nd : nd;   // pixel to pixel
  // element offset of the line's first pixel in walk order (its disparity 0)
  const long long first = (vertical ? static_cast<long long>(line) * nd
                                    : static_cast<long long>(line) * W * nd) +
                          (reverse ? (len - 1) * stride : 0);
  walk_line<K, CostT, ExcT>(cost, exc_in, exc_out, len, first, reverse ? -stride : stride, nd,
                            p1, p2, 0.0f, walk_smem);
}

template <typename CostT, typename ExcT>
cudaError_t launch_walk(const void* cost, const void* exc_in, void* exc_out, int H, int W,
                        int nd, float p1, float p2, int vertical, int reverse,
                        cudaStream_t s) {
  if (H == 0 || W == 0 || nd == 0) return cudaSuccess;
  const cudaError_t ok = walk_args_ok(nd, {cost, exc_in, exc_out});
  if (ok != cudaSuccess) return ok;
  return with_lane_width(nd, [&](auto k) {
    constexpr int K = decltype(k)::value;
    return launch_ring<K, CostT, ExcT>(
        sgm_walk_kernel<K, CostT, ExcT>, exc_in != nullptr, vertical ? W : H, nd, s,
        static_cast<const CostT*>(cost), static_cast<const ExcT*>(exc_in),
        static_cast<ExcT*>(exc_out), H, W, nd, p1, p2, vertical, reverse);
  });
}

// The cost stage of modes 0/1.  tile_rows: rows per warp strip (0:
// sad::pick_rows).
cudaError_t cost_slide(const void* lf, const void* rf, void* cost, int H, int W, int nd,
                       int mind, int r, float clampv, int tile_rows, cudaStream_t s) {
  const long long nchunks = (nd + 31) / 32, segs = (W + sad::kSeg - 1) / sad::kSeg;
  // up to kSlideWarps warps a block, as many as the block size's scratch allows
  const long long per_warp = sad::scratch_floats(r) * static_cast<long long>(sizeof(float));
  const int warps = static_cast<int>(std::min<long long>(kSlideWarps, kSmemMax / per_warp));
  if (warps < 1) return cudaErrorInvalidValue;
  const long long smem = warps * per_warp;
  // on the current device: let the launch (and the occupancy query) use up to kSmemMax
  const cudaError_t err = cudaFuncSetAttribute(
      sgm_cost_slide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return err;
  auto blocks_of = [&](int t) { return (segs * ((H + t - 1) / t) * nchunks + warps - 1) / warps; };
  int ty = tile_rows;
  if (ty <= 0) {
    static int key[4] = {-1, -1, -1, -1}, picked = 0;   // the last shape's choice
    const int k[4] = {H, W, nd, r};
    if (!std::equal(k, k + 4, key)) {
      picked = sad::pick_rows(sgm_cost_slide_kernel, warps * 32, [&](int) { return smem; },
                              blocks_of, H, r, kSmemMax);
      std::copy(k, k + 4, key);
    }
    ty = picked;
  }
  sgm_cost_slide_kernel<<<static_cast<unsigned>(blocks_of(ty)), warps * 32,
                          static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(lf), static_cast<const float*>(rf), static_cast<uint16_t*>(cost),
      H, W, nd, mind, r, ty, clampv);
  return cudaGetLastError();
}

// The cost stage of mode 2, in the plain version's summation order.
template <typename CostT>
cudaError_t cost_plain_order(const void* lf, const void* rf, void* cost, int H, int W, int nd,
                             int mind, int r, float clampv, cudaStream_t s) {
  const long long win = 2 * r + 1, cw = kCostTileX + 2 * r, rw = cw + nd - 1;
  const long long smem = (win * cw + win * rw + nd * cw) * static_cast<long long>(sizeof(float));
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        sgm_cost_kernel<CostT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((W + kCostTileX - 1) / kCostTileX, H);
  sgm_cost_kernel<CostT><<<grid, kCostThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(lf), static_cast<const float*>(rf), static_cast<CostT*>(cost),
      H, W, nd, mind, r, clampv);
  return cudaGetLastError();
}

// The cost stage alone: the storage mode fixes the kernel (integer storage
// slides, float32 keeps the plain order).
template <typename CostT>
cudaError_t cost_stage(const void* lf, const void* rf, void* cost, int H, int W, int nd,
                       int mind, int r, float clampv, int tile_rows, cudaStream_t s) {
  if constexpr (std::is_same_v<CostT, float>)
    return cost_plain_order<CostT>(lf, rf, cost, H, W, nd, mind, r, clampv, s);
  else
    return cost_slide(lf, rf, cost, H, W, nd, mind, r, clampv, tile_rows, s);
}

template <typename CostT, typename ExcT>
cudaError_t cost_down(const void* lf, const void* rf, void* cost, void* exc, int H, int W,
                      int nd, int mind, int r, float clampv, float p1, float p2, int tile_rows,
                      cudaStream_t s) {
  const cudaError_t err = cost_stage<CostT>(lf, rf, cost, H, W, nd, mind, r, clampv, tile_rows, s);
  if (err != cudaSuccess) return err;
  return launch_walk<CostT, ExcT>(cost, nullptr, exc, H, W, nd, p1, p2, 1, 0, s);
}

}  // namespace

// lf, rf: (H, W) float32 prefiltered images; cost, exc: (H, W, nd) outputs in
// the storage types of `mode`.  Two launches: the cost volume, then the down
// walk over it.  tile_rows: rows per warp strip of the mode 0/1 cost stage
// (0: automatic; ignored in mode 2).
extern "C" int sgm_cost_down(const void* lf, const void* rf, void* cost, void* exc, int H,
                             int W, int nd, int mind, int r, float clampv, float p1, float p2,
                             int mode, int tile_rows, void* stream) {
  if (H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(cost_down<uint16_t, uint8_t>(lf, rf, cost, exc, H, W, nd, mind, r, clampv, p1, p2, tile_rows, s));
    case 1: return static_cast<int>(cost_down<uint16_t, int16_t>(lf, rf, cost, exc, H, W, nd, mind, r, clampv, p1, p2, tile_rows, s));
    case 2: return static_cast<int>(cost_down<float, float>(lf, rf, cost, exc, H, W, nd, mind, r, clampv, p1, p2, tile_rows, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cost: (H, W, nd); exc_in: (H, W, nd) or null; exc_out: (H, W, nd).
extern "C" int sgm_aggregate(const void* cost, const void* exc_in, void* exc_out, int H, int W,
                             int nd, float p1, float p2, int vertical, int reverse, int mode,
                             void* stream) {
  if (H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(launch_walk<uint16_t, uint8_t>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s));
    case 1: return static_cast<int>(launch_walk<uint16_t, int16_t>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s));
    case 2: return static_cast<int>(launch_walk<float, float>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// lf, rf as sgm_cost_down's; cost: (H, W, nd) in the cost type of `mode`.
// One launch: sgm_cost_down's cost stage without its down walk (2 paths).
extern "C" int sgm_cost(const void* lf, const void* rf, void* cost, int H, int W, int nd,
                        int mind, int r, float clampv, int mode, int tile_rows, void* stream) {
  if (H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
    case 1: return static_cast<int>(cost_stage<uint16_t>(lf, rf, cost, H, W, nd, mind, r, clampv, tile_rows, s));
    case 2: return static_cast<int>(cost_stage<float>(lf, rf, cost, H, W, nd, mind, r, clampv, tile_rows, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
