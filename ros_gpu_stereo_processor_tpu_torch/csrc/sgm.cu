// Fused 4-path semi-global matching (SGM) for Hopper (sm_90a): cost volume
// with the down path, one path direction per call, and winner-take-all.
//
// Replaces the three TPU kernels of ros_gpu_stereo_processor_tpu/ops/
// sgm_pallas.py (launched by sgm_fused_raw):
//   sgm_cost_down  <- _cost_and_down (K4): the clamped SAD cost volume and the
//                     down path's excess L - C;
//   sgm_aggregate  <- _aggregate (K5): one path direction, forward or reverse,
//                     writing its excess or, given the opposite direction's,
//                     the pair sum;
//   sgm_wta        <- _wta (K6): winner-take-all with the parabolic subpixel
//                     step and the uniqueness sweep over
//                     total = (4 * cost + exc_v) + exc_h.
// Plain versions: ops/sgm_kernel.py::cost_and_down_plain, aggregate_plain and
// wta_plain.
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
// same order where order matters (the WTA total as (4c + ev) + eh; in mode
// 2 the SAD as a column sum over the block rows, top to bottom, then a row
// sum over the block columns, left to right), and the library builds with
// --fmad=false, so kernel and plain version agree bit for bit in every mode,
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
//   sgm_aggregate: bytes (reads the cost and the incoming excess once, writes
//     one excess volume) -- but a walk is a chain of dependent steps, and one
//     warp per line gives only 480 (rows) or 752 (columns) warps, about 4 or 6
//     per SM, so it is latency-bound first.  Each lane keeps nd / 32
//     consecutive disparities of the carry in registers; the min over d is
//     one __reduce_min_sync on order-preserving integer keys, the d +- 1
//     neighbours across lanes come by one shuffle each, and the loads of the
//     next 4 pixels of the line are in flight while a step computes.
//   sgm_wta: bytes (reads three volumes once, writes three maps).  One warp
//     per pixel reads its nd totals coalesced (lane l holds nd / 32 of them);
//     the best is the warp minimum and its disparity the smallest index that
//     holds it, which is what a running strict-< scan keeps (ties to the
//     smallest d; min_disparity - 2 where every candidate is masked, as on
//     the TPU).  The costs at best +- 1 and, with uniqueness, the smallest
//     total outside best +- 1 are further warp minima.  (A first design with
//     one thread per pixel looping over d read each pixel's nd values from a
//     different cache line per lane and ran slower than the plain version.)

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sad_window.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCostTileX = 32;          // output columns per block of the mode-2 cost kernel
constexpr int kCostThreads = 256;
constexpr int kSlideWarps = 4;          // most warp jobs per block of the sliding cost kernel
constexpr int kWalkWarps = 4;           // path lines per block of the walk kernel
constexpr int kWtaThreads = 128;
constexpr long long kWtaMaxBlocks = 132 * 32;   // grid-stride beyond this
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;        // dynamic shared memory an H100 block may opt into

template <typename T>
__device__ __forceinline__ float ld(const T* p) { return static_cast<float>(*p); }

template <typename T>
__device__ __forceinline__ T st(float v) { return static_cast<T>(v); }

// A float's bits mapped to an unsigned key of the same order, and back, so
// a warp minimum is one __reduce_min_sync (min is exact in either form).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float warp_min(float v) {
  return unordered(__reduce_min_sync(kFull, ordered(v)));
}

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

// One warp per path line (a column when vertical, else a row), walked
// forward or in reverse.  Lane l holds disparities l * K .. l * K + K - 1.
// The loads of the next PF pixels are in flight while a step computes.
template <int K, typename CostT, typename ExcT>
__global__ void sgm_walk_kernel(const CostT* __restrict__ cost, const ExcT* __restrict__ exc_in,
                                ExcT* __restrict__ exc_out, int H, int W, int nd, float p1,
                                float p2, int vertical, int reverse) {
  constexpr int PF = K <= 8 ? 4 : 1;
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int n_lines = vertical ? W : H;
  const int len = vertical ? H : W;
  if (line >= n_lines) return;          // whole warps: every shuffle sees a full warp
  const long long pix_step = vertical ? static_cast<long long>(W) * nd : nd;
  const long long base = vertical ? static_cast<long long>(line) * nd
                                  : static_cast<long long>(line) * W * nd;
  const int d0 = lane * K;
  auto offset = [&](int s) { return base + (reverse ? len - 1 - s : s) * pix_step + d0; };

  // the ring holds the loaded values in their storage types: converting
  // them only where a step uses them keeps the warp from stalling on a load
  // right after starting it
  float L[K];
  CostT cb[PF][K];
  ExcT eb[PF][K];
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = d0 + k < nd ? 0.0f : kBig;
#pragma unroll
  for (int j = 0; j < PF; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cb[j][k] = CostT(0);
      eb[j][k] = ExcT(0);
      if (j < len && d0 + k < nd) {
        const long long o = offset(j);
        cb[j][k] = cost[o + k];
        if (exc_in != nullptr) eb[j][k] = exc_in[o + k];
      }
    }
  }
  for (int s0 = 0; s0 < len; s0 += PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int s = s0 + j;
      if (s >= len) break;              // uniform across the warp
      const long long o = offset(s);
      CostT c[K];
      ExcT ei[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[k] = cb[j][k];
        ei[k] = eb[j][k];
      }
      if (s + PF < len) {               // refill this slot with pixel s + PF
        const long long on = offset(s + PF);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (d0 + k < nd) {
            cb[j][k] = cost[on + k];
            if (exc_in != nullptr) eb[j][k] = exc_in[on + k];
          }
        }
      }

      float m = L[0];
#pragma unroll
      for (int k = 1; k < K; ++k) m = fminf(m, L[k]);
      m = warp_min(m);
      float up_edge = __shfl_down_sync(kFull, L[0], 1);     // d = d0 + K, from lane + 1
      float dn_edge = __shfl_up_sync(kFull, L[K - 1], 1);   // d = d0 - 1, from lane - 1
      if (lane == 31) up_edge = kBig;
      if (lane == 0) dn_edge = kBig;

      float Ln[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float up = k + 1 < K ? L[k + 1] : up_edge;
        const float dn = k > 0 ? L[k - 1] : dn_edge;
        const float best = fminf(fminf(L[k], m + p2), fminf(up + p1, dn + p1));
        const float e = best - m;
        if (d0 + k < nd) {
          Ln[k] = static_cast<float>(c[k]) + e;
          exc_out[o + k] = st<ExcT>(exc_in != nullptr ? e + static_cast<float>(ei[k]) : e);
        } else {
          Ln[k] = kBig;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) L[k] = Ln[k];
    }
  }
}

template <typename CostT, typename ExcT>
__device__ __forceinline__ float total_at(const CostT* cost, const ExcT* ev, const ExcT* eh,
                                          long long o, int dd, int x, int mind, int r, int W) {
  const int d = mind + dd;
  const bool ok = (x - d >= r) && (x - d <= W - 1 - r);
  const float t = (4.0f * ld(cost + o + dd) + ld(ev + o + dd)) + ld(eh + o + dd);
  return ok ? t : kBig;
}

// One warp per pixel (grid-stride over the pixels), lane l holding the
// totals of disparities l * K .. l * K + K - 1: the first minimum is the
// smallest index whose total equals the warp minimum, as a running
// strict-< scan from 1e9 finds it.
template <int K, typename CostT, typename ExcT>
__global__ void sgm_wta_kernel(const CostT* __restrict__ cost, const ExcT* __restrict__ ev,
                               const ExcT* __restrict__ eh, float* __restrict__ disp_raw,
                               float* __restrict__ best_cost, float* __restrict__ excl,
                               int H, int W, int nd, int mind, int r, int refine, int uniq) {
  const int lane = threadIdx.x & 31;
  const long long n = static_cast<long long>(H) * W;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int d0 = lane * K;
  for (long long p = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       p < n; p += n_warps) {
    const int x = static_cast<int>(p % W);
    const long long o = p * nd;
    float t[K];
    float lo = kBig;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      t[k] = d0 + k < nd ? total_at(cost, ev, eh, o, d0 + k, x, mind, r, W) : kBig;
      lo = fminf(lo, t[k]);
    }
    const float best = warp_min(lo);
    unsigned first = 0xffffffffu;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (d0 + k < nd && t[k] == best) first = min(first, static_cast<unsigned>(d0 + k));
    first = __reduce_min_sync(kFull, first);
    const int bd = best < kBig ? static_cast<int>(first) : -2;   // -2: every candidate masked

    float disp = static_cast<float>(bd + mind);
    if (refine) {
      // the plain version's parabolic step, operation for operation
      float cm_l = kBig, cp_l = kBig;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (d0 + k == bd - 1) cm_l = t[k];
        if (d0 + k == bd + 1) cp_l = t[k];
      }
      const float cm = warp_min(cm_l), cp = warp_min(cp_l);
      const float denom = (cm + cp) - 2.0f * best;
      float delta = denom > 0.0f ? (cm - cp) / (2.0f * denom) : 0.0f;
      delta = fminf(fmaxf(delta, -0.5f), 0.5f);
      const bool interior = bd > 0 && bd < nd - 1 && cm < kBig && cp < kBig;
      disp = disp + (interior ? delta : 0.0f);
    }
    float ex = kBig;
    if (uniq) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (d0 + k < nd && abs(d0 + k - bd) > 1) ex = fminf(ex, t[k]);
      ex = warp_min(ex);
    }
    if (lane == 0) {
      disp_raw[p] = disp;
      best_cost[p] = best;
      excl[p] = ex;
    }
  }
}

template <typename CostT, typename ExcT>
cudaError_t launch_walk(const void* cost, const void* exc_in, void* exc_out, int H, int W,
                        int nd, float p1, float p2, int vertical, int reverse,
                        cudaStream_t s) {
  const int lines = vertical ? W : H;
  if (lines == 0 || nd == 0) return cudaSuccess;
  const dim3 grid((lines + kWalkWarps - 1) / kWalkWarps), block(32 * kWalkWarps);
  const CostT* c = static_cast<const CostT*>(cost);
  const ExcT* ei = static_cast<const ExcT*>(exc_in);
  ExcT* eo = static_cast<ExcT*>(exc_out);
  const int per_lane = (nd + 31) / 32;
  if (per_lane <= 1)
    sgm_walk_kernel<1, CostT, ExcT><<<grid, block, 0, s>>>(c, ei, eo, H, W, nd, p1, p2, vertical, reverse);
  else if (per_lane <= 2)
    sgm_walk_kernel<2, CostT, ExcT><<<grid, block, 0, s>>>(c, ei, eo, H, W, nd, p1, p2, vertical, reverse);
  else if (per_lane <= 4)
    sgm_walk_kernel<4, CostT, ExcT><<<grid, block, 0, s>>>(c, ei, eo, H, W, nd, p1, p2, vertical, reverse);
  else if (per_lane <= 8)
    sgm_walk_kernel<8, CostT, ExcT><<<grid, block, 0, s>>>(c, ei, eo, H, W, nd, p1, p2, vertical, reverse);
  else if (per_lane <= 16)
    sgm_walk_kernel<16, CostT, ExcT><<<grid, block, 0, s>>>(c, ei, eo, H, W, nd, p1, p2, vertical, reverse);
  else if (per_lane <= 32)
    sgm_walk_kernel<32, CostT, ExcT><<<grid, block, 0, s>>>(c, ei, eo, H, W, nd, p1, p2, vertical, reverse);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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

template <typename CostT, typename ExcT>
cudaError_t cost_down(const void* lf, const void* rf, void* cost, void* exc, int H, int W,
                      int nd, int mind, int r, float clampv, float p1, float p2, int tile_rows,
                      cudaStream_t s) {
  // the storage mode fixes the kernel: integer storage slides, float32 keeps
  // the plain order
  cudaError_t err;
  if constexpr (std::is_same_v<CostT, float>)
    err = cost_plain_order<CostT>(lf, rf, cost, H, W, nd, mind, r, clampv, s);
  else
    err = cost_slide(lf, rf, cost, H, W, nd, mind, r, clampv, tile_rows, s);
  if (err != cudaSuccess) return err;
  return launch_walk<CostT, ExcT>(cost, nullptr, exc, H, W, nd, p1, p2, 1, 0, s);
}

template <typename CostT, typename ExcT>
cudaError_t wta(const void* cost, const void* ev, const void* eh, void* disp, void* best,
                void* excl, int H, int W, int nd, int mind, int r, int refine, int uniq,
                cudaStream_t s) {
  const long long n = static_cast<long long>(H) * W;
  const int warps = kWtaThreads / 32;
  const long long blocks_needed = (n + warps - 1) / warps;
  const unsigned grid = static_cast<unsigned>(blocks_needed < kWtaMaxBlocks ? blocks_needed : kWtaMaxBlocks);
  const CostT* c = static_cast<const CostT*>(cost);
  const ExcT* v = static_cast<const ExcT*>(ev);
  const ExcT* h = static_cast<const ExcT*>(eh);
  float* d = static_cast<float*>(disp);
  float* b = static_cast<float*>(best);
  float* x = static_cast<float*>(excl);
  const int per_lane = (nd + 31) / 32;
  if (per_lane <= 1)
    sgm_wta_kernel<1, CostT, ExcT><<<grid, kWtaThreads, 0, s>>>(c, v, h, d, b, x, H, W, nd, mind, r, refine, uniq);
  else if (per_lane <= 2)
    sgm_wta_kernel<2, CostT, ExcT><<<grid, kWtaThreads, 0, s>>>(c, v, h, d, b, x, H, W, nd, mind, r, refine, uniq);
  else if (per_lane <= 4)
    sgm_wta_kernel<4, CostT, ExcT><<<grid, kWtaThreads, 0, s>>>(c, v, h, d, b, x, H, W, nd, mind, r, refine, uniq);
  else if (per_lane <= 8)
    sgm_wta_kernel<8, CostT, ExcT><<<grid, kWtaThreads, 0, s>>>(c, v, h, d, b, x, H, W, nd, mind, r, refine, uniq);
  else if (per_lane <= 16)
    sgm_wta_kernel<16, CostT, ExcT><<<grid, kWtaThreads, 0, s>>>(c, v, h, d, b, x, H, W, nd, mind, r, refine, uniq);
  else if (per_lane <= 32)
    sgm_wta_kernel<32, CostT, ExcT><<<grid, kWtaThreads, 0, s>>>(c, v, h, d, b, x, H, W, nd, mind, r, refine, uniq);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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

// cost, exc_v, exc_h: (H, W, nd); disp_raw, best_cost, excl: (H, W) float32.
extern "C" int sgm_wta(const void* cost, const void* exc_v, const void* exc_h, void* disp_raw,
                       void* best_cost, void* excl, int H, int W, int nd, int mind, int r,
                       int refine, int uniq, int mode, void* stream) {
  if (H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(wta<uint16_t, uint8_t>(cost, exc_v, exc_h, disp_raw, best_cost, excl, H, W, nd, mind, r, refine, uniq, s));
    case 1: return static_cast<int>(wta<uint16_t, int16_t>(cost, exc_v, exc_h, disp_raw, best_cost, excl, H, W, nd, mind, r, refine, uniq, s));
    case 2: return static_cast<int>(wta<float, float>(cost, exc_v, exc_h, disp_raw, best_cost, excl, H, W, nd, mind, r, refine, uniq, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
