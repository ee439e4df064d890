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
#include <initializer_list>
#include <type_traits>

#include "sad_window.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCostTileX = 32;          // output columns per block of the mode-2 cost kernel
constexpr int kCostThreads = 256;
constexpr int kSlideWarps = 4;          // most warp jobs per block of the sliding cost kernel
constexpr int kWalkRingBytes = 16384;   // bytes a line's walk keeps in flight (at most)
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

// --- the path walk ----------------------------------------------------------

__device__ __forceinline__ int warp_min(int v) { return __reduce_min_sync(kFull, v); }
__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }

// 16 bytes from device memory into shared memory (a shared-space address),
// asynchronously, L1 bypassed.
__device__ __forceinline__ void cp16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int B> struct WordOf;
template <> struct WordOf<1> { using type = uint8_t; };
template <> struct WordOf<2> { using type = uint16_t; };
template <> struct WordOf<4> { using type = uint32_t; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<16> { using type = uint4; };

// A lane's K consecutive values of T (disparities d0 .. d0 + K - 1), moved
// as the widest aligned words, at most 16 bytes each.  nd is a multiple of
// 16 and a word holds a divisor of 16 values, so a word lies wholly inside
// the range or wholly outside it; words outside are neither read (they load
// as 0) nor written.
template <typename T, int K>
struct Run {
  static constexpr int kBytes = K * static_cast<int>(sizeof(T));
  static constexpr int kWordBytes = kBytes < 16 ? kBytes : 16;
  static constexpr int kPer = kWordBytes / static_cast<int>(sizeof(T));   // values per word
  using Word = typename WordOf<kWordBytes>::type;
  union {
    Word w[K / kPer];
    T v[K];
    uint32_t u[kBytes >= 4 ? kBytes / 4 : 1];
  };

  __device__ __forceinline__ void load(const T* p, int d0, int nd) {
#pragma unroll
    for (int i = 0; i < K / kPer; ++i)
      w[i] = d0 + i * kPer < nd ? reinterpret_cast<const Word*>(p)[i] : Word{};
  }
  __device__ __forceinline__ void store(T* p, int d0, int nd) const {
#pragma unroll
    for (int i = 0; i < K / kPer; ++i)
      if (d0 + i * kPer < nd) reinterpret_cast<Word*>(p)[i] = w[i];
  }
  // value k in type V; 1- and 2-byte integers by one shift or mask of a
  // 32-bit word each (k is a constant once unrolled)
  template <typename V>
  __device__ __forceinline__ V get(int k) const {
    constexpr int bits = 8 * static_cast<int>(sizeof(T));
    if constexpr (sizeof(T) < 4 && kBytes >= 4) {
      const uint32_t word = u[k * bits / 32];
      const int sh = k * bits % 32;
      if constexpr (std::is_signed_v<T>)
        return static_cast<V>(static_cast<int>(word << (32 - bits - sh)) >> (32 - bits));
      else
        return static_cast<V>(sh + bits == 32 ? word >> sh : (word >> sh) & ((1u << bits) - 1));
    } else {
      return static_cast<V>(v[k]);
    }
  }
};

// The carry's type: int32 for integer storage (every value an integer below
// 2^24, so the recurrence is exact in either type), float32 otherwise.
template <typename CostT>
using WalkT = std::conditional_t<std::is_same_v<CostT, float>, float, int>;

// Pixels a walk stages ahead of the step that reads them: about
// kWalkRingBytes in flight per line at the widest pixel of K, 2 to 32.
template <int K, typename CostT, typename ExcT>
__host__ __device__ constexpr int walk_depth() {
  constexpr int pix = 32 * K * static_cast<int>(sizeof(CostT) + sizeof(ExcT));
  return kWalkRingBytes / pix < 2 ? 2 : kWalkRingBytes / pix > 32 ? 32 : kWalkRingBytes / pix;
}

// Shared-memory slots of a line's ring: the D pixels in flight, the one
// being read and the one read a step before (a slot is refilled two steps
// after its pixel was read, so no copy waits on a read).
template <int K, typename CostT, typename ExcT>
__host__ __device__ constexpr int walk_slots() { return walk_depth<K, CostT, ExcT>() + 2; }

// One warp per path line (a column when vertical, else a row), walked
// forward or in reverse; lane l holds disparities l * K .. l * K + K - 1 of
// the carry.  The line's pixels (nd cost values, then nd exc_in values when
// given; 16-byte aligned) are copied into a ring of shared-memory slots by
// 16-byte cp.async, one commit group per pixel, D pixels ahead of the step
// that reads them: with exc_in, lanes 0-15 copy the cost and lanes 16-31
// the excess, so each lane keeps one source pointer and moves it by a fixed
// stride per step.  A step issues the warp minimum and the neighbour
// shuffles of the carry first, then waits for the group of the pixel after
// its own (landed long before), reads that pixel's values into registers a
// step early (K <= 8) and issues the next copy, so the latencies of the
// reduction and the shuffles hide behind that work; then the recurrence, in
// int32 on integer storage.  Each lane writes its K outputs as whole words.
template <int K, typename CostT, typename ExcT>
__global__ void __launch_bounds__(32)
sgm_walk_kernel(const CostT* __restrict__ cost, const ExcT* __restrict__ exc_in,
                ExcT* __restrict__ exc_out, int H, int W, int nd, float p1, float p2,
                int vertical, int reverse) {
  using V = WalkT<CostT>;
  constexpr int D = walk_depth<K, CostT, ExcT>();
  constexpr int R = walk_slots<K, CostT, ExcT>();
  constexpr bool kAhead = K <= 8;
  // 16-byte copies per lane per pixel, at most: nd <= 32 K cost values over
  // 16 lanes (exc_in's are no wider)
  constexpr int NQ = K * static_cast<int>(sizeof(CostT)) / 8 > 1
                         ? K * static_cast<int>(sizeof(CostT)) / 8 : 1;
  extern __shared__ __align__(16) unsigned char walk_smem[];
  const int lane = threadIdx.x, line = blockIdx.x;   // one warp, one line, per block
  const int len = vertical ? H : W;
  const long long stride = vertical ? static_cast<long long>(W) * nd : nd;   // pixel to pixel
  const long long pix_step = reverse ? -stride : stride;                      // in walk order
  // element offset of the line's first pixel in walk order (its disparity 0)
  const long long first = (vertical ? static_cast<long long>(line) * nd
                                    : static_cast<long long>(line) * W * nd) +
                          (reverse ? (len - 1) * stride : 0);
  const bool has_in = exc_in != nullptr;
  const int cost_bytes = nd * static_cast<int>(sizeof(CostT));
  const int pix_bytes = cost_bytes + (has_in ? nd * static_cast<int>(sizeof(ExcT)) : 0);
  const int ring_bytes = R * pix_bytes;
  unsigned char* ring = walk_smem;
  const int d0 = lane * K;

  // this lane's share of a pixel's copies: bytes 16 * (part + lanes * t) of
  // its buffer (the cost, or with exc_in on lanes 16-31 the excess); a lane
  // past the buffer's end copies its last 16 bytes again (the same bytes to
  // the same place as another lane), so no copy needs a branch
  const bool exc_lane = has_in && lane >= 16;
  const int lanes = has_in ? 16 : 32, part = exc_lane ? lane - 16 : lane;
  const int span = exc_lane ? pix_bytes - cost_bytes : cost_bytes;
  const int esize = exc_lane ? static_cast<int>(sizeof(ExcT)) : static_cast<int>(sizeof(CostT));
  const char* src = (exc_lane ? reinterpret_cast<const char*>(exc_in)
                              : reinterpret_cast<const char*>(cost)) + first * esize;
  const long long src_step = pix_step * esize;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(ring)) +
                       (exc_lane ? cost_bytes : 0);
  int piece[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) piece[t] = min(16 * (part + lanes * t), span - 16);
  int foff = 0;                         // the slot of the next pixel copied
  auto fetch = [&]() {                  // the next pixel as one commit group
#pragma unroll
    for (int t = 0; t < NQ; ++t) cp16(dst + foff + piece[t], src + piece[t]);
    cp_commit();
    src += src_step;
    foff = foff + pix_bytes == ring_bytes ? 0 : foff + pix_bytes;
  };
  auto read = [&](int off, Run<CostT, K>& c, Run<ExcT, K>& ei) {
    c.load(reinterpret_cast<const CostT*>(ring + off) + d0, d0, nd);
    if (has_in) ei.load(reinterpret_cast<const ExcT*>(ring + off + cost_bytes) + d0, d0, nd);
  };

  const V vp1 = static_cast<V>(p1), vp2 = static_cast<V>(p2), big = static_cast<V>(kBig);
  // the carry, and the cost of disparities past nd as +1e9: such an L stays
  // at 1e9 + [0, P2], above every real one, so it never wins a minimum
  V L[K];
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = d0 + k < nd ? V(0) : big;
  V lm = d0 < nd ? V(0) : big;          // the lane's minimum of the carry
  ExcT* out_ptr = exc_out + first + d0;
  // D + 1 groups ahead (empty past the line's end, so the counts hold)
  for (int s = 0; s <= D; ++s) {
    if (s < len) {
      fetch();
    } else {
      cp_commit();
    }
  }
  Run<CostT, K> c;
  Run<ExcT, K> ei;
  if constexpr (kAhead) {
    cp_wait<D>();                       // step 0's pixel
    __syncwarp();
    read(0, c, ei);
  }
  int roff = 0;                         // this step's slot

  // One step.  The warp minimum and the neighbours' shuffles go first and
  // their results are used after the wait, the reads and the copies, which
  // hide their latency; `copying`: the step copies the pixel D + 1 ahead
  // into the slot of the step before, read a step ago; `full`: nd = 32 K,
  // no disparity past nd to keep at 1e9.
  auto step = [&](auto copying, auto full) {
    const V m = warp_min(lm);
    V up_edge = __shfl_down_sync(kFull, L[0], 1);     // d = d0 + K, from lane + 1
    V dn_edge = __shfl_up_sync(kFull, L[K - 1], 1);   // d = d0 - 1, from lane - 1
    // groups in flight: steps s + 1 .. s + D; this leaves s + 2 .. s + D
    cp_wait<D - 1>();
    __syncwarp();                       // every lane's copies visible to every lane
    const int noff = roff + pix_bytes == ring_bytes ? 0 : roff + pix_bytes;
    Run<CostT, K> cn;
    Run<ExcT, K> en;
    if constexpr (kAhead)
      read(noff, cn, en);               // past the line's end a slot never used
    else
      read(roff, c, ei);
    if constexpr (decltype(copying)::value)
      fetch();
    else
      cp_commit();                      // an empty group keeps the count
    if (lane == 31) up_edge = big;
    if (lane == 0) dn_edge = big;

    // best = min(L, up + P1, dn + P1, m + P2): the part without m first.
    // float32 keeps the plain version's rounding steps (the adds; a min is
    // exact in any order); on integers min(up, dn) + P1 is the same value
    V Ln[K];
    Run<ExcT, K> out;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const V up = k + 1 < K ? L[k + 1] : up_edge;
      const V dn = k > 0 ? L[k - 1] : dn_edge;
      const V ck = decltype(full)::value || d0 + k < nd ? c.template get<V>(k) : big;
      V e;
      if constexpr (std::is_same_v<V, int>) {
        const V best = min(min(L[k], min(up, dn) + vp1), m + vp2);
        e = best - m;
        Ln[k] = ck + best - m;
      } else {
        const V best = fminf(fminf(L[k], fminf(up + vp1, dn + vp1)), m + vp2);
        e = best - m;
        Ln[k] = ck + e;
      }
      out.v[k] = static_cast<ExcT>(has_in ? e + ei.template get<V>(k) : e);
    }
    lm = Ln[0];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      L[k] = Ln[k];
      lm = vmin(lm, Ln[k]);
    }
    out.store(out_ptr, d0, nd);
    out_ptr += pix_step;
    if constexpr (kAhead) {
      c = cn;
      ei = en;
    }
    roff = noff;
  };
  // the steps that copy, then those with nothing left to copy; unrolled by 2
  // so that no register is copied from one step's name to the next's
  auto walk = [&](auto full) {
    int s = 0;
#pragma unroll 2
    for (; s < len - D - 1; ++s) step(std::true_type{}, full);
#pragma unroll 2
    for (; s < len; ++s) step(std::false_type{}, full);
  };
  if (nd == 32 * K)
    walk(std::true_type{});
  else
    walk(std::false_type{});
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

// One walk at K disparities per lane: the ring's shared memory per line is
// walk_slots pixels of nd cost values (and nd exc_in values when given).
template <int K, typename CostT, typename ExcT>
cudaError_t launch_walk_k(const void* cost, const void* exc_in, void* exc_out, int H, int W,
                          int nd, float p1, float p2, int vertical, int reverse,
                          cudaStream_t s) {
  const long long pix = static_cast<long long>(nd) *
                        (sizeof(CostT) + (exc_in != nullptr ? sizeof(ExcT) : 0));
  const long long smem = walk_slots<K, CostT, ExcT>() * pix;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const auto kernel = sgm_walk_kernel<K, CostT, ExcT>;
  // per device, so on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<vertical ? W : H, 32, static_cast<size_t>(smem), s>>>(
      static_cast<const CostT*>(cost), static_cast<const ExcT*>(exc_in),
      static_cast<ExcT*>(exc_out), H, W, nd, p1, p2, vertical, reverse);
  return cudaGetLastError();
}

// nd must be a multiple of 16 (every pixel's span 16-byte aligned in every
// storage mode) and at most 1024; the volumes 16-byte aligned.
template <typename CostT, typename ExcT>
cudaError_t launch_walk(const void* cost, const void* exc_in, void* exc_out, int H, int W,
                        int nd, float p1, float p2, int vertical, int reverse,
                        cudaStream_t s) {
  if (H == 0 || W == 0 || nd == 0) return cudaSuccess;
  if (nd % 16 != 0) return cudaErrorInvalidValue;
  for (const void* p : {cost, exc_in, static_cast<const void*>(exc_out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const int per_lane = (nd + 31) / 32;
  if (per_lane <= 1)
    return launch_walk_k<1, CostT, ExcT>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s);
  if (per_lane <= 2)
    return launch_walk_k<2, CostT, ExcT>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s);
  if (per_lane <= 4)
    return launch_walk_k<4, CostT, ExcT>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s);
  if (per_lane <= 8)
    return launch_walk_k<8, CostT, ExcT>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s);
  if (per_lane <= 16)
    return launch_walk_k<16, CostT, ExcT>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s);
  if (per_lane <= 32)
    return launch_walk_k<32, CostT, ExcT>(cost, exc_in, exc_out, H, W, nd, p1, p2, vertical, reverse, s);
  return cudaErrorInvalidValue;
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
