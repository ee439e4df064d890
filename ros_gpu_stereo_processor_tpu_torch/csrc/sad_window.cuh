// The block-window SAD sweep shared by the block matcher (stereobm.cu, K2)
// and the SGM cost stage (sgm.cu, K4).
//
// One warp, lane l = candidate d (32 consecutive disparities), sweeps one
// segment of at most kSeg = 32 output columns down a strip of rows.  Each
// step brings one image row into the window: per column xg of the segment
// and its 2r halo columns, the lane's column sum of |L - R_d| over the block
// rows takes the entering row's difference and, once the window is full,
// gives back the leaving row's (cs, in shared memory, lane-contiguous).  The
// first 2r steps only fill the window; from then on each step is an output
// row, whose window sums slide across the columns in a register (add the
// entering column sum, subtract the one 2r + 1 columns back).  So an output
// (pixel, d) costs O(1) whatever the block size.
//
// The rows a step needs (L and R, entering and leaving; R over the columns
// xg - d of all 32 lanes) are copied into the warp's shared memory with
// cp.async, zero outside the image, one step ahead: they land while the
// step before computes.  L(xg) is one address for all lanes (a broadcast
// float4 load covers 4 columns) and R(xg - d) 32 consecutive addresses.
// Columns go 8 (or 4, for a window narrower than 8) at a time, all loads of
// a group before any store.  An output row's 32 x 32 window sums land in a
// tile T[column][d] of row stride 33, so the caller can read it either way
// round without bank conflicts: by d (lane = d) or by pixel (lane = column).
//
// Exactness: the plain version (ops/stereobm.py::_box_sum) sums the zero-
// padded |difference| image column-wise top to bottom, then row-wise left to
// right.  Sliding sums equal that only when every partial sum is exact: the
// values are integers and |v| * 2 * (2r + 2)^2 <= 2^24 (a prefiltered
// integer image holds integers in [0, 126]).  integer_tile() tests that on
// the warp's whole footprint; where it fails, sweep<false> recomputes each
// column sum top to bottom and each window sum left to right from global
// memory, the plain version's order, so float images are exact too.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <initializer_list>

namespace sad {

constexpr int kSeg = 32;                     // output columns per warp segment
constexpr int kT = 33;                       // row stride of the output tile
constexpr int kRegRadius = 7;                // block 15: column sums in registers
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one warp's sweep, in floats: the output tile, two slots
// of staged rows and, unless the column sums live in registers (block 15,
// kRegRadius), 2r + 1 columns of zeros and the column sums.  Columns are
// padded to a multiple of 8 (zero-staged, and never read by a real window)
// so that a step's column loop runs whole groups.
__host__ __device__ constexpr int cols(int r) { return (kSeg + 2 * r + 7) / 8 * 8; }
__host__ __device__ constexpr int slot_floats(int r) { return 4 * cols(r) + 64; }
__host__ __device__ constexpr int scratch_floats(int r) {
  return cols(r) * kT + 2 * slot_floats(r) + (r == kRegRadius ? 0 : (2 * r + 1 + cols(r)) * 32);
}

// The output tile of the current row within a warp's scratch: T[j * kT + l]
// is the window sum of output column j for candidate dbase + l.
__device__ __forceinline__ float* tile(float* scratch, int r) { return scratch + 2 * r * kT; }

// Over one pixel's row t of the tile (candidates dbase + k, k < 32, at
// output column x): t[k] = masked where the right window leaves the image
// (x - d outside [r, W - 1 - r]) and for k >= n.  Lane j calls it on its
// own row j; a pixel away from the image's edges has nothing to mask.
__device__ __forceinline__ void mask_row(float* t, int x, int dbase, int r, int W, int n,
                                         float masked) {
  const int xd = x - dbase;                        // x - d at k = 0
  const int lo = min(max(xd - (W - 1 - r), 0), n);  // valid: lo <= k <= hi
  const int hi = max(min(xd - r, n - 1), lo - 1);
  for (int k = 0; k < lo; ++k) t[k] = masked;
  for (int k = hi + 1; k < n; ++k) t[k] = masked;
}

// |L(y, xg) - R(y, xg - d)| with zero rows and columns outside the image
// and R zero outside [0, W) (the plain version's padding).
__device__ __forceinline__ float absdiff(const float* __restrict__ L,
                                         const float* __restrict__ R, int H, int W,
                                         int y, int xg, int d) {
  if (static_cast<unsigned>(y) >= static_cast<unsigned>(H) ||
      static_cast<unsigned>(xg) >= static_cast<unsigned>(W))
    return 0.0f;
  const long long row = static_cast<long long>(y) * W;
  const int xr = xg - d;
  const float rv = static_cast<unsigned>(xr) < static_cast<unsigned>(W) ? R[row + xr] : 0.0f;
  return fabsf(L[row + xg] - rv);
}

// Whether every img(y, x), ya <= y < yb, xa <= x < xb, is an integer of
// magnitude <= vmax, on this lane's share of the region: lanes stride over
// it row-major, 16 loads in flight at a time.
__device__ __forceinline__ bool integer_region(const float* __restrict__ img, int W, int ya,
                                               int yb, int xa, int xb, float vmax) {
  const int n = xb - xa;
  if (n <= 0 || yb <= ya) return true;
  const int lane = threadIdx.x & 31;
  const int drow = 32 / n, dcol = 32 % n;   // one lane's step through the region
  int row = ya + lane / n, col = lane % n;
  bool ok = true;
  while (row < yb) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k] = row < yb ? img[static_cast<long long>(row) * W + xa + col] : 0.0f;
      col += dcol;
      row += drow;
      if (col >= n) {
        col -= n;
        ++row;
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) ok &= v[k] == truncf(v[k]) && fabsf(v[k]) <= vmax;
  }
  return ok;
}

// True on every lane when all values the warp will read (L over the
// segment and its halo, R over the same rows and the disparities
// [dlo, dhi]) are integers small enough for the sliding sums to be exact.
__device__ __forceinline__ bool integer_tile(const float* __restrict__ L,
                                             const float* __restrict__ R, int H, int W,
                                             int x0, int ncols, int y0, int y1, int r,
                                             int dlo, int dhi) {
  const float vmax = 16777216.0f / (2.0f * (2 * r + 2) * (2 * r + 2));
  const int ya = max(y0 - r, 0), yb = min(y1 + r, H);
  const bool ok =
      integer_region(L, W, ya, yb, max(x0 - r, 0), min(x0 + ncols + r, W), vmax) &&
      integer_region(R, W, ya, yb, max(x0 - r - dhi, 0), min(x0 + ncols + r - dlo, W), vmax);
  return __all_sync(kFull, ok);
}

// dst[i] = img(y, x0 + i) for i < n, zero outside the image and for
// n <= i < n_pad: 4-byte cp.async copies, lanes striding over i.
__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ img, int H,
                                          int W, int y, int x0, int n, int n_pad) {
  const bool row_ok = static_cast<unsigned>(y) < static_cast<unsigned>(H);
  const float* row = img + (row_ok ? static_cast<long long>(y) * W : 0);
  for (int i = threadIdx.x & 31; i < n_pad; i += 32) {
    const int x = x0 + i;
    const bool ok = row_ok && i < n && static_cast<unsigned>(x) < static_cast<unsigned>(W);
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(ok ? row + x : img), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One step over the columns [0, jpad) of a segment: each column sum takes
// the entering row's difference (le, re) and, with LEAVE, gives back the
// leaving row's (ll, rl); with OUTPUT the window sum slides across and
// T[(j, lane)] gets the window ending at column j.  Columns outside the
// image keep a sum of 0 (the plain version's padding).  G <= 2r + 1, so the
// column sums 2r + 1 back were stored by an earlier group (or are the zero
// columns before column 0).
template <int G, bool LEAVE, bool OUTPUT>
__device__ __forceinline__ void slide_columns(float* cs, float* T, const float* le,
                                              const float* ll, const float* re,
                                              const float* rl, int lane, int jpad, int win,
                                              int xg0, int W) {
  float ws = 0.0f;
  for (int j0 = 0; j0 < jpad; j0 += G) {
    float c[G], back[G], e[G], l[G], lv[G], lo[G];
#pragma unroll
    for (int q = 0; q < G; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(le + j0 + q);
      lv[q] = a.x, lv[q + 1] = a.y, lv[q + 2] = a.z, lv[q + 3] = a.w;
      if constexpr (LEAVE) {
        const float4 b = *reinterpret_cast<const float4*>(ll + j0 + q);
        lo[q] = b.x, lo[q + 1] = b.y, lo[q + 2] = b.z, lo[q + 3] = b.w;
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int j = j0 + k;
      c[k] = cs[j * 32 + lane];
      e[k] = lv[k] - re[j];
      if constexpr (LEAVE) l[k] = lo[k] - rl[j];
      if constexpr (OUTPUT) back[k] = cs[(j - win) * 32 + lane];
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int j = j0 + k;
      if (static_cast<unsigned>(xg0 + j) < static_cast<unsigned>(W)) {
        c[k] = c[k] + fabsf(e[k]);
        if constexpr (LEAVE) c[k] = c[k] - fabsf(l[k]);
      }
      cs[j * 32 + lane] = c[k];
      if constexpr (OUTPUT) {
        ws = ws + (c[k] - back[k]);
        T[j * kT + lane] = ws;
      }
    }
  }
}

// One step with the group size the window allows (a block is at least 5).
template <bool LEAVE, bool OUTPUT>
__device__ __forceinline__ void step_columns(float* cs, float* T, const float* b, int r,
                                             int lane, int jpad, int xg0, int W) {
  const int cp = cols(r);
  const float* le = b;
  const float* ll = b + cp;
  const float* re = b + 2 * cp + 31 - lane;   // re[j] = R(row, xg - d)
  const float* rl = re + cp + 32;
  if (2 * r + 1 >= 8)
    slide_columns<8, LEAVE, OUTPUT>(cs, T, le, ll, re, rl, lane, jpad, 2 * r + 1, xg0, W);
  else
    slide_columns<4, LEAVE, OUTPUT>(cs, T, le, ll, re, rl, lane, jpad, 2 * r + 1, xg0, W);
}

// step_columns with the column sums in registers, for a compile-time block
// radius RC: no shared-memory traffic for cs, and the one 2r + 1 columns
// back is a register too.  All cols(RC) columns go every step (columns past
// the segment's last are staged zero on L and never read by a real window).
template <int RC, bool LEAVE, bool OUTPUT>
__device__ __forceinline__ void reg_columns(float (&cs)[cols(RC)], float* T, const float* b,
                                            int lane, int xg0, int W) {
  constexpr int CP = cols(RC), WIN = 2 * RC + 1;
  const float* le = b;
  const float* ll = b + CP;
  const float* re = b + 2 * CP + 31 - lane;
  const float* rl = re + CP + 32;
  float ws = 0.0f;
#pragma unroll
  for (int j0 = 0; j0 < CP; j0 += 4) {
    const float4 a = *reinterpret_cast<const float4*>(le + j0);
    const float lv[4] = {a.x, a.y, a.z, a.w};
    float lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (LEAVE) {
      const float4 q = *reinterpret_cast<const float4*>(ll + j0);
      lo[0] = q.x, lo[1] = q.y, lo[2] = q.z, lo[3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k;
      const float e = lv[k] - re[j];
      float c = cs[j];
      if (static_cast<unsigned>(xg0 + j) < static_cast<unsigned>(W)) {
        c = c + fabsf(e);
        if constexpr (LEAVE) c = c - fabsf(lo[k] - rl[j]);
      }
      cs[j] = c;
      if constexpr (OUTPUT) {
        ws = ws + (c - (j >= WIN ? cs[j >= WIN ? j - WIN : 0] : 0.0f));
        T[j * kT + lane] = ws;
      }
    }
  }
}

// Sweep rows [y0, y1) of output columns [x0, x0 + ncols) for the candidates
// d = dbase + lane; after each output row, with its window sums in the tile
// (tile(scratch, r)), calls out_row(y) on every lane of the warp at once.
// scratch: scratch_floats(r) floats of the warp's own shared memory.  RC >
// 0 compiles the sliding sweep for r == RC, with the column sums in
// registers.
template <bool SLIDE, int RC = 0, typename OutRow>
__device__ __forceinline__ void sweep(const float* __restrict__ L, const float* __restrict__ R,
                                      float* scratch, int H, int W, int r, int x0, int ncols,
                                      int y0, int y1, int dbase, OutRow&& out_row) {
  const int lane = threadIdx.x & 31;
  const int win = 2 * r + 1;
  const int jend = ncols + 2 * r;
  const int cp = cols(r);
  float* T = scratch;                        // [column][d], row stride kT
  if constexpr (SLIDE) {
    const int jpad = (jend + 7) / 8 * 8;
    float* slots = T + cp * kT;
    float* cs = slots + 2 * slot_floats(r) + win * 32;   // [column][lane], after win zeros
    float csr[RC > 0 ? cols(RC) : 1];
    if constexpr (RC > 0) {
#pragma unroll
      for (int j = 0; j < cols(RC); ++j) csr[j] = 0.0f;
    } else {
      for (int j = -win; j < cp; ++j) cs[j * 32 + lane] = 0.0f;
    }
    const int rx0 = x0 - r - dbase - 31;     // image column of R slot 0
    const int steps = 2 * r + (y1 - y0);
    // slot layout: L entering, L leaving (cp each), R entering, R leaving
    // (cp + 32 each)
    auto stage = [&](int s) {
      float* b = slots + (s & 1) * slot_floats(r);
      const int ye = y0 - r + s;
      stage_row(b, L, H, W, ye, x0 - r, jend, cp);
      stage_row(b + 2 * cp, R, H, W, ye, rx0, jend + 31, cp + 32);
      if (s >= win) {
        stage_row(b + cp, L, H, W, ye - win, x0 - r, jend, cp);
        stage_row(b + 3 * cp + 32, R, H, W, ye - win, rx0, jend + 31, cp + 32);
      }
      commit();
    };
    stage(0);
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) stage(s + 1); else commit();
      wait_all_but_newest();
      __syncwarp();
      const float* b = slots + (s & 1) * slot_floats(r);
      if constexpr (RC > 0) {
        if (s < 2 * r)
          reg_columns<RC, false, false>(csr, T, b, lane, x0 - r, W);
        else if (s == 2 * r)
          reg_columns<RC, false, true>(csr, T, b, lane, x0 - r, W);
        else
          reg_columns<RC, true, true>(csr, T, b, lane, x0 - r, W);
      } else {
        if (s < 2 * r)
          step_columns<false, false>(cs, T, b, r, lane, jpad, x0 - r, W);
        else if (s == 2 * r)
          step_columns<false, true>(cs, T, b, r, lane, jpad, x0 - r, W);
        else
          step_columns<true, true>(cs, T, b, r, lane, jpad, x0 - r, W);
      }
      __syncwarp();          // the tile is complete; this slot is staged again next step
      if (s >= 2 * r) out_row(y0 + s - 2 * r);
    }
  } else {
    // the plain order: column sums top to bottom into the tile's rows, then
    // each window sum left to right, written over the tile's row j + 2r
    // from the right (that row is no later window's)
    const int d = dbase + lane;
    for (int y = y0; y < y1; ++y) {
      for (int j = 0; j < jend; ++j) {
        const int xg = x0 - r + j;
        float c = absdiff(L, R, H, W, y - r, xg, d);
        for (int i = 1; i < win; ++i) c += absdiff(L, R, H, W, y - r + i, xg, d);
        T[j * kT + lane] = c;
      }
      for (int j = ncols - 1; j >= 0; --j) {
        const float* col = T + j * kT + lane;
        float total = col[0];
        for (int k = 1; k < win; ++k) total += col[k * kT];
        T[(j + 2 * r) * kT + lane] = total;
      }
      __syncwarp();
      out_row(y);
      __syncwarp();          // out_row has read the tile before it is written again
    }
  }
}

// The card's SM count (132 on an H100 SXM), read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// Rows per strip for a sweep kernel: of 64, 32, 16, 8 and 4 rows, the one
// with the least modelled time, waves of co-resident blocks (the occupancy
// query, at the strip's shared memory) times the rows a strip walks, its 2r
// fill rows counted at 0.4 (they form no window sums and write nothing).
// The model ranks the strip heights as timed at 752x480 and on a 134x752
// band (scripts/torch_match_kernels.py --tiles).  Ties keep the taller
// strip.  The kernel's dynamic shared memory limit must already allow
// smem_of(ty); a height whose blocks cannot run is skipped (4 if none can).
template <typename Kernel, typename SmemOf, typename BlocksOf>
int pick_rows(Kernel kernel, int threads, SmemOf smem_of, BlocksOf blocks_of, int H, int r,
              long long smem_max) {
  int best = 4;
  double best_cost = 1e300;
  for (int ty : {64, 32, 16, 8, 4}) {
    const long long smem = smem_of(ty);
    int per_sm = 0;
    if (smem > smem_max ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      static_cast<size_t>(smem)) != cudaSuccess ||
        per_sm == 0)
      continue;
    const long long wave = static_cast<long long>(per_sm) * sm_count();
    const long long waves = (blocks_of(ty) + wave - 1) / wave;
    const double cost = static_cast<double>(waves) * (0.4 * 2 * r + std::min(ty, H));
    if (cost < best_cost) {
      best_cost = cost;
      best = ty;
    }
  }
  return best;
}

}  // namespace sad
