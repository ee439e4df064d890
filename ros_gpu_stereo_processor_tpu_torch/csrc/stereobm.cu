// Fused SAD block matcher for Hopper (sm_90a): cost -> winner-take-all in one
// pass, with no cost volume in device memory.
//
// Replaces: ros_gpu_stereo_processor_tpu/ops/stereobm_pallas.py::_make_kernel,
// the TPU kernel launched by fused_raw.  Plain version: the cost volume and
// argmin of ops/stereobm_kernel.py::fused_raw_plain (ops/stereobm.py).
//
// What it computes, per pixel (y, x) of the prefiltered images L and R, for
// each candidate d in [min_d, min_d + nd):
//   cost(d) = sum over the block x block window of |L - R shifted by d|, with
//             zero rows and columns outside the image (SAME padding of the
//             |difference| image) and R zero outside [0, W);
//   cost(d) = 1e9 where the right window would leave the image;
// and returns disp_raw (the argmin, ties to the smallest d, plus the clipped
// parabolic step when refine), best_cost, and excl (the smallest cost outside
// best +- 1, for the uniqueness gate; 1e9 when uniqueness is off).
//
// What bounds it on the H100: instruction issue and shared-memory traffic,
// not device memory.  The cost volume the plain version writes and reads
// back (nd x H x W floats, 92 MB at 752x480x64) never leaves the SM.
//
// Design.  A block owns a tile of 32 columns by `ty` rows and has NW warps;
// warp w takes the contiguous disparity range of chunks [w * cpw, (w + 1) *
// cpw), 32 candidates a chunk, one per lane, so the d range, not only the
// pixels, spreads over the card's warps.  Each chunk is one sad::sweep
// (sad_window.cuh): rows staged one step ahead by cp.async, column sums
// sliding down the rows (in registers for block 15, else in shared memory),
// window sums sliding across the columns, O(1) work per (pixel, d).  After
// each output row the sweep leaves the row's 32 x 32 window sums in a tile;
// lane j then scans pixel j's 32 candidates with a strict <, so the first
// minimum wins, and keeps what refine and uniqueness need: the costs at
// best -+ 1 and at the chunk's ends, and the minima outside best +- 1,
// outside the first and outside the last candidate (a second scan of the
// same 32 values; the SAD is never swept twice).  That state merges into the
// lane's running state of the pixel in shared memory.  One barrier per
// block, after every warp's sweep; then each pixel merges the NW range
// states in d order (merge(): strict <, so ties keep the smallest d; the
// costs at best -+ 1 come from the neighbouring range's end when best sits
// at a range boundary, and the uniqueness minimum leaves out exactly best -
// 1 .. best + 1 across the boundary too).  min is exact in any order.  The
// strip height is chosen per shape (sad::pick_rows), so a 134-row mesh band
// fills the card as the whole image does.  The sliding sums are exact for
// integer images (see sad_window.cuh); a warp whose inputs are not small
// integers sums in the plain version's order instead, so every output
// equals fused_raw_plain's bit for bit either way.  Every block size and
// disparity range of StereoBMConfig fits: the images are read from device
// memory, and only the column sums, one row's tile and the winner states
// live in shared memory (a very large block takes fewer, longer d ranges
// per block).  None of the TPU kernel's machinery (the 8-lane roll
// schedule, u-space recentring, VMEM tile budgets, slack lanes) is carried
// over.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "sad_window.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr int kMaxWarps = 8;            // warps (disparity ranges) per block
constexpr long long kMaxSmem = 232448;  // dynamic shared memory an H100 block may opt into

// One pixel's winner state over a contiguous disparity range.
struct St {
  float m;        // best cost
  int bd;         // its index (0 .. nd - 1), the first minimum
  float cm, cp;   // costs at bd - 1, bd + 1 when inside the range
  float first, last;          // costs at the range's ends
  float ein, enf, enl;        // minima outside bd +- 1, outside first, outside last
};

template <bool REFINE, bool UNIQ>
constexpr int n_fields() { return 2 + (REFINE ? 4 : 0) + (UNIQ ? 3 : 0); }

template <bool REFINE, bool UNIQ>
__device__ __forceinline__ void store(float* p, int stride, const St& s) {
  p[0] = s.m;
  p[stride] = __int_as_float(s.bd);
  int f = 2;
  if constexpr (REFINE) {
    p[f++ * stride] = s.cm;
    p[f++ * stride] = s.cp;
    p[f++ * stride] = s.first;
    p[f++ * stride] = s.last;
  }
  if constexpr (UNIQ) {
    p[f++ * stride] = s.ein;
    p[f++ * stride] = s.enf;
    p[f++ * stride] = s.enl;
  }
}

template <bool REFINE, bool UNIQ>
__device__ __forceinline__ St load(const float* p, int stride) {
  St s{};
  s.m = p[0];
  s.bd = __float_as_int(p[stride]);
  int f = 2;
  if constexpr (REFINE) {
    s.cm = p[f++ * stride];
    s.cp = p[f++ * stride];
    s.first = p[f++ * stride];
    s.last = p[f++ * stride];
  }
  if constexpr (UNIQ) {
    s.ein = p[f++ * stride];
    s.enf = p[f++ * stride];
    s.enl = p[f++ * stride];
  }
  return s;
}

// A's range ends at a_hi and B's starts at a_hi + 1: the state of the union.
template <bool REFINE, bool UNIQ>
__device__ __forceinline__ St merge(const St& A, const St& B, int a_hi) {
  const bool b_wins = B.m < A.m;          // strict: a tie keeps A's smaller d
  St o{};
  o.m = b_wins ? B.m : A.m;
  o.bd = b_wins ? B.bd : A.bd;
  if constexpr (REFINE) {
    o.cm = b_wins ? (B.bd == a_hi + 1 ? A.last : B.cm) : A.cm;
    o.cp = b_wins ? B.cp : (A.bd == a_hi ? B.first : A.cp);
    o.first = A.first;
    o.last = B.last;
  }
  if constexpr (UNIQ) {
    o.ein = b_wins ? fminf(B.ein, B.bd == a_hi + 1 ? A.enl : A.m)
                   : fminf(A.ein, A.bd == a_hi ? B.enf : B.m);
    o.enf = fminf(A.enf, B.m);
    o.enl = fminf(A.m, B.enl);
  }
  return o;
}

// The state of one chunk of 32 candidates at one pixel: t[k] is the cost of
// index dd0 + k (masked by sad::mask_row: 1e9, +inf past nd).  A strict-<
// scan from +inf, so the first minimum wins.
template <bool REFINE, bool UNIQ>
__device__ __forceinline__ St chunk_state(const float* t, int dd0) {
  St s{};
  s.m = INFINITY;
  int bl = 0;
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    const float c = t[k];
    if (c < s.m) {
      s.m = c;
      bl = k;
    }
  }
  s.bd = dd0 + bl;
  if constexpr (REFINE) {
    s.first = t[0];
    s.last = t[31];
    s.cm = t[bl > 0 ? bl - 1 : 0];
    s.cp = t[bl < 31 ? bl + 1 : 31];
  }
  if constexpr (UNIQ) {
    s.ein = s.enf = s.enl = INFINITY;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const float c = t[k];
      if (abs(k - bl) > 1) s.ein = fminf(s.ein, c);
      if (k > 0) s.enf = fminf(s.enf, c);
      if (k < 31) s.enl = fminf(s.enl, c);
    }
  }
  return s;
}

template <bool REFINE, bool UNIQ>
__global__ void __launch_bounds__(kMaxWarps * 32)
bm_fused_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
                float* __restrict__ disp_raw, float* __restrict__ best_cost,
                float* __restrict__ excl_out, int H, int W, int nd, int mind, int r,
                int ty, int cpw) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = blockIdx.x * sad::kSeg, y0 = blockIdx.y * ty;
  const int y1 = min(y0 + ty, H), ncols = min(sad::kSeg, W - x0);
  const int nchunks = (nd + 31) >> 5;
  const int c0 = w * cpw, c1 = min(c0 + cpw, nchunks);
  const int npix = sad::kSeg * ty;
  float* scratch = smem + w * sad::scratch_floats(r);
  float* st = smem + nw * sad::scratch_floats(r);      // [field][warp][pixel]
  const int stride = nw * npix;

  const bool slide = sad::integer_tile(lf, rf, H, W, x0, ncols, y0, y1, r, mind + c0 * 32,
                                       mind + min(c1 * 32, nd) - 1);
  for (int c = c0; c < c1; ++c) {
    const int dd0 = c * 32;
    // lane = output column: scan the row's 32 candidates of this chunk
    auto out_row = [&](int y) {
      const int j = lane;
      if (j >= ncols) return;
      float* t = sad::tile(scratch, r) + j * sad::kT;
      const int nreal = min(32, nd - dd0);
      sad::mask_row(t, x0 + j, mind + dd0, r, W, nreal, kBig);
      for (int k = nreal; k < 32; ++k) t[k] = INFINITY;
      St s = chunk_state<REFINE, UNIQ>(t, dd0);
      float* p = st + w * npix + (y - y0) * sad::kSeg + j;
      if (c > c0) s = merge<REFINE, UNIQ>(load<REFINE, UNIQ>(p, stride), s, dd0 - 1);
      store<REFINE, UNIQ>(p, stride, s);
    };
    if (slide && r == sad::kRegRadius)
      sad::sweep<true, sad::kRegRadius>(lf, rf, scratch, H, W, r, x0, ncols, y0, y1, mind + dd0,
                                        out_row);
    else if (slide)
      sad::sweep<true>(lf, rf, scratch, H, W, r, x0, ncols, y0, y1, mind + dd0, out_row);
    else
      sad::sweep<false>(lf, rf, scratch, H, W, r, x0, ncols, y0, y1, mind + dd0, out_row);
  }
  __syncthreads();

  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int x = x0 + (p & (sad::kSeg - 1)), y = y0 + p / sad::kSeg;
    if (x >= W || y >= H) continue;
    St s = load<REFINE, UNIQ>(st + p, stride);
    for (int v = 1; v < nw; ++v)
      s = merge<REFINE, UNIQ>(s, load<REFINE, UNIQ>(st + v * npix + p, stride),
                              v * cpw * 32 - 1);
    float disp = static_cast<float>(s.bd + mind);
    if constexpr (REFINE) {
      // the plain version's parabolic step, operation for operation
      const float denom = (s.cm + s.cp) - 2.0f * s.m;
      float delta = denom > 0.0f ? (s.cm - s.cp) / (2.0f * denom) : 0.0f;
      delta = fminf(fmaxf(delta, -0.5f), 0.5f);
      const bool interior = s.bd > 0 && s.bd < nd - 1 && s.cm < kBig && s.cp < kBig;
      disp = disp + (interior ? delta : 0.0f);
    }
    const long long o = static_cast<long long>(y) * W + x;
    disp_raw[o] = disp;
    best_cost[o] = s.m;
    excl_out[o] = UNIQ ? s.ein : kBig;
  }
}

template <bool REFINE, bool UNIQ>
cudaError_t launch(const void* lf, const void* rf, void* disp_raw, void* best_cost, void* excl,
                   int H, int W, int nd, int mind, int r, int tile_rows, cudaStream_t s) {
  const int nchunks = (nd + 31) / 32;
  int cpw = (nchunks + kMaxWarps - 1) / kMaxWarps;
  int nw = (nchunks + cpw - 1) / cpw;
  const long long segs = (W + sad::kSeg - 1) / sad::kSeg;
  constexpr int F = n_fields<REFINE, UNIQ>();
  auto smem_of = [&](int warps, int ty) {
    return static_cast<long long>(warps) * (sad::scratch_floats(r) + sad::kSeg * ty * F) *
           static_cast<long long>(sizeof(float));
  };
  // on the current device: let the launch (and the occupancy query) use up to kMaxSmem
  const cudaError_t err = cudaFuncSetAttribute(bm_fused_kernel<REFINE, UNIQ>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  int ty = tile_rows;
  if (ty <= 0) {
    static int key[5] = {-1, -1, -1, -1, -1}, picked = 0;   // the last shape's choice
    const int k[5] = {H, W, nd, r, nw};
    if (!std::equal(k, k + 5, key)) {
      picked = sad::pick_rows(
          bm_fused_kernel<REFINE, UNIQ>, nw * 32, [&](int t) { return smem_of(nw, t); },
          [&](int t) { return segs * ((H + t - 1) / t); }, H, r, kMaxSmem);
      std::copy(k, k + 5, key);
    }
    ty = picked;
  }
  while (smem_of(nw, ty) > kMaxSmem && nw > 1) {   // fewer, longer ranges
    ++cpw;
    nw = (nchunks + cpw - 1) / cpw;
  }
  const long long smem = smem_of(nw, ty);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(segs), (H + ty - 1) / ty);
  bm_fused_kernel<REFINE, UNIQ><<<grid, nw * 32, static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(lf), static_cast<const float*>(rf),
      static_cast<float*>(disp_raw), static_cast<float*>(best_cost),
      static_cast<float*>(excl), H, W, nd, mind, r, ty, cpw);
  return cudaGetLastError();
}

}  // namespace

// lf, rf: (H, W) float32 prefiltered images; disp_raw, best_cost, excl:
// (H, W) float32 outputs.  tile_rows: rows per block (0: sad::pick_rows).  Returns cudaErrorInvalidValue when a strip of
// tile_rows does not fit in shared memory.
extern "C" int bm_fused(const void* lf, const void* rf, void* disp_raw, void* best_cost,
                        void* excl, int H, int W, int nd, int mind, int r, int refine,
                        int uniq, int tile_rows, void* stream) {
  if (H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (refine && uniq)
    err = launch<true, true>(lf, rf, disp_raw, best_cost, excl, H, W, nd, mind, r, tile_rows, s);
  else if (refine)
    err = launch<true, false>(lf, rf, disp_raw, best_cost, excl, H, W, nd, mind, r, tile_rows, s);
  else if (uniq)
    err = launch<false, true>(lf, rf, disp_raw, best_cost, excl, H, W, nd, mind, r, tile_rows, s);
  else
    err = launch<false, false>(lf, rf, disp_raw, best_cost, excl, H, W, nd, mind, r, tile_rows, s);
  return static_cast<int>(err);
}
