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
// What bounds it on the H100: arithmetic and shared-memory bandwidth, not
// device memory.  The cost volume the plain version writes and reads back
// (nd x H x W floats, 92 MB at 752x480x64) never leaves the SM here: each
// block reads its image tiles once and keeps only the running winner.
//
// Design: a block of TX threads owns a TX x TY output tile; thread t owns
// column t and keeps the TY pixels' winner state in registers.  The block
// loads the L tile with a radius halo and the R tile with a radius halo plus
// the nd - 1 columns of disparity halo into shared memory once.  For each d:
// (1) each thread forms the block-row column sums of |L - R_d| for one
// column of the halo tile, sliding down the TY rows (add the entering row,
// subtract the leaving one), (2) each thread adds the block-width window of
// column sums for its TY pixels and updates best (strict <, so ties keep the
// smallest d), the cost at best - 1 (the cost of the previous d when best
// moves), the cost at best + 1 and the previous cost.  Uniqueness takes a
// second sweep once best is known, as on the TPU.  The prefiltered values of
// an integer image are small integers in float32 (a SAD is at most
// 62 * 225 < 2^24), so the sliding and windowed sums are exact and equal the
// plain version's in any order.  None of the TPU kernel's machinery (the
// 8-lane roll schedule, u-space recentring, VMEM tile budgets, slack lanes)
// is carried over.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kTileY = 8;     // output rows per block (register state per thread)

__device__ __forceinline__ void column_sums(const float* Ls, const float* Rs, float* cs,
                                            int t, int tx, int cw, int rw, int r,
                                            int nd, int dd, int lx0, int W) {
  const int win = 2 * r + 1;
  for (int j = t; j < cw; j += tx) {
    const int xg = lx0 + j;
    const bool inside = xg >= 0 && xg < W;
    // R column for L column j at candidate dd (image column lx0 + j - d)
    const int jr = j + nd - 1 - dd;
    float s = 0.0f;
    for (int i = 0; i < win; ++i) s += fabsf(Ls[i * cw + j] - Rs[i * rw + jr]);
    cs[j] = inside ? s : 0.0f;
    for (int ty = 1; ty < kTileY; ++ty) {
      const int in_row = ty + 2 * r, out_row = ty - 1;
      s += fabsf(Ls[in_row * cw + j] - Rs[in_row * rw + jr]);
      s -= fabsf(Ls[out_row * cw + j] - Rs[out_row * rw + jr]);
      cs[ty * cw + j] = inside ? s : 0.0f;
    }
  }
}

__device__ __forceinline__ float window_cost(const float* cs, int ty, int cw, int t,
                                             int r, bool ok) {
  float c = 0.0f;
  for (int k = 0; k <= 2 * r; ++k) c += cs[ty * cw + t + k];
  return ok ? c : kBig;
}

__global__ void bm_fused_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
                                float* __restrict__ disp_raw, float* __restrict__ best_cost,
                                float* __restrict__ excl_out, int H, int W, int nd,
                                int mind, int r, int refine, int uniq) {
  extern __shared__ float smem[];
  const int tx = blockDim.x;
  const int cw = tx + 2 * r;           // L columns: x0 - r .. x0 + tx + r
  const int rows = kTileY + 2 * r;     // rows:      y0 - r .. y0 + TY + r
  const int rw = cw + nd - 1;          // R columns: x0 - r - mind - nd + 1 ..
  float* Ls = smem;
  float* Rs = Ls + rows * cw;
  float* cs = Rs + rows * rw;

  const int t = threadIdx.x;
  const int x0 = blockIdx.x * tx;
  const int y0 = blockIdx.y * kTileY;
  const int lx0 = x0 - r;
  const int rx0 = x0 - r - mind - nd + 1;

  for (int i = t; i < rows * cw; i += tx) {
    const int ry = i / cw, cx = i - ry * cw;
    const int y = y0 - r + ry, x = lx0 + cx;
    Ls[i] = (y >= 0 && y < H && x >= 0 && x < W) ? lf[static_cast<long long>(y) * W + x] : 0.0f;
  }
  for (int i = t; i < rows * rw; i += tx) {
    const int ry = i / rw, cx = i - ry * rw;
    const int y = y0 - r + ry, x = rx0 + cx;
    Rs[i] = (y >= 0 && y < H && x >= 0 && x < W) ? rf[static_cast<long long>(y) * W + x] : 0.0f;
  }
  __syncthreads();

  const int x = x0 + t;
  float best[kTileY], cm[kTileY], cp[kTileY], prev[kTileY];
  int bd[kTileY];

  for (int dd = 0; dd < nd; ++dd) {
    column_sums(Ls, Rs, cs, t, tx, cw, rw, r, nd, dd, lx0, W);
    __syncthreads();
    const int d = mind + dd;
    const bool ok = (x - d >= r) && (x - d <= W - 1 - r);
#pragma unroll
    for (int ty = 0; ty < kTileY; ++ty) {
      const float c = window_cost(cs, ty, cw, t, r, ok);
      if (dd == 0) {
        best[ty] = c;
        bd[ty] = 0;
        cm[ty] = kBig;
        cp[ty] = kBig;
      } else if (c < best[ty]) {
        cm[ty] = prev[ty];
        best[ty] = c;
        bd[ty] = dd;
        cp[ty] = kBig;
      } else if (dd == bd[ty] + 1) {
        cp[ty] = c;
      }
      prev[ty] = c;
    }
    __syncthreads();
  }

  float ex[kTileY];
#pragma unroll
  for (int ty = 0; ty < kTileY; ++ty) ex[ty] = kBig;
  if (uniq) {
    for (int dd = 0; dd < nd; ++dd) {
      column_sums(Ls, Rs, cs, t, tx, cw, rw, r, nd, dd, lx0, W);
      __syncthreads();
      const int d = mind + dd;
      const bool ok = (x - d >= r) && (x - d <= W - 1 - r);
#pragma unroll
      for (int ty = 0; ty < kTileY; ++ty) {
        const float c = window_cost(cs, ty, cw, t, r, ok);
        if (abs(dd - bd[ty]) > 1) ex[ty] = fminf(ex[ty], c);
      }
      __syncthreads();
    }
  }

  if (x >= W) return;
#pragma unroll
  for (int ty = 0; ty < kTileY; ++ty) {
    const int y = y0 + ty;
    if (y >= H) break;
    float disp = static_cast<float>(bd[ty] + mind);
    if (refine) {
      // the plain version's parabolic step, operation for operation
      const float denom = (cm[ty] + cp[ty]) - 2.0f * best[ty];
      float delta = denom > 0.0f ? (cm[ty] - cp[ty]) / (2.0f * denom) : 0.0f;
      delta = fminf(fmaxf(delta, -0.5f), 0.5f);
      const bool interior = bd[ty] > 0 && bd[ty] < nd - 1 && cm[ty] < kBig && cp[ty] < kBig;
      disp = disp + (interior ? delta : 0.0f);
    }
    const long long o = static_cast<long long>(y) * W + x;
    disp_raw[o] = disp;
    best_cost[o] = best[ty];
    excl_out[o] = ex[ty];
  }
}

constexpr int kTileX = 64;             // output columns per block, one thread each
constexpr long long kMaxSmem = 232448;  // dynamic shared memory an H100 block may opt into

}  // namespace

// lf, rf: (H, W) float32 prefiltered images; disp_raw, best_cost, excl:
// (H, W) float32 outputs.  Returns cudaErrorInvalidValue when the tiles of
// this block size and disparity range do not fit in shared memory.
extern "C" int bm_fused(const void* lf, const void* rf, void* disp_raw, void* best_cost,
                        void* excl, int H, int W, int nd, int mind, int r, int refine,
                        int uniq, void* stream) {
  if (H == 0 || W == 0) return 0;
  const long long cw = kTileX + 2 * r, rows = kTileY + 2 * r, rw = cw + nd - 1;
  const long long smem = (rows * cw + rows * rw + kTileY * cw) * static_cast<long long>(sizeof(float));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bm_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  bm_fused_kernel<<<grid, kTileX, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lf), static_cast<const float*>(rf),
      static_cast<float*>(disp_raw), static_cast<float*>(best_cost),
      static_cast<float*>(excl), H, W, nd, mind, r, refine, uniq);
  return static_cast<int>(cudaGetLastError());
}
