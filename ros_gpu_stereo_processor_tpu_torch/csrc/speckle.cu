// Speckle component labels for Hopper (sm_90a): iterated row/column
// min-propagation of raster labels.
//
// Replaces: ros_gpu_stereo_processor_tpu/ops/speckle_pallas.py::
// _propagation_kernel (launched by labels_pallas).  Plain version:
// ops/speckle.py::_labels_scan.
//
// What it computes: label = minimum raster index of the pixel's 4-connected
// component, where neighbours connect iff both are valid and |d - d'| <=
// max_diff; invalid pixels get H*W.  Each of at most `iters` rounds is a row
// pass then a column pass, and each pass gives every run of connected pixels
// the minimum label of the run -- exactly what one row and one column
// segmented min-scan of the plain version do, so the labels are
// bit-identical at the same `iters`.  Propagation only ever lowers labels,
// so a round that changes nothing is a fixed point: later rounds are skipped
// (the TPU kernel's early exit) without changing the result.  A union-find
// CCL would converge in fewer passes but differs wherever `iters` runs out
// first, so it is not used.
//
// What bounds it on the H100: latency, not bandwidth.  The whole state is
// under 3 MB and stays in L2; a round is two passes, each a chain of
// dependent steps along every line.  One warp takes one line: it stages the
// line's labels and links in shared memory (independent loads, all in
// flight at once), then walks the line 32 elements at a time with a
// segmented min-scan in registers (five shuffle steps per chunk), forward
// for the prefix minimum of each run and backward for the suffix minimum of
// those, which is the run's minimum.  A row pass is then about 2 * W / 32
// chunk steps long, not W dependent steps.  Skipped rounds still cost their
// two launches.
//
// Design: one kernel computes the initial labels and the two link masks
// (uint8, read by every later pass).  Then, per round, the line kernel over
// the rows (element stride 1) and over the columns (element stride W).
// Early exit needs no host read-back: round i records in changed[i] whether
// anything moved, and both passes of round i return at once when
// changed[i - 1] is 0.  All 2 * iters launches are enqueued by one C call.
// Labels are plain int32: no composite keys, no 2^19 label limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void speckle_init(const float* __restrict__ disp,
                             const uint8_t* __restrict__ valid, int* __restrict__ lab,
                             uint8_t* __restrict__ conn_x, uint8_t* __restrict__ conn_y,
                             int H, int W, float max_diff) {
  const long long n = static_cast<long long>(H) * W;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = static_cast<int>(i / W), x = static_cast<int>(i - static_cast<long long>(y) * W);
  const bool v = valid[i] != 0;
  lab[i] = v ? static_cast<int>(i) : static_cast<int>(n);
  conn_x[i] = v && x > 0 && valid[i - 1] && fabsf(disp[i] - disp[i - 1]) <= max_diff;
  conn_y[i] = v && y > 0 && valid[i - W] && fabsf(disp[i] - disp[i - W]) <= max_diff;
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;          // identity of min

// Segmented inclusive min-scan across the warp, towards higher lanes
// (down = false) or towards lower lanes (down = true).  `stop` marks the
// lane where a run starts (scanning up) or ends (scanning down); on return
// it says whether such a lane lies between this lane and the chunk's edge,
// i.e. whether the run is closed within the chunk.
__device__ __forceinline__ int seg_scan(int v, bool& stop, int lane, bool down) {
  for (int off = 1; off < 32; off <<= 1) {
    const int vv = down ? __shfl_down_sync(kFull, v, off) : __shfl_up_sync(kFull, v, off);
    const bool ss = down ? __shfl_down_sync(kFull, stop, off) : __shfl_up_sync(kFull, stop, off);
    if (down ? lane + off < 32 : lane >= off) {
      if (!stop) v = min(v, vv);
      stop = stop || ss;
    }
  }
  return v;
}

// One warp per line: give every run of linked elements the run's minimum
// label.  Element k of line i is lab[i * line_stride + k * elem_stride];
// link[...] says whether it is linked to element k - 1 (0 at k = 0).
__global__ void speckle_lines(int* __restrict__ lab, const uint8_t* __restrict__ link,
                              int n_lines, int len, long long line_stride,
                              long long elem_stride, int* __restrict__ changed, int round) {
  if (round > 0 && changed[round - 1] == 0) return;
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int line = blockIdx.x * (blockDim.x >> 5) + warp;
  if (line >= n_lines) return;              // whole warps only: no block barrier below
  const int region = 2 * len + (len + 3) / 4;   // ints: labels, prefix mins, links
  int* s_lab = smem + warp * region;
  int* s_fwd = s_lab + len;
  uint8_t* s_link = reinterpret_cast<uint8_t*>(s_fwd + len);
  int* L = lab + line * line_stride;
  const uint8_t* C = link + line * line_stride;
  for (int k = lane; k < len; k += 32) {
    s_lab[k] = L[k * elem_stride];
    s_link[k] = C[k * elem_stride];
  }
  __syncwarp();

  // forward: prefix minimum of each run; a run starts where link is 0
  int carry = kNone;
  for (int base = 0; base < len; base += 32) {
    const int k = base + lane;
    const bool in = k < len;
    bool closed = !in || !s_link[k];
    int v = seg_scan(in ? s_lab[k] : kNone, closed, lane, false);
    if (!closed) v = min(v, carry);
    if (in) s_fwd[k] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
  __syncwarp();

  // backward: suffix minimum of the prefix minima = the run's minimum; a
  // run ends at k where element k + 1 is not linked to it
  bool moved = false;
  carry = kNone;
  for (int base = ((len - 1) / 32) * 32; base >= 0; base -= 32) {
    const int k = base + lane;
    const bool in = k < len;
    bool closed = !in || k == len - 1 || !s_link[k + 1];
    int v = seg_scan(in ? s_fwd[k] : kNone, closed, lane, true);
    if (!closed) v = min(v, carry);
    if (in && v != s_lab[k]) {
      L[k * elem_stride] = v;
      moved = true;
    }
    carry = __shfl_sync(kFull, v, 0);
  }
  if (__any_sync(kFull, moved) && lane == 0) changed[round] = 1;
}

constexpr int kStageBytes = 48 * 1024;     // shared memory without opt-in
constexpr int kMaxStageBytes = 227 * 1024; // the most an H100 block may use
constexpr int kMaxWarps = 8;               // lines (warps) per block

struct LinePass {
  int warps;          // lines per block
  long long smem;     // dynamic shared memory per block, bytes
};

LinePass line_pass(int len) {
  const long long per_line = 4LL * (2 * len + (len + 3) / 4);
  long long w = kStageBytes / per_line;
  w = w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
  return {static_cast<int>(w), w * per_line};
}

cudaError_t allow_smem(long long bytes) {
  if (bytes > kMaxStageBytes) return cudaErrorInvalidValue;
  if (bytes <= kStageBytes) return cudaSuccess;
  return cudaFuncSetAttribute(speckle_lines, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// disp: (H, W) float32; valid: (H, W) bool (one byte each); lab: (H, W)
// int32 output; conn_x, conn_y: (H, W) uint8 scratch; changed: `iters`
// int32 scratch.
extern "C" int speckle_labels(const void* disp, const void* valid, void* lab, void* conn_x,
                              void* conn_y, void* changed, int H, int W, float max_diff,
                              int iters, void* stream) {
  const long long n = static_cast<long long>(H) * W;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (iters > 0) {
    err = cudaMemsetAsync(changed, 0, sizeof(int) * iters, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 256;
  speckle_init<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(disp), static_cast<const uint8_t*>(valid),
      static_cast<int*>(lab), static_cast<uint8_t*>(conn_x), static_cast<uint8_t*>(conn_y),
      H, W, max_diff);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const LinePass rows = line_pass(W), cols = line_pass(H);
  if ((err = allow_smem(rows.smem > cols.smem ? rows.smem : cols.smem)) != cudaSuccess)
    return static_cast<int>(err);
  for (int round = 0; round < iters; ++round) {
    speckle_lines<<<(H + rows.warps - 1) / rows.warps, 32 * rows.warps,
                    static_cast<size_t>(rows.smem), s>>>(
        static_cast<int*>(lab), static_cast<const uint8_t*>(conn_x), H, W, W, 1,
        static_cast<int*>(changed), round);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    speckle_lines<<<(W + cols.warps - 1) / cols.warps, 32 * cols.warps,
                    static_cast<size_t>(cols.smem), s>>>(
        static_cast<int*>(lab), static_cast<const uint8_t*>(conn_y), W, H, 1, W,
        static_cast<int*>(changed), round);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
