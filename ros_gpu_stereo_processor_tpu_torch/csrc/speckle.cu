// Speckle component labels and size propagation for Hopper (sm_90a):
// iterated row/column min- or max-propagation of an int32 field over runs of
// linked pixels.
//
// Replaces two TPU kernels of ros_gpu_stereo_processor_tpu/ops/
// speckle_pallas.py:
//   K3 _propagation_kernel (labels_pallas): entry speckle_labels, plain
//      version ops/speckle.py::_labels_scan;
//   K7 _maxprop_kernel (max_propagate_pallas): entry speckle_maxprop, plain
//      version ops/speckle.py::_max_propagate.
// A third entry, speckle_band_labels, runs the same rounds in min mode on a
// given label field: the band-local label rounds of the row-sharded speckle
// filter (parallel/frontend.py), which have no TPU kernel of their own.
//
// What K3 computes: label = minimum raster index of the pixel's 4-connected
// component, where neighbours connect iff both are valid and |d - d'| <=
// max_diff; invalid pixels get H*W.  Each of at most `iters` rounds is a row
// pass then a column pass, and each pass gives every run of connected pixels
// the minimum label of the run -- exactly what one row and one column
// segmented min-scan of the plain version do, so the labels are
// bit-identical at the same `iters`.  K7 is the same rounds with max in
// place of min, over a given field and given link masks (its plain version
// min-scans the negated field, which is the same thing).  Propagation is
// monotone, so a round that changes nothing is a fixed point: later rounds
// are skipped (the TPU kernels' early exit) without changing the result.  A
// union-find CCL would converge in fewer passes but differs wherever `iters`
// runs out first, so it is not used.
//
// What bounds it on the H100: latency, not bandwidth.  The whole state is
// under 3 MB and stays in L2; a round is two passes, each a chain of
// dependent steps along every line.  One warp takes one line: it stages the
// line's values and links in shared memory (independent loads, all in
// flight at once), then walks the line 32 elements at a time with a
// segmented scan in registers (five shuffle steps per chunk), forward for
// the prefix extreme of each run and backward for the suffix extreme of
// those, which is the run's extreme.  A row pass is then about 2 * W / 32
// chunk steps long, not W dependent steps.  Skipped rounds still cost their
// two launches.
//
// Design: K3 first runs one kernel that computes the initial labels and the
// two link masks (uint8, read by every later pass); K7 and the band labels
// are given theirs.  Then, per round, the line kernel over the rows (element
// stride 1) and over the columns (element stride W), templated on the
// combining operation.  Early exit needs no host read-back: round i records
// in changed[i] whether anything moved, and both passes of round i return
// at once when changed[i - 1] is 0.  All 2 * iters launches are enqueued by
// one C call.  Values are plain int32: no composite keys, no 2^19 limit (the
// TPU K7's, which packs the field beside segment ids).

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

struct MinOp {
  static constexpr int kNone = 0x7fffffff;           // identity of min
  __device__ static int f(int a, int b) { return min(a, b); }
};

struct MaxOp {
  static constexpr int kNone = -0x7fffffff - 1;      // identity of max
  __device__ static int f(int a, int b) { return max(a, b); }
};

// Segmented inclusive scan with Op across the warp, towards higher lanes
// (down = false) or towards lower lanes (down = true).  `stop` marks the
// lane where a run starts (scanning up) or ends (scanning down); on return
// it says whether such a lane lies between this lane and the chunk's edge,
// i.e. whether the run is closed within the chunk.
template <class Op>
__device__ __forceinline__ int seg_scan(int v, bool& stop, int lane, bool down) {
  for (int off = 1; off < 32; off <<= 1) {
    const int vv = down ? __shfl_down_sync(kFull, v, off) : __shfl_up_sync(kFull, v, off);
    const bool ss = down ? __shfl_down_sync(kFull, stop, off) : __shfl_up_sync(kFull, stop, off);
    if (down ? lane + off < 32 : lane >= off) {
      if (!stop) v = Op::f(v, vv);
      stop = stop || ss;
    }
  }
  return v;
}

// One warp per line: give every run of linked elements the run's Op-extreme
// value.  Element k of line i is val[i * line_stride + k * elem_stride];
// link[...] says whether it is linked to element k - 1 (0 at k = 0).
template <class Op>
__global__ void speckle_lines(int* __restrict__ val, const uint8_t* __restrict__ link,
                              int n_lines, int len, long long line_stride,
                              long long elem_stride, int* __restrict__ changed, int round) {
  if (round > 0 && changed[round - 1] == 0) return;
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int line = blockIdx.x * (blockDim.x >> 5) + warp;
  if (line >= n_lines) return;              // whole warps only: no block barrier below
  const int region = 2 * len + (len + 3) / 4;   // ints: values, prefix extremes, links
  int* s_val = smem + warp * region;
  int* s_fwd = s_val + len;
  uint8_t* s_link = reinterpret_cast<uint8_t*>(s_fwd + len);
  int* L = val + line * line_stride;
  const uint8_t* C = link + line * line_stride;
  for (int k = lane; k < len; k += 32) {
    s_val[k] = L[k * elem_stride];
    s_link[k] = C[k * elem_stride];
  }
  __syncwarp();

  // forward: prefix extreme of each run; a run starts where link is 0
  int carry = Op::kNone;
  for (int base = 0; base < len; base += 32) {
    const int k = base + lane;
    const bool in = k < len;
    bool closed = !in || !s_link[k];
    int v = seg_scan<Op>(in ? s_val[k] : Op::kNone, closed, lane, false);
    if (!closed) v = Op::f(v, carry);
    if (in) s_fwd[k] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
  __syncwarp();

  // backward: suffix extreme of the prefix extremes = the run's extreme; a
  // run ends at k where element k + 1 is not linked to it
  bool moved = false;
  carry = Op::kNone;
  for (int base = ((len - 1) / 32) * 32; base >= 0; base -= 32) {
    const int k = base + lane;
    const bool in = k < len;
    bool closed = !in || k == len - 1 || !s_link[k + 1];
    int v = seg_scan<Op>(in ? s_fwd[k] : Op::kNone, closed, lane, true);
    if (!closed) v = Op::f(v, carry);
    if (in && v != s_val[k]) {
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

template <class Op>
cudaError_t allow_smem(long long bytes) {
  if (bytes > kMaxStageBytes) return cudaErrorInvalidValue;
  if (bytes <= kStageBytes) return cudaSuccess;
  return cudaFuncSetAttribute(speckle_lines<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// `iters` rounds of Op-propagation of `val` (H, W) in place: a row pass over
// conn_x, then a column pass over conn_y, each round skipped on the device
// once a round has changed nothing.  `changed`: `iters` int32 scratch.
template <class Op>
cudaError_t propagate(int* val, const uint8_t* conn_x, const uint8_t* conn_y, int* changed,
                      int H, int W, int iters, cudaStream_t s) {
  cudaError_t err;
  if (iters <= 0) return cudaSuccess;
  if ((err = cudaMemsetAsync(changed, 0, sizeof(int) * iters, s)) != cudaSuccess) return err;
  const LinePass rows = line_pass(W), cols = line_pass(H);
  if ((err = allow_smem<Op>(rows.smem > cols.smem ? rows.smem : cols.smem)) != cudaSuccess)
    return err;
  for (int round = 0; round < iters; ++round) {
    speckle_lines<Op><<<(H + rows.warps - 1) / rows.warps, 32 * rows.warps,
                        static_cast<size_t>(rows.smem), s>>>(val, conn_x, H, W, W, 1, changed,
                                                             round);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    speckle_lines<Op><<<(W + cols.warps - 1) / cols.warps, 32 * cols.warps,
                        static_cast<size_t>(cols.smem), s>>>(val, conn_y, W, H, 1, W, changed,
                                                             round);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// out = field, then `iters` rounds of Op-propagation of out.
template <class Op>
int propagate_copy(const void* field, void* out, const void* conn_x, const void* conn_y,
                   void* changed, int H, int W, int iters, void* stream) {
  const long long n = static_cast<long long>(H) * W;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out, field, sizeof(int) * n, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(propagate<Op>(static_cast<int*>(out),
                                        static_cast<const uint8_t*>(conn_x),
                                        static_cast<const uint8_t*>(conn_y),
                                        static_cast<int*>(changed), H, W, iters, s));
}

}  // namespace

// K3.  disp: (H, W) float32; valid: (H, W) bool (one byte each); lab: (H, W)
// int32 output; conn_x, conn_y: (H, W) uint8 scratch; changed: `iters`
// int32 scratch.
extern "C" int speckle_labels(const void* disp, const void* valid, void* lab, void* conn_x,
                              void* conn_y, void* changed, int H, int W, float max_diff,
                              int iters, void* stream) {
  const long long n = static_cast<long long>(H) * W;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  speckle_init<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(disp), static_cast<const uint8_t*>(valid),
      static_cast<int*>(lab), static_cast<uint8_t*>(conn_x), static_cast<uint8_t*>(conn_y),
      H, W, max_diff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(propagate<MinOp>(static_cast<int*>(lab),
                                           static_cast<const uint8_t*>(conn_x),
                                           static_cast<const uint8_t*>(conn_y),
                                           static_cast<int*>(changed), H, W, iters, s));
}

// K7.  field: (H, W) int32; out: (H, W) int32 output; conn_x, conn_y: (H, W)
// bool link masks (element linked to its left / upper neighbour); changed:
// `iters` int32 scratch.
extern "C" int speckle_maxprop(const void* field, void* out, const void* conn_x,
                               const void* conn_y, void* changed, int H, int W, int iters,
                               void* stream) {
  return propagate_copy<MaxOp>(field, out, conn_x, conn_y, changed, H, W, iters, stream);
}

// The band-local label rounds: the same arguments, min in place of max.
extern "C" int speckle_band_labels(const void* field, void* out, const void* conn_x,
                                   const void* conn_y, void* changed, int H, int W,
                                   int iters, void* stream) {
  return propagate_copy<MinOp>(field, out, conn_x, conn_y, changed, H, W, iters, stream);
}
