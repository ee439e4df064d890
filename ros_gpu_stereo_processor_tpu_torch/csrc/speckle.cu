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
// filter (parallel/frontend.py), which have no TPU kernel of their own.  Its
// merge loop runs a fixed number of rounds on the device (no host read per
// round, so a mesh frame can be one CUDA graph); a device-side `done` flag
// that the loop sets at its fixed point gates each launch, which then only
// copies its field through (the JAX while_loop's exit, as a gate).
// A fourth entry, speckle_sizing (SZ), turns K3's labels into the filtered
// disparity and validity; it has no TPU kernel either (below).
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
// dependent steps along every line, and only the rounds the data needs (a
// dozen at 752x480) do work.  A host loop of one launch per pass costs
// 2 * iters launches (128 for K3 at 64 rounds, 960 for K7 at 480) whatever
// the data needs, so the walk is one launch.  Inside it, each pass's
// dependent chain along a line sets the time: walked 32 elements at a time,
// a line costs one five-step shuffle scan per chunk, which measured most of
// a round on the card; staging, the uncoalesced column accesses and the
// grid barriers take the rest.
//
// Design: one cooperative launch per call, persistent over the rounds.
// Every warp takes lines warp, warp + n_warps, ... of a pass (grid-stride).
// It stages a line's values and links in shared memory (eight loads a lane
// in flight), then scans it forward for the prefix extreme of each run and
// backward for the suffix extreme of those, which is the run's extreme.
// Each direction is a raking scan: every lane walks its own segment of
// about len / 32 elements, one segmented warp scan joins the segments, and
// every lane fixes up its segment's head or tail.  For lines of up to 992
// elements (line_extremes_regs) the segment stays in registers through both
// directions; longer lines go through shared memory (line_scan).  Columns
// of up to 992 elements are staged and written back a tile of adjacent
// columns per block (column_tiles), so that a warp's loads and stores touch
// a few cache lines rather than 32.  A grid
// barrier (cooperative_groups' grid sync) follows each pass; after the
// column pass every thread reads changed[round] and all leave the loop
// together once a round has moved nothing, so the passes and their order
// are the plain version's at every `iters`, converged or not.  Round 0's
// row pass reads the source instead of the output: K3 computes the initial
// labels and both link masks there (the old init kernel), K7 and the band
// labels read the given field (the old copy), and it writes every element
// of the output.  The grid is at most what can be co-resident (the
// cooperative launch's condition; the occupancy query is cached per device
// and block shape).  Values written by other blocks are read through L2
// (__ldcg), after the barrier.  The host enqueues one memset of `changed`
// (zeroing it inside the kernel would race with round 0's writes) and the
// kernel.  Values are plain int32: no composite keys, no 2^19 limit (the
// TPU K7's, which packs the field beside segment ids).
//
// SZ, the speckle filter's sizing and masking: keep = valid && lab < n &&
// (# pixels labelled lab) > T, out = keep ? disp : fill.  It replaces the
// plain-torch chain of ops/speckle.py::_keep_large_components and the
// where of filter_speckles (its plain version, which the JAX package's
// two-sort run-extent sizing matches; that sizing is jnp, not a Pallas
// kernel), whose index_add_ issued one global int64 atomic a pixel.  Labels
// are the component's minimum raster index, so every pixel of a large
// component, and every invalid pixel (label n), hit one address, and
// same-address atomics serialise in L2: ~0.28 ms a 1242x375 frame on an
// H100 80GB HBM3, against a 0.0019 ms bound.  Its bound is bytes, 14 a pixel (labels, disparity,
// validity in; disparity, validity out), plus those atomics.  Design: one
// memset of n int32 counts and two launches.  The count pass reads labels
// in raster order, a thread a pixel, so a warp holds 32 neighbours of a
// row, which almost always carry one or two labels; __match_any_sync groups
// the lanes of equal label and the group's lowest lane adds the group's
// size with one atomic: ~32 times fewer atomics, and none for the sentinel
// n (invalid pixels; K3 gives n to them alone, so a valid pixel is never
// labelled n).  The keep-and-fill pass reads each pixel's label, disparity
// and validity once and writes both outputs; counts[lab] hits a few
// L2-resident slots.  Integer adds commute, so the counts, and the result,
// are bit for bit bincount(lab)[lab] > T whatever order the atomics land in.
// int32 counts cannot overflow: a count is at most n < 2^31 (the wrapper
// refuses larger images).  The JAX package's int64 concern (ROADMAP R2) is
// its packed sort key, which this has none of.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

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
// it says whether such a lane lies between this lane and the warp's first
// lane (last, scanning down), i.e. whether the run is closed within the warp.
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

struct Args {
  const float* disp;      // K3: (H, W) disparity
  const uint8_t* valid;   // K3: (H, W) validity
  const int* field;       // K7, band labels: (H, W) initial values
  int* val;               // (H, W) output, propagated in place
  uint8_t* conn_x;        // (H, W) linked to the left neighbour (K3 writes it)
  uint8_t* conn_y;        // (H, W) linked to the upper neighbour (K3 writes it)
  int* changed;           // `iters` flags, zeroed before the launch
  const int* done;        // band labels: a 0-d flag, nonzero = copy `field` and leave; or null
  int H, W, iters;
  float max_diff;
};

// Shared memory of one warp for a line of `len` elements, in ints: values,
// scanned values, then links (bytes).
__host__ __device__ constexpr int line_region(int len) { return 2 * len + (len + 3) / 4; }

// One direction of the segmented scan along a staged line: dst[k] = the
// Op-extreme of src over k's run from its start to k (forward, `down`
// false) or from k to its end (backward); dst may be src.  A raking scan:
//   1. each lane walks its own segment of S consecutive elements in order,
//      S odd and at least len / 32 (so the lanes' segments start in 32
//      different banks), keeping the extreme since the last run stop;
//   2. one segmented warp scan over the 32 segment aggregates gives each
//      segment the extreme carried into it from the segments before it;
//   3. each lane gives that carry to the elements of its segment whose run
//      reaches the segment's edge without stopping.
// The dependent chain is about 2 * S steps plus one warp scan, where a walk
// chunk by chunk takes a warp scan per 32 elements; the result is the same
// (the same extremes over the same runs).
template <class Op>
__device__ void line_scan(const int* src, int* dst, const uint8_t* s_link, int len, int lane,
                          bool down) {
  const int S = ((len + 31) / 32) | 1;
  const int b = min(lane * S, len), e = min(b + S, len);
  int acc = Op::kNone;
  bool closed = false;          // a run stops inside the segment
  if (!down) {
    for (int j = b; j < e; ++j) {
      const bool start = !s_link[j];
      acc = start ? src[j] : Op::f(acc, src[j]);
      closed = closed || start;
      dst[j] = acc;
    }
  } else {
    for (int j = e - 1; j >= b; --j) {
      const bool end = j == len - 1 || !s_link[j + 1];
      acc = end ? src[j] : Op::f(acc, src[j]);
      closed = closed || end;
      dst[j] = acc;
    }
  }
  int carry = seg_scan<Op>(acc, closed, lane, down);     // out of each segment
  carry = down ? __shfl_down_sync(kFull, carry, 1) : __shfl_up_sync(kFull, carry, 1);
  if (lane == (down ? 31 : 0)) carry = Op::kNone;        // into each segment
  if (!down) {
    for (int j = b; j < e && s_link[j]; ++j) dst[j] = Op::f(dst[j], carry);
  } else {
    for (int j = e - 1; j >= b && j < len - 1 && s_link[j + 1]; --j)
      dst[j] = Op::f(dst[j], carry);
  }
  __syncwarp();
}

// Both directions of line_scan at once, for lines of at most 32 * kMax
// elements (segments of at most kMax, which fit in registers): each lane
// loads its segment and its run starts and ends (bit masks) from shared
// memory once, and every step after that is in registers.  dst[k] = the
// Op-extreme of src over k's run; element k is src[k * stride], its link
// s_link[k * link_stride].
constexpr int kMaxSeg = 31;     // lines up to 992 elements: 752 x 480 frames

template <class Op>
__device__ void line_extremes_regs(const int* src, int* dst, const uint8_t* s_link, int len,
                                   int lane, int stride = 1, int link_stride = 1) {
  const int S = ((len + 31) / 32) | 1;
  const int b = min(lane * S, len), n = min(b + S, len) - b;
  int x[kMaxSeg];
  unsigned start = 0, end = 0;    // bit j: element b + j starts / ends a run
#pragma unroll
  for (int j = 0; j < kMaxSeg; ++j) {
    if (j < n) {
      x[j] = src[(b + j) * stride];
      start |= static_cast<unsigned>(!s_link[(b + j) * link_stride]) << j;
      end |= static_cast<unsigned>(b + j == len - 1 || !s_link[(b + j + 1) * link_stride]) << j;
    }
  }
  // forward: prefix extremes, then the carry into the elements before the
  // segment's first run start
  int acc = Op::kNone;
#pragma unroll
  for (int j = 0; j < kMaxSeg; ++j) {
    if (j < n) {
      acc = (start >> j & 1) ? x[j] : Op::f(acc, x[j]);
      x[j] = acc;
    }
  }
  bool closed = start != 0;
  int carry = __shfl_up_sync(kFull, seg_scan<Op>(acc, closed, lane, false), 1);
  if (lane == 0) carry = Op::kNone;
  const unsigned head = start ? (start & (0u - start)) - 1 : ~0u;
#pragma unroll
  for (int j = 0; j < kMaxSeg; ++j)
    if (j < n && (head >> j & 1)) x[j] = Op::f(x[j], carry);
  // backward: suffix extremes, then the carry into the elements after the
  // segment's last run end
  acc = Op::kNone;
#pragma unroll
  for (int j = kMaxSeg - 1; j >= 0; --j) {
    if (j < n) {
      acc = (end >> j & 1) ? x[j] : Op::f(acc, x[j]);
      x[j] = acc;
    }
  }
  closed = end != 0;
  carry = __shfl_down_sync(kFull, seg_scan<Op>(acc, closed, lane, true), 1);
  if (lane == 31) carry = Op::kNone;
  const unsigned tail = end ? ~((2u << (31 - __clz(end))) - 1) : ~0u;
#pragma unroll
  for (int j = 0; j < kMaxSeg; ++j) {
    if (j < n) dst[(b + j) * stride] = (tail >> j & 1) ? Op::f(x[j], carry) : x[j];
  }
  __syncwarp();
}

// One warp walks one line: every run of linked elements gets the run's
// Op-extreme value.  Rows (element stride 1, links conn_x) or columns
// (element stride W, links conn_y).  `first` is round 0's row pass, which
// reads the source and writes every element; with `scan` false (iters = 0)
// it only writes the source.  Sets changed[round] if a value moved.
template <class Op, bool kLabels>
__device__ void walk_line(const Args& a, int line, bool rows, bool first, bool scan, int round,
                          int* s_val, int lane) {
  const int len = rows ? a.W : a.H;
  const int line_stride = rows ? a.W : 1, elem_stride = rows ? 1 : a.W;
  int* s_fwd = s_val + len;
  uint8_t* s_link = reinterpret_cast<uint8_t*>(s_fwd + len);
  const uint8_t* link = rows ? a.conn_x : a.conn_y;
  const int base_i = line * line_stride;
  constexpr int kBatch = 8;     // elements a lane keeps in flight

  if (!first) {
    // values written by other blocks in the last pass: through L2
    for (int k0 = lane; k0 < len; k0 += 32 * kBatch) {
      int v[kBatch];
      uint8_t l[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + 32 * u;
        if (k < len) {
          v[u] = __ldcg(a.val + base_i + k * elem_stride);
          l[u] = __ldcg(link + base_i + k * elem_stride);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + 32 * u;
        if (k < len) {
          s_val[k] = v[u];
          s_link[k] = l[u];
        }
      }
    }
  } else if (kLabels) {
    // the initial labels and both link masks (rows: line = y, k = x); every
    // load is made, at a clamped index, so that none waits on another
    const int n = a.H * a.W;
#pragma unroll 4
    for (int k = lane; k < len; k += 32) {
      const int i = base_i + k;
      const int il = k > 0 ? i - 1 : i, iu = line > 0 ? i - a.W : i;
      const uint8_t v = a.valid[i], vl = a.valid[il], vu = a.valid[iu];
      const float d = a.disp[i], dl = a.disp[il], du = a.disp[iu];
      const bool cx = v && k > 0 && vl && fabsf(d - dl) <= a.max_diff;
      const bool cy = v && line > 0 && vu && fabsf(d - du) <= a.max_diff;
      a.conn_x[i] = cx;
      a.conn_y[i] = cy;
      s_val[k] = v ? i : n;
      s_link[k] = cx;
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < len; k += 32) {
      s_val[k] = a.field[base_i + k];
      s_link[k] = a.conn_x[base_i + k];
    }
  }
  __syncwarp();
  if (!scan) {
    for (int k = lane; k < len; k += 32) a.val[base_i + k * elem_stride] = s_val[k];
    return;
  }

  // forward: prefix extreme of each run; backward: suffix extreme of the
  // prefix extremes = the run's extreme
  if (len <= 32 * kMaxSeg) {
    line_extremes_regs<Op>(s_val, s_fwd, s_link, len, lane);
  } else {
    line_scan<Op>(s_val, s_fwd, s_link, len, lane, false);
    line_scan<Op>(s_fwd, s_fwd, s_link, len, lane, true);
  }

  bool moved = false;
  for (int k = lane; k < len; k += 32) {
    const int v = s_fwd[k];
    const bool diff = v != s_val[k];
    if (diff || first) a.val[base_i + k * elem_stride] = v;
    moved = moved || diff;
  }
  if (__any_sync(kFull, moved) && lane == 0) a.changed[round] = 1;
  __syncwarp();     // the warp's next line reuses the staging buffers
}

// Shared memory of the column tiles: `warps` columns of `h` elements, values
// and extremes at an odd pitch, links at a pitch of `warps` bytes.
__host__ __device__ constexpr int tile_bytes(int h, int warps) {
  return 8 * h * (warps | 1) + h * warps;
}

// The column pass for columns of at most 32 * kMaxSeg elements.  A block
// takes `warps` adjacent columns at a time: its threads stage them together
// into a row-major tile (a warp's load covers 32 / warps rows of `warps`
// adjacent elements, a few cache lines, where a warp walking one column
// touches 32), each warp scans one column of the tile in registers, and the
// block writes back the elements that changed the same way.  Every thread
// of the block runs the same loop, so the block barriers are reached by all.
template <class Op>
__device__ void column_tiles(const Args& a, int round, int* smem) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pitch = warps | 1;    // odd: the lanes' segments start in distinct banks
  int* t_val = smem;
  int* t_out = t_val + a.H * pitch;
  uint8_t* t_link = reinterpret_cast<uint8_t*>(t_out + a.H * pitch);
  const int c = threadIdx.x % warps, y0 = threadIdx.x / warps;   // 32 rows per sweep
  constexpr int kBatch = 8;
  bool moved = false;
  for (int x0 = blockIdx.x * warps; x0 < a.W; x0 += gridDim.x * warps) {
    const bool mine = x0 + c < a.W;
    for (int ya = y0; ya < a.H; ya += 32 * kBatch) {
      int v[kBatch];
      uint8_t l[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int y = ya + 32 * u;
        if (mine && y < a.H) {
          v[u] = __ldcg(a.val + y * a.W + x0 + c);
          l[u] = __ldcg(a.conn_y + y * a.W + x0 + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int y = ya + 32 * u;
        if (mine && y < a.H) {
          t_val[y * pitch + c] = v[u];
          t_link[y * warps + c] = l[u];
        }
      }
    }
    __syncthreads();
    if (x0 + warp < a.W)
      line_extremes_regs<Op>(t_val + warp, t_out + warp, t_link + warp, a.H, lane, pitch, warps);
    __syncthreads();
    for (int y = y0; mine && y < a.H; y += 32) {
      const int e = t_out[y * pitch + c];
      if (e != t_val[y * pitch + c]) {
        a.val[y * a.W + x0 + c] = e;
        moved = true;
      }
    }
    __syncthreads();              // the next columns overwrite the tile
  }
  if (__any_sync(kFull, moved) && lane == 0) a.changed[round] = 1;
}

// The whole walk: `iters` rounds (a row pass, then a column pass), leaving
// after the first round that moved nothing.  Every thread of every block
// reaches every grid barrier: no thread returns early, but for the `done`
// gate below, which every thread reads at entry and leaves by together,
// before any barrier.
template <class Op, bool kLabels>
__global__ void __launch_bounds__(256) propagate_kernel(Args a) {
  extern __shared__ int smem[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int gwarp = blockIdx.x * warps + warp, n_warps = gridDim.x * warps;
  if (!kLabels && a.done != nullptr && __ldcg(a.done) != 0) {
    // the row-band merge loop has converged: the rounds would change
    // nothing, so the output is the field as it is
    const int n = a.H * a.W;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
      a.val[i] = a.field[i];
    return;
  }
  const int rounds = a.iters > 0 ? a.iters : 1;
  for (int round = 0; round < rounds; ++round) {
    int* s_row = smem + warp * line_region(a.W);
    for (int line = gwarp; line < a.H; line += n_warps)
      walk_line<Op, kLabels>(a, line, true, round == 0, a.iters > 0, round, s_row, lane);
    if (a.iters <= 0) break;          // uniform: only the source was written
    grid.sync();
    if (a.H <= 32 * kMaxSeg) {
      column_tiles<Op>(a, round, smem);
    } else {
      int* s_col = smem + warp * line_region(a.H);
      for (int line = gwarp; line < a.W; line += n_warps)
        walk_line<Op, kLabels>(a, line, false, false, true, round, s_col, lane);
    }
    if (round + 1 == rounds) break;   // uniform: the last round needs no exit test
    grid.sync();
    if (__ldcg(a.changed + round) == 0) break;   // same flag, same barrier, every thread
  }
}

constexpr int kMaxStageBytes = 227 * 1024; // the most an H100 block may use
constexpr int kMaxWarps = 8;               // warps per block

// Blocks of this kernel that fit on the current device at once, for a block
// of `threads` with `smem` bytes of dynamic shared memory: the occupancy
// query times the SM count, cached per (device, threads, smem).  A miss
// first lifts the kernel's dynamic shared memory limit on the device to the
// card's most (always the same value, so calls never race on it).
template <class Op, bool kLabels>
cudaError_t coresident_blocks(int threads, int smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> cache;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, threads, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(propagate_kernel<Op, kLabels>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, propagate_kernel<Op, kLabels>,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
  cache[key] = per_sm * sms;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// Zero `changed`, then launch the persistent walk over `a`.
template <class Op, bool kLabels>
int propagate(Args a, cudaStream_t s) {
  if (static_cast<long long>(a.H) * a.W == 0) return 0;
  const int len = a.H > a.W ? a.H : a.W;
  const int per_line = 4 * line_region(len);
  if (per_line > kMaxStageBytes) return static_cast<int>(cudaErrorInvalidValue);
  int warps = kMaxStageBytes / per_line;
  warps = warps > kMaxWarps ? kMaxWarps : warps;
  const int threads = 32 * warps;
  int smem = warps * per_line;          // one line per warp
  if (a.H <= 32 * kMaxSeg && tile_bytes(a.H, warps) > smem) smem = tile_bytes(a.H, warps);
  int blocks;
  cudaError_t err = coresident_blocks<Op, kLabels>(threads, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wanted = (len + warps - 1) / warps;
  if (wanted < blocks) blocks = wanted;
  const int flags = a.iters > 0 ? a.iters : 1;
  if ((err = cudaMemsetAsync(a.changed, 0, sizeof(int) * flags, s)) != cudaSuccess)
    return static_cast<int>(err);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&propagate_kernel<Op, kLabels>), dim3(blocks),
      dim3(threads), params, static_cast<size_t>(smem), s));
}

constexpr int kSizingThreads = 256;

// SZ's count pass: counts[l] += # pixels labelled l, for l < n; one atomic
// per group of lanes with equal labels.  Every lane reaches the match (a
// lane past the image takes the sentinel).  A label outside [0, n) adds
// nothing.
__global__ void __launch_bounds__(kSizingThreads)
    sizing_count_kernel(const int* __restrict__ lab, int* __restrict__ counts, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int l = i < n ? __ldg(lab + i) : n;
  const unsigned group = __match_any_sync(kFull, l);
  if (static_cast<unsigned>(l) < static_cast<unsigned>(n) &&
      static_cast<int>(threadIdx.x & 31) == __ffs(group) - 1)
    atomicAdd(counts + l, __popc(group));
}

// SZ's keep-and-fill pass, a thread a pixel.
__global__ void __launch_bounds__(kSizingThreads)
    sizing_fill_kernel(const float* __restrict__ disp, const uint8_t* __restrict__ valid,
                       const int* __restrict__ lab, const int* __restrict__ counts,
                       float* __restrict__ out, uint8_t* __restrict__ keep, int n, int T,
                       float fill) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int l = __ldg(lab + i);
  const bool k = __ldg(valid + i) != 0 && static_cast<unsigned>(l) < static_cast<unsigned>(n) &&
                 __ldg(counts + l) > T;
  out[i] = k ? __ldg(disp + i) : fill;
  keep[i] = k;
}

}  // namespace

// K3.  disp: (H, W) float32; valid: (H, W) bool (one byte each); lab: (H, W)
// int32 output; conn_x, conn_y: (H, W) uint8 scratch; changed: max(iters, 1)
// int32 scratch.
extern "C" int speckle_labels(const void* disp, const void* valid, void* lab, void* conn_x,
                              void* conn_y, void* changed, int H, int W, float max_diff,
                              int iters, void* stream) {
  Args a{static_cast<const float*>(disp), static_cast<const uint8_t*>(valid), nullptr,
         static_cast<int*>(lab), static_cast<uint8_t*>(conn_x), static_cast<uint8_t*>(conn_y),
         static_cast<int*>(changed), nullptr, H, W, iters, max_diff};
  return propagate<MinOp, true>(a, static_cast<cudaStream_t>(stream));
}

namespace {

template <class Op>
int propagate_field(const void* field, void* out, const void* conn_x, const void* conn_y,
                    void* changed, const void* done, int H, int W, int iters, void* stream) {
  Args a{nullptr, nullptr, static_cast<const int*>(field), static_cast<int*>(out),
         static_cast<uint8_t*>(const_cast<void*>(conn_x)),
         static_cast<uint8_t*>(const_cast<void*>(conn_y)), static_cast<int*>(changed),
         static_cast<const int*>(done), H, W, iters, 0.0f};
  return propagate<Op, false>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// K7.  field: (H, W) int32; out: (H, W) int32 output; conn_x, conn_y: (H, W)
// bool link masks (element linked to its left / upper neighbour); changed:
// max(iters, 1) int32 scratch.
extern "C" int speckle_maxprop(const void* field, void* out, const void* conn_x,
                               const void* conn_y, void* changed, int H, int W, int iters,
                               void* stream) {
  return propagate_field<MaxOp>(field, out, conn_x, conn_y, changed, nullptr, H, W, iters,
                                stream);
}

// The band-local label rounds: K7's arguments, min in place of max, and
// `done`: null, or a device int32 read once at the kernel's entry; when it
// is nonzero (the row-band merge loop has converged) the launch copies
// `field` to `out` and runs no round.
extern "C" int speckle_band_labels(const void* field, void* out, const void* conn_x,
                                   const void* conn_y, void* changed, const void* done, int H,
                                   int W, int iters, void* stream) {
  return propagate_field<MinOp>(field, out, conn_x, conn_y, changed, done, H, W, iters,
                                stream);
}

// SZ.  disp: n float32; valid: n bool (one byte each); lab: n int32 labels,
// n where invalid (K3's); counts: n int32 scratch, zeroed here; out: n
// float32 output (disp where kept, else `fill`); keep: n bool output.
// Components of at most T pixels are dropped.
extern "C" int speckle_sizing(const void* disp, const void* valid, const void* lab, void* counts,
                              void* out, void* keep, int n, int T, float fill, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kSizingThreads - 1) /
                                                kSizingThreads);
  sizing_count_kernel<<<blocks, kSizingThreads, 0, s>>>(static_cast<const int*>(lab),
                                                        static_cast<int*>(counts), n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sizing_fill_kernel<<<blocks, kSizingThreads, 0, s>>>(
      static_cast<const float*>(disp), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(lab), static_cast<const int*>(counts), static_cast<float*>(out),
      static_cast<uint8_t*>(keep), n, T, fill);
  return static_cast<int>(cudaGetLastError());
}
