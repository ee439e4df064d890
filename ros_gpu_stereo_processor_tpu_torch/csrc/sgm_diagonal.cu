// The SGM diagonal pair walk (DG) for Hopper (sm_90a): one diagonal line
// pair of 8-path SGM, both directions in one launch, written as the pair sum.
//
// Replaces the jnp diagonal scans of ros_gpu_stereo_processor_tpu/ops/sgm.py
// (_aggregate_diagonal, which the JAX pipeline runs for 8 paths; no TPU
// kernel):
//   sgm_aggregate_diagonal <- the excess of (dx, forward) plus that of (-dx,
//                     reverse), the same 45-degree lines walked top to bottom
//                     and bottom to top.
// Plain version: ops/sgm_kernel.py::aggregate_diagonal_plain.  Volumes,
// storage modes, the recurrence and exactness as in sgm.cu; the carry
// starts at 1e6 (_RESTART) as JAX's, so a line starts at L = C exactly.
//
// Line geometry.  JAX's _aggregate_diagonal walks rows and shifts its carry
// dx columns a row, with _RESTART in the vacated column, so each 45-degree
// line is a path of its own that starts where it enters the image.  dx = +1:
// the lines x - y = line - (H - 1), pixel to pixel (W + 1) * nd elements;
// dx = -1: the lines x + y = line, (W - 1) * nd; W + H - 1 lines of 1 to
// min(H, W) pixels, one 1-warp block each.
//
// What bounds it (an H100 80GB HBM3 at 700 W, 752x480, mode 0, 128
// disparities: ~0.098 ms a call against the bound's 0.0414): a byte model
// counts ~7 bytes a cell, not the bound's 3 (the cost read by both
// directions at times far apart; the first visit's excess stored, read back
// and overwritten), ~0.096 ms at the memory rate; each SM sub-partition's
// issue rate (H W / 528 warp-steps each, K values a lane) predicts the same
// ~205 ns a step on the image and on a 134-row band.  scripts/
// torch_match_kernels.py times it warm and with L2 emptied before each
// call, which tells the two apart.
//
// The pair walk (nd <= 256, sgm_diagonal_pair_kernel) walks both directions
// of a line at once: lanes 0-15 top to bottom (dx, forward), lanes 16-31
// bottom to top (-dx, reverse), each lane holding K = nd / 16 disparities
// (rounded up to 1, 2, 4, 8, 16).  A warp-step advances two pixels, so a
// call takes H W warp-steps, not the two-pass walk's 2 H W, and the longest
// chain is min(H, W) steps, not 2 min(H, W).  The neighbour shuffles act on
// each half alone (__shfl_*_sync of width 16, +1e9 guards at lanes 0, 15,
// 16 and 31), and so does the minimum (half_min: two whole-warp
// __reduce_min_sync, each with the other half's lanes at the largest value;
// one on each half's 16-lane mask diverges the warp around it, and both it
// and four xor shuffles were slower on the card).  A pixel at position p of
// a line of `len` is reached by the top half at step p and by the bottom
// half at step len - 1 - p; whichever comes second writes the pair sum,
// with its partner's stored excess as the incoming one (a float32 sum of
// two values is the same in either order).  With nG = (len - 1) / 2, both
// halves make nG first visits (each storing its excess), then cross in one
// step (odd len: both at the middle pixel; the partner's excess by
// __shfl_xor_sync(.., 16), the top half writes) or two (even len: the
// halves swap pixels, then write the sums with the excess taken by the
// shuffle), then make nG second visits; every branch between the phases is
// warp-uniform.
//
// Each half stages its pixels through its own ring of D + 2 shared-memory
// slots by 16-byte cp.async, D pixels ahead, as walk_line does (lanes 0-7 of
// a half copy the cost, 8-15 the partner's excess; one source pointer per
// lane).  A partner's excess reaches a second visit one of two ways:
//   - for second visits b >= D (b counted from the first after the
//     crossing), through the ring, from device memory: their copies are
//     issued at or after the crossing, behind a __threadfence that follows
//     the last first visit, so every first-visit store is performed at
//     device scope (the copies read L2) before a copy can read it;
//   - for b < D, through a handoff of D slots in shared memory, written by
//     the partner's first visit nG - 1 - b (a copy D + 1 steps ahead would
//     be issued before that store) and made visible by a later step's
//     __syncwarp; the read comes a step early, and the partner stored it at
//     least two steps before.
// The excess lanes copy only for b >= D (their other groups are empty), and
// a first visit stores to device memory only what the ring reads back.
// Depth: a block holds two rings and two handoffs in kPairBlockBytes (20
// KB), so the 1231 blocks of a 752x480 call, 9.3 per SM, are resident at
// once (10 x (20 + 1 reserved) KB <= 228 KB; the carveout is set to the
// most shared memory).  D is the deepest that fits, up to 32: 18 at 128
// disparities (3.7 us ahead at ~205 ns a step), 32 at 64; a copy under the
// whole card's load takes microseconds.
//
// Wider ranges (nd 272-1024) would need 32-64 values a lane in registers;
// there the two-pass walk (sgm_diagonal_kernel, walk_line with 32 lanes,
// one warp down and back up) runs instead.  The C entry picks by nd, as
// with_lane_width picks K: a choice by shape, both exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sgm_walk.cuh"

namespace {

constexpr float kRestart = 1e6f;        // ops/sgm.py's _RESTART: a diagonal's carry at its start
constexpr int kPairMaxNd = 256;         // the widest range the pair walk takes (16 a lane)
constexpr int kPairBlockBytes = 20480;  // a pair-walk block's shared memory (at most)

// Line `line` of a diagonal pair: its top pixel (y0, x0) and its length.
__device__ __forceinline__ void diagonal_line(int line, int H, int W, int dx, int& y0, int& x0,
                                              int& len) {
  if (dx > 0) {
    const int k = line - (H - 1);
    y0 = k < 0 ? -k : 0;
    x0 = k < 0 ? 0 : k;
    len = min(H - y0, W - x0);
  } else {
    y0 = line < W ? 0 : line - (W - 1);
    x0 = line < W ? line : W - 1;
    len = min(H - y0, x0 + 1);
  }
}

// Two-pass DG (nd 272-1024): one warp per line walks it top to bottom (dx,
// forward), writing the excess to exc, then bottom to top (-dx, reverse)
// with exc as its incoming excess, writing the pair sum over it.
template <int K, typename CostT, typename ExcT>
__global__ void __launch_bounds__(32)
sgm_diagonal_kernel(const CostT* __restrict__ cost, ExcT* __restrict__ exc, int H, int W,
                    int nd, float p1, float p2, int dx) {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  int y0, x0, len;
  diagonal_line(blockIdx.x, H, W, dx, y0, x0, len);
  const long long stride = (static_cast<long long>(W) + dx) * nd;
  const long long top = (static_cast<long long>(y0) * W + x0) * nd;
  walk_line<K, CostT, ExcT>(cost, nullptr, exc, len, top, stride, nd, p1, p2, kRestart,
                            walk_smem);
  // every lane's excess stores performed at device scope (the copies read
  // L2) and every lane done with the ring before the second pass fills it
  cp_wait<0>();
  __threadfence();
  __syncwarp();
  walk_line<K, CostT, ExcT>(cost, exc, exc, len, top + (len - 1) * stride, -stride, nd, p1, p2,
                            kRestart, walk_smem);
}

// The minimum over this lane's half of the warp (`low`: lanes 0-15): two
// whole-warp __reduce_min_sync, each with the other half's lanes at the
// largest value, so the warp never diverges around them.
__device__ __forceinline__ unsigned half_min_key(unsigned k, bool low) {
  const unsigned a = __reduce_min_sync(kFull, low ? k : 0xffffffffu);
  const unsigned b = __reduce_min_sync(kFull, low ? 0xffffffffu : k);
  return low ? a : b;
}

// int32 carries are non-negative (below 2^31), so their order is that of
// their bits as unsigned; float32 carries go through order-preserving keys
__device__ __forceinline__ int half_min(int v, bool low) {
  return static_cast<int>(half_min_key(static_cast<unsigned>(v), low));
}

__device__ __forceinline__ float half_min(float v, bool low) {
  return unordered(half_min_key(ordered(v), low));
}

// Pixels each half of the pair walk stages ahead: its ring (D + 2 slots of
// a pixel's cost and excess) and its handoff (D slots of excess) in half of
// kPairBlockBytes at nd = 16 K, 2 to 32.
template <int K, typename CostT, typename ExcT>
__host__ __device__ constexpr int pair_depth() {
  constexpr int slot = 16 * K * static_cast<int>(sizeof(CostT) + sizeof(ExcT));
  constexpr int hand = 16 * K * static_cast<int>(sizeof(ExcT));
  constexpr int d = (kPairBlockBytes / 2 - 2 * slot) / (slot + hand);
  return d < 2 ? 2 : d > 32 ? 32 : d;
}

// A pair-walk block's shared memory at nd disparities: two rings, then two
// handoffs.
template <int K, typename CostT, typename ExcT>
long long pair_smem(int nd) {
  constexpr long long D = pair_depth<K, CostT, ExcT>();
  return 2 * nd * ((D + 2) * static_cast<long long>(sizeof(CostT) + sizeof(ExcT)) +
                   D * static_cast<long long>(sizeof(ExcT)));
}

using First = std::integral_constant<int, 0>;    // a half's first visit: store the excess
using Cross = std::integral_constant<int, 1>;    // the step(s) where the halves cross
using Second = std::integral_constant<int, 2>;   // the second visit: store the pair sum

// DG for nd <= 256: one warp per line, the two directions at once, half a
// warp each (see the top of this file).
template <int K, typename CostT, typename ExcT>
__global__ void __launch_bounds__(32)
sgm_diagonal_pair_kernel(const CostT* __restrict__ cost, ExcT* __restrict__ exc, int H, int W,
                         int nd, float p1, float p2, int dx) {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  using V = WalkT<CostT>;
  constexpr int D = pair_depth<K, CostT, ExcT>();
  constexpr int R = D + 2;              // ring slots, as walk_slots
  constexpr bool kAhead = K <= 8;
  // 16-byte copies per lane per pixel, at most: nd <= 16 K cost values over
  // 8 lanes (the excess is no wider)
  constexpr int NQ = K * static_cast<int>(sizeof(CostT)) / 8 > 1
                         ? K * static_cast<int>(sizeof(CostT)) / 8 : 1;
  int y0, x0, len;
  diagonal_line(blockIdx.x, H, W, dx, y0, x0, len);
  const long long stride = (static_cast<long long>(W) + dx) * nd;
  const long long top = (static_cast<long long>(y0) * W + x0) * nd;

  const int lane = threadIdx.x, hl = lane & 15;
  const bool low = lane < 16;           // the half that walks top to bottom
  const int d0 = hl * K;
  const int cost_bytes = nd * static_cast<int>(sizeof(CostT));
  const int pix_bytes = cost_bytes + nd * static_cast<int>(sizeof(ExcT));
  const int ring_bytes = R * pix_bytes;
  // the two rings, then the two handoffs
  unsigned char* ring = walk_smem + (low ? 0 : ring_bytes);
  ExcT* hand = reinterpret_cast<ExcT*>(walk_smem + 2 * ring_bytes);
  ExcT* hand_own = hand + (low ? 0 : D * nd);
  const ExcT* hand_partner = hand + (low ? D * nd : 0);
  const long long first = low ? top : top + (len - 1) * stride;
  const long long pix_step = low ? stride : -stride;

  // this lane's share of a pixel's copies: lanes 0-7 of a half copy the
  // cost, 8-15 the excess its partner stored there, bytes 16 * (part + 8 t)
  // of the buffer; a lane past the buffer's end copies its last 16 bytes
  // again (the same bytes to the same place as another lane)
  const bool exc_lane = hl >= 8;
  const int part = hl & 7;
  const int span = exc_lane ? pix_bytes - cost_bytes : cost_bytes;
  const int esize = exc_lane ? static_cast<int>(sizeof(ExcT)) : static_cast<int>(sizeof(CostT));
  const char* src = (exc_lane ? reinterpret_cast<const char*>(exc)
                              : reinterpret_cast<const char*>(cost)) + first * esize;
  const long long src_step = pix_step * esize;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(ring)) +
                       (exc_lane ? cost_bytes : 0);
  int piece[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) piece[t] = min(16 * (part + 8 * t), span - 16);
  int foff = 0;                         // the slot of the next pixel copied
  // the next pixel as one commit group; the excess lanes copy only with
  // `with_exc` (second visits b >= D, all after the fence), else their
  // group is empty
  auto fetch = [&](bool with_exc) {
    if (with_exc || !exc_lane) {
#pragma unroll
      for (int t = 0; t < NQ; ++t) cp16(dst + foff + piece[t], src + piece[t]);
    }
    cp_commit();
    src += src_step;
    foff = foff + pix_bytes == ring_bytes ? 0 : foff + pix_bytes;
  };

  const V vp1 = static_cast<V>(p1), vp2 = static_cast<V>(p2), big = static_cast<V>(kBig);
  const V v0 = static_cast<V>(kRestart);
  // the carry, and the cost of disparities past nd as +1e9, as walk_line's
  V L[K];
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = d0 + k < nd ? v0 : big;
  V lm = d0 < nd ? v0 : big;            // the lane's minimum of the carry
  ExcT* out_ptr = exc + first + d0;
  const int nG = (len - 1) / 2;         // first visits before the halves cross
  const int sB = len - nG;              // the first step of the second visits
  // the partner's excess for step t >= sB: from the handoff for the first D
  // second visits, else from ring slot `off`
  auto partner = [&](int t, int off) {
    const int b = t - sB;
    return b < D ? hand_partner + b * nd : reinterpret_cast<const ExcT*>(ring + off + cost_bytes);
  };
  // D + 1 groups ahead (empty past the line's end, so the counts hold)
  for (int s = 0; s <= D; ++s) {
    if (s < len) {
      fetch(false);
    } else {
      cp_commit();
    }
  }
  Run<CostT, K> c;
  Run<ExcT, K> ei;
  if constexpr (kAhead) {
    cp_wait<D>();                       // step 0's pixel (a first visit or a crossing)
    __syncwarp();
    c.load(reinterpret_cast<const CostT*>(ring) + d0, d0, nd);
  }
  int roff = 0;                         // this step's slot
  V keep[K];                            // even len: the partner's excess where they swap
#pragma unroll
  for (int k = 0; k < K; ++k) keep[k] = 0;

  // One step of both halves, as walk_line's step: the minimum and the
  // shuffles first, then the wait, the reads (a step early when K <= 8), the
  // next copy, the recurrence, and the phase's outputs.
  auto step = [&](int s, auto phase, auto full) {
    constexpr int P = decltype(phase)::value;
    const V m = half_min(lm, low);
    V up_edge = __shfl_down_sync(kFull, L[0], 1, 16);     // d = d0 + K, from lane + 1
    V dn_edge = __shfl_up_sync(kFull, L[K - 1], 1, 16);   // d = d0 - 1, from lane - 1
    // groups in flight: steps s + 1 .. s + D; this leaves s + 2 .. s + D
    cp_wait<D - 1>();
    __syncwarp();                       // every lane's copies and handoff stores visible
    const int noff = roff + pix_bytes == ring_bytes ? 0 : roff + pix_bytes;
    Run<CostT, K> cn;
    Run<ExcT, K> en;
    if constexpr (kAhead) {
      cn.load(reinterpret_cast<const CostT*>(ring + noff) + d0, d0, nd);
      if (P == Second::value || (P == Cross::value && s + 1 >= sB))
        en.load(partner(s + 1, noff) + d0, d0, nd);   // past the line's end: never used
    } else {
      c.load(reinterpret_cast<const CostT*>(ring + roff) + d0, d0, nd);
      if constexpr (P == Second::value) ei.load(partner(s, roff) + d0, d0, nd);
    }
    if (s + D + 1 < len) {
      // step s + D + 1 a second visit b >= D: its excess too (written so, not
      // as s + 1 >= sB, which compiled to a walk 5 % slower at 64 disparities)
      fetch(s + D + 1 - sB >= D);
    } else {
      cp_commit();                      // an empty group keeps the count
    }
    if (hl == 15) up_edge = big;
    if (hl == 0) dn_edge = big;

    V e[K], Ln[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const V up = k + 1 < K ? L[k + 1] : up_edge;
      const V dn = k > 0 ? L[k - 1] : dn_edge;
      const V ck = decltype(full)::value || d0 + k < nd ? c.template get<V>(k) : big;
      if constexpr (std::is_same_v<V, int>) {
        const V best = min(min(L[k], min(up, dn) + vp1), m + vp2);
        e[k] = best - m;
        Ln[k] = ck + best - m;
      } else {
        const V best = fminf(fminf(L[k], fminf(up + vp1, dn + vp1)), m + vp2);
        e[k] = best - m;
        Ln[k] = ck + e[k];
      }
    }
    Run<ExcT, K> out;
    if constexpr (P == First::value) {
#pragma unroll
      for (int k = 0; k < K; ++k) out.v[k] = static_cast<ExcT>(e[k]);
      // read by the partner's second visit b = slot: from the handoff for b
      // < D, else from device memory
      const int slot = nG - 1 - s;
      if (slot < D)
        out.store(hand_own + slot * nd + d0, d0, nd);
      else
        out.store(out_ptr, d0, nd);
    } else if constexpr (P == Second::value) {
#pragma unroll
      for (int k = 0; k < K; ++k) out.v[k] = static_cast<ExcT>(e[k] + ei.template get<V>(k));
      out.store(out_ptr, d0, nd);
    } else {
      V pe[K];                          // the partner's excess this step (same disparities)
#pragma unroll
      for (int k = 0; k < K; ++k) pe[k] = __shfl_xor_sync(kFull, e[k], 16);
      if (len & 1) {                    // both at the middle pixel: the top half writes it
#pragma unroll
        for (int k = 0; k < K; ++k) out.v[k] = static_cast<ExcT>(e[k] + pe[k]);
        if (low) out.store(out_ptr, d0, nd);
      } else if (s == nG) {             // the halves swap pixels: both first visits
#pragma unroll
        for (int k = 0; k < K; ++k) keep[k] = pe[k];
      } else {                          // the second visits of the swapped pixels
#pragma unroll
        for (int k = 0; k < K; ++k) out.v[k] = static_cast<ExcT>(e[k] + keep[k]);
        out.store(out_ptr, d0, nd);
      }
    }
    lm = Ln[0];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      L[k] = Ln[k];
      lm = vmin(lm, Ln[k]);
    }
    out_ptr += pix_step;
    if constexpr (kAhead) {
      c = cn;
      ei = en;
    }
    roff = noff;
  };
  auto walk = [&](auto full) {
    int s = 0;
#pragma unroll 2
    for (; s < nG; ++s) step(s, First{}, full);
    // every first-visit store performed at device scope before a copy
    // issued from here on reads it
    __threadfence();
    for (; s < sB; ++s) step(s, Cross{}, full);
#pragma unroll 2
    for (; s < len; ++s) step(s, Second{}, full);
  };
  if (nd == 16 * K)
    walk(std::true_type{});
  else
    walk(std::false_type{});
}

// f(std::integral_constant<int, K>{}) for K = nd / 16 rounded up to 1, 2, 4,
// 8, 16: a lane's disparities in the pair walk.
template <typename F>
cudaError_t with_half_width(int nd, F&& f) {
  const int per_lane = (nd + 15) / 16;
  if (per_lane <= 1) return f(std::integral_constant<int, 1>{});
  if (per_lane <= 2) return f(std::integral_constant<int, 2>{});
  if (per_lane <= 4) return f(std::integral_constant<int, 4>{});
  if (per_lane <= 8) return f(std::integral_constant<int, 8>{});
  if (per_lane <= 16) return f(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

template <typename CostT, typename ExcT>
cudaError_t launch_diagonal(const void* cost, void* exc, int H, int W, int nd, float p1,
                            float p2, int dx, cudaStream_t s) {
  if (H == 0 || W == 0 || nd == 0) return cudaSuccess;
  if (dx != 1 && dx != -1) return cudaErrorInvalidValue;
  const cudaError_t ok = walk_args_ok(nd, {cost, exc});
  if (ok != cudaSuccess) return ok;
  const CostT* c = static_cast<const CostT*>(cost);
  ExcT* e = static_cast<ExcT*>(exc);
  if (nd > kPairMaxNd) {                // 272-1024: the two-pass walk, 16 or 32 a lane
    if (nd > 1024) return cudaErrorInvalidValue;
    auto two_pass = [&](auto k) {
      constexpr int K = decltype(k)::value;
      return launch_ring<K, CostT, ExcT>(sgm_diagonal_kernel<K, CostT, ExcT>, true, W + H - 1,
                                         nd, s, c, e, H, W, nd, p1, p2, dx);
    };
    return nd <= 512 ? two_pass(std::integral_constant<int, 16>{})
                     : two_pass(std::integral_constant<int, 32>{});
  }
  return with_half_width(nd, [&](auto k) {
    constexpr int K = decltype(k)::value;
    auto kernel = sgm_diagonal_pair_kernel<K, CostT, ExcT>;
    // the most shared memory the SM offers, so that every line is resident
    // at once (per device, so on every launch)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kernel<<<W + H - 1, 32, static_cast<size_t>(pair_smem<K, CostT, ExcT>(nd)), s>>>(
        c, e, H, W, nd, p1, p2, dx);
    return cudaGetLastError();
  });
}

template <typename CostT, typename ExcT>
int depth_of(int nd) {
  int d = 0;
  with_half_width(nd, [&](auto k) {
    d = pair_depth<decltype(k)::value, CostT, ExcT>();
    return cudaSuccess;
  });
  return d;
}

}  // namespace

// cost: (H, W, nd); exc: (H, W, nd) output, the pair sum of the diagonal
// directions (dx, forward) and (-dx, reverse) of ops/sgm.py.  One launch:
// the pair walk for nd <= 256, else the two-pass walk.
extern "C" int sgm_aggregate_diagonal(const void* cost, void* exc, int H, int W, int nd,
                                      float p1, float p2, int dx, int mode, void* stream) {
  if (H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(launch_diagonal<uint16_t, uint8_t>(cost, exc, H, W, nd, p1, p2, dx, s));
    case 1: return static_cast<int>(launch_diagonal<uint16_t, int16_t>(cost, exc, H, W, nd, p1, p2, dx, s));
    case 2: return static_cast<int>(launch_diagonal<float, float>(cost, exc, H, W, nd, p1, p2, dx, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pixels each half of the pair walk stages ahead at nd disparities in
// storage `mode`: its ring's depth D, and the second visits its handoff
// serves; 0 where nd takes the two-pass walk; -1 for an nd or a mode that
// no walk takes.  No launch.
extern "C" int sgm_diagonal_depth(int nd, int mode) {
  if (nd <= 0 || nd % 16 != 0 || nd > 1024 || mode < 0 || mode > 2) return -1;
  if (nd > kPairMaxNd) return 0;
  switch (mode) {
    case 0: return depth_of<uint16_t, uint8_t>(nd);
    case 1: return depth_of<uint16_t, int16_t>(nd);
    default: return depth_of<float, float>(nd);
  }
}
