// SGM winner-take-all over 2, 4 or 8 paths for Hopper (sm_90a).
//
// Replaces the TPU kernel _wta of ros_gpu_stereo_processor_tpu/ops/
// sgm_pallas.py (K6):
//   sgm_wta        <- _wta (K6): winner-take-all with the parabolic subpixel
//                     step and the uniqueness sweep over the total of 2, 4 or
//                     8 paths (2 c + exc_h; (4 c + exc_v) + exc_h; and the
//                     two diagonal pair sums added for 8).
// Plain version: ops/sgm_kernel.py::wta_plain.  Volumes, storage modes and
// exactness as in sgm.cu: the total is the plain version's float32 sum in
// its order, (4c + ev) + eh, ((8c + ev) + eh + ed1) + ed2, or 2c + eh.
//
// What bounds it on the H100 (752x480, 128 disparities, modes 0/1): bytes
// (reads 2 to 5 volumes once, writes three maps).  One warp per pixel reads
// its nd totals coalesced (lane l holds nd / 32 of them); the best is the
// warp minimum and its disparity the smallest index that holds it, which is
// what a running strict-< scan keeps (ties to the smallest d; min_disparity -
// 2 where every candidate is masked, as on the TPU).  The costs at best +- 1
// and, with uniqueness, the smallest total outside best +- 1 are further warp
// minima.  (A first design with one thread per pixel looping over d read each
// pixel's nd values from a different cache line per lane and ran slower than
// the plain version; lane l holding disparities l, l + 32, ..., each load of
// the warp 32 consecutive values, ran 1.2-1.6x slower than runs of K
// consecutive values at 2880x1988, 256 and 304 disparities.)
//
// A lane's run K is nd / 32 rounded up to 1, 2, 4, 8, 12, 16 or 32: the
// walks' widths (sgm_walk.cuh) and 12 between 8 and 16.  On an H100 80GB HBM3
// at 700 W, 2880x1988 and 304 disparities, K = 16 (13 of 32 lanes idle) took
// 6.5 ms a call, 0.0037 ns a cell, against 0.0023-0.0025 at 256 (K = 8); K =
// 12 takes 4.45 ms, 0.0026 ns a cell; K = 10 took 9.4-9.6 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgm_walk.cuh"

namespace {

constexpr int kWtaThreads = 128;
constexpr long long kWtaMaxBlocks = 132 * 32;   // grid-stride beyond this

template <typename T>
__device__ __forceinline__ float ld(const T* p) { return static_cast<float>(*p); }

// The total over P paths: 2 * cost + exc_h; (4 * cost + exc_v) + exc_h; or
// that with the two diagonal pair sums added, ((8 * cost + exc_v) + exc_h +
// exc_d1) + exc_d2 -- the plain version's order.
template <int P, typename CostT, typename ExcT>
__device__ __forceinline__ float total_at(const CostT* cost, const ExcT* ev, const ExcT* eh,
                                          const ExcT* ed1, const ExcT* ed2, long long o, int dd,
                                          int x, int mind, int r, int W) {
  const int d = mind + dd;
  const bool ok = (x - d >= r) && (x - d <= W - 1 - r);
  float t;
  if constexpr (P == 2) {
    t = 2.0f * ld(cost + o + dd) + ld(eh + o + dd);
  } else {
    t = (static_cast<float>(P) * ld(cost + o + dd) + ld(ev + o + dd)) + ld(eh + o + dd);
    if constexpr (P == 8) t = (t + ld(ed1 + o + dd)) + ld(ed2 + o + dd);
  }
  return ok ? t : kBig;
}

// One warp per pixel (grid-stride over the pixels), lane l holding the
// totals of disparities l * K .. l * K + K - 1: the first minimum is the
// smallest index whose total equals the warp minimum, as a running
// strict-< scan from 1e9 finds it.
template <int K, int P, typename CostT, typename ExcT>
__global__ void sgm_wta_kernel(const CostT* __restrict__ cost, const ExcT* __restrict__ ev,
                               const ExcT* __restrict__ eh, const ExcT* __restrict__ ed1,
                               const ExcT* __restrict__ ed2, float* __restrict__ disp_raw,
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
      t[k] = d0 + k < nd ? total_at<P>(cost, ev, eh, ed1, ed2, o, d0 + k, x, mind, r, W) : kBig;
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

// f(std::integral_constant<int, K>{}) for K = nd / 32 rounded up to 1, 2, 4,
// 8, 12, 16, 32: a lane's run of disparities in the WTA.
template <typename F>
cudaError_t with_wta_width(int nd, F&& f) {
  if (nd > 256 && nd <= 384) return f(std::integral_constant<int, 12>{});
  return with_lane_width(nd, static_cast<F&&>(f));
}

// exc_v is unused with 2 paths, exc_d1 and exc_d2 with fewer than 8.
template <typename CostT, typename ExcT>
cudaError_t wta(const void* cost, const void* ev, const void* eh, const void* ed1,
                const void* ed2, void* disp, void* best, void* excl, int H, int W, int nd,
                int mind, int r, int refine, int uniq, int paths, cudaStream_t s) {
  const long long n = static_cast<long long>(H) * W;
  const int warps = kWtaThreads / 32;
  const long long blocks_needed = (n + warps - 1) / warps;
  const unsigned grid = static_cast<unsigned>(blocks_needed < kWtaMaxBlocks ? blocks_needed : kWtaMaxBlocks);
  const CostT* c = static_cast<const CostT*>(cost);
  const ExcT* v = static_cast<const ExcT*>(ev);
  const ExcT* h = static_cast<const ExcT*>(eh);
  const ExcT* d1 = static_cast<const ExcT*>(ed1);
  const ExcT* d2 = static_cast<const ExcT*>(ed2);
  float* d = static_cast<float*>(disp);
  float* b = static_cast<float*>(best);
  float* x = static_cast<float*>(excl);
  return with_wta_width(nd, [&](auto k) {
    constexpr int K = decltype(k)::value;
    auto launch = [&](auto kernel) {
      kernel<<<grid, kWtaThreads, 0, s>>>(c, v, h, d1, d2, d, b, x, H, W, nd, mind, r, refine, uniq);
      return cudaGetLastError();
    };
    switch (paths) {
      case 2: return launch(sgm_wta_kernel<K, 2, CostT, ExcT>);
      case 4: return launch(sgm_wta_kernel<K, 4, CostT, ExcT>);
      case 8: return launch(sgm_wta_kernel<K, 8, CostT, ExcT>);
      default: return cudaErrorInvalidValue;
    }
  });
}

}  // namespace

// cost, exc_v, exc_h, exc_d1, exc_d2: (H, W, nd), the total over `paths` (2,
// 4 or 8; exc_v is null with 2 paths, exc_d1 and exc_d2 with fewer than 8);
// disp_raw, best_cost, excl: (H, W) float32.
extern "C" int sgm_wta(const void* cost, const void* exc_v, const void* exc_h,
                       const void* exc_d1, const void* exc_d2, void* disp_raw, void* best_cost,
                       void* excl, int H, int W, int nd, int mind, int r, int refine, int uniq,
                       int paths, int mode, void* stream) {
  if (H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(wta<uint16_t, uint8_t>(cost, exc_v, exc_h, exc_d1, exc_d2, disp_raw, best_cost, excl, H, W, nd, mind, r, refine, uniq, paths, s));
    case 1: return static_cast<int>(wta<uint16_t, int16_t>(cost, exc_v, exc_h, exc_d1, exc_d2, disp_raw, best_cost, excl, H, W, nd, mind, r, refine, uniq, paths, s));
    case 2: return static_cast<int>(wta<float, float>(cost, exc_v, exc_h, exc_d1, exc_d2, disp_raw, best_cost, excl, H, W, nd, mind, r, refine, uniq, paths, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
