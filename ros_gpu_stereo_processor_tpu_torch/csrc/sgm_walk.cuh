// The SGM path walk and the helpers the SGM units share: sgm.cu (K5 and K4's
// down walk), sgm_diagonal.cu (DG) and sgm_wta.cu (K6).  walk_line is one
// warp's walk of one path line, its pixels staged through a ring of shared
// memory by cp.async; sgm.cu's header says what bounds it and why it is
// built so.  Everything here has internal linkage: each unit compiles its
// own copy, so the units build in parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkRingBytes = 16384;   // bytes a line's walk keeps in flight (at most)
constexpr int kSmemMax = 232448;        // dynamic shared memory an H100 block may opt into

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

// One warp walks one path line of `len` pixels, the first at element offset
// `first` (its disparity 0), each next one `pix_step` elements on; lane l
// holds disparities l * K .. l * K + K - 1 of the carry, which starts at
// `init` (0 on an axis, as the plain version's carry; _RESTART on a
// diagonal, as JAX's).  The line's pixels (nd cost values, then nd exc_in
// values when given; 16-byte aligned) are copied into a ring of
// shared-memory slots (`ring`) by 16-byte cp.async, one commit group per
// pixel, D pixels ahead of the step that reads them: with exc_in, lanes 0-15
// copy the cost and lanes 16-31 the excess, so each lane keeps one source
// pointer and moves it by a fixed stride per step.  A step issues the warp
// minimum and the neighbour shuffles of the carry first, then waits for the
// group of the pixel after its own (landed long before), reads that pixel's
// values into registers a step early (K <= 8) and issues the next copy, so
// the latencies of the reduction and the shuffles hide behind that work;
// then the recurrence, in int32 on integer storage.  Each lane writes its K
// outputs as whole words.  exc_in may be exc_out (the diagonal's second
// pass): a pixel's excess is copied in before the step that overwrites it.
template <int K, typename CostT, typename ExcT>
__device__ __forceinline__ void walk_line(const CostT* __restrict__ cost, const ExcT* exc_in,
                                          ExcT* exc_out, int len, long long first,
                                          long long pix_step, int nd, float p1, float p2,
                                          float init, unsigned char* ring) {
  using V = WalkT<CostT>;
  constexpr int D = walk_depth<K, CostT, ExcT>();
  constexpr int R = walk_slots<K, CostT, ExcT>();
  constexpr bool kAhead = K <= 8;
  // 16-byte copies per lane per pixel, at most: nd <= 32 K cost values over
  // 16 lanes (exc_in's are no wider)
  constexpr int NQ = K * static_cast<int>(sizeof(CostT)) / 8 > 1
                         ? K * static_cast<int>(sizeof(CostT)) / 8 : 1;
  const int lane = threadIdx.x;
  const bool has_in = exc_in != nullptr;
  const int cost_bytes = nd * static_cast<int>(sizeof(CostT));
  const int pix_bytes = cost_bytes + (has_in ? nd * static_cast<int>(sizeof(ExcT)) : 0);
  const int ring_bytes = R * pix_bytes;
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
  const V v0 = static_cast<V>(init);
  // the carry, and the cost of disparities past nd as +1e9: such an L stays
  // at 1e9 + [0, P2], above every real one, so it never wins a minimum
  V L[K];
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = d0 + k < nd ? v0 : big;
  V lm = d0 < nd ? v0 : big;            // the lane's minimum of the carry
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

// f(std::integral_constant<int, K>{}) for K = nd / 32 rounded up to 1, 2,
// 4 ... 32: a lane's disparities in the walks and the WTA.
template <typename F>
cudaError_t with_lane_width(int nd, F&& f) {
  const int per_lane = (nd + 31) / 32;
  if (per_lane <= 1) return f(std::integral_constant<int, 1>{});
  if (per_lane <= 2) return f(std::integral_constant<int, 2>{});
  if (per_lane <= 4) return f(std::integral_constant<int, 4>{});
  if (per_lane <= 8) return f(std::integral_constant<int, 8>{});
  if (per_lane <= 16) return f(std::integral_constant<int, 16>{});
  if (per_lane <= 32) return f(std::integral_constant<int, 32>{});
  return cudaErrorInvalidValue;
}

// nd must be a multiple of 16 (every pixel's span 16-byte aligned in every
// storage mode) and at most 1024; the volumes 16-byte aligned.
inline cudaError_t walk_args_ok(int nd, std::initializer_list<const void*> ptrs) {
  if (nd % 16 != 0) return cudaErrorInvalidValue;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

// A walk kernel's launch: its ring's shared memory per line is walk_slots
// pixels of nd cost values, and nd excess values when `with_exc`.
template <int K, typename CostT, typename ExcT, typename Kernel, typename... Args>
cudaError_t launch_ring(Kernel kernel, bool with_exc, int lines, int nd, cudaStream_t s,
                        Args... args) {
  const long long pix = static_cast<long long>(nd) *
                        (sizeof(CostT) + (with_exc ? sizeof(ExcT) : 0));
  const long long smem = walk_slots<K, CostT, ExcT>() * pix;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  // per device, so on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<lines, 32, static_cast<size_t>(smem), s>>>(args...);
  return cudaGetLastError();
}

}  // namespace
