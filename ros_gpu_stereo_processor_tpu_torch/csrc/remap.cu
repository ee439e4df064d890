// Bilinear rectification remap for Hopper (sm_90a).
//
// Replaces: ros_gpu_stereo_processor_tpu/ops/remap_pallas.py::_kernel, the
// TPU kernel that DMAs a host-planned source window per 8x128 output tile and
// gathers inside it.  Plain version: ops/remap.py::remap_bilinear.
//
// What bounds it on the H100: memory, and at the pipeline's shapes launch
// latency.  Each output pixel reads its two map floats (8 bytes, the bulk of
// the traffic) and four source taps that neighbouring pixels share through
// the caches, and writes one element per channel, with a few arithmetic
// operations in between.  A 752x480 uint8 pair moves about 7 MB, about 2 us
// at the card's 3.35 TB/s, so a launch (a few us) weighs as much as the
// bytes, and the instructions per output decide the rest: 64-bit integer
// division is emulated in software, and narrow loads and stores cost an
// instruction each.
//
// Design: a 3-D grid -- z the side, y the output row, x groups of four
// consecutive output columns -- with 32-bit indices and no division.  A
// thread reads its four (x, y) map pairs as two 16-byte loads, computes the
// four pixels' weights once, loops over the channels inside the thread, and
// writes its 4 * C outputs with 4- or 16-byte stores (one uchar4 for mono
// uint8, one float4 for mono float32, three of either for C = 3).  Rows whose
// width is not a multiple of 4, or tensors not 16-byte aligned, take the
// scalar variant of the same kernel (chosen at launch by a template flag),
// as does any channel count other than 1 or 3.  A GPU gathers freely, so the
// TPU kernel's host window plan (build_plan, TILE/WIN, the fallback when a
// map leaves its window) has no counterpart.  The arithmetic is the plain
// version's, operation for operation: floorf, the four weights, the sum in
// the same order, each step rounded on its own (__fmul_rn/__fadd_rn, and the
// library builds with --fmad=false), then rintf (half to even, as
// torch.round) and a clip for integer output.  The wrapper keeps every
// index under 2^31.  REMAP_BLOCK_X/Y set the block shape (threads along a
// row, rows per block).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef REMAP_BLOCK_X
#define REMAP_BLOCK_X 64
#endif
#ifndef REMAP_BLOCK_Y
#define REMAP_BLOCK_Y 4
#endif

namespace {

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ uint8_t from_float<uint8_t>(float v) {
  v = rintf(v);
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  return static_cast<uint8_t>(v);
}

// Four consecutive outputs, one aligned store.
__device__ __forceinline__ void store4(uint8_t* p, const uint8_t* r) {
  *reinterpret_cast<uchar4*>(p) = make_uchar4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void store4(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

// kC: channels (1 or 3), or 0 for any count given at run time (scalar only).
// kVec: the width is a multiple of 4 and maps and out are 16-byte aligned.
template <typename T, int kC, bool kVec>
__global__ void __launch_bounds__(REMAP_BLOCK_X * REMAP_BLOCK_Y)
remap_bilinear_kernel(const T* __restrict__ src, const float* __restrict__ maps,
                      T* __restrict__ out, int src_h, int src_w, int h, int w, int chans) {
  static_assert(!kVec || kC > 0, "the vector stores need a fixed channel count");
  const int C = kC > 0 ? kC : chans;
  const int x4 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x4 >= w || y >= h) return;
  const int side = blockIdx.z;
  const int p = (side * h + y) * w + x4;          // the thread's first output pixel
  const T* img = src + side * src_h * src_w * C;

  float mx[4], my[4];
  if constexpr (kVec) {
    const float4* m = reinterpret_cast<const float4*>(maps + 2 * p);
    const float4 a = __ldg(m), b = __ldg(m + 1);
    mx[0] = a.x; my[0] = a.y; mx[1] = a.z; my[1] = a.w;
    mx[2] = b.x; my[2] = b.y; mx[3] = b.z; my[3] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = x4 + j < w;
      mx[j] = in ? __ldg(maps + 2 * (p + j)) : 0.0f;
      my[j] = in ? __ldg(maps + 2 * (p + j) + 1) : 0.0f;
    }
  }

  T res[kVec ? 4 * kC : 1];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!kVec && x4 + j >= w) break;
    const float x0 = floorf(mx[j]);
    const float y0 = floorf(my[j]);
    const float fx = __fsub_rn(mx[j], x0);
    const float fy = __fsub_rn(my[j], y0);
    const int x0i = static_cast<int>(x0);
    const int y0i = static_cast<int>(y0);
    const bool okx0 = x0i >= 0 && x0i < src_w, okx1 = x0i + 1 >= 0 && x0i + 1 < src_w;
    const bool oky0 = y0i >= 0 && y0i < src_h, oky1 = y0i + 1 >= 0 && y0i + 1 < src_h;
    const float gx = __fsub_rn(1.0f, fx);
    const float gy = __fsub_rn(1.0f, fy);
    const float w00 = __fmul_rn(gx, gy);
    const float w01 = __fmul_rn(fx, gy);
    const float w10 = __fmul_rn(gx, fy);
    const float w11 = __fmul_rn(fx, fy);
    // the taps' element offsets, modulo 2^32 (no signed overflow): exact
    // wherever the tap is in range, and only those are read
    const unsigned t00 = (static_cast<unsigned>(y0i) * src_w + static_cast<unsigned>(x0i)) * C;
    const unsigned t10 = t00 + static_cast<unsigned>(src_w) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float v00 = (oky0 && okx0) ? static_cast<float>(img[t00 + c]) : 0.0f;
      const float v01 = (oky0 && okx1) ? static_cast<float>(img[t00 + C + c]) : 0.0f;
      const float v10 = (oky1 && okx0) ? static_cast<float>(img[t10 + c]) : 0.0f;
      const float v11 = (oky1 && okx1) ? static_cast<float>(img[t10 + C + c]) : 0.0f;
      float acc = __fadd_rn(__fmul_rn(v00, w00), __fmul_rn(v01, w01));
      acc = __fadd_rn(acc, __fmul_rn(v10, w10));
      acc = __fadd_rn(acc, __fmul_rn(v11, w11));
      if constexpr (kVec)
        res[j * kC + c] = from_float<T>(acc);
      else
        out[(p + j) * C + c] = from_float<T>(acc);
    }
  }
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < kC; ++q) store4(out + p * kC + 4 * q, res + 4 * q);
  }
}

template <typename T, int kC, bool kVec>
void launch_with(const T* src, const float* maps, T* out, int n_sides, int src_h, int src_w,
                 int h, int w, int chans, cudaStream_t s) {
  const dim3 block(REMAP_BLOCK_X, REMAP_BLOCK_Y);
  const int groups = (w + 3) / 4;
  const dim3 grid((groups + REMAP_BLOCK_X - 1) / REMAP_BLOCK_X,
                  (h + REMAP_BLOCK_Y - 1) / REMAP_BLOCK_Y, n_sides);
  remap_bilinear_kernel<T, kC, kVec><<<grid, block, 0, s>>>(src, maps, out, src_h, src_w, h,
                                                            w, chans);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* src_v, const void* maps_v, void* out_v, int n_sides, int src_h,
           int src_w, int h, int w, int chans, void* stream) {
  if (n_sides == 0 || h == 0 || w == 0 || chans == 0) return 0;
  const T* src = static_cast<const T*>(src_v);
  const float* maps = static_cast<const float*>(maps_v);
  T* out = static_cast<T*>(out_v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && aligned16(maps) && aligned16(out);
  if (chans == 1 && vec)
    launch_with<T, 1, true>(src, maps, out, n_sides, src_h, src_w, h, w, chans, s);
  else if (chans == 1)
    launch_with<T, 1, false>(src, maps, out, n_sides, src_h, src_w, h, w, chans, s);
  else if (chans == 3 && vec)
    launch_with<T, 3, true>(src, maps, out, n_sides, src_h, src_w, h, w, chans, s);
  else if (chans == 3)
    launch_with<T, 3, false>(src, maps, out, n_sides, src_h, src_w, h, w, chans, s);
  else
    launch_with<T, 0, false>(src, maps, out, n_sides, src_h, src_w, h, w, chans, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (n_sides, src_h, src_w, chans) contiguous; maps: (n_sides, h, w, 2)
// float32 (x_src, y_src); out: (n_sides, h, w, chans); every element count
// under 2^31.
extern "C" int remap_bilinear_u8(const void* src, const void* maps, void* out,
                                 int n_sides, int src_h, int src_w, int h, int w,
                                 int chans, void* stream) {
  return launch<uint8_t>(src, maps, out, n_sides, src_h, src_w, h, w, chans, stream);
}

extern "C" int remap_bilinear_f32(const void* src, const void* maps, void* out,
                                  int n_sides, int src_h, int src_w, int h, int w,
                                  int chans, void* stream) {
  return launch<float>(src, maps, out, n_sides, src_h, src_w, h, w, chans, stream);
}
