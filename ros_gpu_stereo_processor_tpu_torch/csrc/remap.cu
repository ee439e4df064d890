// Bilinear rectification remap for Hopper (sm_90a).
//
// Replaces: ros_gpu_stereo_processor_tpu/ops/remap_pallas.py::_kernel, the
// TPU kernel that DMAs a host-planned source window per 8x128 output tile and
// gathers inside it.  Plain version: ops/remap.py::remap_bilinear.
//
// What bounds it on the H100: memory.  Each output pixel reads its two map
// floats (8 bytes, the bulk of the traffic) and four source taps that
// neighbouring pixels share through the caches, and writes one element per
// channel, with a few arithmetic operations in between.  A 752x480 uint8
// pair moves about 7 MB, about 2 us at the card's 3.35 TB/s, so at the
// pipeline's shapes launch and latency weigh as much as the bytes.
//
// Design: one thread per output element (side, row, column, channel), every
// side and channel of the stack in one launch.  A GPU gathers freely, so the
// TPU kernel's host window plan (build_plan, TILE/WIN, the fallback when a
// map leaves its window) has no counterpart: neighbouring threads read
// neighbouring map entries and nearby source pixels, which the caches serve.
// The arithmetic is the plain version's, operation for operation: floorf,
// the four weights, the sum in the same order, each step rounded on its own
// (__fmul_rn/__fadd_rn, and the library builds with --fmad=false), then
// rintf (half to even, as torch.round) and a clip for integer output.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void remap_bilinear_kernel(const T* __restrict__ src,
                                      const float* __restrict__ maps,
                                      T* __restrict__ out, int n_sides,
                                      int src_h, int src_w, int h, int w,
                                      int chans) {
  const long long n = static_cast<long long>(n_sides) * h * w * chans;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % chans);
  const long long p = i / chans;                  // (side * h + y) * w + x
  const int side = static_cast<int>(p / (static_cast<long long>(h) * w));
  const float x = maps[2 * p];
  const float y = maps[2 * p + 1];

  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = __fsub_rn(x, x0);
  const float fy = __fsub_rn(y, y0);
  const int x0i = static_cast<int>(x0);
  const int y0i = static_cast<int>(y0);

  const T* img = src + static_cast<long long>(side) * src_h * src_w * chans;
  auto tap = [&](int yi, int xi) -> float {
    const bool ok = xi >= 0 && xi < src_w && yi >= 0 && yi < src_h;
    return ok ? static_cast<float>(img[(static_cast<long long>(yi) * src_w + xi) * chans + c])
              : 0.0f;
  };
  const float v00 = tap(y0i, x0i);
  const float v01 = tap(y0i, x0i + 1);
  const float v10 = tap(y0i + 1, x0i);
  const float v11 = tap(y0i + 1, x0i + 1);

  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const float w00 = __fmul_rn(gx, gy);
  const float w01 = __fmul_rn(fx, gy);
  const float w10 = __fmul_rn(gx, fy);
  const float w11 = __fmul_rn(fx, fy);
  float acc = __fadd_rn(__fmul_rn(v00, w00), __fmul_rn(v01, w01));
  acc = __fadd_rn(acc, __fmul_rn(v10, w10));
  acc = __fadd_rn(acc, __fmul_rn(v11, w11));
  out[i] = from_float<T>(acc);
}

template <typename T>
int launch(const void* src, const void* maps, void* out, int n_sides, int src_h,
           int src_w, int h, int w, int chans, void* stream) {
  const long long n = static_cast<long long>(n_sides) * h * w * chans;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  remap_bilinear_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const float*>(maps),
      static_cast<T*>(out), n_sides, src_h, src_w, h, w, chans);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (n_sides, src_h, src_w, chans) contiguous; maps: (n_sides, h, w, 2)
// float32 (x_src, y_src); out: (n_sides, h, w, chans).
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
