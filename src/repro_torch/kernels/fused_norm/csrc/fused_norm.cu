// Fused RMSNorm / LayerNorm (+ residual add, + bias) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_norm (_norm_kernel) of
// src/repro/kernels/fused_norm/fused_norm.py: per row of an (rows, d)
// view, h = x (+ residual) in fp32; RMS: y = h * rsqrt(mean(h^2) + eps);
// Layer: y = (h - mean) * rsqrt(mean((h - mean)^2) + eps); then y * w
// (+ b), written in x's dtype.
//
// Launch grid: one block of kThreads threads per row.  The row lives in
// registers (at most kMaxD / kThreads = 32 fp32 values a thread, read once
// from device memory, coalesced across the warp); the mean (and the
// centred second moment for LayerNorm) is a block reduction in fp32:
// warp shuffles, then one value per warp through shared memory.
//
// Bound: memory.  One call must read x (and residual) and write y, about
// 4 bytes per bf16 element, and does ~5 flops per element: far below the
// H100's ~295 flops/byte balance point.  What the design does about it:
// every element is read once and written once (the unfused PyTorch norm
// makes about six passes over the row through device memory, one kernel
// each), and the (d,) weight and bias are read through the L2 cache by
// every block.  What it does not do yet: 16-byte vector loads, several
// rows a block for narrow d, or a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;
constexpr int kPer = kMaxD / kThreads;   // row elements a thread holds

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                 // red may still be read by a prior call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// Thread t holds the row's elements e = t + j * kThreads, j < kPer.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) fused_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const W* __restrict__ w, const W* __restrict__ bias, T* __restrict__ out,
    int d, float eps, int layer) {
  __shared__ float red[kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* rr = res == nullptr ? nullptr : res + row * d;
  float h[kPer];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    float v = 0.f;
    if (e < d) {
      v = to_f(xr[e]);
      if (rr != nullptr) v += to_f(rr[e]);
    }
    h[j] = v;
    sum += layer ? v : v * v;
  }
  const float inv_d = 1.f / (float)d;
  float mu = 0.f, var;
  if (layer) {
    mu = block_sum(sum, red) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < d) sq += (h[j] - mu) * (h[j] - mu);
    }
    var = block_sum(sq, red) * inv_d;
  } else {
    var = block_sum(sum, red) * inv_d;
  }
  const float r = rsqrtf(var + eps);
  T* orow = out + row * d;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < d) {
      float y = (h[j] - mu) * r * to_f(w[e]);
      if (bias != nullptr) y += to_f(bias[e]);
      orow[e] = from_f<T>(y);
    }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* res, const void* w,
                   const void* b, void* out, int64_t rows, int d, float eps,
                   int layer, cudaStream_t stream) {
  fused_norm_kernel<T, W><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const W*>(w), static_cast<const W*>(b),
      static_cast<T*>(out), d, eps, layer);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16 (residual has x's dtype,
// bias has w's).  residual / bias may be null.  layer: 0 = RMS, 1 = Layer.
// Rows are contiguous, d elements apart.  Returns cudaGetLastError().
int fused_norm(int x_dtype, int w_dtype, const void* x, const void* residual,
               const void* w, const void* b, void* out, int64_t rows, int d,
               float eps, int layer, void* stream) {
  if (d < 1 || d > kMaxD || rows < 1 || rows > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = x_dtype * 2 + w_dtype;
  switch (code) {
    case 0:
      return (int)launch<float, float>(x, residual, w, b, out, rows, d, eps,
                                       layer, s);
    case 1:
      return (int)launch<float, __nv_bfloat16>(x, residual, w, b, out, rows,
                                               d, eps, layer, s);
    case 2:
      return (int)launch<__nv_bfloat16, float>(x, residual, w, b, out, rows,
                                               d, eps, layer, s);
    case 3:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(
          x, residual, w, b, out, rows, d, eps, layer, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
