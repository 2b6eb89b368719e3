// Fused RMSNorm / LayerNorm (+ residual add, + bias) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_norm (_norm_kernel) of
// src/repro/kernels/fused_norm/fused_norm.py: per row of an (rows, d)
// view, h = x (+ residual) in fp32; RMS: y = h * rsqrt(mean(h^2) + eps);
// Layer: y = (h - mean) * rsqrt(mean((h - mean)^2) + eps); then y * w
// (+ b), written in x's dtype.  Both passes over the row (the mean, then
// the centred second moment for LayerNorm) run on the row held in
// registers, in fp32.
//
// Bound: memory.  One call must read x (and residual) and write y, about
// 4 bytes per bf16 element, and does ~5 flops per element: far below the
// H100's ~295 flops/byte balance point.  Every element is read once and
// written once (the unfused PyTorch norm makes about six passes over the
// row through device memory, one kernel each).
//
// Two bodies; the wrapper (fused_norm.py plan_launch) picks one and passes
// it.
//
// vector (fused_norm_vec_kernel, d a multiple of 8 and every base 16-byte
// aligned): 16-byte loads and stores, one vector of 8 bf16 or 4 fp32 a
// thread a step.  A row takes tpr threads (32, 64, 128 or 256: a warp or
// a few), each holding NV vectors of it in registers, NV = ceil(d / E /
// tpr) <= 5 a template parameter (bf16 d 2048: 64 x 4; 2560: 64 x 5; 4096:
// 128 x 4; 5120: 128 x 5).  A block of 256 threads takes 256 / tpr rows at
// once and strides over the rows with its weight (and bias) loaded into
// registers once; the next rows' vectors are fetched while the current
// ones reduce and store, so the block keeps loads in flight.  A warp's
// row sums with shuffles alone; a row of several warps adds one value a
// warp through shared memory (one block barrier a reduction, two
// alternating buffers).
//
// scalar (fused_norm_kernel, the other rows): one block of kThreads
// threads per row, 2-byte or 4-byte loads, kPer registers a thread sized
// for d 8192, block reductions with two barriers.

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

// ---------------------------------------------------------------------------
// vector body
// ---------------------------------------------------------------------------

constexpr int kVecThreads = 256;
constexpr int kVecWarps = kVecThreads / 32;

// A vector is 16 bytes of x: kE<T> elements.
template <typename T> constexpr int kE = 16 / sizeof(T);

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// A raw 16-byte vector of x (or residual) as fp32.
__device__ __forceinline__ void unpack(const uint4& u, __nv_bfloat16*, float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float*, float* v) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// E elements of the weight (or bias) at p as fp32.
template <int E>
__device__ __forceinline__ void load_w(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}
template <int E>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float* v) {
  if (E == 8) {
    unpack(ld16(p), (__nv_bfloat16*)nullptr, v);
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Sum over the tpr threads of a row (tpr a multiple of 32); every thread
// of the row gets the total.  Block-uniform: every thread calls it.
__device__ __forceinline__ float row_sum(float x, int tpr,
                                         float (*red)[kVecWarps], int& nred) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (tpr == 32) return x;
  float* buf = red[nred++ & 1];
  const int warp = threadIdx.x / 32, wpr = tpr / 32;
  if (threadIdx.x % 32 == 0) buf[warp] = x;
  __syncthreads();
  const int w0 = warp - warp % wpr;
  float t = 0.f;
  for (int w = 0; w < wpr; ++w) t += buf[w0 + w];
  return t;
}

// Thread lr of a row's tpr holds the row's vectors u = lr + j * tpr,
// j < NV (elements E u .. E u + E - 1).  The block takes 256 / tpr rows
// at once and strides over the rows; the next rows' vectors are fetched
// (raw, 16 bytes each) while the current rows reduce and store, so a
// block keeps its loads in flight.  BIAS: bias is given (its registers
// exist only then).
template <typename T, typename W, int NV, bool BIAS>
__global__ void __launch_bounds__(kVecThreads) fused_norm_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const W* __restrict__ w, const W* __restrict__ bias, T* __restrict__ out,
    int64_t rows, int d, float eps, int layer, int tpr) {
  constexpr int E = kE<T>;
  __shared__ float red[2][kVecWarps];
  const int lr = threadIdx.x % tpr;
  const int rpc = kVecThreads / tpr;        // rows the block takes at once
  const int units = d / E;
  const int64_t stride = (int64_t)gridDim.x * rpc;
  float wv[NV][E], bv[BIAS ? NV : 1][E];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int u = lr + j * tpr;
#pragma unroll
    for (int e = 0; e < E; ++e) wv[j][e] = bv[BIAS ? j : 0][e] = 0.f;
    if (u < units) {
      load_w<E>(w + E * u, wv[j]);
      if (BIAS) load_w<E>(bias + E * u, bv[BIAS ? j : 0]);
    }
  }
  uint4 px[NV], pr[NV];                     // the next rows, raw
  auto fetch = [&](int64_t row) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int u = lr + j * tpr;
      px[j] = pr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows && u < units) {
        px[j] = ld16(x + row * d + E * u);
        if (res != nullptr) pr[j] = ld16(res + row * d + E * u);
      }
    }
  };
  const float inv_d = 1.f / (float)d;
  int nred = 0;
  int64_t row = (int64_t)blockIdx.x * rpc + threadIdx.x / tpr;
  fetch(row);
  for (int64_t r0 = (int64_t)blockIdx.x * rpc; r0 < rows; r0 += stride) {
    float h[NV][E];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack(px[j], (T*)nullptr, h[j]);
      if (res != nullptr) {
        float r[E];
        unpack(pr[j], (T*)nullptr, r);
#pragma unroll
        for (int e = 0; e < E; ++e) h[j][e] += r[e];
      }
    }
    const int64_t cur = row;
    row += stride;
    fetch(row);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) sum += layer ? h[j][e] : h[j][e] * h[j][e];
    float mu = 0.f, var;
    if (layer) {
      mu = row_sum(sum, tpr, red, nred) * inv_d;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (lr + j * tpr < units) {
#pragma unroll
          for (int e = 0; e < E; ++e) sq += (h[j][e] - mu) * (h[j][e] - mu);
        }
      }
      var = row_sum(sq, tpr, red, nred) * inv_d;
    } else {
      var = row_sum(sum, tpr, red, nred) * inv_d;
    }
    const float r = rsqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int u = lr + j * tpr;
      if (cur < rows && u < units) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          o[e] = (h[j][e] - mu) * r * wv[j][e];
          if (BIAS) o[e] += bv[BIAS ? j : 0][e];
        }
        store16(out + cur * d + E * u, o);
      }
    }
  }
}

template <typename T, typename W, int NV>
cudaError_t launch_vec_nv(const void* x, const void* res, const void* w,
                          const void* b, void* out, int64_t rows, int d,
                          float eps, int layer, int tpr, int ctas,
                          cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const W* wt = static_cast<const W*>(w);
  const W* bt = static_cast<const W*>(b);
  T* ot = static_cast<T*>(out);
  if (b != nullptr) {
    fused_norm_vec_kernel<T, W, NV, true><<<(unsigned)ctas, kVecThreads, 0,
                                            stream>>>(xt, rt, wt, bt, ot, rows,
                                                      d, eps, layer, tpr);
  } else {
    fused_norm_vec_kernel<T, W, NV, false><<<(unsigned)ctas, kVecThreads, 0,
                                             stream>>>(xt, rt, wt, bt, ot,
                                                       rows, d, eps, layer,
                                                       tpr);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_vec(const void* x, const void* res, const void* w,
                       const void* b, void* out, int64_t rows, int d,
                       float eps, int layer, int tpr, int ctas,
                       cudaStream_t stream) {
  switch ((d / kE<T> + tpr - 1) / tpr) {
    case 1:
      return launch_vec_nv<T, W, 1>(x, res, w, b, out, rows, d, eps, layer,
                                    tpr, ctas, stream);
    case 2:
      return launch_vec_nv<T, W, 2>(x, res, w, b, out, rows, d, eps, layer,
                                    tpr, ctas, stream);
    case 3:
      return launch_vec_nv<T, W, 3>(x, res, w, b, out, rows, d, eps, layer,
                                    tpr, ctas, stream);
    case 4:
      return launch_vec_nv<T, W, 4>(x, res, w, b, out, rows, d, eps, layer,
                                    tpr, ctas, stream);
    case 5:
      return launch_vec_nv<T, W, 5>(x, res, w, b, out, rows, d, eps, layer,
                                    tpr, ctas, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// body: 0 = scalar, 1 = vector (tpr threads a row, ctas blocks).
// x_dtype / w_dtype: 0 = float32, 1 = bfloat16 (residual has x's dtype,
// bias has w's).  residual / bias may be null.  layer: 0 = RMS, 1 = Layer.
// Rows are contiguous, d elements apart.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the chosen body does not take.
int fused_norm(int body, int tpr, int ctas, int x_dtype, int w_dtype,
               const void* x, const void* residual, const void* w,
               const void* b, void* out, int64_t rows, int d, float eps,
               int layer, void* stream) {
  if (d < 1 || d > kMaxD || rows < 1 || rows > 0x7fffffff ||
      x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = x_dtype * 2 + w_dtype;
  if (body == 1) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                            reinterpret_cast<uintptr_t>(residual) |
                            reinterpret_cast<uintptr_t>(w) |
                            reinterpret_cast<uintptr_t>(b) |
                            reinterpret_cast<uintptr_t>(out);
    const int per = x_dtype == 1 ? 8 : 4;   // elements a 16-byte vector
    if (d % 8 || bases % 16 || (tpr != 32 && tpr != 64 && tpr != 128 &&
                                tpr != 256) ||
        (d / per + tpr - 1) / tpr > 5 || ctas < 1) {
      return (int)cudaErrorInvalidValue;
    }
    switch (code) {
      case 0:
        return (int)launch_vec<float, float>(x, residual, w, b, out, rows, d,
                                             eps, layer, tpr, ctas, s);
      case 1:
        return (int)launch_vec<float, __nv_bfloat16>(
            x, residual, w, b, out, rows, d, eps, layer, tpr, ctas, s);
      case 2:
        return (int)launch_vec<__nv_bfloat16, float>(
            x, residual, w, b, out, rows, d, eps, layer, tpr, ctas, s);
      default:
        return (int)launch_vec<__nv_bfloat16, __nv_bfloat16>(
            x, residual, w, b, out, rows, d, eps, layer, tpr, ctas, s);
    }
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
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
    default:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(
          x, residual, w, b, out, rows, d, eps, layer, s);
  }
}

}  // extern "C"
