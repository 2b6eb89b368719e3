// Causal / full GQA flash attention for Hopper (sm_90a): the port's prefill
// attention.
//
// Replaces the Pallas TPU kernel flash_attention (_flash_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py: per query row, an
// fp32 online softmax (acc, m, l) over KV blocks, KV blocks wholly above
// the causal diagonal skipped, the output acc / max(l, 1e-30) in q's dtype.
// Beyond the Pallas kernel's static q_offset it takes what the serve path
// needs, all per slot: q_offset[b] (the slot's cursor), kv_len[b] (keys at
// or past it are masked) and q_len[b] (query rows at or past it are
// padding, written as zeros; a tile of padding rows loads nothing, so a
// parked slot with q_len 0 costs one store of zeros).
//
// Two addressings, one device body (as in decode_attention.cu): K/V as a
// dense (b, hkv, skv, d) view taken by strides, or the page pool
// (N, page_size, hkv, d) read in place through a (b, P) page table (-1 =
// unmapped, clamped to page 0; such rows are always past kv_len).  A KV
// row's offset is the only thing that differs, and rows past the tile's
// key limit are zero-filled in both, so paged and dense are bitwise equal.
//
// Launch grid: one block of 256 threads per (q tile of kBQ = 64 rows, q
// head, batch).  The Pallas grid's sequential KV axis is the loop inside
// the block.  Shared memory holds the fp32 Q tile, one K and one V tile of
// kBKV = 32 rows and the tile's probabilities; each thread keeps a 4 x 2
// block of scores and a 4 x (DP / 16) block of the output accumulator in
// registers, and the 16 threads that share a query row reduce its max and
// sum with warp shuffles.  DP is the head dim padded to 64, 128 or 256.
//
// Bound: at prefill shapes, operations.  One causal call does
// 4 * d * (valid query-key pairs) * hq flops on 2-4 bytes per element
// moved; yi-9b's 16 x 1024 prefill is ~137 GFLOP against ~0.3 GB.  This
// first version does them in fp32 on the CUDA cores (67 TFLOP/s peak, not
// the 989 TFLOP/s of bf16 tensor cores), so it sits at ~15x its bound at
// best.  What the design does about the rest: blocks above the diagonal,
// past kv_len and past q_len are never loaded, K/V tiles are read once per
// q tile and reused by its 64 rows from shared memory, and the inner
// products read shared memory as 16-byte vectors laid out without bank
// conflicts.  What it does not do yet: mma/wgmma tensor-core products,
// TMA or cp.async pipelining, sharing K/V tiles across the GQA group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;           // query rows per block
constexpr int kBKV = 32;          // key rows per KV step
constexpr int kRows = 4;          // query rows per thread
constexpr int kCols = 2;          // score columns per thread (tx + 16 u)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element offset of one logical KV row (batch b, kv head h, position pos).
//   dense: b*s0 + h*s1 + pos*s2                   (k is (b, hkv, skv, d))
//   paged: page*s0 + (pos % psz)*s1 + h*s2        (pool is (N, psz, hkv, d))
//          with page = clamp(pages[b, pos / psz], 0, N - 1)
struct KvAddr {
  const int32_t* pages;  // nullptr in dense mode
  int64_t s0, s1, s2;
  int psz, n_table, n_pages;
};

__device__ __forceinline__ int64_t kv_offset(const KvAddr& a, int b, int h,
                                             int pos) {
  if (a.pages == nullptr) {
    return b * a.s0 + h * a.s1 + pos * a.s2;
  }
  int page = a.pages[(int64_t)b * a.n_table + pos / a.psz];
  page = min(max(page, 0), a.n_pages - 1);
  return page * a.s0 + (pos % a.psz) * a.s1 + h * a.s2;
}

struct Args {
  const void* q;
  int64_t q_s0, q_s1, q_s2;     // (b, hq, sq) strides; d has stride 1
  void* out;
  int64_t o_s0, o_s1, o_s2;
  const void* k;
  const void* v;
  KvAddr addr;
  const int32_t* q_off;         // (b,)
  const int32_t* kv_len;        // (b,)
  const int32_t* q_len;         // (b,)
  int group, sq, skv, d;
  float scale;
  int causal;
};

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(int64_t) * kBKV +
         sizeof(float) * ((size_t)(kBQ + kBKV) * (DP + 4) + kBKV * DP +
                          kBQ * (kBKV + 4));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  constexpr int QS = DP + 4;      // Q / K smem row stride (floats)
  constexpr int PS = kBKV + 4;    // P smem row stride
  constexpr int OC = DP / 16;     // output columns per thread
  extern __shared__ int64_t smem[];
  int64_t* row_off = smem;
  float* qs = reinterpret_cast<float*>(smem + kBKV);
  float* ks = qs + kBQ * QS;
  float* vs = ks + kBKV * QS;
  float* ps = vs + kBKV * DP;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const T* q = static_cast<const T*>(a.q) + b * a.q_s0 + h * a.q_s1;
  T* out = static_cast<T*>(a.out) + b * a.o_s0 + h * a.o_s1;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int d = a.d;

  const int trows = min(kBQ, a.sq - q0);                  // rows in the view
  const int qlen = min(a.sq, max(a.q_len[b], 0));
  const int nrows = max(0, min(trows, qlen - q0));        // non-padding rows
  if (nrows == 0) {
    for (int i = tid; i < trows * d; i += kThreads) {
      out[(q0 + i / d) * a.o_s2 + i % d] = from_f<T>(0.f);
    }
    return;
  }
  const int off = a.q_off[b];
  int kv_hi = min(a.skv, a.kv_len[b]);
  if (a.causal) kv_hi = min(kv_hi, off + q0 + nrows);     // last row's keys
  kv_hi = max(kv_hi, 0);

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, e = i % DP;
    qs[r * QS + e] = (r < nrows && e < d) ? to_f(q[(q0 + r) * a.q_s2 + e]) : 0.f;
  }

  float acc[kRows][OC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_hi; kv0 += kBKV) {
    const int n = min(kBKV, kv_hi - kv0);
    __syncthreads();              // the previous step's readers are done
    if (tid < kBKV) row_off[tid] = tid < n ? kv_offset(a.addr, b, kvh, kv0 + tid) : 0;
    __syncthreads();
    for (int i = tid; i < kBKV * DP; i += kThreads) {
      const int j = i / DP, e = i % DP;
      const bool ok = j < n && e < d;
      ks[j * QS + e] = ok ? to_f(k[row_off[j] + e]) : 0.f;
      vs[j * DP + e] = ok ? to_f(v[row_off[j] + e]) : 0.f;
    }
    __syncthreads();

    // Scores: rows ty*4 + i, columns tx + 16 u.
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int u = 0; u < kCols; ++u) s[i][u] = 0.f;
#pragma unroll 4
    for (int e = 0; e < DP; e += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty * kRows + i) * QS + e]);
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        kv[u] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * u) * QS + e]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          s[i][u] = fmaf(qv[i].x, kv[u].x, s[i][u]);
          s[i][u] = fmaf(qv[i].y, kv[u].y, s[i][u]);
          s[i][u] = fmaf(qv[i].z, kv[u].z, s[i][u]);
          s[i][u] = fmaf(qv[i].w, kv[u].w, s[i][u]);
        }
    }

    // Online softmax; the 16 threads of a row are lanes with equal ty.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qpos = off + q0 + r;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = tx + 16 * u;
        ok[u] = c < n && r < nrows && (!a.causal || kv0 + c <= qpos);
        s[i][u] = ok[u] ? s[i][u] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][u]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const float p = ok[u] ? expf(s[i][u] - m_cur) : 0.f;
        ps[r * PS + tx + 16 * u] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P @ V: rows ty*4 + i, columns tx*4 + 64 hc + w.
    const int n4 = (n + 3) & ~3;  // rows past n are zero in P and V
    for (int j = 0; j < n4; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty * kRows + i) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int hc = 0; hc < DP / 64; ++hc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &vs[(j + jj) * DP + tx * 4 + 64 * hc]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][hc * 4 + 0] = fmaf(p, vv.x, acc[i][hc * 4 + 0]);
            acc[i][hc * 4 + 1] = fmaf(p, vv.y, acc[i][hc * 4 + 1]);
            acc[i][hc * 4 + 2] = fmaf(p, vv.z, acc[i][hc * 4 + 2]);
            acc[i][hc * 4 + 3] = fmaf(p, vv.w, acc[i][hc * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= trows) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int hc = 0; hc < DP / 64; ++hc)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int c = tx * 4 + 64 * hc + w;
        if (c < d) {
          out[(q0 + r) * a.o_s2 + c] =
              from_f<T>(r < nrows ? acc[i][hc * 4 + w] / lm : 0.f);
        }
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const Args& a, int b, int hq, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool configured = false;   // opt in to > 48 KB once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<T, DP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int b, int hq, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, b, hq, stream);
  if (a.d <= 128) return launch<T, 128>(a, b, hq, stream);
  return launch<T, 256>(a, b, hq, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  pages == nullptr selects dense
// addressing.  q_off, kv_len and q_len are (b,) int32 on the device.
// Returns cudaGetLastError() after the launch.
int flash_attention(int dtype, const void* q, int64_t q_s0, int64_t q_s1,
                    int64_t q_s2, void* out, int64_t o_s0, int64_t o_s1,
                    int64_t o_s2, const void* k, const void* v,
                    const int32_t* pages, int64_t kv_s0, int64_t kv_s1,
                    int64_t kv_s2, int psz, int n_table, int n_pages,
                    const int32_t* q_off, const int32_t* kv_len,
                    const int32_t* q_len, int b, int hq, int hkv, int sq,
                    int skv, int d, float scale, int causal, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || skv < 0 ||
      d < 1 || d > 256 || b > 65535 || hq > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, q_s0, q_s1, q_s2, out, o_s0, o_s1, o_s2, k, v,
               KvAddr{pages, kv_s0, kv_s1, kv_s2, psz, n_table, n_pages},
               q_off, kv_len, q_len, hq / hkv, sq, skv, d, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(a, b, hq, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(a, b, hq, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
