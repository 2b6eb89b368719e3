// Split-KV (flash-decoding) GQA decode attention for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/decode_attention/decode_attention.py:
//   * paged_decode_attention (_paged_decode_kernel): K/V read in place from
//     an (N, page_size, hkv, d) pool through a (b, P) page table;
//   * decode_attention (_decode_kernel): the same over a dense (b, hkv, s, d)
//     view, taken by strides (the contiguous ring's swapaxes view needs no
//     copy).
// Both modes share one device body and differ only in how a logical KV row
// is addressed (kv_offset below), so with equal splits and bkv == page_size
// the paged and dense modes are bitwise equal on the card.
//
// Launch grid: one block of 128 threads per (batch, kv head, split).  The
// Pallas grid's sequential KV-block axis becomes the loop over the split's
// blocks; the fp32 online-softmax state (acc[group][d] in registers,
// m[group] and l[group] in shared memory) never leaves the block.  Each
// block writes its (acc, m, l) partials to device memory and
// combine_partials (torch ops) merges them: nothing carries across blocks.
//
// Bound: decode is memory-bound.  One call must move the valid K/V,
// 2 * sum_b lengths[b] * hkv * d * bytes, and does ~4 flops per K/V element
// loaded (two dot products per query row of the group, 8 rows for yi-9b),
// far below the H100's ~295 flops/byte balance point.  What this first
// design does about it: every K/V byte below a slot's cursor is read once
// per call (the GQA group shares each load), loads are coalesced across the
// warp, blocks wholly past the cursor are skipped without a load, the
// page table is dereferenced in place (once per KV block, into shared
// memory) so no gathered copy is written, and each warp issues the loads
// of several K rows (and each thread of several V rows) before using them.  What
// it does not do yet: no TMA, no cp.async multi-stage pipeline, no wgmma;
// K/V loads are synchronous, so latency is hidden only by the number of
// blocks in flight.
//
// Masking: a lane at pos >= lengths[b] never enters the softmax (its
// probability is an explicit 0, not exp(s - m)), so a wholly masked split
// keeps m = -1e30, l = 0, acc = 0, and combine_partials' max(l, 1e-30)
// guard turns a length-0 (parked) slot into a 0 output.  Unmapped (-1)
// page entries are clamped to page 0 as gather_pages does; they are only
// ever reached below the cursor if the caller's table is inconsistent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 16;
constexpr int kMaxD = 256;
constexpr int kLaneElems = kMaxD / 32;      // K elements per lane in a row dot
constexpr int kThreadElems = kMaxD / kThreads;  // acc columns per thread
constexpr int kRows = 4;                    // K rows a warp loads at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Element offset of one logical KV row (batch b, kv head h, position pos).
//   dense: base + b*s0 + h*s1 + pos*s2                 (k is (b, hkv, s, d))
//   paged: base + page*s0 + (pos % psz)*s1 + h*s2      (pool is (N, psz, hkv, d))
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

template <typename T>
__global__ void __launch_bounds__(kThreads) split_kv_decode_kernel(
    const T* __restrict__ q, int64_t q_s0, int64_t q_s1,
    const T* __restrict__ k, const T* __restrict__ v, KvAddr addr,
    const int32_t* __restrict__ lengths, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int hkv, int group,
    int d, int splits, int steps, int bkv, int extent, float scale) {
  // Dynamic shared memory: row offsets of the current KV block, then the
  // (group, d) fp32 query rows, then the (group, bkv) scores.
  extern __shared__ int64_t smem[];
  int64_t* row_off = smem;
  float* qs = reinterpret_cast<float*>(smem + bkv);
  float* sc = qs + group * d;
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int sp = blockIdx.x % splits;
  const int ih = (blockIdx.x / splits) % hkv;
  const int ib = blockIdx.x / (splits * hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hq = hkv * group;
  const int len = min(lengths[ib], extent);

  for (int i = tid; i < group * d; i += kThreads) {
    const int g = i / d, e = i % d;
    qs[i] = to_f(q[ib * q_s0 + (ih * group + g) * q_s1 + e]);
  }
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup][kThreadElems];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int j = 0; j < kThreadElems; ++j) acc[g][j] = 0.f;
  __syncthreads();

  for (int ik = 0; ik < steps; ++ik) {
    const int base = (sp * steps + ik) * bkv;
    if (base >= len) break;           // block-uniform: no load past the cursor
    const int n = min(bkv, len - base);  // valid positions in this block

    // Row offsets once per block: the page-table lookups leave the inner
    // loops, so their K/V loads are independent and issue back to back.
    for (int t = tid; t < n; t += kThreads) {
      row_off[t] = kv_offset(addr, ib, ih, base + t);
    }
    __syncthreads();

    // Scores: each warp takes kRows consecutive positions at a time, loads
    // their K rows first, then reduces; the GQA group shares each load.
    for (int t0 = warp * kRows; t0 < n; t0 += kWarps * kRows) {
      float kv[kRows][kLaneElems];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const T* kr = k + row_off[min(t0 + u, n - 1)];
#pragma unroll
        for (int j = 0; j < kLaneElems; ++j) {
          const int e = lane + 32 * j;
          kv[u][j] = e < d ? to_f(kr[e]) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < kLaneElems; ++j) {
              const int e = lane + 32 * j;
              if (e < d) dot = fmaf(qs[g * d + e], kv[u][j], dot);
            }
            dot = warp_sum(dot);
            if (lane == 0 && t0 + u < n) sc[g * bkv + t0 + u] = dot * scale;
          }
        }
      }
    }
    __syncthreads();

    // Online-softmax statistics, one warp per query row of the group.
    for (int g = warp; g < group; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sc[g * bkv + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(sc[g * bkv + t] - m_cur);
        sc[g * bkv + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, one output column per thread.
#pragma unroll
    for (int j = 0; j < kThreadElems; ++j) {
      const int e = tid + j * kThreads;
      if (e < d) {
        float pv[kMaxGroup];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) pv[g] = 0.f;
#pragma unroll 8
        for (int t = 0; t < n; ++t) {
          const float vv = to_f(v[row_off[t] + e]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < group) pv[g] = fmaf(sc[g * bkv + t], vv, pv[g]);
        }
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < group) acc[g][j] = acc[g][j] * alpha_s[g] + pv[g];
      }
    }
    __syncthreads();  // sc / alpha_s are rewritten by the next block
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      const int64_t row = ((int64_t)ib * hq + ih * group + g) * splits + sp;
#pragma unroll
      for (int j = 0; j < kThreadElems; ++j) {
        const int e = tid + j * kThreads;
        if (e < d) acc_out[row * d + e] = acc[g][j];
      }
      if (tid == 0) {
        m_out[row] = m_s[g];
        l_out[row] = l_s[g];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, int64_t q_s0, int64_t q_s1, const void* k,
                   const void* v, KvAddr addr, const int32_t* lengths,
                   float* acc, float* m, float* l, int b, int hkv, int group,
                   int d, int splits, int steps, int bkv, int extent,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(int64_t) * (size_t)bkv +
                      sizeof(float) * (size_t)group * (d + bkv);
  const dim3 grid((unsigned)b * hkv * splits);
  split_kv_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_s0, q_s1, static_cast<const T*>(k),
      static_cast<const T*>(v), addr, lengths, acc, m, l, hkv, group, d,
      splits, steps, bkv, extent, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  pages == nullptr selects
// dense addressing.  Returns cudaGetLastError() after the launch.
int split_kv_decode(int dtype, const void* q, int64_t q_s0, int64_t q_s1,
                    const void* k, const void* v, const int32_t* pages,
                    int64_t kv_s0, int64_t kv_s1, int64_t kv_s2, int psz,
                    int n_table, int n_pages, const int32_t* lengths,
                    float* acc, float* m, float* l, int b, int hkv, int group,
                    int d, int splits, int steps, int bkv, int extent,
                    float scale, void* stream) {
  if (group < 1 || group > kMaxGroup || d < 1 || d > kMaxD || bkv < 1 ||
      splits < 1 || steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const KvAddr addr{pages, kv_s0, kv_s1, kv_s2, psz, n_table, n_pages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, q_s0, q_s1, k, v, addr, lengths, acc, m, l,
                                b, hkv, group, d, splits, steps, bkv, extent,
                                scale, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, q_s0, q_s1, k, v, addr, lengths,
                                        acc, m, l, b, hkv, group, d, splits,
                                        steps, bkv, extent, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
