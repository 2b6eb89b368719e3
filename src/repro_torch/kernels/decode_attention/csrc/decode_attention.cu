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
// Bound: bytes.  One call must move the live K/V,
// 2 * sum_b lengths[b] * hkv * d * bytes, and does ~4 flops per K/V element
// per query row of the group (8 rows for yi-9b), far below the H100's ~295
// flops/byte balance point.  So the design is about keeping loads in flight.
//
// Splits divide each slot's live length, not the page table: slot b has
// n_b = cdiv(min(len_b, extent), bkv) live KV blocks and split sp walks
// blocks [sp * c_b, min(n_b, (sp + 1) * c_b)) with c_b = cdiv(n_b, splits),
// computed here from lengths[b] (no host sync).  Every split of a slot gets
// an equal share of its live rows; a split with no block writes
// m = -1e30, l = 0, acc = 0, which combine_partials weighs as nothing.
//
// Launch grid: one block per (batch, kv head, split) in x and per tile of
// up to 16 query heads of the GQA group in y, of 8 warps when the group has
// 8 or more query heads and of 4 otherwise (groups up to 64:
// granite-20b's MQA group of 48 is three tiles, each re-reading the K/V
// tile from the L2).  The block walks its split's rows in steps of kRows
// (64 rows, four pages of 16, in bf16; 32 in fp32) through a kStages = 2
// ring of K and V tiles in dynamic shared memory, filled with 16-byte
// cp.async copies (zero-filled past the step's last live row), so the next
// step's tile loads while this one computes.  A tile row is padded by 16
// bytes so that lanes reading one 16-byte chunk of different rows hit
// distinct banks.  The page table is read once a row, one thread a row,
// kStages steps ahead of the row's copies (row offsets in shared memory),
// so the copy loop starts its cp.async copies back to back.  Per step:
//   barrier 1 (the tile has landed; the last step's readers are done), start
//   the next tile's copies; scores and the online-softmax update, each warp
//   owning whole query rows of the group (rows w, w+W, ...), lanes over the
//   step's K rows, dot products from shared memory as 16-byte vectors, max
//   and sum by warp shuffles, one update per step (not per page);
//   barrier 2; acc = acc * alpha + P V, each thread owning 16-byte column
//   chunks of a query row (and, when the group tile has fewer (row, chunk)
//   pairs than threads, a slice of the step's rows, the slices summed once
//   at the end).
// The fp32 state never leaves the block: it writes its (acc, m, l) partials
// and combine_partials (torch ops) merges them, in a fixed order, without
// atomics.  Every K/V row must be 16-byte aligned (the wrapper refuses
// others).
//
// Masking: a lane at pos >= the split's live end never enters the softmax
// (its probability is an explicit 0, not exp(s - m)); rows past it are
// zero-filled, so no value of an unmapped or stale page reaches the output.
// Unmapped (-1) page entries are clamped to page 0 as gather_pages does.
//
// What it does not do yet: TMA or a producer warp, tensor-core products
// (the kernel is byte-bound), fusing combine_partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kGroupTile = 16;      // query rows of the group per block
constexpr int kMaxGroup = 64;
constexpr int kMaxD = 256;
constexpr int kStages = 2;          // depth of the cp.async ring
constexpr int kMaxSlices = 8;       // row slices of the P V product

template <typename T> struct Step;
template <> struct Step<float> { static constexpr int kRows = 32; };
template <> struct Step<__nv_bfloat16> { static constexpr int kRows = 64; };

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// One 16-byte chunk of shared memory as fp32 values.
__device__ __forceinline__ void chunk_to_f(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void chunk_to_f(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Element offset of one logical KV row (batch b, kv head h, position pos).
//   dense: b*s0 + h*s1 + pos*s2                  (k is (b, hkv, s, d))
//   paged: page*s0 + (pos % psz)*s1 + h*s2       (pool is (N, psz, hkv, d))
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
  int64_t q_s0, q_s1;
  const void* k;
  const void* v;
  KvAddr addr;
  const int32_t* lengths;
  float* acc_out;
  float* m_out;
  float* l_out;
  int hkv, group, d, splits, bkv, extent;
  float scale;
};

// W warps a block: 8 when the group has 8 or more query heads (a warp per
// query row or two), else 4 (a small group's scores are one warp's work,
// and the other warps wait for them).
template <typename T, int W>
__global__ void __launch_bounds__(W * 32) split_kv_decode_kernel(Args a) {
  constexpr int kWarps = W;
  constexpr int kThreads = W * 32;
  constexpr int R = Step<T>::kRows;           // K/V rows a step
  constexpr int E = 16 / sizeof(T);           // elements of a 16-byte chunk
  constexpr int J = R / 32;                   // K rows a lane scores
  constexpr int kItems = kGroupTile * (kMaxD / E) / kThreads;
  const int nc = (a.d + E - 1) / E;           // chunks a row
  const int RS = nc * 16 + 16;                // tile row stride, bytes
  const int QW = nc * E;                      // padded query row, floats

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                 // [kStages][K, V][R][RS]
  int64_t* row_off = reinterpret_cast<int64_t*>(smem + kStages * 2 * R * RS);
  float* qs = reinterpret_cast<float*>(row_off + kStages * R);
  float* sc = qs + kGroupTile * QW;           // [kGroupTile][R] probabilities
  float* alpha_s = sc + kGroupTile * R;       // [kGroupTile]

  const int sp = blockIdx.x % a.splits;
  const int ih = (blockIdx.x / a.splits) % a.hkv;
  const int ib = blockIdx.x / (a.splits * a.hkv);
  const int g0 = blockIdx.y * kGroupTile;
  const int gt = min(kGroupTile, a.group - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hq = a.hkv * a.group;
  const T* q = static_cast<const T*>(a.q);
  const T* kb = static_cast<const T*>(a.k);
  const T* vb = static_cast<const T*>(a.v);

  // This split's rows: the live-length rule.
  const int len = min(max(a.lengths[ib], 0), a.extent);
  const int n_blk = (len + a.bkv - 1) / a.bkv;
  const int per = (n_blk + a.splits - 1) / a.splits;
  const int lo = min(sp * per, n_blk) * a.bkv;
  const int hi = min(min((sp + 1) * per, n_blk) * a.bkv, len);
  const int nsteps = hi > lo ? (hi - lo + R - 1) / R : 0;

  // Row offsets of step `step` into row_off[step % kStages] (-1: past the
  // split's live end, zero-filled): one thread a row, so the page-table
  // loads of a step are independent and leave the copy loop.  Step t's
  // offsets are written kStages steps ahead of its copies and read after
  // a barrier.
  auto row_offsets = [&](int step) {
    const int base = lo + step * R;
    if (tid < R && step < nsteps) {
      row_off[(step % kStages) * R + tid] =
          base + tid < hi ? kv_offset(a.addr, ib, ih, base + tid) : -1;
    }
  };
  // Stage step `step`'s K and V rows into ring slot step % kStages: thread
  // tid copies 16-byte chunk tid % nc of rows tid / nc + k * (kThreads / nc).
  const int c_own = tid % nc, rstep = kThreads / nc;
  auto load_tile = [&](int step) {
    const int slot = step % kStages;
    unsigned char* kt = ring + (size_t)(slot * 2) * R * RS;
    unsigned char* vt = kt + (size_t)R * RS;
    if (tid >= rstep * nc) return;
    for (int r = tid / nc; r < R; r += rstep) {
      const int64_t off = row_off[slot * R + r];
      const int64_t o = off < 0 ? 0 : off + c_own * E;
      const int bytes = off < 0 ? 0 : 16;     // 0: zero-fill, nothing read
      cp_async16(kt + r * RS + c_own * 16, kb + o, bytes);
      cp_async16(vt + r * RS + c_own * 16, vb + o, bytes);
    }
  };

  for (int s = 0; s < kStages; ++s) row_offsets(s);
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load_tile(s);
    cp_async_commit();
  }
  for (int i = tid; i < gt * QW; i += kThreads) {
    const int g = i / QW, e = i % QW;
    qs[i] = e < a.d ? to_f(q[ib * a.q_s0 + (ih * a.group + g0 + g) * a.q_s1 + e])
                    : 0.f;
  }

  // P V work: (query row g, chunk c) units, and row slices of each step
  // when there are fewer units than threads.
  const int units = gt * nc;
  int rs = 1;
  while (rs < kMaxSlices && units * rs * 2 <= kThreads && R / (rs * 2) >= 4) {
    rs *= 2;
  }
  float acc[kItems][E];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  float m[kGroupTile / kWarps], l[kGroupTile / kWarps];
#pragma unroll
  for (int k = 0; k < kGroupTile / kWarps; ++k) {
    m[k] = kNegInf;
    l[k] = 0.f;
  }

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();          // tile `it` visible; step it-1's readers done
    if (it + kStages - 1 < nsteps) load_tile(it + kStages - 1);
    cp_async_commit();
    row_offsets(it + kStages);    // into the slot step `it` no longer needs

    const unsigned char* kt = ring + (size_t)((it % kStages) * 2) * R * RS;
    const unsigned char* vt = kt + (size_t)R * RS;
    const int n = min(R, hi - (lo + it * R));

    // Scores and the online-softmax update: warp `warp` owns query rows
    // warp + 4k of the tile, lane `lane` K rows lane + 32j of the step.
    float dot[kGroupTile / kWarps][J];
#pragma unroll
    for (int k = 0; k < kGroupTile / kWarps; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j) dot[k][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < nc; ++c) {
      float kf[J][E];
#pragma unroll
      for (int j = 0; j < J; ++j)
        chunk_to_f(reinterpret_cast<const T*>(kt + (lane + 32 * j) * RS +
                                              c * 16), kf[j]);
#pragma unroll
      for (int k = 0; k < kGroupTile / kWarps; ++k) {
        const int g = warp + kWarps * k;
        if (g < gt) {
          float qf[E];
#pragma unroll
          for (int e = 0; e < E; e += 4) chunk_to_f(qs + g * QW + c * E + e, qf + e);
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int e = 0; e < E; ++e) dot[k][j] = fmaf(qf[e], kf[j][e], dot[k][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGroupTile / kWarps; ++k) {
      const int g = warp + kWarps * k;
      if (g < gt) {
        float s[J];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          s[j] = lane + 32 * j < n ? dot[k][j] * a.scale : kNegInf;
          mx = fmaxf(mx, s[j]);
        }
        mx = warp_max(mx);
        const float m_cur = fmaxf(m[k], mx);
        const float alpha = expf(m[k] - m_cur);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float p = lane + 32 * j < n ? expf(s[j] - m_cur) : 0.f;
          sc[g * R + lane + 32 * j] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        l[k] = l[k] * alpha + sum;
        m[k] = m_cur;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();          // probabilities and alphas visible

    // acc = acc * alpha + P V over this thread's units and row slice.
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < units * rs) {
        const int unit = idx % units, slice = idx / units;
        const int g = unit / nc, c = unit % nc;
        const float al = alpha_s[g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] *= al;
        // Rows past n have p = 0 and zero-filled V: the whole slice runs,
        // four rows at a time.
        for (int r = slice * (R / rs); r < (slice + 1) * (R / rs); r += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(sc + g * R + r);
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
          float vf[4][E];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            chunk_to_f(reinterpret_cast<const T*>(vt + (r + u) * RS + c * 16),
                       vf[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[i][e] = fmaf(p[u], vf[u][e], acc[i][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free for the slice reduction

  const int64_t row0 = ((int64_t)ib * hq + ih * a.group + g0) * a.splits + sp;
#pragma unroll
  for (int k = 0; k < kGroupTile / kWarps; ++k) {
    const int g = warp + kWarps * k;
    if (g < gt && lane == 0) {
      a.m_out[row0 + (int64_t)g * a.splits] = m[k];
      a.l_out[row0 + (int64_t)g * a.splits] = l[k];
    }
  }
  if (rs == 1) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < units) {
        const int g = idx / nc, c = idx % nc;
        float* out = a.acc_out + (row0 + (int64_t)g * a.splits) * a.d;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (c * E + e < a.d) out[c * E + e] = acc[i][e];
      }
    }
    return;
  }
  float* red = reinterpret_cast<float*>(ring);   // [rs][units][E]
  if (tid < units * rs) {
#pragma unroll
    for (int e = 0; e < E; ++e) red[tid * E + e] = acc[0][e];
  }
  __syncthreads();
  for (int i = tid; i < units * E; i += kThreads) {
    const int unit = i / E, e = i % E;
    float sum = 0.f;
    for (int s = 0; s < rs; ++s) sum += red[(s * units + unit) * E + e];
    const int g = unit / nc, col = (unit % nc) * E + e;
    if (col < a.d) a.acc_out[(row0 + (int64_t)g * a.splits) * a.d + col] = sum;
  }
}

template <typename T>
size_t smem_bytes(int d) {
  constexpr int R = Step<T>::kRows;
  const int row_bytes = (d * (int)sizeof(T) + 15) / 16 * 16;
  return (size_t)kStages * 2 * R * (row_bytes + 16) +
         sizeof(int64_t) * kStages * R +
         sizeof(float) * kGroupTile * (row_bytes / sizeof(T) + R + 1);
}

template <typename T, int W>
cudaError_t launch_w(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.d);
  static size_t configured = 48 * 1024;     // opt in above 48 KB
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kv_decode_kernel<T, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const dim3 grid((unsigned)b * a.hkv * a.splits,
                  (a.group + kGroupTile - 1) / kGroupTile);
  split_kv_decode_kernel<T, W><<<grid, W * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  return a.group >= 8 ? launch_w<T, 8>(a, b, stream)
                      : launch_w<T, 4>(a, b, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  pages == nullptr selects dense
// addressing.  Partials acc (b, hq, splits, d), m and l (b, hq, splits),
// fp32.  Returns cudaGetLastError() after the launch.
int split_kv_decode(int dtype, const void* q, int64_t q_s0, int64_t q_s1,
                    const void* k, const void* v, const int32_t* pages,
                    int64_t kv_s0, int64_t kv_s1, int64_t kv_s2, int psz,
                    int n_table, int n_pages, const int32_t* lengths,
                    float* acc, float* m, float* l, int b, int hkv, int group,
                    int d, int splits, int bkv, int extent, float scale,
                    void* stream) {
  if (b < 1 || hkv < 1 || group < 1 || group > kMaxGroup || d < 1 ||
      d > kMaxD || bkv < 1 || splits < 1 || extent < 0) {
    return (int)cudaErrorInvalidValue;
  }
  // Every K/V row is copied in 16-byte pieces.
  const int es = dtype == 0 ? 4 : 2;
  if (!aligned16(k) || !aligned16(v) || (d * es) % 16 || (kv_s0 * es) % 16 ||
      (kv_s1 * es) % 16 || (kv_s2 * es) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, q_s0, q_s1, k, v,
               KvAddr{pages, kv_s0, kv_s1, kv_s2, psz, n_table, n_pages},
               lengths, acc, m, l, hkv, group, d, splits, bkv, extent, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(a, b, s);
    case 1:
      return (int)launch<__nv_bfloat16>(a, b, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
