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
// Two addressings, one device body per type (as in decode_attention.cu):
// K/V as a dense (b, hkv, skv, d) view taken by strides, or the page pool
// (N, page_size, hkv, d) read in place through a (b, P) page table (-1 =
// unmapped, clamped to page 0; such rows are always past kv_len).  A KV
// row's offset is the only thing that differs, and rows past the tile's
// key limit are zero-filled in both, so paged and dense are bitwise equal.
//
// Bound: operations.  One causal call does 4 * d * (valid query-key pairs)
// * hq flops on 2-4 bytes per element moved; yi-9b's 16 x 1024 prefill is
// ~137 GFLOP against ~0.3 GB.
//
// Two bodies.
//
// bf16 (flash_mma_kernel), when the head dim is at most 128 and every row
// of q, k and v is 16-byte aligned: the products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulators; not wgmma), fragments
// loaded with ldmatrix, in the FlashAttention-2 layout.  Launch grid: one
// block of 8 warps per (q tile of 128 rows, q head, batch), the q tiles
// in reverse order so that the longest causal rows start first.  Each
// warp owns 16 query rows: S = Q K^T for a 64-key tile is 8 accumulator
// tiles (Q's fragments read from shared memory each k-step, so that the
// registers, capped at 128 for two blocks an SM, hold the accumulators),
// the online softmax runs on those registers (row max and sum over the 4
// lanes of a quad), and the S accumulators are reused in registers as P's
// A-fragments for O += P V (ldmatrix.trans of V).  K/V tiles of 64 rows
// are staged with 16-byte cp.async copies in a 2-stage ring in dynamic
// shared memory, shared by the 8 warps (rows padded by 16 bytes: ldmatrix
// without bank conflicts), so the next tile loads while this one
// computes; one block barrier a tile.  The head dim runs at its own width
// when it is 64, 80 or 128 (the ported configs' widths; d 80 is 5 k-steps
// and 10 n-tiles), else at the next of them with the missing columns
// zero-filled.  Masked lanes get an explicit zero probability, so a fully
// masked row or tile leaves (acc, m, l) as it was; a warp skips the
// products of a tile wholly past its rows' keys.  P is rounded to bf16 for
// the P V product (l sums the fp32 probabilities).  That rounding adds up
// to 2^-9 relative error per probability; at yi-9b's and zamba2's prefill
// shapes it stays within chip_smoke.py's bf16 tolerance (its rows'
// tol_used), so P V is one product, not the two of a split into
// bf16(P) + bf16(P - bf16(P)).
//
// fp32, and bf16 rows that the tensor-core body does not take
// (flash_simt_kernel): fp32 FMA on the CUDA cores.  One block of 256
// threads per (q tile of 64 rows, q head, batch); shared memory holds the
// fp32 Q tile, one K and one V tile of 32 rows and the tile's
// probabilities; each thread keeps a 4 x 2 block of scores and a
// 4 x (DP / 16) block of the output accumulator in registers, and the 16
// threads that share a query row reduce its max and sum with warp
// shuffles.  DP is the head dim padded to 64, 128 or 256.  TF32 would not
// hold fp32's tolerance, so fp32 stays here (67 TFLOP/s peak).
//
// Both bodies never load tiles above the causal diagonal, past kv_len or
// past q_len.  What neither does yet: wgmma with TMA and a producer warp
// (the only way to the card's full bf16 rate), sharing K/V tiles across
// the GQA group (the rereads hit the L2), a persistent grid.

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
constexpr size_t simt_smem_bytes() {
  return sizeof(int64_t) * kBKV +
         sizeof(float) * ((size_t)(kBQ + kBKV) * (DP + 4) + kBKV * DP +
                          kBQ * (kBKV + 4));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_simt_kernel(Args a) {
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

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;       // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;
constexpr int kMmaMinBlocks = 2;   // blocks an SM holds (caps registers)
constexpr int kMmaBKV = 64;
constexpr int kMmaMaxD = 128;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kMmaBQ + 2 * 2 * kMmaBKV) * (DP * 2 + 16);
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
flash_mma_kernel(Args a) {
  constexpr int NC = DP / 8;          // 16-byte chunks of a row
  constexpr int RS = DP * 2 + 16;     // shared-memory row stride, bytes
  constexpr int KT = DP / 16;         // k-steps of Q K^T
  constexpr int NT = DP / 8;          // n-tiles of P V
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* qs = smem_mma;                      // [BQ][RS]
  unsigned char* ring = smem_mma + kMmaBQ * RS;      // [2][K, V][BKV][RS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  typedef __nv_bfloat16 T;
  const T* q = static_cast<const T*>(a.q) + b * a.q_s0 + h * a.q_s1;
  T* out = static_cast<T*>(a.out) + b * a.o_s0 + h * a.o_s1;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int d = a.d;

  const int trows = min(kMmaBQ, a.sq - q0);
  const int qlen = min(a.sq, max(a.q_len[b], 0));
  const int nrows = max(0, min(trows, qlen - q0));
  if (nrows == 0) {
    for (int i = tid; i < trows * d; i += kMmaThreads) {
      out[(q0 + i / d) * a.o_s2 + i % d] = __float2bfloat16(0.f);
    }
    return;
  }
  const int off = a.q_off[b];
  const int kvl = max(0, min(a.skv, a.kv_len[b]));
  int kv_hi = kvl;
  if (a.causal) kv_hi = min(kv_hi, off + q0 + nrows);
  kv_hi = max(kv_hi, 0);
  const int ntiles = (kv_hi + kMmaBKV - 1) / kMmaBKV;

  // Q tile (rows past nrows and columns past d zero-filled).
  for (int i = tid; i < kMmaBQ * NC; i += kMmaThreads) {
    const int r = i / NC, c = i % NC;
    const bool ok = r < nrows && c * 8 < d;
    cp_async16(qs + r * RS + c * 16, ok ? q + (q0 + r) * a.q_s2 + c * 8 : q,
               ok ? 16 : 0);
  }
  auto load_tile = [&](int t, int slot) {
    const int kv0 = t * kMmaBKV;
    const int n = min(kMmaBKV, kv_hi - kv0);
    unsigned char* kt = ring + (size_t)slot * 2 * kMmaBKV * RS;
    unsigned char* vt = kt + kMmaBKV * RS;
    for (int i = tid; i < kMmaBKV * NC; i += kMmaThreads) {
      const int r = i / NC, c = i % NC;
      const bool ok = r < n && c * 8 < d;
      const int64_t o = ok ? kv_offset(a.addr, b, kvh, kv0 + r) + c * 8 : 0;
      cp_async16(kt + r * RS + c * 16, k + o, ok ? 16 : 0);
      cp_async16(vt + r * RS + c * 16, v + o, ok ? 16 : 0);
    }
  };
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();

  // This thread's two rows of the warp's 16 (lane / 4 and lane / 4 + 8)
  // and the keys each may see: below kv_len, and at or before its
  // position when causal; a padding row sees none.
  const int wrow = warp * 16;
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + lane / 4 + 8 * i;
    lim[i] = r < nrows ? (a.causal ? min(kvl, off + q0 + r + 1) : kvl) : 0;
  }
  const int wlast = min(wrow + 15, nrows - 1);
  const int wlim = wrow < nrows
                       ? (a.causal ? min(kvl, off + q0 + wlast + 1) : kvl)
                       : 0;
  const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2 units

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();          // tile t visible; tile t-1's readers are done
    if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int kv0 = t * kMmaBKV;
    if (kv0 >= wlim) continue;          // no key of this tile for the warp
    const unsigned char* kt = ring + (size_t)(t & 1) * 2 * kMmaBKV * RS;
    const unsigned char* vt = kt + kMmaBKV * RS;

    // S = Q K^T: 8 accumulator tiles of 8 keys; Q's fragments come from
    // shared memory each k-step (registers go to the accumulators).
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      uint32_t qa[4];
      ldsm_x4(qa, qs + (wrow + ((lane / 8) & 1) * 8 + lane % 8) * RS +
                      (ks * 16 + (lane / 16) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * RS +
                        (ks * 16 + ((lane / 8) & 1) * 8) * 2);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // Online softmax on the accumulators: element e of tile n is row
    // lane / 4 + 8 (e / 2), key kv0 + 8 n + 2 (lane % 4) + e % 2.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + 8 * n + 2 * (lane % 4) + (e & 1);
        s[n][e] = key < lim[e / 2] ? s[n][e] * sl2 : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_cur = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_cur);
      m[i] = m_cur;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + 8 * n + 2 * (lane % 4) + (e & 1);
        const float p = key < lim[e / 2] ? exp2f(s[n][e] - m[e / 2]) : 0.f;
        s[n][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the S tiles 2 kk and 2 kk + 1 are P's A-fragment of k-step
    // kk (keys 16 kk .. 16 kk + 15).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vt + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * RS +
                              (np * 16 + (lane / 16) * 8) * 2);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // l is summed over the quad's columns; rows past nrows are zeros.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + lane / 4 + 8 * i;
    if (r >= trows) continue;
    const float inv = r < nrows ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * (lane % 4);
      if (c < d) {
        *reinterpret_cast<__nv_bfloat162*>(out + (q0 + r) * a.o_s2 + c) =
            __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Opt in to more than 48 KB of dynamic shared memory once per instance.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <typename T, int DP>
cudaError_t launch_simt(const Args& a, int b, int hq, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<DP>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_simt_kernel<T, DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, hq, b);
  flash_simt_kernel<T, DP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mma(const Args& a, int b, int hq, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DP>();
  static bool configured = false;
  const cudaError_t err = allow_smem(flash_mma_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kMmaBQ - 1) / kMmaBQ, hq, b);
  flash_mma_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_d(const Args& a, int b, int hq, cudaStream_t stream) {
  if (a.d <= 64) return launch_simt<T, 64>(a, b, hq, stream);
  if (a.d <= 128) return launch_simt<T, 128>(a, b, hq, stream);
  return launch_simt<T, 256>(a, b, hq, stream);
}

cudaError_t launch_mma_d(const Args& a, int b, int hq, cudaStream_t stream) {
  if (a.d <= 64) return launch_mma<64>(a, b, hq, stream);
  if (a.d <= 80) return launch_mma<80>(a, b, hq, stream);
  return launch_mma<128>(a, b, hq, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The tensor-core body takes bf16 with d <= 128 and every row of q, k, v
// (and the output, which has q's strides) 16-byte aligned.
bool use_mma(int dtype, const void* q, int64_t q_s0, int64_t q_s1,
             int64_t q_s2, const void* out, int64_t o_s0, int64_t o_s1,
             int64_t o_s2, const void* k, const void* v, int64_t kv_s0,
             int64_t kv_s1, int64_t kv_s2, int d) {
  const int64_t strides[9] = {q_s0, q_s1, q_s2, o_s0, o_s1, o_s2,
                              kv_s0, kv_s1, kv_s2};
  bool ok = dtype == 1 && d <= kMmaMaxD && d % 8 == 0 && aligned16(q) &&
            aligned16(out) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 9; ++i) ok = ok && strides[i] % 8 == 0;
  return ok;
}

}  // namespace

extern "C" {

// 1 if flash_attention() runs these arguments on the tensor-core body, 0
// if on the CUDA cores.
int flash_attention_body(int dtype, const void* q, int64_t q_s0,
                         int64_t q_s1, int64_t q_s2, const void* out,
                         int64_t o_s0, int64_t o_s1, int64_t o_s2,
                         const void* k, const void* v, int64_t kv_s0,
                         int64_t kv_s1, int64_t kv_s2, int d) {
  return use_mma(dtype, q, q_s0, q_s1, q_s2, out, o_s0, o_s1, o_s2, k, v,
                 kv_s0, kv_s1, kv_s2, d) ? 1 : 0;
}

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
  if (use_mma(dtype, q, q_s0, q_s1, q_s2, out, o_s0, o_s1, o_s2, k, v, kv_s0,
              kv_s1, kv_s2, d)) {
    return (int)launch_mma_d(a, b, hq, s);
  }
  switch (dtype) {
    case 0:
      return (int)launch_simt_d<float>(a, b, hq, s);
    case 1:
      return (int)launch_simt_d<__nv_bfloat16>(a, b, hq, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
