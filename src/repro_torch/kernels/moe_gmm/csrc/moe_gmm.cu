// MoE grouped expert GEMM for Hopper (sm_90a): every expert product of the
// port's MoE layers.
//
// Replaces the Pallas TPU kernel grouped_matmul (pl.pallas_call at :78,
// body _gmm_kernel at :28) of src/repro/kernels/moe_gmm/moe_gmm.py, and
// computes what it computes.  For x (e, c, k), w (e, k, n) and optional
// counts (e,):
//
//   y[e] = x[e] @ w[e]        fp32 accumulator, y in out_dtype
//   y[e, r, :] = 0            for r >= counts[e] (every row live if null)
//
// A row tile lying wholly at or past counts[e] writes its zeros and skips
// its products, as the Pallas kernel's pl.when(live) does; inside a live
// tile, rows past the count may be multiplied and are zeroed at the store,
// as its _flush does.  counts is read in the kernel (no host sync, so a call
// can be captured in a CUDA graph).  Every sum runs in a fixed order (K
// steps in order, no split-K, no atomics), so repeated calls are bitwise
// equal and a row's result does not depend on what the other rows hold.
// Ragged c, k and n are handled here: nothing is padded by the caller.
//
// Bound, at olmoe-1b-7b's width (64 experts, d 2048, d_ff 1024).  The
// wrapper picks the body by shape, never by counts, content or a caught
// failure, and passes its code here:
//
// * wgmma (bf16, c > 64, TMA-aligned: k and n multiples of 8, positive row
//   and expert strides multiples of 8, 16-byte aligned bases).  A prefill
//   wave under dense dispatch (every expert multiplies all 16 x 1024
//   tokens) is bound by operations: 4.4 TFLOP a call, 4.45 ms at 989
//   TFLOP/s.  A persistent grid of 2-CTA clusters, one CTA an SM (as many
//   as cudaOccupancyMaxActiveClusters says the card holds).  A work unit is
//   (expert, 256-row tile, 256-column tile), expert-major with the column
//   tile fastest, so the units in flight share one x panel and one
//   expert's w (4 MB) in L2; cluster g of G takes units g, g + G, ...  Each
//   CTA takes 128 rows of a unit: one producer thread issues TMA loads of
//   its x box (128 x 64, K-major) and of half of w's 64 x 256 tile (N-major,
//   two of four 64-column boxes) multicast to both CTAs, into a ring of 4
//   stages with 128-byte swizzle (full / empty mbarriers); two consumer
//   warpgroups run wgmma m64n256k16 over 64 rows each with fp32
//   accumulators.  The tensor maps are rank 3, (k, c, e) and (n, k, e) with
//   a box depth of 1 on the expert axis, so a box's rows past c, its
//   columns past n and its K past k are zero-filled and never read the next
//   expert.  A unit at or past counts[e] loads nothing and writes zeros; a
//   CTA or warpgroup whose rows are all past the count skips its loads or
//   products.  The epilogue writes each warpgroup's tile into shared memory
//   (rows >= counts[e] as zeros) and TMA stores it (nothing past c or n);
//   the warpgroup goes on to the next unit while the stores drain and the
//   producer has already loaded its first stages.
// * decode (bf16, c <= 64, TMA-aligned).  A decode step (16 tokens) is bound
//   by w's bytes: 268 MB a projection, 0.080 ms at 3.35 TB/s.  One CTA an
//   (expert, 128-column tile), 512-1024 CTAs at olmoe, two an SM, so every
//   SM streams w with no K split; each CTA streams its w panel (rows of
//   256 bytes) and x's live rows through a 4-stage cp.async ring, and each
//   of its 4 warps owns 32 columns over the whole K range with mma.sync
//   m16n8k16 (m 16 fits one fragment row).  Each weight byte is read once
//   a call.
// * wmma (bf16 shapes that fail the alignment, e.g. n 130): 128 x 128 tiles,
//   a block each, masked loads, nvcuda::wmma 16x16x16 fragments.
// * cuda_cores (fp32 inputs): 64 x 64 tiles, K steps of 16, a 4 x 4 register
//   tile per thread, fma on the CUDA cores (no TF32).
//
// Not done here: fusing wg/wu with the SiLU gate, skipping dense dispatch's
// zero rows or fusing its mask into the x loads (dispatch changes), and a
// tensor-core fp32 body.

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the
                    // runtime's driver entry point, so no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// Body codes, as the wrapper passes them.
enum Body { kCudaCores = 0, kWmma = 1, kWgmma = 2, kDecode = 3 };

constexpr int kThreads = 256;   // wmma and cuda_cores bodies

// wmma body: 128 x 128 tiles, K steps of 32.
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWM = 64, kWN = 32;            // a warp's sub-tile (2 x 4 warps)
constexpr int kFM = kWM / 16, kFN = kWN / 16;
constexpr int kAS = kBK + 8;                 // smem row stride of x (bf16)
constexpr int kBS = kBN + 8;                 // smem row stride of w (bf16)
constexpr int kCS = 16 + 4;                  // epilogue scratch row stride

// fp32 CUDA-core tiles.
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

// wgmma body: 128 x 256 CTA tiles, 64-deep stages, 4 of them; clusters of
// 2 CTAs on vertically adjacent row tiles of one expert share w's tiles.
constexpr int kGBM = 128, kGBN = 256, kGBK = 64, kGStages = 4;
constexpr int kGCluster = 2;
constexpr int kGThreads = 384;               // producer + 2 consumer groups
constexpr int kGABytes = kGBM * kGBK * 2;    // 16 KB: x's 128 x 64 box
constexpr int kGBChunk = kGBK * 64 * 2;      // 8 KB: one 64 x 64 box of w
constexpr int kGBBytes = kGBChunk * (kGBN / 64);
constexpr int kGStageBytes = kGABytes + kGBBytes;
// The epilogue passes each warpgroup's 64 x 256 tile to TMA stores through
// shared memory, kGEpiRow bytes of each row at a time: kGEpiRow / 128 boxes
// of 64 x 128 bytes of y, 128-byte swizzled.
constexpr int kGEpiBox = 64 * 128, kGEpiRow = 256;
constexpr int kGEpiBytes = 2 * 64 * kGEpiRow;
constexpr int kGSmem =
    1024 + kGStages * kGStageBytes + kGEpiBytes + 2 * kGStages * 8;

// decode body: 128-column tiles, 64-deep stages in a ring of 4, 4 warps.
constexpr int kDBN = 128, kDBK = 64, kDStages = 4, kDThreads = 128;
constexpr int kDXS = kDBK + 8, kDWS = kDBN + 8;   // smem row strides (bf16)

struct Args {
  const void* x;                   // (e, c, k), k contiguous
  int64_t x_se, x_sc;
  const void* w;                   // (e, k, n), n contiguous
  int64_t w_se, w_sk;
  const int* counts;               // (e,) or null
  void* y;                         // (e, c, n) contiguous
  int e, c, k, n;
  int body, ctas;                  // the body's code; wgmma: the grid
  int tm, tn;                      // wgmma, decode: row and column tiles
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Rows of expert ie that are live (0..c).
__device__ __forceinline__ int live_rows(const Args& a, int ie) {
  return a.counts != nullptr ? max(0, min(a.c, a.counts[ie])) : a.c;
}

// A dead row tile: write its zeros and return.
template <typename TOut>
__device__ void zero_tile(TOut* y, const Args& a, int m0, int n0, int bm,
                          int bn) {
  const int rows = min(bm, a.c - m0), cols = min(bn, a.n - n0);
  for (int i = threadIdx.x; i < rows * bn; i += kThreads) {
    const int r = i / bn, cc = i % bn;
    if (cc < cols) y[(int64_t)(m0 + r) * a.n + n0 + cc] = from_f<TOut>(0.f);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const int bytes = ok ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wmma body (bf16 shapes that fail the alignment): masked loads, wmma.
// ---------------------------------------------------------------------------

template <typename TOut>
__global__ void __launch_bounds__(kThreads) gmm_wmma_kernel(Args a) {
  __shared__ __align__(128) bf16 As[kBM * kAS];
  __shared__ __align__(128) bf16 Bs[kBK * kBS];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * kCS];

  const int ie = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int live = live_rows(a, ie);
  TOut* y = static_cast<TOut*>(a.y) + (int64_t)ie * a.c * a.n;
  if (m0 >= live) {
    zero_tile(y, a, m0, n0, kBM, kBN);
    return;
  }
  const bf16* x = static_cast<const bf16*>(a.x) + ie * a.x_se;
  const bf16* w = static_cast<const bf16*>(a.w) + ie * a.w_se;
  const int rows = min(kBM, live - m0);   // live rows of this tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < a.k; k0 += kBK) {
    // Stage the K step: x rows past the live count and anything past k or
    // n are zeros.
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      As[r * kAS + cc] = (r < rows && k0 + cc < a.k)
                             ? x[(m0 + r) * a.x_sc + k0 + cc] : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, cc = i % kBN;
      Bs[r * kBS + cc] = (k0 + r < a.k && n0 + cc < a.n)
                             ? w[(k0 + r) * a.w_sk + n0 + cc] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bf[kFN];
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk * kBS + wn * kWN + j * 16], kBS);
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        if (wm * kWM + i * 16 >= rows) continue;   // warp-uniform
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, &As[(wm * kWM + i * 16) * kAS + kk], kAS);
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: each fragment through the warp's scratch, rows past the live
  // count written as zeros, nothing past c or n.
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], kCS, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * kWM + i * 16, c0 = n0 + wn * kWN + j * 16;
      for (int t = lane; t < 256; t += 32) {
        const int r = r0 + t / 16, cc = c0 + t % 16;
        if (r < a.c && cc < a.n)
          y[(int64_t)r * a.n + cc] =
              from_f<TOut>(r < live ? cs[(t / 16) * kCS + t % 16] : 0.f);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: fma on the CUDA cores.
// ---------------------------------------------------------------------------

template <typename TOut>
__global__ void __launch_bounds__(kThreads) gmm_f32(Args a) {
  __shared__ __align__(16) float As[kFBK][kFBM + 4];   // x tile, transposed
  __shared__ __align__(16) float Bs[kFBK][kFBN + 4];

  const int ie = blockIdx.z;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const int live = live_rows(a, ie);
  TOut* y = static_cast<TOut*>(a.y) + (int64_t)ie * a.c * a.n;
  if (m0 >= live) {
    zero_tile(y, a, m0, n0, kFBM, kFBN);
    return;
  }
  const float* x = static_cast<const float*>(a.x) + ie * a.x_se;
  const float* w = static_cast<const float*>(a.w) + ie * a.w_se;
  const int rows = min(kFBM, live - m0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.k; k0 += kFBK) {
    for (int i = threadIdx.x; i < kFBM * kFBK; i += kThreads) {
      const int r = i / kFBK, cc = i % kFBK;
      As[cc][r] = (r < rows && k0 + cc < a.k) ? x[(m0 + r) * a.x_sc + k0 + cc]
                                               : 0.f;
    }
    for (int i = threadIdx.x; i < kFBK * kFBN; i += kThreads) {
      const int r = i / kFBN, cc = i % kFBN;
      Bs[r][cc] = (k0 + r < a.k && n0 + cc < a.n)
                      ? w[(k0 + r) * a.w_sk + n0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= a.c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = n0 + tx * 4 + j;
      if (cc < a.n)
        y[(int64_t)r * a.n + cc] = from_f<TOut>(r < live ? acc[i][j] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma body: TMA producer, two wgmma consumer warpgroups, persistent.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Box (c0, c1, c2) of a rank-3 tensor map into this CTA's shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The same box into the same shared-memory offset of every CTA in
// cta_mask, each CTA's mbarrier at bar's offset told of its bytes.
__device__ __forceinline__ void tma_load_3d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, int c2,
                                                      uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(cta_mask),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Box (c0, c1, c2) of a rank-3 tensor map from this CTA's shared memory,
// in the thread's bulk group; nothing past the map's edges is written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until the thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Wait until the thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Order this thread's shared-memory writes before later async-proxy reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrive on the mbarrier at bar's offset in cluster CTA `cta`.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// Every thread of the cluster arrives and waits.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" :::
          "memory");
}

// A consumer warpgroup is done with a ring stage: tell both producers.
__device__ __forceinline__ void release_stage(uint64_t* bar, int rank) {
  mbar_arrive(bar);
  mbar_arrive_remote(bar, rank ^ 1);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across a wait.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 128 accumulator operands of one m64n256k16 product.
#define WGMMA_D_LIST \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"
#define WGMMA_D_OPERANDS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 256, fp32) += a (64 x 16, K-major) * b (16 x 256, N-major).
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      WGMMA_D_LIST
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : WGMMA_D_OPERANDS
      : "l"(da), "l"(db), "r"(1));
}

// Work unit u: expert ie, cluster row tile ti (256 rows), column tile tj
// (256 columns); expert-major, the column tile fastest.
__device__ __forceinline__ void unit_of(const Args& a, int u, int& ie, int& ti,
                                        int& tj) {
  const int per = a.tm * a.tn;
  ie = u / per;
  const int r = u - ie * per;
  ti = r / a.tn;
  tj = r - ti * a.tn;
}

// Columns col, col + 1 of row `row` of a 64 x 128-byte box of TOut with
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)).
template <typename TOut>
__device__ __forceinline__ void put2(uint8_t* box, int row, int col, float a,
                                     float b) {
  const int byte = col * (int)sizeof(TOut);
  store2(reinterpret_cast<TOut*>(
             box + row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) |
                                (byte & 15))),
         a, b);
}

template <typename TOut>
__global__ void __launch_bounds__(kGThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_x,
                     const __grid_constant__ CUtensorMap tma_w,
                     const __grid_constant__ CUtensorMap tma_y, Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* epi = smem + kGStages * kGStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGStages * kGStageBytes +
                                               kGEpiBytes);
  uint64_t* empty = full + kGStages;
  const int rank = (int)cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);      // the producer's expect_tx
      // One arrival per consumer warpgroup of both CTAs: the peer writes
      // half of w into this stage too.
      mbar_init(&empty[s], 2 * kGCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();              // both CTAs' barriers are initialized
  const int units = a.e * a.tm * a.tn;
  const int cid = blockIdx.x / kGCluster, clusters = gridDim.x / kGCluster;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // Producer warpgroup: one thread issues every TMA load; this CTA's x
    // box, and half of w's boxes multicast to both CTAs of the cluster.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int u = cid; u < units; u += clusters) {
        int ie, ti, tj;
        unit_of(a, u, ie, ti, tj);
        const int live = live_rows(a, ie);
        if (ti * kGBM * kGCluster >= live) continue;   // dead: no loads
        const int m0 = ti * kGBM * kGCluster + rank * kGBM, n0 = tj * kGBN;
        const int nb = min(kGBN / 64, cdiv(a.n - n0, 64));  // boxes inside n
        const bool rows = m0 < live;   // else x is all dead here: not loaded
        const uint32_t bytes = (rows ? kGABytes : 0) + nb * kGBChunk;
        for (int k0 = 0; k0 < a.k; k0 += kGBK) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], bytes);
          uint8_t* sa = smem + stage * kGStageBytes;
          if (rows) tma_load_3d(sa, &tma_x, &full[stage], k0, m0, ie);
          for (int j = rank; j < nb; j += kGCluster)
            tma_load_3d_multicast(sa + kGABytes + j * kGBChunk, &tma_w,
                                  &full[stage], n0 + 64 * j, k0, ie,
                                  (1 << kGCluster) - 1);
          if (++stage == kGStages) { stage = 0; phase ^= 1; }
        }
      }
    }
    cluster_sync_all();            // no CTA leaves while its peer writes
    return;
  }

  // Consumer warpgroups 1 and 2: rows 64 (wg - 1) ... of the CTA tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ctid = threadIdx.x - 128;          // 0 ... 255
  const int row0 = (wg - 1) * 64;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool signal = threadIdx.x % 128 == 0;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[128];
  int stage = 0, phase = 0;
  for (int u = cid; u < units; u += clusters) {
    int ie, ti, tj;
    unit_of(a, u, ie, ti, tj);
    const int live = live_rows(a, ie);
    const int m0 = ti * kGBM * kGCluster + rank * kGBM, n0 = tj * kGBN;
    if (ti * kGBM * kGCluster >= live) {
      // A dead unit: its zeros (n is a multiple of 8), no products.
      TOut* y = static_cast<TOut*>(a.y) + (int64_t)ie * a.c * a.n;
      const int rows = min(kGBM, a.c - m0), q = min(kGBN, a.n - n0) / 4;
      for (int i = ctid; i < rows * q; i += 256)
        store4(y + (int64_t)(m0 + i / q) * a.n + n0 + (i % q) * 4, zero4);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    if (m0 + row0 < live) {
      int prev = -1;
      for (int k0 = 0; k0 < a.k; k0 += kGBK) {
        mbar_wait(&full[stage], phase);
        const uint8_t* sa = smem + stage * kGStageBytes;
        const uint8_t* sb = sa + kGABytes;
        wgmma_fence();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < kGBK / 16; ++kk) {
          // x: K-major rows of 128 bytes, 8-row groups 1 KB apart; a k16
          // step moves 32 bytes along the swizzled row.  w: N-major, 64-
          // column atoms 8 KB apart (leading), 8-row K groups 1 KB apart
          // (stride); a k16 step moves 16 rows, 2 KB.
          wgmma_m64n256k16(acc,
                           sw128_desc(sa + row0 * 128 + kk * 32, 16, 1024),
                           sw128_desc(sb + kk * 2048, kGBChunk, 1024));
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();           // the previous stage's products are done
        fence_acc(acc);
        if (prev >= 0 && signal) release_stage(&empty[prev], rank);
        prev = stage;
        if (++stage == kGStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0 && signal) release_stage(&empty[prev], rank);
    } else {
      // Every row of this warpgroup is dead: pass the stages on unread.
      for (int k0 = 0; k0 < a.k; k0 += kGBK) {
        mbar_wait(&full[stage], phase);
        if (signal) release_stage(&empty[stage], rank);
        if (++stage == kGStages) { stage = 0; phase ^= 1; }
      }
    }

    // Epilogue.  Element (row, col) of the warpgroup's 64 x 256 tile is
    // acc[4 (col / 8) + 2 (row / 8 % 2) + col % 2] of lane 4 (row % 8) +
    // col % 8 / 2 in warp row / 16.  kGEpiRow bytes of each row at a time
    // (PC columns, NB boxes of BC) go into the warpgroup's boxes, rows at or
    // past the live count as zeros; one thread then stores the boxes with
    // TMA (which writes nothing past c or n) and the warpgroup goes on to
    // the next unit while the stores drain.  Before a box is written
    // again, that thread waits until the last stores have read it.
    constexpr int PC = kGEpiRow / (int)sizeof(TOut);
    constexpr int BC = 128 / (int)sizeof(TOut), NB = kGEpiRow / 128;
    const int er = warp * 16 + lane / 4, ec = (lane % 4) * 2;
    const int ebar = 1 + wg;                     // named barriers 2, 3
    uint8_t* ebox = epi + (wg - 1) * 64 * kGEpiRow;
    const bool lo = m0 + row0 + er < live, hi = m0 + row0 + er + 8 < live;
#pragma unroll
    for (int p = 0; p < kGBN / PC; ++p) {
      if (signal) bulk_wait_read();
      bar_sync(ebar, 128);
#pragma unroll
      for (int jj = 0; jj < PC / 8; ++jj) {
        const int j = p * (PC / 8) + jj, lc = jj * 8 + ec;
        uint8_t* box = ebox + (lc / BC) * kGEpiBox;
        put2<TOut>(box, er, lc % BC, lo ? acc[4 * j] : 0.f,
                   lo ? acc[4 * j + 1] : 0.f);
        put2<TOut>(box, er + 8, lc % BC, hi ? acc[4 * j + 2] : 0.f,
                   hi ? acc[4 * j + 3] : 0.f);
      }
      fence_proxy_async();
      bar_sync(ebar, 128);
      if (signal && m0 + row0 < a.c) {
        for (int bx = 0; bx < NB; ++bx) {
          const int col = n0 + p * PC + bx * BC;
          if (col < a.n)
            tma_store_3d(&tma_y, ebox + bx * kGEpiBox, col, m0 + row0, ie);
        }
        bulk_commit();
      }
    }
  }
  if (signal) bulk_wait();
  cluster_sync_all();
}

// ---------------------------------------------------------------------------
// decode body: an (expert, 128-column tile) a CTA, w streamed, mma.sync.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

// MF 16-row fragments hold the rows (c <= 16 MF).
template <int MF>
struct Decode {
  static constexpr int kXElems = 16 * MF * kDXS;
  static constexpr int kStageElems = kXElems + kDBK * kDWS;
  static constexpr int kSmem = kDStages * kStageElems * 2;
};

template <int MF, typename TOut>
__global__ void __launch_bounds__(kDThreads) gmm_decode_kernel(Args a) {
  using D = Decode<MF>;
  extern __shared__ __align__(128) uint8_t smem_dec[];
  bf16* ring = reinterpret_cast<bf16*>(smem_dec);
  const int ie = blockIdx.x / a.tn;
  const int n0 = (blockIdx.x - ie * a.tn) * kDBN;
  const int live = live_rows(a, ie);
  const bf16* x = static_cast<const bf16*>(a.x) + ie * a.x_se;
  const bf16* w = static_cast<const bf16*>(a.w) + ie * a.w_se;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // A dead expert (its one row tile at or past the count) skips the K loop
  // and writes zeros.
  const int nk = live > 0 ? cdiv(a.k, kDBK) : 0;

  // Stage K chunk i into ring stage st: x rows past the live count and
  // anything past k or n are zeros.
  auto load = [&](int i, int st) {
    bf16* sx = ring + st * D::kStageElems;
    bf16* sw = sx + D::kXElems;
    const int k0 = i * kDBK;
    for (int v = threadIdx.x; v < 16 * MF * (kDBK / 8); v += kDThreads) {
      const int r = v / (kDBK / 8), c8 = (v % (kDBK / 8)) * 8;
      const bool ok = r < live && k0 + c8 < a.k;
      cp_async16(sx + r * kDXS + c8, ok ? x + r * a.x_sc + k0 + c8 : x, ok);
    }
    for (int v = threadIdx.x; v < kDBK * (kDBN / 8); v += kDThreads) {
      const int r = v / (kDBN / 8), c8 = (v % (kDBN / 8)) * 8;
      const bool ok = k0 + r < a.k && n0 + c8 < a.n;
      cp_async16(sw + r * kDWS + c8,
                 ok ? w + (k0 + r) * a.w_sk + n0 + c8 : w, ok);
    }
  };

  // Warp `warp` owns WN columns, n0 + WN warp ..., over the whole K range:
  // NF 8-column fragments.
  constexpr int WN = kDBN / 4, NF = WN / 8;
  float acc[MF][NF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kDStages - 1; ++i) {
    if (i < nk) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();               // stage i is in; stage i - 1 is free
    const int next = i + kDStages - 1;
    if (next < nk) load(next, next % kDStages);
    cp_async_commit();
    const bf16* sx = ring + (i % kDStages) * D::kStageElems;
    const bf16* sw = sx + D::kXElems;
#pragma unroll
    for (int kk = 0; kk < kDBK; kk += 16) {
      uint32_t bfr[NF / 2][4];
#pragma unroll
      for (int jn = 0; jn < NF / 2; ++jn)
        ldsm_x4_trans(bfr[jn],
                      sw + (kk + ((lane / 8) & 1) * 8 + lane % 8) * kDWS +
                          warp * WN + jn * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        if (mf * 16 >= live) break;              // block-uniform
        uint32_t af[4];
        ldsm_x4(af, sx + (mf * 16 + lane % 16) * kDXS + kk + (lane / 16) * 8);
#pragma unroll
        for (int jn = 0; jn < NF / 2; ++jn) {
          mma_bf16(acc[mf][2 * jn], af, bfr[jn][0], bfr[jn][1]);
          mma_bf16(acc[mf][2 * jn + 1], af, bfr[jn][2], bfr[jn][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Element (row, col) of a 16 x 8 fragment is acc[2 (row / 8) + col % 2]
  // of lane 4 (row % 8) + col / 2; rows at or past the live count are
  // written as zeros, nothing past c or n.
  TOut* y = static_cast<TOut*>(a.y) + (int64_t)ie * a.c * a.n;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mf * 16 + lane / 4 + 8 * h;
        const int cc = n0 + warp * WN + j * 8 + (lane % 4) * 2;
        if (r < a.c && cc < a.n) {
          const bool on = r < live;
          store2(y + (int64_t)r * a.n + cc, on ? acc[mf][j][2 * h] : 0.f,
                 on ? acc[mf][j][2 * h + 1] : 0.f);
        }
      }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cuTensorMapEncodeTiled, from the runtime's driver entry point.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A rank-3 tensor map of T, (experts, outer, inner) elements with row
// stride ld and expert stride se, boxes of 1 x box_outer x 128 bytes (one
// 128-byte swizzle row), zeros past every edge on loads and nothing
// written past them on stores.
template <typename T>
bool make_map3(CUtensorMap* map, const void* base, int64_t inner,
               int64_t outer, int64_t ld, int64_t experts, int64_t se,
               uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int64_t es = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)experts};
  const cuuint64_t strides[2] = {(cuuint64_t)(ld * es), (cuuint64_t)(se * es)};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), box_outer, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// A launch of `ctas` CTAs in clusters of `cluster`, its one attribute in
// *attr.
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int ctas,
                                  int threads, int smem, int cluster,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TOut>
cudaError_t launch_wgmma(const Args& a, cudaStream_t s) {
  CUtensorMap tx, tw, ty;
  if (!make_map3<bf16>(&tx, a.x, a.k, a.c, a.x_sc, a.e, a.x_se, kGBM) ||
      !make_map3<bf16>(&tw, a.w, a.n, a.k, a.w_sk, a.e, a.w_se, kGBK) ||
      !make_map3<TOut>(&ty, a.y, a.n, a.c, a.n, a.e, (int64_t)a.c * a.n, 64))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(gmm_wgmma_kernel<TOut>, kGSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      cluster_config(&cluster, a.ctas, kGThreads, kGSmem, kGCluster, s);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, gmm_wgmma_kernel<TOut>, tx, tw, ty, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MF, typename TOut>
cudaError_t launch_decode_t(const Args& a, cudaStream_t s) {
  static const cudaError_t attr =
      allow_smem(gmm_decode_kernel<MF, TOut>, Decode<MF>::kSmem);
  if (attr != cudaSuccess) return attr;
  gmm_decode_kernel<MF, TOut>
      <<<a.e * a.tn, kDThreads, Decode<MF>::kSmem, s>>>(a);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_decode(const Args& a, cudaStream_t s) {
  if (a.c <= 16) return launch_decode_t<1, TOut>(a, s);
  if (a.c <= 32) return launch_decode_t<2, TOut>(a, s);
  return launch_decode_t<4, TOut>(a, s);
}

template <typename TOut>
cudaError_t launch(int in_dtype, const Args& a, cudaStream_t s) {
  if (in_dtype == 0) {
    const dim3 grid((a.n + kFBN - 1) / kFBN, (a.c + kFBM - 1) / kFBM, a.e);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_f32<TOut><<<grid, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (a.body == kWgmma) return launch_wgmma<TOut>(a, s);
  if (a.body == kDecode) return launch_decode<TOut>(a, s);
  const dim3 grid((a.n + kBN - 1) / kBN, (a.c + kBM - 1) / kBM, a.e);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gmm_wmma_kernel<TOut><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16 (w has x's dtype).
// x (e, c, k) and w (e, k, n) by their two leading strides (last axis
// contiguous); counts (e,) int32 or null; y (e, c, n) contiguous.  body:
// 0 cuda_cores (fp32), 1 wmma, 2 wgmma (ctas: the persistent grid, a
// multiple of 2), 3 decode (c <= 64); wgmma and decode need k and n
// multiples of 8, positive strides multiples of 8 and 16-byte aligned
// bases (wgmma: y's too).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a body the shape does not allow.
int moe_gmm(int in_dtype, int out_dtype, const void* x, int64_t x_se,
            int64_t x_sc, const void* w, int64_t w_se, int64_t w_sk,
            const int* counts, void* y, int e, int c, int k, int n, int body,
            int ctas, void* stream) {
  const bool tma = k % 8 == 0 && n % 8 == 0 && x_se > 0 && x_se % 8 == 0 &&
                   x_sc > 0 && x_sc % 8 == 0 && w_se > 0 && w_se % 8 == 0 &&
                   w_sk > 0 && w_sk % 8 == 0 && aligned16(x) && aligned16(w);
  bool ok = e >= 1 && e <= 65535 && c >= 1 && k >= 1 && n >= 1 &&
            in_dtype >= 0 && in_dtype <= 1 && out_dtype >= 0 &&
            out_dtype <= 1 && (body == kCudaCores) == (in_dtype == 0) &&
            body >= 0 && body <= kDecode;
  if (body == kWgmma)
    ok = ok && tma && aligned16(y) && ctas >= kGCluster &&
         ctas % kGCluster == 0;
  if (body == kDecode) ok = ok && tma && c <= 16 * 4;
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a{x, x_se, x_sc, w, w_se, w_sk, counts, y, e, c, k, n, body, ctas,
         1, 1};
  if (body == kWgmma) {
    a.tm = (c + kGBM * kGCluster - 1) / (kGBM * kGCluster);
    a.tn = (n + kGBN - 1) / kGBN;
  } else if (body == kDecode) {
    a.tn = (n + kDBN - 1) / kDBN;
  }
  if ((int64_t)a.e * a.tm * a.tn > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? (int)launch<float>(in_dtype, a, s)
                        : (int)launch<bf16>(in_dtype, a, s);
}

// The most CTAs of the wgmma body that the current device holds at once:
// 2 x cudaOccupancyMaxActiveClusters (its clusters need 2 SMs of one GPC
// each), or a negative CUDA error.
int moe_gmm_wgmma_ctas() {
  const cudaError_t attr = allow_smem(gmm_wgmma_kernel<bf16>, kGSmem);
  if (attr != cudaSuccess) return -(int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(
      &cluster, kGCluster, kGThreads, kGSmem, kGCluster, nullptr);
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, gmm_wgmma_kernel<bf16>, &cfg);
  return e != cudaSuccess ? -(int)e : kGCluster * clusters;
}

}  // extern "C"
