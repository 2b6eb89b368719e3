// Policy-planned blocked GEMM for Hopper (sm_90a): both schedules of the
// port's planned matmul (repro_torch.kernels.matmul.ops.matmul).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/matmul/matmul.py:
// matmul's _mm_kernel (:126; output RESIDENT_ACCUM: an fp32 accumulator
// over the k loop, each output tile written once, grid order mnk or nmk)
// and its inline split-K kern (:98; output STREAM: split_k ranges of K,
// each writing an fp32 partial through to memory, summed and cast by the
// caller).  For a (m, k) and b (k, n), row-major with unit column stride:
//
//   c = a @ b                       fp32 accumulator, c in out_dtype
//   c = sum_s a[:, K_s] @ b[K_s, :] split s of `splits` an fp32 partial in
//                                   part (splits, m, n), c in out_dtype
//
// with K_s = [s * ks, min(k, (s + 1) * ks)); the accumulating schedule is
// splits 1, ks = k.  The caller computes ks and splits as the reference
// does on K padded to a multiple of bk, so every split has the same K range
// as the Pallas kernel's.
//
// Bound, at yi-9b's layer GEMMs (d 4096, d_ff 11008): a 16 x 1024 prefill
// wave (m 16384) is bound by operations (0.55 TFLOP for q, 0.556 ms at
// 989 TFLOP/s); a decode step and the LM head (m 16) by the weight bytes
// (33.6 MB for q, 0.010 ms at 3.35 TB/s; 537 MB for the LM head, 0.161 ms).
// The wrapper picks a body by shape and passes it here; it is never chosen
// by catching a failure:
//
// * wgmma (bf16, m > 64, TMA-aligned): the operations bound.  A persistent
//   grid of 2-CTA clusters, one CTA an SM (as many clusters as the card
//   holds at once, cudaOccupancyMaxActiveClusters; the SMs come from the
//   device, not a constant).  A cluster takes a 256 x 256 tile, each CTA
//   128 rows of it.  In each CTA one producer thread issues TMA loads of
//   its a tile (128 x 64, K-major) and of half of b's 64 x 256 tile (N-
//   major, two of its four 64-column boxes), multicast to both CTAs, so
//   the pair reads each b tile from L2 once; a ring of 4 stages with
//   128-byte swizzle, each stage signalled by a full mbarrier (the bytes of
//   both CTAs' copies) and an empty one (both CTAs' consumers).  Two
//   consumer warpgroups (setmaxnreg moves registers to them) each run
//   wgmma.mma_async m64n256k16 over 64 rows with fp32 accumulators.  b is
//   read N-major, so its shared-memory descriptor is the transposed
//   (MN-major) one: 64-column atoms 8 KB apart (the leading offset) and
//   8-row K groups 1 KB apart (the stride offset).  The epilogue passes
//   32-column slabs of the accumulators through shared memory, so that its
//   global stores are row-contiguous, while the producer already loads the
//   next tile's stages.  TMA zero-fills past ragged m and k; stores past m
//   and n are masked.
// * small_m (bf16, m <= 64, 16-byte aligned): the bytes bound, where the
//   fault is CTA count (a 128 x 128 tile grid gives 8-86 CTAs for 132 SMs).
//   Narrow n tiles (32, 64 or 128 columns, so rows of b stay whole 32-byte
//   sectors) and a split of each tile's K range over a thread-block cluster
//   of up to 8 CTAs, chosen so that every decode shape of chip_smoke.py
//   puts at least 132 CTAs to streaming b.  Each CTA streams its K slice of
//   b through a cp.async ring; 4 warps take the 4 k16 steps of a 64-deep
//   stage with mma.sync m16n8k16 (m 16 fits one fragment row).  The warps'
//   partials are summed in warp order in shared memory, then each rank sums
//   its rows of the tile over the cluster's ranks in rank order through
//   distributed shared memory and writes them once.
// * cp_async / masked (bf16, shapes that fail the alignment above): the
//   grid of (128 x 128 CTA tiles, splits) with nvcuda::wmma 16x16x16
//   fragments; 16-byte cp.async into two buffers when k, n, the row strides
//   and ks are multiples of 8 and the bases 16-byte aligned (wgmma also
//   needs ks a multiple of 64 when split), else masked scalar loads.
// * cuda_cores (fp32 inputs): 64 x 64 tiles, K steps of 16, fma on the CUDA
//   cores (no TF32), the same grid.
//
// How each knob of the plan reads on the card:
// * order is the raster in which output tiles are taken: row-major (mnk,
//   the rinse order) or column-major (nmk).  raster() maps a linear tile
//   index to a tile (wgmma: a 256 x 256 cluster tile).  The persistent
//   cluster c of G takes indices c, c + G, c + 2G, ..., so the G tiles in
//   flight are consecutive in the raster; the other bodies rely on blocks
//   being dispatched in index order.
// * the plan's bm x bn (up to 512 x 512 under the H100 model, far beyond
//   one CTA's 227 KB of shared memory) is the L2 window: the group of the
//   body's tiles (win_m x win_n of them) that the raster finishes before it
//   moves to the next window, windows and the tiles inside one both in the
//   plan's order.  It decides which a and b panels share the L2.
// * bk is the split granule (it sets ks).
// * split-K: work units are (split, tile), split-major, so each split is a
//   pass over the tiles in the raster above, the window holding one K range
//   of each panel at a time.  Each unit writes its fp32 partial through to
//   `part`, as the STREAM policy means; then the last unit to finish a
//   tile, found by a per-tile ticket (an atomic count, zeroed on the stream
//   before the launch), adds the tile's partials in split order 0 ... S-1,
//   casts and writes out_dtype.  No host sync, no second kernel, no torch
//   op on the partials; the call stays capturable in a CUDA graph.
// Every sum runs in a fixed order (K steps in order, warps and cluster
// ranks in order, splits in order) with no float atomics, so mnk and nmk
// give bitwise equal results, and so do repeated calls.
//
// Still left: the fp32 body is CUDA-core fma (no TF32 by contract) at
// about 2.2x torch.matmul; split-K's partial traffic is not overlapped with
// the products (both consumer warpgroups run the epilogue together); the
// grouped GEMM (moe_gmm.cu) does not share this kernel, and fusing its
// wg/wu products with the SiLU gate is its own redesign.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the
                    // runtime's driver entry point, so no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;
using bf16 = __nv_bfloat16;

// Body codes, as the wrapper passes them.
enum Body { kCudaCores = 0, kMasked = 1, kCpAsync = 2, kWgmma = 3,
            kSmallM = 4 };

constexpr int kThreads = 256;   // cp_async, masked and cuda_cores bodies

// wmma bodies (cp_async, masked): 128 x 128 tiles, K steps of 32.
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWM = 64, kWN = 32;            // a warp's sub-tile (2 x 4 warps)
constexpr int kFM = kWM / 16, kFN = kWN / 16;
constexpr int kAS = kBK + 8;                 // smem row stride of a (bf16)
constexpr int kBS = kBN + 8;                 // smem row stride of b (bf16)
constexpr int kCS = 16 + 4;                  // epilogue scratch row stride

// fp32 CUDA-core tiles.
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

// wgmma body: 128 x 256 CTA tiles, 64-deep stages, 4 of them; clusters of
// 2 CTAs on vertically adjacent tiles (a 256 x 256 cluster tile) share b.
constexpr int kGBM = 128, kGBN = 256, kGBK = 64, kGStages = 4;
constexpr int kGCluster = 2;
constexpr int kGThreads = 384;               // producer + 2 consumer groups
constexpr int kGABytes = kGBM * kGBK * 2;    // 16 KB: a's 128 x 64 box
constexpr int kGBChunk = kGBK * 64 * 2;      // 8 KB: one 64 x 64 box of b
constexpr int kGBBytes = kGBChunk * (kGBN / 64);
constexpr int kGStageBytes = kGABytes + kGBBytes;
// The epilogue stages 32 columns of each warpgroup's 64 x 256 fp32 tile at
// a time in shared memory, so that its global stores are row-contiguous.
constexpr int kGEpiCols = 32, kGEpiStride = kGEpiCols + 4;   // floats
constexpr int kGEpiBytes = 2 * 64 * kGEpiStride * 4;
constexpr int kGSmem = 1024 + kGStages * kGStageBytes + kGEpiBytes +
                       2 * kGStages * 8 + 16;

// small_m body: 64-deep stages, 4 warps.
constexpr int kSK = 64;
constexpr int kSThreads = 128;
constexpr int kRingBudget = 49152;           // bytes of cp.async ring

struct Args {
  const void* a;                   // (m, k), row stride lda
  int64_t lda;
  const void* b;                   // (k, n), row stride ldb
  int64_t ldb;
  void* c;                         // (m, n) contiguous, out_dtype
  float* part;                     // (splits, m, n) fp32 partials
  int* tickets;                    // per tile x cluster rank, zeroed
  int m, k, n;
  int ks, splits;                  // K elements per split, split count
  int tm, tn;                      // the body's tiles along m and n
  int win_m, win_n;                // L2 window, in those tiles
  int col_major;                   // raster: 0 row-major (mnk), 1 nmk
  int ck;                          // CTAs of a cluster (1 without)
  int kslice;                      // small_m: K elements a rank sums
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
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

// The output tile (ti, tj) of linear tile index L: windows of win_m x
// win_n tiles in the raster order, the tiles inside a window in the same
// order; windows on the bottom and right edges are cut to fit.
__device__ __forceinline__ void raster(const Args& a, int L, int& ti,
                                       int& tj) {
  const int wm = a.win_m, wn = a.win_n;
  if (!a.col_major) {
    const int r = L / (wm * a.tn);
    int rem = L - r * wm * a.tn;
    const int h = min(wm, a.tm - r * wm);
    const int c = rem / (h * wn);
    rem -= c * h * wn;
    const int w = min(wn, a.tn - c * wn);
    ti = r * wm + rem / w;
    tj = c * wn + rem % w;
  } else {
    const int c = L / (wn * a.tm);
    int rem = L - c * wn * a.tm;
    const int w = min(wn, a.tn - c * wn);
    const int r = rem / (w * wm);
    rem -= r * w * wm;
    const int h = min(wm, a.tm - r * wm);
    ti = r * wm + rem % h;
    tj = c * wn + rem / h;
  }
}

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// The split ticket, taken by `nthr` threads (index tid, named barrier
// `bar`) once each has written its share of this unit's fp32 partial:
// true for the last of the p.splits units of ticket `ticket`, which then
// sums the partials.  The barrier and thread 0's fences order every
// thread's partial before the count (release) and the count before the
// last unit's reads of the others' partials (acquire).
__device__ __forceinline__ bool take_ticket(const Args& p, int ticket,
                                            int tid, int nthr, int bar,
                                            int* flag) {
  bar_sync(bar, nthr);
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(p.tickets + ticket, 1) == p.splits - 1;
    __threadfence();
  }
  bar_sync(bar, nthr);
  return *flag;
}

// The last unit's sum of rows [r0, r0 + rows) x columns [c0, c0 + cols) of
// every split's partial, in split order 0 ... S-1, written to c in TOut.
template <typename TOut>
__device__ void split_sum(const Args& p, int r0, int rows, int c0, int cols,
                          int tid, int nthr) {
  const int64_t plane = (int64_t)p.m * p.n;
  TOut* c = static_cast<TOut*>(p.c);
  if (rows <= 0 || cols <= 0) return;
  if ((cols & 3) == 0 && (c0 & 3) == 0 && (p.n & 3) == 0) {
    const int q = cols / 4;
    for (int e = tid; e < rows * q; e += nthr) {
      const int64_t off = (int64_t)(r0 + e / q) * p.n + c0 + (e % q) * 4;
      float4 acc = __ldcg(reinterpret_cast<const float4*>(p.part + off));
      for (int s = 1; s < p.splits; ++s) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(p.part + s * plane + off));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      store4(c + off, acc);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthr) {
      const int64_t off = (int64_t)(r0 + e / cols) * p.n + c0 + e % cols;
      float acc = __ldcg(p.part + off);
      for (int s = 1; s < p.splits; ++s)
        acc += __ldcg(p.part + s * plane + off);
      c[off] = from_f<TOut>(acc);
    }
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
// wgmma body: TMA producer, two wgmma consumer warpgroups, persistent.
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same box into the same shared-memory offset of every CTA in
// cta_mask, each CTA's mbarrier at bar's offset told of its bytes.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1,
                                                      uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(cta_mask),
      "r"(c0), "r"(c1)
      : "memory");
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

template <typename TOut>
__global__ void __launch_bounds__(kGThreads, 1)
    mm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b, Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* epi = reinterpret_cast<float*>(smem + kGStages * kGStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGStages * kGStageBytes +
                                               kGEpiBytes);
  uint64_t* empty = full + kGStages;
  int* flag = reinterpret_cast<int*>(empty + kGStages);
  const int rank = (int)cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);      // the producer's expect_tx
      // One arrival per consumer warpgroup of both CTAs: the peer writes
      // half of b into this stage too.
      mbar_init(&empty[s], 2 * kGCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();              // both CTAs' barriers are initialized
  // Cluster tile (ti, tj) of linear index L: this CTA's 128 rows of it.
  const int tiles = p.tm * p.tn, units = tiles * p.splits;
  const int cid = blockIdx.x / kGCluster, clusters = gridDim.x / kGCluster;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // Producer warpgroup: one thread issues every TMA load; this CTA's a
    // box, and half of b's boxes multicast to both CTAs of the cluster.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int u = cid; u < units; u += clusters) {
        const int s = u / tiles, L = u - s * tiles;
        int ti, tj;
        raster(p, L, ti, tj);
        const int m0 = ti * kGBM * kGCluster + rank * kGBM, n0 = tj * kGBN;
        const int kb = s * p.ks, ke = min(p.k, kb + p.ks);
        const int nb = min(kGBN / 64, cdiv(p.n - n0, 64));  // boxes inside n
        const bool rows = m0 < p.m;    // else a is all past m: not loaded
        const uint32_t bytes = (rows ? kGABytes : 0) + nb * kGBChunk;
        for (int k0 = kb; k0 < ke; k0 += kGBK) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], bytes);
          uint8_t* sa = smem + stage * kGStageBytes;
          if (rows) tma_load_2d(sa, &tma_a, &full[stage], k0, m0);
          for (int j = rank; j < nb; j += kGCluster)
            tma_load_2d_multicast(sa + kGABytes + j * kGBChunk, &tma_b,
                                  &full[stage], n0 + 64 * j, k0,
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
  float acc[128];
  int stage = 0, phase = 0;
  for (int u = cid; u < units; u += clusters) {
    const int s = u / tiles, L = u - s * tiles;
    int ti, tj;
    raster(p, L, ti, tj);
    const int m0 = ti * kGBM * kGCluster + rank * kGBM, n0 = tj * kGBN;
    const int kb = s * p.ks, ke = min(p.k, kb + p.ks);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int k0 = kb; k0 < ke; k0 += kGBK) {
      mbar_wait(&full[stage], phase);
      const uint8_t* sa = smem + stage * kGStageBytes;
      const uint8_t* sb = sa + kGABytes;
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < kGBK / 16; ++kk) {
        // a: K-major rows of 128 bytes, 8-row groups 1 KB apart; a k16
        // step moves 32 bytes along the swizzled row.  b: N-major, 64-
        // column atoms 8 KB apart (leading), 8-row K groups 1 KB apart
        // (stride); a k16 step moves 16 rows, 2 KB.
        wgmma_m64n256k16(acc, sw128_desc(sa + row0 * 128 + kk * 32, 16, 1024),
                         sw128_desc(sb + kk * 2048, kGBChunk, 1024));
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();             // the previous stage's products are done
      fence_acc(acc);
      if (prev >= 0 && signal)
        release_stage(&empty[prev], rank);
      prev = stage;
      if (++stage == kGStages) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && signal)
      release_stage(&empty[prev], rank);

    // Epilogue.  Element (row, col) of the warpgroup's 64 x 256 tile is
    // acc[4 (col / 8) + 2 (row / 8 % 2) + col % 2] of lane 4 (row % 8) +
    // col % 8 / 2 in warp row / 16.  Each 32-column slab goes through ebuf;
    // thread wtid then stores float4 groups (wtid % 8) of rows wtid / 8 +
    // 16 i, so a warp writes four runs of 32 contiguous columns.
    const int er = warp * 16 + lane / 4, ec = (lane % 4) * 2;
    const int wtid = threadIdx.x % 128, ebar = 1 + wg;   // barriers 2, 3
    float* ebuf = epi + (wg - 1) * 64 * kGEpiStride;
    const int64_t plane = (int64_t)p.m * p.n;
    float* out = p.splits == 1 ? nullptr : p.part + s * plane;
#pragma unroll
    for (int q = 0; q < kGBN / kGEpiCols; ++q) {
#pragma unroll
      for (int jj = 0; jj < kGEpiCols / 8; ++jj) {
        const int j = q * kGEpiCols / 8 + jj;
        *reinterpret_cast<float2*>(&ebuf[er * kGEpiStride + jj * 8 + ec]) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(
            &ebuf[(er + 8) * kGEpiStride + jj * 8 + ec]) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      bar_sync(ebar, 128);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wtid / 8 + 16 * i, c4 = (wtid % 8) * 4;
        const int gr = m0 + row0 + row, gc = n0 + q * kGEpiCols + c4;
        const float4 v =
            *reinterpret_cast<const float4*>(&ebuf[row * kGEpiStride + c4]);
        if (gr < p.m && gc < p.n) {
          const int64_t off = (int64_t)gr * p.n + gc;
          if (out == nullptr)
            store4(static_cast<TOut*>(p.c) + off, v);
          else
            store4(out + off, v);
        }
      }
      bar_sync(ebar, 128);
    }
    if (out == nullptr) continue;
    if (!take_ticket(p, L * kGCluster + rank, ctid, 256, 1, flag)) continue;
    // The last split of this tile: the partials summed in split order, its
    // own from registers (bitwise what it wrote), slab by slab as above.
#pragma unroll
    for (int q = 0; q < kGBN / kGEpiCols; ++q) {
#pragma unroll
      for (int jj = 0; jj < kGEpiCols / 8; ++jj) {
        const int j = q * kGEpiCols / 8 + jj;
        *reinterpret_cast<float2*>(&ebuf[er * kGEpiStride + jj * 8 + ec]) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(
            &ebuf[(er + 8) * kGEpiStride + jj * 8 + ec]) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      bar_sync(ebar, 128);
      float4 v[4];
      int64_t off[4];
      bool in[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wtid / 8 + 16 * i, c4 = (wtid % 8) * 4;
        const int gr = m0 + row0 + row, gc = n0 + q * kGEpiCols + c4;
        in[i] = gr < p.m && gc < p.n;
        off[i] = in[i] ? (int64_t)gr * p.n + gc : 0;
      }
      for (int t = 0; t < p.splits; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wtid / 8 + 16 * i, c4 = (wtid % 8) * 4;
          float4 w =
              *reinterpret_cast<const float4*>(&ebuf[row * kGEpiStride + c4]);
          if (t != s && in[i])
            w = __ldcg(reinterpret_cast<const float4*>(p.part + t * plane +
                                                       off[i]));
          if (t == 0) {
            v[i] = w;
          } else {
            v[i].x += w.x;
            v[i].y += w.y;
            v[i].z += w.z;
            v[i].w += w.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (in[i]) store4(static_cast<TOut*>(p.c) + off[i], v[i]);
      bar_sync(ebar, 128);
    }
  }
  cluster_sync_all();
}

// ---------------------------------------------------------------------------
// small_m body: narrow n tiles, K split over a cluster, mma.sync.
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

template <int MF, int BN>
struct Small {
  static constexpr int kMP = 16 * MF;          // rows held (m <= kMP)
  static constexpr int kAS = kSK + 8;          // smem row strides (bf16),
  static constexpr int kBS = BN + 8;           // 16 bytes of padding
  static constexpr int kAElems = kMP * kAS;
  static constexpr int kStageElems = kAElems + kSK * kBS;
  static constexpr int kStageBytes = kStageElems * 2;
  // About 48 KB of ring, 4 to 8 stages, so several CTAs fit an SM.
  static constexpr int kStages =
      kRingBudget / kStageBytes < 4
          ? 4
          : (kRingBudget / kStageBytes > 8 ? 8 : kRingBudget / kStageBytes);
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kRed = 4 * kMP * BN * 4;    // the 4 warps' partials
  static constexpr int kPartOff = kRing > kRed ? kRing : kRed;
  static constexpr int kSmem = kPartOff + kMP * BN * 4 + 16;
};

template <int MF, int BN, typename TOut>
__global__ void __launch_bounds__(kSThreads)
    mm_small_kernel(Args p) {
  using S = Small<MF, BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem);   // reused after the K loop
  float* part = reinterpret_cast<float*>(smem + S::kPartOff);
  int* flag = reinterpret_cast<int*>(part + S::kMP * BN);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / p.ck;
  const int s = unit / p.tn, L = unit - s * p.tn;   // tm == 1
  int ti, tj;
  raster(p, L, ti, tj);                          // ti == 0: m <= 64
  const int n0 = tj * BN;
  const int kb = s * p.ks, ke = min(p.k, kb + p.ks);
  const int k0 = min(ke, kb + rank * p.kslice);
  const int k1 = min(ke, k0 + p.kslice);
  const int nk = cdiv(k1 - k0, kSK);
  const bf16* a = static_cast<const bf16*>(p.a);
  const bf16* b = static_cast<const bf16*>(p.b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Stage K chunk i (64 rows of b, 64 columns of a) into ring stage st;
  // rows past m, n or the rank's K slice are zeros.
  auto load = [&](int i, int st) {
    bf16* sa = ring + st * S::kStageElems;
    bf16* sb = sa + S::kAElems;
    const int kc = k0 + i * kSK;
    for (int v = threadIdx.x; v < S::kMP * (kSK / 8); v += kSThreads) {
      const int r = v / (kSK / 8), c8 = (v % (kSK / 8)) * 8;
      const bool ok = r < p.m && kc + c8 < k1;
      cp_async16(sa + r * S::kAS + c8, ok ? a + r * p.lda + kc + c8 : a, ok);
    }
    for (int v = threadIdx.x; v < kSK * (BN / 8); v += kSThreads) {
      const int r = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
      const bool ok = kc + r < k1 && n0 + c8 < p.n;
      cp_async16(sb + r * S::kBS + c8,
                 ok ? b + (int64_t)(kc + r) * p.ldb + n0 + c8 : b, ok);
    }
  };

  float acc[MF][BN / 8][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < S::kStages - 1; ++i) {
    if (i < nk) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();
    const int next = i + S::kStages - 1;
    if (next < nk) load(next, next % S::kStages);
    cp_async_commit();
    const bf16* sa = ring + (i % S::kStages) * S::kStageElems;
    const bf16* sb = sa + S::kAElems;
    const int kk = warp * 16;                    // each warp one k16 step
    uint32_t bfr[BN / 16][4];
#pragma unroll
    for (int jn = 0; jn < BN / 16; ++jn)
      ldsm_x4_trans(bfr[jn], sb + (kk + ((lane / 8) & 1) * 8 + lane % 8) *
                                      S::kBS + jn * 16 + (lane / 16) * 8);
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      if (mf * 16 >= p.m) break;                 // warp-uniform
      uint32_t af[4];
      ldsm_x4(af, sa + (mf * 16 + lane % 16) * S::kAS + kk + (lane / 16) * 8);
#pragma unroll
      for (int jn = 0; jn < BN / 16; ++jn) {
        mma_bf16(acc[mf][2 * jn], af, bfr[jn][0], bfr[jn][1]);
        mma_bf16(acc[mf][2 * jn + 1], af, bfr[jn][2], bfr[jn][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // Warp partials, then the CTA's: warps summed in order 0 ... 3.
  constexpr int E = S::kMP * BN;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int r = mf * 16 + lane / 4, c = j * 8 + (lane % 4) * 2;
      float* w = red + warp * E;
      w[r * BN + c] = acc[mf][j][0];
      w[r * BN + c + 1] = acc[mf][j][1];
      w[(r + 8) * BN + c] = acc[mf][j][2];
      w[(r + 8) * BN + c + 1] = acc[mf][j][3];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kSThreads)
    part[e] = ((red[e] + red[E + e]) + red[2 * E + e]) + red[3 * E + e];
  cluster.sync();

  // This rank's rows of the tile, summed over the ranks in order through
  // distributed shared memory, written once (or as this split's partial).
  const int rows = S::kMP / p.ck, r0 = rank * rows;
  const int vrows = min(rows, p.m - r0), cols = min(BN, p.n - n0);
  const int q = BN / 4;
  for (int e = threadIdx.x; e < rows * q; e += kSThreads) {
    const int r = r0 + e / q, c = (e % q) * 4;
    float4 v = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + r * BN + c);
    for (int rk = 1; rk < p.ck; ++rk) {
      const float4 w = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, rk) + r * BN + c);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    if (r < p.m && c < cols) {
      const int64_t off = (int64_t)r * p.n + n0 + c;
      if (p.splits == 1)
        store4(static_cast<TOut*>(p.c) + off, v);
      else
        store4(p.part + (int64_t)s * p.m * p.n + off, v);
    }
  }
  cluster.sync();                  // no rank leaves while its part is read
  if (p.splits > 1 &&
      take_ticket(p, L * p.ck + rank, threadIdx.x, kSThreads, 0, flag))
    split_sum<TOut>(p, r0, vrows, n0, cols, threadIdx.x, kSThreads);
}

// ---------------------------------------------------------------------------
// cp_async / masked bodies: wmma on the tensor cores, one tile a CTA.
// ---------------------------------------------------------------------------

template <typename TOut, bool kVec>
__global__ void __launch_bounds__(kThreads) mm_wmma_kernel(Args p) {
  __shared__ __align__(128) bf16 As[2][kBM * kAS];
  __shared__ __align__(128) bf16 Bs[2][kBK * kBS];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * kCS];
  __shared__ int flag;

  int ti, tj;
  raster(p, blockIdx.x, ti, tj);
  const int m0 = ti * kBM, n0 = tj * kBN;
  const int split = blockIdx.y;
  const int kb = split * p.ks, ke = min(p.k, kb + p.ks);
  const bf16* a = static_cast<const bf16*>(p.a);
  const bf16* b = static_cast<const bf16*>(p.b);
  const int rows = min(kBM, p.m - m0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);

  // Stage the K step at k0 into buffer buf: anything past m, n or the
  // split's K range is zeros.
  auto load_async = [&](int k0, int buf) {
    for (int i = threadIdx.x; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c8 = (i % (kBK / 8)) * 8;
      const bool ok = r < rows && k0 + c8 < ke;
      cp_async16(&As[buf][r * kAS + c8],
                 ok ? a + (m0 + r) * p.lda + k0 + c8 : a, ok);
    }
    for (int i = threadIdx.x; i < kBK * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8), c8 = (i % (kBN / 8)) * 8;
      const bool ok = k0 + r < ke && n0 + c8 < p.n;
      cp_async16(&Bs[buf][r * kBS + c8],
                 ok ? b + (k0 + r) * p.ldb + n0 + c8 : b, ok);
    }
  };
  auto load_sync = [&](int k0, int buf) {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      As[buf][r * kAS + cc] = (r < rows && k0 + cc < ke)
                                  ? a[(m0 + r) * p.lda + k0 + cc] : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, cc = i % kBN;
      Bs[buf][r * kBS + cc] = (k0 + r < ke && n0 + cc < p.n)
                                  ? b[(k0 + r) * p.ldb + n0 + cc] : zero;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_k = (ke - kb + kBK - 1) / kBK;
  if (kVec) {
    load_async(kb, 0);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kVec ? (kt & 1) : 0;
    if (kVec) {
      if (kt + 1 < n_k) {
        load_async(kb + (kt + 1) * kBK, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_sync(kb + kt * kBK, buf);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bf[kFN];
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[buf][kk * kBS + wn * kWN + j * 16],
                               kBS);
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        if (wm * kWM + i * 16 >= rows) continue;   // warp-uniform
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, &As[buf][(wm * kWM + i * 16) * kAS + kk],
                               kAS);
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: each fragment through the warp's scratch, nothing past m or
  // n; c itself, or this split's fp32 partial.
  float* cs = Cs[warp];
  TOut* c = static_cast<TOut*>(p.c);
  float* pc = p.part + (int64_t)split * p.m * p.n;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
    if (wm * kWM + i * 16 >= rows) continue;       // warp-uniform
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], kCS, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * kWM + i * 16, c0 = n0 + wn * kWN + j * 16;
      for (int t = lane; t < 256; t += 32) {
        const int r = r0 + t / 16, cc = c0 + t % 16;
        if (r < p.m && cc < p.n) {
          const float v = cs[(t / 16) * kCS + t % 16];
          if (p.splits == 1)
            c[(int64_t)r * p.n + cc] = from_f<TOut>(v);
          else
            pc[(int64_t)r * p.n + cc] = v;
        }
      }
      __syncwarp();
    }
  }
  if (p.splits > 1 &&
      take_ticket(p, ti * p.tn + tj, threadIdx.x, kThreads, 0, &flag))
    split_sum<TOut>(p, m0, rows, n0, min(kBN, p.n - n0), threadIdx.x,
                    kThreads);
}

// ---------------------------------------------------------------------------
// cuda_cores body (fp32 inputs): fma on the CUDA cores.
// ---------------------------------------------------------------------------

template <typename TOut>
__global__ void __launch_bounds__(kThreads) mm_fma_kernel(Args p) {
  __shared__ __align__(16) float As[kFBK][kFBM + 4];   // a tile, transposed
  __shared__ __align__(16) float Bs[kFBK][kFBN + 4];
  __shared__ int flag;

  int ti, tj;
  raster(p, blockIdx.x, ti, tj);
  const int m0 = ti * kFBM, n0 = tj * kFBN;
  const int split = blockIdx.y;
  const int kb = split * p.ks, ke = min(p.k, kb + p.ks);
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  const int rows = min(kFBM, p.m - m0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += kFBK) {
    for (int i = threadIdx.x; i < kFBM * kFBK; i += kThreads) {
      const int r = i / kFBK, cc = i % kFBK;
      As[cc][r] = (r < rows && k0 + cc < ke) ? a[(m0 + r) * p.lda + k0 + cc]
                                             : 0.f;
    }
    for (int i = threadIdx.x; i < kFBK * kFBN; i += kThreads) {
      const int r = i / kFBN, cc = i % kFBN;
      Bs[r][cc] = (k0 + r < ke && n0 + cc < p.n)
                      ? b[(k0 + r) * p.ldb + n0 + cc] : 0.f;
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
  TOut* c = static_cast<TOut*>(p.c);
  float* pc = p.part + (int64_t)split * p.m * p.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = n0 + tx * 4 + j;
      if (cc < p.n) {
        if (p.splits == 1)
          c[(int64_t)r * p.n + cc] = from_f<TOut>(acc[i][j]);
        else
          pc[(int64_t)r * p.n + cc] = acc[i][j];
      }
    }
  }
  if (p.splits > 1 &&
      take_ticket(p, ti * p.tn + tj, threadIdx.x, kThreads, 0, &flag))
    split_sum<TOut>(p, m0, rows, n0, min(kFBN, p.n - n0), threadIdx.x,
                    kThreads);
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

// A 2-D bf16 tensor map of (outer, inner) elements with row stride ld,
// boxes of box_outer x box_inner (inner 64 = one 128-byte swizzle row),
// zeros past the edges.
bool make_map(CUtensorMap* map, const void* base, int64_t inner,
              int64_t outer, int64_t ld, uint32_t box_inner,
              uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
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
cudaError_t launch_wgmma(const Args& p, int ctas, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!make_map(&ta, p.a, p.k, p.m, p.lda, 64, kGBM) ||
      !make_map(&tb, p.b, p.n, p.k, p.ldb, 64, kGBK))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(mm_wgmma_kernel<TOut>, kGSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      cluster_config(&cluster, ctas, kGThreads, kGSmem, kGCluster, s);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, mm_wgmma_kernel<TOut>, ta, tb, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MF, int BN, typename TOut>
cudaError_t launch_small_t(const Args& p, cudaStream_t s) {
  using S = Small<MF, BN>;
  static const cudaError_t attr =
      allow_smem(mm_small_kernel<MF, BN, TOut>, S::kSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(
      &cluster, p.tn * p.splits * p.ck, kSThreads, S::kSmem, p.ck, s);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, mm_small_kernel<MF, BN, TOut>, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_small(const Args& p, int bn, cudaStream_t s) {
  const int mf = p.m <= 16 ? 1 : p.m <= 32 ? 2 : 4;
  switch (mf * 1000 + bn) {
    case 1032: return launch_small_t<1, 32, TOut>(p, s);
    case 1064: return launch_small_t<1, 64, TOut>(p, s);
    case 1128: return launch_small_t<1, 128, TOut>(p, s);
    case 2032: return launch_small_t<2, 32, TOut>(p, s);
    case 2064: return launch_small_t<2, 64, TOut>(p, s);
    case 2128: return launch_small_t<2, 128, TOut>(p, s);
    case 4032: return launch_small_t<4, 32, TOut>(p, s);
    case 4064: return launch_small_t<4, 64, TOut>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TOut>
cudaError_t launch(int body, Args p, int tile_n, int ctas, cudaStream_t s) {
  switch (body) {
    case kCudaCores:
      mm_fma_kernel<TOut><<<dim3(p.tm * p.tn, p.splits), kThreads, 0, s>>>(p);
      return cudaGetLastError();
    case kMasked:
      mm_wmma_kernel<TOut, false>
          <<<dim3(p.tm * p.tn, p.splits), kThreads, 0, s>>>(p);
      return cudaGetLastError();
    case kCpAsync:
      mm_wmma_kernel<TOut, true>
          <<<dim3(p.tm * p.tn, p.splits), kThreads, 0, s>>>(p);
      return cudaGetLastError();
    case kWgmma:
      return launch_wgmma<TOut>(p, ctas, s);
    default:
      return launch_small<TOut>(p, tile_n, s);
  }
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16 (b has a's dtype).
// a (m, k) and b (k, n) by their row strides (unit column stride); c (m, n)
// contiguous in out_dtype.  Split s sums K range [s * ks, min(k, (s + 1) *
// ks)); the accumulating schedule is splits 1, ks >= k.  With splits > 1,
// part holds (splits, m, n) fp32 partials and tickets one int per CTA tile
// (x ck for small_m), zeroed here on the stream.  win_m x win_n: the L2
// window in CTA tiles; col_major: 0 row-major raster (mnk), 1 column-major
// (nmk).  body: 0 cuda_cores, 1 masked, 2 cp_async, 3 wgmma (ctas: the
// persistent grid), 4 small_m (tile_n columns, clusters of ck CTAs each
// summing kslice of a unit's K range).  Returns the first CUDA error of the
// memset and the launch, or cudaErrorInvalidValue for a body the shape
// does not allow.
int matmul(int in_dtype, int out_dtype, const void* a, int64_t lda,
           const void* b, int64_t ldb, void* c, void* part, void* tickets,
           int m, int k, int n, int splits, int ks, int win_m, int win_n,
           int col_major, int body, int tile_n, int ctas, int ck, int kslice,
           void* stream) {
  const bool vec = k % 8 == 0 && n % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0 &&
                   ks % 8 == 0 && aligned16(a) && aligned16(b);
  bool ok = m >= 1 && k >= 1 && n >= 1 && splits >= 1 && splits <= 65535 &&
            ks >= 1 && (int64_t)(splits - 1) * ks < k && in_dtype >= 0 &&
            in_dtype <= 1 && out_dtype >= 0 && out_dtype <= 1 &&
            (splits == 1 || (part != nullptr && tickets != nullptr)) &&
            (body == kCudaCores) == (in_dtype == 0) && body >= 0 &&
            body <= kSmallM;
  if (body == kCpAsync) ok = ok && vec;
  if (body == kWgmma)
    ok = ok && vec && ctas >= kGCluster && ctas % kGCluster == 0 &&
         (splits == 1 || ks % kGBK == 0);
  if (body == kSmallM)
    ok = ok && vec && m <= 64 &&
         (tile_n == 32 || tile_n == 64 || (tile_n == 128 && m <= 32)) &&
         (ck == 1 || ck == 2 || ck == 4 || ck == 8) && kslice >= 1 &&
         kslice % kSK == 0 && (int64_t)kslice * ck >= min(ks, k);
  if (!ok) return (int)cudaErrorInvalidValue;

  int tile_m, tn_cols;
  switch (body) {
    case kCudaCores: tile_m = kFBM; tn_cols = kFBN; break;
    case kWgmma: tile_m = kGBM * kGCluster; tn_cols = kGBN; break;
    case kSmallM: tile_m = 64; tn_cols = tile_n; break;
    default: tile_m = kBM; tn_cols = kBN; break;
  }
  Args p{a, lda, b, ldb, c, static_cast<float*>(part),
         static_cast<int*>(tickets), m, k, n, ks, splits, 0, 0, win_m,
         win_n, col_major != 0,
         body == kSmallM ? ck : body == kWgmma ? kGCluster : 1, kslice};
  p.tm = (m + tile_m - 1) / tile_m;
  p.tn = (n + tn_cols - 1) / tn_cols;
  if ((int64_t)p.tm * p.tn * splits * p.ck > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  p.win_m = max(1, min(p.win_m, p.tm));
  p.win_n = max(1, min(p.win_n, p.tn));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(
        tickets, 0, sizeof(int) * (size_t)p.tm * p.tn * p.ck, s);
    if (e != cudaSuccess) return (int)e;
  }
  return out_dtype == 0 ? (int)launch<float>(body, p, tile_n, ctas, s)
                        : (int)launch<bf16>(body, p, tile_n, ctas, s);
}

// The most CTAs of the wgmma body that the current device holds at once:
// 2 x cudaOccupancyMaxActiveClusters (its clusters need 2 SMs of one GPC
// each), or a negative CUDA error.
int matmul_wgmma_ctas() {
  const cudaError_t attr = allow_smem(mm_wgmma_kernel<bf16>, kGSmem);
  if (attr != cudaSuccess) return -(int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(
      &cluster, kGCluster, kGThreads, kGSmem, kGCluster, nullptr);
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, mm_wgmma_kernel<bf16>, &cfg);
  return e != cudaSuccess ? -(int)e : kGCluster * clusters;
}

}  // extern "C"
