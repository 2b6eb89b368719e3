// MoE grouped expert GEMM for Hopper (sm_90a): every expert product of the
// port's MoE layers.
//
// Replaces the Pallas TPU kernel grouped_matmul (_gmm_kernel) of
// src/repro/kernels/moe_gmm/moe_gmm.py.  For x (e, c, k), w (e, k, n) and
// optional counts (e,):
//
//   y[e] = x[e] @ w[e]        fp32 accumulator, y in out_dtype
//   y[e, r, :] = 0            for r >= counts[e] (every row live if null)
//
// Launch grid: one block per (column tile, row tile, expert).  The Pallas
// grid's sequential K axis and its VMEM accumulator become a loop inside
// the block with the accumulator in registers; nothing is carried between
// blocks, and no atomics or split-K are used, so a call is deterministic.
// A row tile lying wholly at or past counts[e] writes its zeros and skips
// the product, as the Pallas kernel's pl.when(live) does; inside a live
// tile, 16-row fragments past the count skip their products too.  Ragged
// edges in c, k and n are masked here: nothing is padded by the caller.
//
// bf16 path: 128 x 128 output tiles, K in steps of 32, 8 warps each owning
// a 64 x 32 sub-tile as 4 x 2 nvcuda::wmma 16x16x16 bf16 fragments with fp32
// accumulators (mma.sync on the tensor cores).  The next K step's x and w
// tiles are copied into a second shared-memory buffer with cp.async while
// the current one is multiplied.  That path needs k and n multiples of 8
// and 16-byte aligned rows; other shapes load the tiles with plain masked
// loads, one K step at a time.  fp32 path: 64 x 64 tiles, K in steps of 16,
// a 4 x 4 register tile per thread, fma on the CUDA cores (no TF32).
//
// Bound, at olmoe-1b-7b's width (64 experts, d 2048, d_ff 1024):
// * prefill (dense dispatch: every expert sees all 16 x 1024 tokens) is
//   bound by operations: 4.4 TFLOP a call, 4.45 ms at the card's 989
//   TFLOP/s bf16 peak.  The tensor cores carry the product; each w tile
//   is reused by the 128 rows of a block, each x tile by its 128 columns,
//   and blocks are ordered column tile fastest so that the blocks resident
//   together share x's row tiles and one expert's w in L2.  What it does
//   not do yet: wgmma and TMA (mma.sync reaches only part of the peak), a
//   deeper pipeline, and fusing the dense-dispatch mask into the x loads.
// * decode (16 tokens a step) is bound by the weights' bytes: 268 MB per
//   projection, 0.080 ms at 3.35 TB/s.  Each weight byte is read once per
//   call (one row tile per expert); the 16-row fragments past the 16 live
//   rows skip their products, so the tensor cores do not set the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

// bf16 tensor-core tiles.
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWM = 64, kWN = 32;            // a warp's sub-tile (2 x 4 warps)
constexpr int kFM = kWM / 16, kFN = kWN / 16;
constexpr int kAS = kBK + 8;                 // smem row stride of x (bf16)
constexpr int kBS = kBN + 8;                 // smem row stride of w (bf16)
constexpr int kCS = 16 + 4;                  // epilogue scratch row stride

// fp32 CUDA-core tiles.
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

struct Args {
  const void* x;                   // (e, c, k), k contiguous
  int64_t x_se, x_sc;
  const void* w;                   // (e, k, n), n contiguous
  int64_t w_se, w_sk;
  const int* counts;               // (e,) or null
  void* y;                         // (e, c, n) contiguous
  int e, c, k, n;
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = ok ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// bf16 inputs: wmma on the tensor cores.
// ---------------------------------------------------------------------------

template <typename TOut, bool kVec>
__global__ void __launch_bounds__(kThreads) gmm_bf16(Args a) {
  __shared__ __align__(128) bf16 As[2][kBM * kAS];
  __shared__ __align__(128) bf16 Bs[2][kBK * kBS];
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

  // Stage K step kt into buffer buf: x rows past the live count and
  // anything past k or n are zeros.
  auto load_async = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    for (int i = threadIdx.x; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c8 = (i % (kBK / 8)) * 8;
      const bool ok = r < rows && k0 + c8 < a.k;
      cp_async16(&As[buf][r * kAS + c8],
                 ok ? x + (m0 + r) * a.x_sc + k0 + c8 : x, ok);
    }
    for (int i = threadIdx.x; i < kBK * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8), c8 = (i % (kBN / 8)) * 8;
      const bool ok = k0 + r < a.k && n0 + c8 < a.n;
      cp_async16(&Bs[buf][r * kBS + c8],
                 ok ? w + (k0 + r) * a.w_sk + n0 + c8 : w, ok);
    }
  };
  auto load_sync = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      As[buf][r * kAS + cc] = (r < rows && k0 + cc < a.k)
                                  ? x[(m0 + r) * a.x_sc + k0 + cc] : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, cc = i % kBN;
      Bs[buf][r * kBS + cc] = (k0 + r < a.k && n0 + cc < a.n)
                                  ? w[(k0 + r) * a.w_sk + n0 + cc] : zero;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_k = (a.k + kBK - 1) / kBK;
  if (kVec) {
    load_async(0, 0);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kVec ? (kt & 1) : 0;
    if (kVec) {
      if (kt + 1 < n_k) {
        load_async(kt + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_sync(kt, buf);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TOut>
cudaError_t launch(int in_dtype, const Args& a, cudaStream_t s) {
  if (in_dtype == 0) {
    const dim3 grid((a.n + kFBN - 1) / kFBN, (a.c + kFBM - 1) / kFBM, a.e);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_f32<TOut><<<grid, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  const dim3 grid((a.n + kBN - 1) / kBN, (a.c + kBM - 1) / kBM, a.e);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  // 16-byte cp.async needs every staged row to start 16-byte aligned.
  const bool vec = a.k % 8 == 0 && a.n % 8 == 0 && a.x_sc % 8 == 0 &&
                   a.x_se % 8 == 0 && a.w_sk % 8 == 0 && a.w_se % 8 == 0 &&
                   aligned16(a.x) && aligned16(a.w);
  if (vec) {
    gmm_bf16<TOut, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    gmm_bf16<TOut, false><<<grid, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16 (w has x's dtype).
// x (e, c, k) and w (e, k, n) by their two leading strides (last axis
// contiguous); counts (e,) int32 or null; y (e, c, n) contiguous.
// Returns cudaGetLastError() after the launch.
int moe_gmm(int in_dtype, int out_dtype, const void* x, int64_t x_se,
            int64_t x_sc, const void* w, int64_t w_se, int64_t w_sk,
            const int* counts, void* y, int e, int c, int k, int n,
            void* stream) {
  if (e < 1 || e > 65535 || c < 1 || k < 1 || n < 1 || in_dtype < 0 ||
      in_dtype > 1 || out_dtype < 0 || out_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, x_se, x_sc, w, w_se, w_sk, counts, y, e, c, k, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? (int)launch<float>(in_dtype, a, s)
                        : (int)launch<bf16>(in_dtype, a, s);
}

}  // extern "C"
