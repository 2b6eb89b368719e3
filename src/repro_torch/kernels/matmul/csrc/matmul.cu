// Policy-planned blocked GEMM for Hopper (sm_90a): both schedules of the
// port's planned matmul (repro_torch.kernels.matmul.ops.matmul).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/matmul/matmul.py:
// matmul's _mm_kernel (output RESIDENT_ACCUM: an fp32 accumulator over the
// k loop, each output tile written once, grid order mnk or nmk) and its
// inline split-K kern (output STREAM: split_k ranges of K, each writing an
// fp32 partial through to memory, summed and cast by the caller).  For
// a (m, k) and b (k, n), row-major with unit column stride:
//
//   c = a @ b                       fp32 accumulator, c in out_dtype
//   c[s] = a[:, K_s] @ b[K_s, :]    split s of `splits`, c fp32 (splits, m, n)
//
// with K_s = [s * ks, min(k, (s + 1) * ks)); the accumulating schedule is
// splits 1, ks = k.  The caller computes ks and splits as the reference
// does on K padded to a multiple of bk, so every split has the same K range
// as the Pallas kernel's.
//
// How each knob of the plan reads on the card:
// * blocks run in parallel, so the grid order becomes the raster order in
//   which CTAs walk the output tiles: row-major (mnk, the rinse order) or
//   column-major (nmk).  CTAs are dispatched roughly in block-index order,
//   so the raster decides which tiles are in flight together and hence
//   which a and b panels the L2 holds.
// * the plan's bm x bn (up to 512 x 512 under the H100 model, far beyond
//   one CTA's 227 KB of shared memory) becomes the L2 window: the group of
//   CTA tiles (win_m x win_n of them) that the raster finishes before it
//   moves to the next window, windows and the tiles inside one both in the
//   plan's order.  The CTA tile is the kernel's own: 128 x 128 in bf16,
//   64 x 64 in fp32.
// * bk is the split granule (it sets ks); a CTA steps through K by 32 (bf16)
//   or 16 (fp32).
// One CTA sums one output tile (or one split's partial) over its K range
// in a fixed order: no atomics, no cross-block reduction.  So mnk and nmk
// give bitwise equal results, and so do repeated calls.
//
// bf16 path: 8 warps, each a 64 x 32 sub-tile as 4 x 2 nvcuda::wmma
// 16x16x16 bf16 fragments with fp32 accumulators (mma.sync on the tensor
// cores); the next K step's a and b tiles are copied into a second shared
// buffer with 16-byte cp.async while the current one is multiplied.  That
// needs k, n, the row strides and ks multiples of 8 and 16-byte aligned
// bases; other shapes load with masked scalar loads, one K step at a time.
// Row fragments past m skip their products (a decode step's 16 rows).
// fp32 path: 64 x 64 tiles, K steps of 16, a 4 x 4 register tile a thread,
// fma on the CUDA cores (no TF32).  Ragged m, k and n are masked here:
// nothing is padded by the caller.
//
// Bound, at yi-9b's layer GEMMs (d 4096, d_ff 11008): a 16 x 1024 prefill
// wave (m 16384) is bound by operations (0.55 TFLOP for q, 0.556 ms at
// 989 TFLOP/s); a decode step (m 16) by the weight bytes (33.6 MB for q,
// 0.010 ms at 3.35 TB/s).  Each b tile is reused by the 128 rows of a CTA
// and each a tile by its 128 columns; the window keeps the a and b panels
// of the tiles in flight in the L2.  What it does not do yet: wgmma and
// TMA (mma.sync reaches only part of the peak), a deeper pipeline, a
// persistent grid, and an in-kernel split reduction.

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
constexpr int kAS = kBK + 8;                 // smem row stride of a (bf16)
constexpr int kBS = kBN + 8;                 // smem row stride of b (bf16)
constexpr int kCS = 16 + 4;                  // epilogue scratch row stride

// fp32 CUDA-core tiles.
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

struct Args {
  const void* a;                   // (m, k), row stride lda
  int64_t lda;
  const void* b;                   // (k, n), row stride ldb
  int64_t ldb;
  void* c;                         // (splits, m, n) contiguous
  int m, k, n;
  int ks;                          // K elements per split
  int tm, tn;                      // CTA tiles along m and n
  int win_m, win_n;                // L2 window, in CTA tiles
  int col_major;                   // raster: 0 row-major (mnk), 1 nmk
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// The output tile (ti, tj) of the CTA with linear index L: windows of
// win_m x win_n tiles in the raster order, the tiles inside a window in the
// same order; windows on the bottom and right edges are cut to fit.
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
__global__ void __launch_bounds__(kThreads) mm_bf16(Args p) {
  __shared__ __align__(128) bf16 As[2][kBM * kAS];
  __shared__ __align__(128) bf16 Bs[2][kBK * kBS];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * kCS];

  int ti, tj;
  raster(p, blockIdx.x, ti, tj);
  const int m0 = ti * kBM, n0 = tj * kBN;
  const int split = blockIdx.y;
  const int kb = split * p.ks, ke = min(p.k, kb + p.ks);
  const bf16* a = static_cast<const bf16*>(p.a);
  const bf16* b = static_cast<const bf16*>(p.b);
  TOut* c = static_cast<TOut*>(p.c) + (int64_t)split * p.m * p.n;
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

  // Epilogue: each fragment through the warp's scratch, nothing past m or n.
  float* cs = Cs[warp];
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
        if (r < p.m && cc < p.n)
          c[(int64_t)r * p.n + cc] = from_f<TOut>(cs[(t / 16) * kCS + t % 16]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: fma on the CUDA cores.
// ---------------------------------------------------------------------------

template <typename TOut>
__global__ void __launch_bounds__(kThreads) mm_f32(Args p) {
  __shared__ __align__(16) float As[kFBK][kFBM + 4];   // a tile, transposed
  __shared__ __align__(16) float Bs[kFBK][kFBN + 4];

  int ti, tj;
  raster(p, blockIdx.x, ti, tj);
  const int m0 = ti * kFBM, n0 = tj * kFBN;
  const int split = blockIdx.y;
  const int kb = split * p.ks, ke = min(p.k, kb + p.ks);
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  TOut* c = static_cast<TOut*>(p.c) + (int64_t)split * p.m * p.n;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = n0 + tx * 4 + j;
      if (cc < p.n) c[(int64_t)r * p.n + cc] = from_f<TOut>(acc[i][j]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TOut>
cudaError_t launch(int in_dtype, Args p, int splits, cudaStream_t s) {
  const int tile_m = in_dtype == 0 ? kFBM : kBM;
  const int tile_n = in_dtype == 0 ? kFBN : kBN;
  p.tm = (p.m + tile_m - 1) / tile_m;
  p.tn = (p.n + tile_n - 1) / tile_n;
  if ((int64_t)p.tm * p.tn > 0x7fffffff) return cudaErrorInvalidValue;
  p.win_m = max(1, min(p.win_m, p.tm));
  p.win_n = max(1, min(p.win_n, p.tn));
  const dim3 grid(p.tm * p.tn, splits);
  if (in_dtype == 0) {
    mm_f32<TOut><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  // 16-byte cp.async needs every staged row and split to start 16-byte
  // aligned.
  const bool vec = p.k % 8 == 0 && p.n % 8 == 0 && p.lda % 8 == 0 &&
                   p.ldb % 8 == 0 && p.ks % 8 == 0 && aligned16(p.a) &&
                   aligned16(p.b);
  if (vec) {
    mm_bf16<TOut, true><<<grid, kThreads, 0, s>>>(p);
  } else {
    mm_bf16<TOut, false><<<grid, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16 (b has a's dtype).
// a (m, k) and b (k, n) by their row strides (unit column stride); c
// (splits, m, n) contiguous in out_dtype, which must be float32 when
// splits > 1.  Split s sums K range [s * ks, min(k, (s + 1) * ks)); the
// accumulating schedule is splits 1, ks >= k.  win_m x win_n: the L2
// window in CTA tiles; col_major: 0 row-major raster (mnk), 1 column-major
// (nmk).  Returns cudaGetLastError() after the launch.
int matmul(int in_dtype, int out_dtype, const void* a, int64_t lda,
           const void* b, int64_t ldb, void* c, int m, int k, int n,
           int splits, int ks, int win_m, int win_n, int col_major,
           void* stream) {
  if (m < 1 || k < 1 || n < 1 || splits < 1 || splits > 65535 || ks < 1 ||
      (int64_t)(splits - 1) * ks >= k || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || (splits > 1 && out_dtype != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args p{a, lda, b, ldb, c, m, k, n, ks, 0, 0, win_m, win_n,
               col_major != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? (int)launch<float>(in_dtype, p, splits, s)
                        : (int)launch<bf16>(in_dtype, p, splits, s);
}

}  // extern "C"
