// Mamba-2 SSD chunked scan for Hopper (sm_90a): the port's prefill of every
// Mamba-2 layer.
//
// Replaces the Pallas TPU kernel ssd (_ssd_kernel) of
// src/repro/kernels/ssd/ssd.py, and takes what the serve path needs beyond
// it: an initial state.  Per (batch b, head h), with dt already softplus'ed
// and gated (dt = 0 on padding and on parked slots), A[h] < 0 and the B/C
// rows of the head's group g = h / (heads / groups):
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T        (ds x dh, fp32)
//   y_t = C_t S_t + D x_t
//
// computed chunk by chunk as the state-space duality splits it: within a
// chunk of kQ rows, with cum_t the inclusive sum of dt_s A over the chunk,
//
//   y_t   = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//         + exp(cum_t) C_t S_in + D x_t
//   S_out = exp(cum_last) S_in + sum_s B_s exp(cum_last - cum_s) dt_s x_s^T
//
// The chunked algorithm is exact for any tile, so kQ = 64 here differs from
// the plain version's chunk (128 or more) only in rounding.
//
// The reference's policy holds in both bodies: the (ds, dh) fp32 state is
// RESIDENT_ACCUM (read from init_state once, kept on chip for the whole
// sweep, written once after the last chunk); x, B, C, dt and y STREAM
// (each element read or written once); the chunk loop runs inside the
// block.  Bound: at mamba2-1.3b's prefill shape (16 x 1024, 64 heads of
// 64, ds 128) one call moves ~0.35 GB (x and y in bf16, the state in and
// out in fp32, B, C and dt): 0.10 ms of bytes.
//
// Two bodies; the wrapper (ssd.py plan_launch) picks one and passes it.
//
// mma (ssd_mma_kernel, bf16 with dh a multiple of 16 up to 128, ds a
// multiple of 8 up to 128, 16-byte aligned rows): the four products on the
// tensor cores, mma.sync.m16n8k16 bf16 with fp32 accumulators, fragments
// from ldmatrix.  One block takes hb heads of one group of a batch row and
// runs dh / 16 warps a head, at most 16 warps; warp w of a head owns 16
// columns of the head dim.  Per chunk:
//   * x (hb heads), B, C and dt are staged in bf16 shared memory by a
//     2-stage cp.async ring: chunk c + 1 loads while chunk c computes;
//     rows past l and state columns past ds load as zeros;
//   * C B^T (kQ x kQ, its 16 x 8 tiles on or below the diagonal) is
//     computed ONCE for the block and kept in shared memory (fp32): the hb
//     heads of a group share B and C, so it is a third of the arithmetic
//     that per-head blocks would repeat hb times;
//   * each warp keeps its slice of the head's state TRANSPOSED, S^T (16 dh
//     rows x DS columns), as mma accumulator fragments in registers: the
//     update S^T = exp(cum_last) S^T + (w x)^T B accumulates into them, and
//     the same registers are the B-fragments of C S (an accumulator tile's
//     (row, column pair) is a B-fragment's (column, k pair));
//   * the chunk's decay sums cum_t are a warp scan (two rows a lane) by
//     the head's first warp, beside exp(cum_t) and the update's weights
//     w_s = exp(cum_last - cum_s) dt_s;
//   * y for the warp's 16 columns: exp(cum_t) (C S) + M x + D x, with
//     M = (C B^T) o exp(cum_t - cum_s) dt_s formed in registers from the
//     shared C B^T only for s <= t (the s > t lanes are set to zero before
//     exp, which would overflow there), and the k-steps above the diagonal
//     skipped.
// Operands that are fp32 (M, S, w x with w_s = exp(cum_last - cum_s) dt_s)
// enter each product as hi + lo: hi = bf16(v), lo = bf16(v - hi), two mma
// that carry ~16 bits of v's mantissa; C B^T multiplies bf16 inputs, whose
// products are exact.  A single bf16 rounding (8 bits) would put the
// state beyond its fp32 tolerance (tests/test_torch_ssd.py holds both
// against the plain version).
//
// cuda_cores (ssd_fma_kernel: fp32, and the bf16 shapes the mma body does
// not take): fp32 fma, no TF32 (it would not hold fp32's tolerance).  One
// block of 256 threads per (batch, head); x, B and C staged in fp32 shared
// memory, the state in shared memory; the chunk's decay sums on one
// thread; 4 x 4 register tiles of a 16 x 16 thread grid for C B^T,
// M x + C S and the update.
//
// Exactness the serve path relies on, in both bodies: with dt = 0 on every
// row of a slot, cum = 0, the decay is exp(0) = 1 and every product term is
// an exact zero, so the state leaves the kernel bitwise unchanged (a parked
// slot); padding rows past l are loaded as x = B = C = dt = 0.
//
// What neither body does yet: wgmma with TMA and a producer warp, or a
// persistent grid (the mma body's grid is b * heads / hb blocks: at the
// models' prefill shapes two or three waves of 16 warps an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;             // chunk rows (both bodies)
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Inclusive prefix sums over a chunk's 64 rows, lane l holding rows 2l and
// 2l + 1 (v0, v1); returns the sums at those rows.  All-zero input gives
// exact zeros.
__device__ __forceinline__ float2 warp_cumsum64(float v0, float v1) {
  const int lane = threadIdx.x % 32;
  float s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.f;
  const float c0 = before + v0;
  return make_float2(c0, c0 + v1);
}

struct Args {
  const void* x;                  // (b, l, h, dh), dh contiguous
  int64_t x_sb, x_sl, x_sh;
  const float* dt;                // (b, l, h)
  int64_t dt_sb, dt_sl, dt_sh;
  const float* A;                 // (h,)
  const void* B;                  // (b, l, g, ds), ds contiguous
  int64_t B_sb, B_sl, B_sg;
  const void* C;
  int64_t C_sb, C_sl, C_sg;
  const float* D;                 // (h,) or null
  const float* s_in;              // (b, h, ds, dh) contiguous, or null
  void* y;                        // (b, l, h, dh) contiguous
  float* s_out;                   // (b, h, ds, dh) contiguous
  int b, l, h, g, dh, ds;
};

// ---------------------------------------------------------------------------
// cuda_cores body
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// Shared-memory floats for head dim padded to DH: x (kQ, DH+4), B and C
// (kQ, ds+4), M (kQ, kQ+4), the state (ds, DH+4), four (kQ,) vectors.
__host__ __device__ constexpr int64_t fma_smem_floats(int DH, int ds) {
  return (int64_t)kQ * (DH + 4) + 2 * (int64_t)kQ * (ds + 4) +
         (int64_t)kQ * (kQ + 4) + (int64_t)ds * (DH + 4) + 4 * kQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) ssd_fma_kernel(Args a) {
  constexpr int XS = DH + 4;      // row stride of x and of the state
  constexpr int MS = kQ + 4;      // row stride of M
  constexpr int HC = DH / 64;     // 64-column groups
  constexpr int OC = 4 * HC;      // output columns per thread
  extern __shared__ float4 smem4[];
  const int ds = a.ds, dh = a.dh;
  const int BS = ds + 4;          // row stride of B and C
  float* Xs = reinterpret_cast<float*>(smem4);
  float* Bs = Xs + kQ * XS;
  float* Cs = Bs + kQ * BS;
  float* Ms = Cs + kQ * BS;
  float* Ss = Ms + kQ * MS;
  float* cum = Ss + ds * XS;      // inclusive sum of dt A over the chunk
  float* dts = cum + kQ;          // dt
  float* wts = dts + kQ;          // exp(cum_last - cum_s) dt_s
  float* ecum = wts + kQ;         // exp(cum_t)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ib = blockIdx.x / a.h, ih = blockIdx.x % a.h;
  const int ig = ih / (a.h / a.g);
  const float Ah = a.A[ih];
  const float Dh = a.D != nullptr ? a.D[ih] : 0.f;
  const T* x = static_cast<const T*>(a.x) + ib * a.x_sb + ih * a.x_sh;
  const float* dt = a.dt + ib * a.dt_sb + ih * a.dt_sh;
  const T* Bp = static_cast<const T*>(a.B) + ib * a.B_sb + ig * a.B_sg;
  const T* Cp = static_cast<const T*>(a.C) + ib * a.C_sb + ig * a.C_sg;
  const int64_t y_sl = (int64_t)a.h * dh;
  T* y = static_cast<T*>(a.y) + (int64_t)ib * a.l * y_sl + (int64_t)ih * dh;
  const int64_t s_off = ((int64_t)ib * a.h + ih) * ds * dh;

  for (int i = tid; i < ds * DH; i += kThreads) {
    const int n = i / DH, e = i % DH;
    Ss[n * XS + e] =
        (a.s_in != nullptr && e < dh) ? a.s_in[s_off + n * dh + e] : 0.f;
  }

  const int n_chunks = (a.l + kQ - 1) / kQ;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kQ;
    const int rows = min(kQ, a.l - t0);
    __syncthreads();              // the previous chunk's readers are done
    for (int i = tid; i < kQ * DH; i += kThreads) {
      const int r = i / DH, e = i % DH;
      Xs[r * XS + e] =
          (r < rows && e < dh) ? to_f(x[(t0 + r) * a.x_sl + e]) : 0.f;
    }
    for (int i = tid; i < kQ * ds; i += kThreads) {
      const int r = i / ds, n = i % ds;
      const bool ok = r < rows;
      Bs[r * BS + n] = ok ? to_f(Bp[(t0 + r) * a.B_sl + n]) : 0.f;
      Cs[r * BS + n] = ok ? to_f(Cp[(t0 + r) * a.C_sl + n]) : 0.f;
    }
    if (tid < kQ) dts[tid] = tid < rows ? dt[(t0 + tid) * a.dt_sl] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < kQ; ++r) {
        s += dts[r] * Ah;
        cum[r] = s;
      }
    }
    __syncthreads();
    const float total = cum[kQ - 1];
    if (tid < kQ) {
      wts[tid] = expf(total - cum[tid]) * dts[tid];
      ecum[tid] = expf(cum[tid]);
    }

    // M[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0.
    // Rows t = 4 ty + i, columns s = tx + 16 j.
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < ds; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(4 * ty + i) * BS + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * BS + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(cv[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(cv[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(cv[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(cv[i].w, bv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          float m = 0.f;           // mask before exp: s > t would overflow
          if (s <= t) m = acc[i][j] * expf(cum[t] - cum[s]) * dts[s];
          Ms[t * MS + s] = m;
        }
      }
    }
    __syncthreads();

    // y[t][e] = exp(cum_t) (C_t . S[:, e]) + sum_{s<=t} M[t][s] x[s][e]
    //         + D x[t][e].  Rows t = 4 ty + i, columns e = 4 tx + 64 hc + w.
    {
      float acc[4][OC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 0; o < OC; ++o) acc[i][o] = 0.f;
      for (int n = 0; n < ds; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(4 * ty + i) * BS + n]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
          for (int hc = 0; hc < HC; ++hc) {
            const float4 sv = *reinterpret_cast<const float4*>(
                &Ss[(n + nn) * XS + 4 * tx + 64 * hc]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float cc = comp(cv[i], nn);
              acc[i][4 * hc + 0] = fmaf(cc, sv.x, acc[i][4 * hc + 0]);
              acc[i][4 * hc + 1] = fmaf(cc, sv.y, acc[i][4 * hc + 1]);
              acc[i][4 * hc + 2] = fmaf(cc, sv.z, acc[i][4 * hc + 2]);
              acc[i][4 * hc + 3] = fmaf(cc, sv.w, acc[i][4 * hc + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sc = ecum[4 * ty + i];
#pragma unroll
        for (int o = 0; o < OC; ++o) acc[i][o] *= sc;
      }
      const int s_end = 4 * ty + 4;   // M[t][s] = 0 for s > t
      for (int s = 0; s < s_end; s += 4) {
        float4 mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mv[i] = *reinterpret_cast<const float4*>(&Ms[(4 * ty + i) * MS + s]);
#pragma unroll
        for (int ss = 0; ss < 4; ++ss) {
#pragma unroll
          for (int hc = 0; hc < HC; ++hc) {
            const float4 xv = *reinterpret_cast<const float4*>(
                &Xs[(s + ss) * XS + 4 * tx + 64 * hc]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float m = comp(mv[i], ss);
              acc[i][4 * hc + 0] = fmaf(m, xv.x, acc[i][4 * hc + 0]);
              acc[i][4 * hc + 1] = fmaf(m, xv.y, acc[i][4 * hc + 1]);
              acc[i][4 * hc + 2] = fmaf(m, xv.z, acc[i][4 * hc + 2]);
              acc[i][4 * hc + 3] = fmaf(m, xv.w, acc[i][4 * hc + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        if (t >= rows) continue;
#pragma unroll
        for (int hc = 0; hc < HC; ++hc)
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int e = 4 * tx + 64 * hc + w;
            if (e < dh) {
              y[(t0 + t) * y_sl + e] =
                  from_f<T>(acc[i][4 * hc + w] + Dh * Xs[t * XS + e]);
            }
          }
      }
    }
    __syncthreads();              // every reader of the old state is done

    // S[n][e] = exp(cum_last) S[n][e] + sum_s B[s][n] wts[s] x[s][e]; each
    // thread owns rows n = n0 + 4 ty + i, columns e = 4 tx + 64 hc + w.
    const float decay = expf(total);
    for (int n0 = 0; n0 < ds; n0 += 64) {
      const int nb = n0 + 4 * ty;
      if (nb >= ds) break;        // ds % 4 == 0: the whole 4-row block
      float acc[4][OC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 0; o < OC; ++o) acc[i][o] = 0.f;
      for (int s = 0; s < rows; ++s) {
        const float w = wts[s];
        float4 bv = *reinterpret_cast<const float4*>(&Bs[s * BS + nb]);
        const float b4[4] = {bv.x * w, bv.y * w, bv.z * w, bv.w * w};
#pragma unroll
        for (int hc = 0; hc < HC; ++hc) {
          const float4 xv = *reinterpret_cast<const float4*>(
              &Xs[s * XS + 4 * tx + 64 * hc]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * hc + 0] = fmaf(b4[i], xv.x, acc[i][4 * hc + 0]);
            acc[i][4 * hc + 1] = fmaf(b4[i], xv.y, acc[i][4 * hc + 1]);
            acc[i][4 * hc + 2] = fmaf(b4[i], xv.z, acc[i][4 * hc + 2]);
            acc[i][4 * hc + 3] = fmaf(b4[i], xv.w, acc[i][4 * hc + 3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hc = 0; hc < HC; ++hc)
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            float* sp = &Ss[(nb + i) * XS + 4 * tx + 64 * hc + w];
            *sp = fmaf(*sp, decay, acc[i][4 * hc + w]);   // S * 1 + 0 == S
          }
    }
  }
  __syncthreads();
  for (int i = tid; i < ds * dh; i += kThreads) {
    const int n = i / dh, e = i % dh;
    a.s_out[s_off + i] = Ss[n * XS + e];
  }
}

// ---------------------------------------------------------------------------
// mma body
// ---------------------------------------------------------------------------

constexpr int kMmaMaxWarps = 16;
constexpr int kCbStride = kQ + 8;  // floats a row of C B^T (conflict-free float2)
constexpr int kCbUnits = 20;       // 16 x 8 tiles of C B^T on or below the diagonal

// Bytes of one ring stage: x (hb heads x kQ rows, rows padded by 16 bytes
// so that ldmatrix is free of bank conflicts), B and C (kQ rows of DS),
// dt (hb x kQ fp32).
__host__ __device__ constexpr int64_t mma_stage_bytes(int hb, int dh, int DS) {
  return (int64_t)hb * kQ * (dh + 8) * 2 + 2 * (int64_t)kQ * (DS + 8) * 2 +
         (int64_t)hb * kQ * 4;
}

// The ring's two stages, C B^T (fp32), and per head the chunk's cum,
// exp(cum_t) and exp(cum_last - cum_s) dt_s.
__host__ __device__ constexpr int64_t mma_smem_bytes(int hb, int dh, int DS) {
  return 2 * mma_stage_bytes(hb, dh, DS) + (int64_t)kQ * kCbStride * 4 +
         3 * (int64_t)hb * kQ * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) = hi + lo as two packed bf16 pairs (v0 in the low half):
// hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Fragment layouts (m16n8k16): an accumulator's element (r, c) pairs sit
// at row lane/4 (+8), columns 2 (lane%4) (+1); an A-fragment's at row
// lane/4 (+8), k 2 (lane%4) (+1) (+8); a B-fragment's at k 2 (lane%4) (+1)
// (+8), column lane/4.
template <int DS>
__global__ void __launch_bounds__(32 * kMmaMaxWarps, 1) ssd_mma_kernel(Args a,
                                                                      int hb) {
  typedef __nv_bfloat16 T;
  constexpr int KS = DS / 16;          // k-steps over the state dim
  constexpr int NS = DS / 8;           // n-tiles of the state
  constexpr int BR = (DS + 8) * 2;     // B / C row stride, bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = a.dh, ds = a.ds;
  const int XR = (dh + 8) * 2;         // x row stride, bytes
  const int x_bytes = hb * kQ * XR;
  const int stage = (int)mma_stage_bytes(hb, dh, DS);
  float* cb = reinterpret_cast<float*>(smem + 2 * stage);   // [kQ][kCbStride]
  float* cum_all = cb + kQ * kCbStride;    // [hb][kQ] cum (log2 units)
  float* ecum_all = cum_all + hb * kQ;     // [hb][kQ] exp(cum_t)
  float* wts_all = ecum_all + hb * kQ;     // [hb][kQ] exp(cum_last - cum_s) dt_s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int wph = dh / 16;                 // warps a head
  const int hblocks = a.h / hb;
  const int ib = blockIdx.x / hblocks;
  const int h0 = (blockIdx.x % hblocks) * hb;
  const int ig = h0 / (a.h / a.g);
  const int hj = warp / wph;               // this warp's head in the block
  const int ih = h0 + hj;
  const int q16 = (warp % wph) * 16;       // its 16 columns of the head dim
  const int quad = lane / 4, pair = 2 * (lane % 4);

  const T* xg = static_cast<const T*>(a.x) + ib * a.x_sb + h0 * a.x_sh;
  const float* dtg = a.dt + ib * a.dt_sb + h0 * a.dt_sh;
  const T* Bg = static_cast<const T*>(a.B) + ib * a.B_sb + ig * a.B_sg;
  const T* Cg = static_cast<const T*>(a.C) + ib * a.C_sb + ig * a.C_sg;
  const float Al = a.A[ih] * kLog2e;
  const float Dh = a.D != nullptr ? a.D[ih] : 0.f;
  const int64_t y_sl = (int64_t)a.h * dh;
  T* yg = static_cast<T*>(a.y) + (int64_t)ib * a.l * y_sl + (int64_t)ih * dh;
  const int64_t s_off = ((int64_t)ib * a.h + ih) * ds * dh;

  auto load_chunk = [&](int c, int slot) {
    unsigned char* xs = smem + slot * stage;
    unsigned char* bs = xs + x_bytes;
    unsigned char* cs = bs + kQ * BR;
    float* dts = reinterpret_cast<float*>(cs + kQ * BR);
    const int t0 = c * kQ;
    const int rows = min(kQ, a.l - t0);
    const int xp = dh / 8;                 // 16-byte pieces of an x row
    for (int i = tid; i < hb * kQ * xp; i += nthreads) {
      const int j = i / (kQ * xp), r = (i / xp) % kQ, p = i % xp;
      const bool ok = r < rows;
      const T* src = ok ? xg + (t0 + r) * a.x_sl + j * a.x_sh + p * 8 : xg;
      cp_async16(xs + (j * kQ + r) * XR + p * 16, src, ok ? 16 : 0);
    }
    for (int i = tid; i < kQ * (DS / 8); i += nthreads) {
      const int r = i / (DS / 8), p = i % (DS / 8);
      const bool ok = r < rows && p * 8 < ds;
      const int64_t bo = ok ? (t0 + r) * a.B_sl + p * 8 : 0;
      const int64_t co = ok ? (t0 + r) * a.C_sl + p * 8 : 0;
      cp_async16(bs + r * BR + p * 16, Bg + bo, ok ? 16 : 0);
      cp_async16(cs + r * BR + p * 16, Cg + co, ok ? 16 : 0);
    }
    for (int i = tid; i < hb * kQ; i += nthreads) {
      const int j = i / kQ, r = i % kQ;
      const bool ok = r < rows;
      cp_async4(dts + i, ok ? dtg + (t0 + r) * a.dt_sl + j * a.dt_sh : dtg,
                ok ? 4 : 0);
    }
  };

  // The warp's slice of S^T: rows e = q16 + quad (+8), columns
  // n = 8 j + pair (+1); columns past ds stay zero.
  float st[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = 8 * j + pair, e = q16 + quad;
    st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
    if (a.s_in != nullptr && n < ds) {
      const float* sp = a.s_in + s_off + (int64_t)n * dh + e;
      st[j][0] = sp[0];
      st[j][1] = sp[dh];
      st[j][2] = sp[8];
      st[j][3] = sp[dh + 8];
    }
  }

  const int n_chunks = (a.l + kQ - 1) / kQ;
  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();        // chunk c landed; chunk c - 1's readers are done
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) & 1);
    cp_async_commit();
    const unsigned char* xs = smem + (c & 1) * stage;
    const unsigned char* bs = xs + x_bytes;
    const unsigned char* cs = bs + kQ * BR;
    const float* dts = reinterpret_cast<const float*>(cs + kQ * BR);
    const int rows = min(kQ, a.l - c * kQ);

    // The head's decay vectors, by the head's first warp.
    if (warp % wph == 0) {
      const float d0 = dts[hj * kQ + 2 * lane], d1 = dts[hj * kQ + 2 * lane + 1];
      const float2 cu = warp_cumsum64(d0 * Al, d1 * Al);
      const float total = __shfl_sync(0xffffffffu, cu.y, 31);
      float* cum = cum_all + hj * kQ;
      float* ecum = ecum_all + hj * kQ;
      float* wts = wts_all + hj * kQ;
      cum[2 * lane] = cu.x;
      cum[2 * lane + 1] = cu.y;
      ecum[2 * lane] = exp2f(cu.x);
      ecum[2 * lane + 1] = exp2f(cu.y);
      wts[2 * lane] = exp2f(total - cu.x) * d0;
      wts[2 * lane + 1] = exp2f(total - cu.y) * d1;
    }
    // C B^T once for the block: 16 x 8 tiles (m-tile i, n-tile n <= 2i + 1).
    for (int u = warp; u < kCbUnits; u += nwarps) {
      const int i = u < 2 ? 0 : u < 6 ? 1 : u < 12 ? 2 : 3;
      const int n = u - i * (i + 1);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks * 16 >= ds) break;
        uint32_t ca[4], bb[2];
        ldsm_x4(ca, cs + (16 * i + ((lane / 8) & 1) * 8 + lane % 8) * BR +
                        (ks * 16 + (lane / 16) * 8) * 2);
        ldsm_x2(bb, bs + (8 * n + lane % 8) * BR +
                        (ks * 16 + ((lane / 8) & 1) * 8) * 2);
        mma_bf16(acc, ca, bb[0], bb[1]);
      }
      float* row = cb + (16 * i + quad) * kCbStride + 8 * n + pair;
      *reinterpret_cast<float2*>(row) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(row + 8 * kCbStride) =
          make_float2(acc[2], acc[3]);
    }
    __syncthreads();        // C B^T and the decay vectors are visible

    const float* cum = cum_all + hj * kQ;
    const float* ecum = ecum_all + hj * kQ;
    const float* wts = wts_all + hj * kQ;
    const float* dth = dts + hj * kQ;
    const unsigned char* xh = xs + hj * kQ * XR;   // this head's x rows

    // y for m-tiles 2 hf and 2 hf + 1 (rows 32 hf .. 32 hf + 31), the
    // warp's 16 columns (two n-tiles): exp(cum_t) (C S) + M x + D x.  The
    // halves stay a loop: unrolled, the 128-register cap spills more.
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[2][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nn][e] = 0.f;
      // C S: S^T's accumulator tiles 2 kk and 2 kk + 1 are the B-fragments
      // of k-step kk (columns q16 .. q16 + 7 from elements 0, 1; q16 + 8 ..
      // from elements 2, 3).
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk * 16 >= ds) break;
        uint32_t shi[2][2], slo[2][2];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          split2(st[2 * kk][2 * nn], st[2 * kk][2 * nn + 1], shi[nn][0],
                 slo[nn][0]);
          split2(st[2 * kk + 1][2 * nn], st[2 * kk + 1][2 * nn + 1],
                 shi[nn][1], slo[nn][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t ca[4];
          ldsm_x4(ca, cs + (32 * hf + 16 * i + ((lane / 8) & 1) * 8 + lane % 8) *
                               BR + (kk * 16 + (lane / 16) * 8) * 2);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            mma_bf16(acc[i][nn], ca, shi[nn][0], shi[nn][1]);
            mma_bf16(acc[i][nn], ca, slo[nn][0], slo[nn][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 32 * hf + 16 * i + quad;
        const float e0 = ecum[t], e1 = ecum[t + 8];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          acc[i][nn][0] *= e0;
          acc[i][nn][1] *= e0;
          acc[i][nn][2] *= e1;
          acc[i][nn][3] *= e1;
        }
      }
      // M x over the k-steps at or below the diagonal.
#pragma unroll
      for (int kk = 0; kk < 2 * hf + 2; ++kk) {
        uint32_t xb[4];
        ldsm_x4_trans(xb, xh + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * XR +
                              (q16 + (lane / 16) * 8) * 2);
        const int s0 = kk * 16 + pair;
        const float cs0 = cum[s0], cs1 = cum[s0 + 1];
        const float cs8 = cum[s0 + 8], cs9 = cum[s0 + 9];
        const float d0 = dth[s0], d1 = dth[s0 + 1];
        const float d8 = dth[s0 + 8], d9 = dth[s0 + 9];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int mt = 2 * hf + i;             // m-tile
          if (mt < kk) continue;
          const int t0 = 16 * mt + quad, t1 = t0 + 8;
          const float ct0 = cum[t0], ct1 = cum[t1];
          const float* r0 = cb + t0 * kCbStride + s0;
          const float* r1 = cb + t1 * kCbStride + s0;
          const float2 c00 = *reinterpret_cast<const float2*>(r0);
          const float2 c10 = *reinterpret_cast<const float2*>(r1);
          const float2 c01 = *reinterpret_cast<const float2*>(r0 + 8);
          const float2 c11 = *reinterpret_cast<const float2*>(r1 + 8);
          // Mask before exp: s > t would overflow.
          const float m00 = s0 <= t0 ? c00.x * exp2f(ct0 - cs0) * d0 : 0.f;
          const float m01 = s0 + 1 <= t0 ? c00.y * exp2f(ct0 - cs1) * d1 : 0.f;
          const float m10 = s0 <= t1 ? c10.x * exp2f(ct1 - cs0) * d0 : 0.f;
          const float m11 = s0 + 1 <= t1 ? c10.y * exp2f(ct1 - cs1) * d1 : 0.f;
          const float m08 = s0 + 8 <= t0 ? c01.x * exp2f(ct0 - cs8) * d8 : 0.f;
          const float m09 = s0 + 9 <= t0 ? c01.y * exp2f(ct0 - cs9) * d9 : 0.f;
          const float m18 = s0 + 8 <= t1 ? c11.x * exp2f(ct1 - cs8) * d8 : 0.f;
          const float m19 = s0 + 9 <= t1 ? c11.y * exp2f(ct1 - cs9) * d9 : 0.f;
          uint32_t mhi[4], mlo[4];
          split2(m00, m01, mhi[0], mlo[0]);
          split2(m10, m11, mhi[1], mlo[1]);
          split2(m08, m09, mhi[2], mlo[2]);
          split2(m18, m19, mhi[3], mlo[3]);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            mma_bf16(acc[i][nn], mhi, xb[2 * nn], xb[2 * nn + 1]);
            mma_bf16(acc[i][nn], mlo, xb[2 * nn], xb[2 * nn + 1]);
          }
        }
      }
      // + D x, then store the rows below l (bf16 pairs).
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 32 * hf + 16 * i + quad + 8 * half;
          if (t >= rows) continue;
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const int e = q16 + 8 * nn + pair;
            const float2 xv = unpack(
                *reinterpret_cast<const uint32_t*>(xh + t * XR + e * 2));
            *reinterpret_cast<__nv_bfloat162*>(
                yg + (int64_t)(c * kQ + t) * y_sl + e) =
                __floats2bfloat162_rn(acc[i][nn][2 * half] + Dh * xv.x,
                                      acc[i][nn][2 * half + 1] + Dh * xv.y);
          }
        }
      }
    }

    // S^T = exp(cum_last) S^T + (w x)^T B: x's fragment of k-step kk, read
    // transposed, is the A-fragment of x^T ({0, 2, 1, 3}); each pair is
    // scaled by w_s and split.
    const float decay = exp2f(cum[kQ - 1]);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= decay;    // S * 1 == S
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t xb[4];
      ldsm_x4_trans(xb, xh + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * XR +
                            (q16 + (lane / 16) * 8) * 2);
      const int s0 = kk * 16 + pair;
      const float w0 = wts[s0], w1 = wts[s0 + 1];
      const float w8 = wts[s0 + 8], w9 = wts[s0 + 9];
      uint32_t ahi[4], alo[4];
      const float2 x0 = unpack(xb[0]), x1 = unpack(xb[2]);
      const float2 x2 = unpack(xb[1]), x3 = unpack(xb[3]);
      split2(x0.x * w0, x0.y * w1, ahi[0], alo[0]);
      split2(x1.x * w0, x1.y * w1, ahi[1], alo[1]);
      split2(x2.x * w8, x2.y * w9, ahi[2], alo[2]);
      split2(x3.x * w8, x3.y * w9, ahi[3], alo[3]);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        if (np * 16 >= ds) break;
        uint32_t bb[4];
        ldsm_x4_trans(bb, bs + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * BR +
                              (np * 16 + (lane / 16) * 8) * 2);
        mma_bf16(st[2 * np], ahi, bb[0], bb[1]);
        mma_bf16(st[2 * np], alo, bb[0], bb[1]);
        mma_bf16(st[2 * np + 1], ahi, bb[2], bb[3]);
        mma_bf16(st[2 * np + 1], alo, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = 8 * j + pair, e = q16 + quad;
    if (n >= ds) continue;
    float* sp = a.s_out + s_off + (int64_t)n * dh + e;
    sp[0] = st[j][0];
    sp[dh] = st[j][1];
    sp[8] = st[j][2];
    sp[dh + 8] = st[j][3];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t opt_in_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

template <typename T, int DH>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  static bool configured = false;   // opt in to > 48 KB once per instance
  if (!configured) {
    const cudaError_t err = opt_in_smem(ssd_fma_kernel<T, DH>);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const size_t smem = sizeof(float) * (size_t)fma_smem_floats(DH, a.ds);
  ssd_fma_kernel<T, DH><<<(unsigned)(a.b * a.h), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch_mma(const Args& a, int hb, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = opt_in_smem(ssd_mma_kernel<DS>);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const size_t smem = (size_t)mma_smem_bytes(hb, a.dh, DS);
  const int threads = 32 * hb * (a.dh / 16);
  ssd_mma_kernel<DS><<<(unsigned)(a.b * (a.h / hb)), threads, smem, stream>>>(
      a, hb);
  return cudaGetLastError();
}

int mma_ds(int ds) { return ds <= 32 ? 32 : ds <= 64 ? 64 : 128; }

}  // namespace

extern "C" {

// body: 0 = cuda_cores, 1 = mma (bf16 only; hb heads a block).  dtype of
// x, B, C and y: 0 = float32, 1 = bfloat16.  dt, A, D and the states are
// float32; D and s_in may be null (no skip; zero state).  Strides are in
// elements; the last axis of x, B and C is contiguous.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the chosen body does not take.
int ssd_scan(int body, int hb, int dtype, const void* x, int64_t x_sb,
             int64_t x_sl, int64_t x_sh, const float* dt, int64_t dt_sb,
             int64_t dt_sl, int64_t dt_sh, const float* A, const void* B,
             int64_t B_sb, int64_t B_sl, int64_t B_sg, const void* C,
             int64_t C_sb, int64_t C_sl, int64_t C_sg, const float* D,
             const float* s_in, void* y, float* s_out, int b, int l, int h,
             int g, int dh, int ds, void* stream) {
  if (b < 1 || l < 1 || h < 1 || g < 1 || h % g || dh < 1 || dh > 128 ||
      ds < 4 || ds % 4 || (int64_t)b * h > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, x_sb, x_sl, x_sh, dt, dt_sb, dt_sl, dt_sh, A,
               B, B_sb, B_sl, B_sg, C, C_sb, C_sl, C_sg, D, s_in,
               y, s_out, b, l, h, g, dh, ds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    const bool aligned =
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
         reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(y)) % 16 == 0 &&
        (x_sb | x_sl | x_sh | B_sb | B_sl | B_sg | C_sb | C_sl | C_sg) % 8 == 0;
    if (dtype != 1 || dh % 16 || ds % 8 || ds > 128 || hb < 1 ||
        (h / g) % hb || hb * (dh / 16) > kMmaMaxWarps || !aligned ||
        mma_smem_bytes(hb, dh, mma_ds(ds)) > kMaxSmem) {
      return (int)cudaErrorInvalidValue;
    }
    switch (mma_ds(ds)) {
      case 32:
        return (int)launch_mma<32>(a, hb, s);
      case 64:
        return (int)launch_mma<64>(a, hb, s);
      default:
        return (int)launch_mma<128>(a, hb, s);
    }
  }
  if (body != 0 ||
      sizeof(float) * fma_smem_floats(dh <= 64 ? 64 : 128, ds) > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return (int)(dh <= 64 ? launch_fma<float, 64>(a, s)
                            : launch_fma<float, 128>(a, s));
    case 1:
      return (int)(dh <= 64 ? launch_fma<__nv_bfloat16, 64>(a, s)
                            : launch_fma<__nv_bfloat16, 128>(a, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
