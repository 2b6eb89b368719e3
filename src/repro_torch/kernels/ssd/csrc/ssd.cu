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
// Launch grid: one block of 256 threads per (batch, head).  The Pallas
// grid's sequential chunk axis becomes the loop inside the block, and the
// (ds, dh) fp32 state stays in shared memory from the first chunk to the
// last (it is read from init_state once and written once).  Shared memory
// holds, per chunk, x (fp32), B and C (fp32), the (kQ, kQ) masked decay
// matrix M and the per-row cumulative decays; at mamba2-1.3b's shape
// (ds 128, dh 64) that is 138 KB, one block per SM.  The three products
// (C B^T, then y from M x and C S, then the state update B^T x) are
// register-tiled: a 16 x 16 thread grid, each thread a 4-row block of a
// 64-row tile by 4 columns every 64, reading shared memory as 16-byte
// vectors.
//
// Exactness the serve path relies on: M is formed only for s <= t (the
// s > t lanes would overflow in exp), and with dt = 0 on every row of a
// slot the update is S * exp(0) + (sum of zeros) in fp32, so a parked slot
// leaves the kernel with its state bitwise unchanged; padding rows past l
// are loaded as x = B = C = dt = 0.  All arithmetic is fp32 on the CUDA
// cores (no TF32).
//
// Bound: at the serve path's prefill shape (16 x 1024, 64 heads of 64,
// ds 128) one call moves ~0.35 GB (x and y in bf16, the state in and out in
// fp32, B, C and dt) and does ~57 GFLOP of which this design runs all on the
// fp32 CUDA cores (67 TFLOP/s): ~0.85 ms at best against a 0.10 ms
// byte bound.  What the design does about it: each input byte is read once
// and each output byte written once, the state never leaves the block, and
// the masked upper triangle of M x is skipped.  What it does not do yet:
// tensor-core (mma / wgmma) products, sharing C B^T across the heads of a
// group, TMA or cp.async pipelining of the next chunk's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;             // chunk rows
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90

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

// Shared-memory floats for head dim padded to DH: x (kQ, DH+4), B and C
// (kQ, ds+4), M (kQ, kQ+4), the state (ds, DH+4), four (kQ,) vectors.
__host__ __device__ constexpr int64_t smem_floats(int DH, int ds) {
  return (int64_t)kQ * (DH + 4) + 2 * (int64_t)kQ * (ds + 4) +
         (int64_t)kQ * (kQ + 4) + (int64_t)ds * (DH + 4) + 4 * kQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
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

template <typename T, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool configured = false;   // opt in to > 48 KB once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const size_t smem = sizeof(float) * (size_t)smem_floats(DH, a.ds);
  ssd_kernel<T, DH><<<(unsigned)(a.b * a.h), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Args& a, cudaStream_t stream) {
  if (a.dh <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace

extern "C" {

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16.  dt, A, D and the
// states are float32; D and s_in may be null (no skip; zero state).
// Strides are in elements; the last axis of x, B and C is contiguous.
// Returns cudaGetLastError() after the launch.
int ssd_scan(int dtype, const void* x, int64_t x_sb, int64_t x_sl,
             int64_t x_sh, const float* dt, int64_t dt_sb, int64_t dt_sl,
             int64_t dt_sh, const float* A, const void* B, int64_t B_sb,
             int64_t B_sl, int64_t B_sg, const void* C, int64_t C_sb,
             int64_t C_sl, int64_t C_sg, const float* D, const float* s_in,
             void* y, float* s_out, int b, int l, int h, int g, int dh,
             int ds, void* stream) {
  if (b < 1 || l < 1 || h < 1 || g < 1 || h % g || dh < 1 || dh > 128 ||
      ds < 4 || ds % 4 || (int64_t)b * h > 0x7fffffff ||
      sizeof(float) * smem_floats(dh <= 64 ? 64 : 128, ds) > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, x_sb, x_sl, x_sh, dt, dt_sb, dt_sl, dt_sh, A,
               B, B_sb, B_sl, B_sg, C, C_sb, C_sl, C_sg, D, s_in,
               y, s_out, b, l, h, g, dh, ds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_dh<float>(a, s);
    case 1:
      return (int)launch_dh<__nv_bfloat16>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
