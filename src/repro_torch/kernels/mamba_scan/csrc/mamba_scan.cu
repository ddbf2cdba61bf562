// Mamba2 SSD chunked selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py::_ssd_kernel
// (reached through ops.ssd from models/ssm.py in every Mamba layer of every
// prefill).  It computes the same function, per (batch b, head h), over the
// sequence split into chunks of q tokens, with the (P, N) f32 state S
// carried from chunk to chunk:
//   cum     = cumsum(dt * a)                           (q,)
//   M(i, j) = (C_i . B_j) * exp(cum_i - cum_j) * dt_j  for j <= i, else 0
//             (the causal mask applied before exp, as kernel.py:51 does)
//   y_i     = sum_j M(i, j) x_j + exp(cum_i) * (S C_i)
//   S       = exp(cum_q) * S + sum_j exp(cum_q - cum_j) dt_j x_j B_j^T
// and returns y in x's dtype and the final state in f32.  x, dt and y are
// read and written in the model's (B, L, H, P) / (B, L, H) layout, b and c
// as (B, L, N), so the wrapper makes no transposed copies.
//
// What replaces the TPU's sequential chunk axis.  The TPU grid walks
// (B, H, chunk) with the chunk axis sequential and S in VMEM scratch.  Here
// one block loops over the chunks itself, with S in registers (each thread
// owns 8 entries) mirrored into shared memory for the y_inter product.
//
// What bounds it on this card.  Operations, in f32: a 1024-token, 80-head
// zamba2 layer is about 2.7 GFLOP (0.04 ms at 67 TFLOP/s) against about
// 21 MB of traffic (0.006 ms at 3.35 TB/s).  In practice it is latency: the
// chunk loop is sequential, and a B = 1 prefill has only H = 80 (b, h)
// pairs for 132 SMs.
//
// What this design does about it.  It splits P across blocks, which is
// exact (state row p depends only on x[:, p]): one block owns PS = 16 of
// the P state rows of one (b, h), so zamba2's B = 1 prefill (P = 64)
// launches 4 x 80 = 320 blocks, about 59 KB of shared memory each, and
// several fit on an SM.  Each block recomputes the chunk's (q x q) decay
// and C B^T for its slice (at P = 64 the scores are about a third of the
// block's FMAs); the products run as f32 FMAs on the CUDA cores, and the
// prefix sum of dt * a runs in order on one thread (q adds).  Tensor-core
// products and a parallel scan are later work.
//
// Edges: q <= 64, N <= 64 (the shared tiles), P any (a ragged last slice is
// masked); q = min(chunk, L) must divide L, which the wrapper checks (the
// TPU kernel asserts it, kernel.py:84).
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QMAX = 64;           // longest chunk
constexpr int NMAX = 64;           // largest state dimension
constexpr int PS = 16;             // state rows (P) per block
constexpr int THREADS = 128;
constexpr int LDN = NMAX + 1;      // row strides padded against bank
constexpr int LDQ = QMAX + 1;      // conflicts
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

constexpr int smem_floats() {
  // B, C (q x N), M (q x q), X (q x PS), S (PS x N), cum, dt, w (q)
  return 2 * QMAX * LDN + QMAX * LDQ + QMAX * PS + PS * LDN + 3 * QMAX;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ms_ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const T* __restrict__ b,
              const T* __restrict__ c, T* __restrict__ y,
              float* __restrict__ s_fin, int L, int H, int P, int N, int q) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                  // (QMAX, LDN)
  float* Cs = Bs + QMAX * LDN;       // (QMAX, LDN)
  float* Ms = Cs + QMAX * LDN;       // (QMAX, LDQ)
  float* Xs = Ms + QMAX * LDQ;       // (QMAX, PS)
  float* Ss = Xs + QMAX * PS;        // (PS, LDN): the state entering a chunk
  float* cum = Ss + PS * LDN;        // (QMAX)
  float* dts = cum + QMAX;           // (QMAX)
  float* wts = dts + QMAX;           // (QMAX)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const float ah = a[h];

  // State: thread (sp, sn0) owns S[p0 + sp][sn0 + r], r < 8.
  const int sp = tid % PS, sn0 = (tid / PS) * 8;
  // y: thread (sp, yi0) computes y[yi0 + r][p0 + sp], r < 8.
  const int yi0 = (tid / PS) * 8;
  // Scores: thread (ti, tj) computes M[8 ti + r][tj + 16 c], r < 8, c < 4.
  const int ti = tid / 16, tj = tid % 16;

  float s_reg[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) s_reg[r] = 0.f;
  for (int i = tid; i < PS * LDN; i += THREADS) Ss[i] = 0.f;

  const int nc = L / q;
  for (int ci = 0; ci < nc; ++ci) {
    const size_t row0 = (size_t)bb * L + (size_t)ci * q;   // (b, l) row
    for (int i = tid; i < QMAX; i += THREADS)
      dts[i] = i < q ? dt[(row0 + i) * H + h] : 0.f;
#pragma unroll 4
    for (int it = 0; it < QMAX * NMAX / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int j = i / NMAX, n = i % NMAX;
      const bool ok = j < q && n < N;
      const size_t off = (row0 + j) * N + n;
      Bs[j * LDN + n] = ok ? to_f32(b[off]) : 0.f;
      Cs[j * LDN + n] = ok ? to_f32(c[off]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < QMAX * PS / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int j = i / PS, p = i % PS;
      const bool ok = j < q && p0 + p < P;
      Xs[i] = ok ? to_f32(x[((row0 + j) * H + h) * P + p0 + p]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                // inclusive prefix sum, in order
      float run = 0.f;
      for (int i = 0; i < q; ++i) {
        run += dts[i] * ah;
        cum[i] = run;
      }
      for (int i = q; i < QMAX; ++i) cum[i] = run;
    }
    __syncthreads();
    const float total = cum[q - 1];
    for (int j = tid; j < QMAX; j += THREADS)
      wts[j] = j < q ? expf(total - cum[j]) * dts[j] : 0.f;

    // M = (C B^T) .* decay .* dt_j, zero above the diagonal.
    {
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = Cs[(8 * ti + r) * LDN + n];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) bv[cc] = Bs[(tj + 16 * cc) * LDN + n];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] = fmaf(cv[r], bv[cc], acc[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = 8 * ti + r;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int j = tj + 16 * cc;
          const float seg = j <= i ? cum[i] - cum[j] : NEG_INF;
          Ms[i * LDQ + j] = acc[r][cc] * expf(seg) * dts[j];
        }
      }
    }
    __syncthreads();

    // y = M X + exp(cum) * (C S^T), with S the state entering the chunk.
    {
      float intra[8], inter[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) intra[r] = inter[r] = 0.f;
      const int j_end = min(q, yi0 + 8);           // M is zero past i
      for (int j = 0; j < j_end; ++j) {
        const float xv = Xs[j * PS + sp];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          intra[r] = fmaf(Ms[(yi0 + r) * LDQ + j], xv, intra[r]);
      }
      for (int n = 0; n < N; ++n) {
        const float sv = Ss[sp * LDN + n];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          inter[r] = fmaf(Cs[(yi0 + r) * LDN + n], sv, inter[r]);
      }
      if (p0 + sp < P) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = yi0 + r;
          if (i < q)
            store1(y + ((row0 + i) * H + h) * P + p0 + sp,
                   intra[r] + expf(cum[i]) * inter[r]);
        }
      }
    }
    __syncthreads();               // every read of Ss is done

    // S = exp(total) S + sum_j w_j x_j B_j^T
    {
      const float g = expf(total);
      float upd[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) upd[r] = 0.f;
      for (int j = 0; j < q; ++j) {
        const float xw = wts[j] * Xs[j * PS + sp];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          upd[r] = fmaf(xw, Bs[j * LDN + sn0 + r], upd[r]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        s_reg[r] = s_reg[r] * g + upd[r];
        Ss[sp * LDN + sn0 + r] = s_reg[r];
      }
    }
    __syncthreads();               // the chunk's tiles are free again
  }

  if (p0 + sp < P) {
    float* sb = s_fin + (((size_t)bb * H + h) * P + p0 + sp) * N;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (sn0 + r < N) sb[sn0 + r] = s_reg[r];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, void* y, float* s_fin, int B, int L, int H, int P,
           int N, int q, cudaStream_t stream) {
  const int smem = smem_floats() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ms_ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + PS - 1) / PS, H, B);
  ms_ssd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), s_fin, L, H, P, N, q);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, L, H, P); dt: (B, L, H) f32; a: (H,) f32; b, c: (B, L, N);
// s_fin: (B, H, P, N) f32; all contiguous.  x, b, c and y share one dtype
// (0 = float32, 1 = bfloat16).  q = the chunk, 1 <= q <= 64, dividing L;
// N <= 64.
extern "C" int ms_ssd(const void* x, const void* dt, const void* a,
                      const void* b, const void* c, void* y, void* s_fin,
                      int B, int L, int H, int P, int N, int q, int dtype,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      q <= 0 || q > QMAX || L % q != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(s_fin);
  if (dtype == 0)
    return launch<float>(x, dtf, af, b, c, y, sf, B, L, H, P, N, q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, b, c, y, sf, B, L, H, P, N, q,
                                 st);
  return (int)cudaErrorInvalidValue;
}
