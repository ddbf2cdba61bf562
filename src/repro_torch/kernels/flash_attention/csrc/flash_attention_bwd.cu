// Causal / windowed GQA FlashAttention-2 backward for Hopper (sm_90a).
//
// The JAX package has no backward kernel: under jax.grad its attention is
// differentiated by XLA through the plain path (models/attention.py sdpa /
// sdpa_blocked), and the Pallas forward kernel
// src/repro/kernels/flash_attention/kernel.py::_fa_kernel has no VJP.  This
// file is the gradient of the port's forward kernel (flash_attention.cu),
// the same function as autograd of the plain version ref.attention_ref.
//
// With S = scale * q k^T, P = exp(S - lse) (lse from the forward pass),
// O = P v and the incoming dO, for query head h reading kv head h / (H/KV):
//     D_i   = sum_d dO_id O_id                      (fa_bwd_dot_kernel)
//     dP_ij = dO_i . v_j,   dS_ij = P_ij (dP_ij - D_i)
//     dV_j  = sum_{h in group, i} P_ij dO_i          (fa_bwd_dkdv_kernel)
//     dK_j  = scale * sum_{h in group, i} dS_ij q_i  (fa_bwd_dkdv_kernel)
//     dQ_i  = scale * sum_j dS_ij k_j                (fa_bwd_dq_kernel)
// with the forward's masks: causal (j <= i), window (i - j < window), and
// ragged S (rows and keys at or past S are zero-filled and masked).
//
// What bounds it on this card.  About 10 * B * H * pairs * hd FLOPs (the
// two products recomputed, three gradient products, each over the
// unmasked pairs); at the training shape that is the tensor cores' bound
// for bf16.  The bytes (q, k, v, o, dO, lse in; dq, dk, dv out) bound it
// only at short S.
//
// What this design does about it.  The S x S probabilities never reach
// device memory: they are recomputed per tile from lse.  FA2's split
// avoids atomics, so two identical calls give identical gradients: one
// block per (key tile, kv head, batch) owns its dK/dV tile in registers
// and loops over the group's query heads and the query tiles that can see
// it; one block per (query tile, head, batch) owns its dQ tile and loops
// over the key tiles it can see.  Tiles are 64 x 64, staged in shared
// memory as f32; products are f32 FMAs on the CUDA cores (128 threads,
// each owning an 8-row x 4-column patch of a 64 x 64 tile), like the
// forward kernel.  So f32 inputs keep f32 accuracy, and the kernel is
// bound by the FMA and shared-memory pipes, far from the tensor-core
// bound; mma.sync / wgmma products are later work.  Load balance is
// plain: a causal dK/dV block of an early key tile visits every query
// tile, a late one a single tile.
//
// Interface: plain C, loaded with ctypes.  Launches three kernels on the
// caller's stream, allocates nothing (D is caller-provided scratch), does
// not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int THREADS = 128;
constexpr int TX = 16;             // threads across a tile's columns
constexpr int RPT = 8;             // rows per thread: 64 / (THREADS / TX)
constexpr int CPT = 4;             // tile columns per thread: 64 / TX
constexpr int LDP = 65;            // row stride of a 64 x 64 tile in smem

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of a contiguous (S, HD) slab into shared memory as
// f32 with row stride HD + 1.  Rows at or past S are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int S, float* dst) {
  constexpr int N = VecWidth<T>::N;
  constexpr int PER_ROW = HD / N;
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * N;
    float vals[N];
    if (row0 + r < S) {
      load16(src + (size_t)(row0 + r) * HD + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * LD + c + e] = vals[e];
  }
}

// lse and D of query rows [q0, q0 + 64) into shared memory (0 past S).
__device__ __forceinline__ void load_rows(const float* __restrict__ lse,
                                          const float* __restrict__ D, int q0,
                                          int S, float* Ls, float* Ds) {
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    Ls[threadIdx.x] = qi < S ? lse[qi] : 0.f;
    Ds[threadIdx.x] = qi < S ? D[qi] : 0.f;
  }
}

// Whether (query qi, key kj) is attended.
__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal,
                                        int window) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (!window || qi - kj < window);
}

// True where the (q0, k0) tile pair needs elementwise masks: it crosses the
// diagonal, the window's edge or the ragged end of S.
__device__ __forceinline__ bool edge_tile(int q0, int k0, int S, int causal,
                                          int window) {
  return (q0 + BQ > S) || (k0 + BK > S) || (causal && k0 + BK - 1 > q0) ||
         (window && q0 + BQ - 1 - k0 >= window);
}

// D = rowsum(dO * O): one warp per row of the (rows, HD) slabs.
template <typename T, int HD>
__global__ void fa_bwd_dot_kernel(const T* __restrict__ o,
                                  const T* __restrict__ dout,
                                  float* __restrict__ D, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;              // whole warps leave together
  const T* orow = o + (size_t)row * HD;
  const T* drow = dout + (size_t)row * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

template <int HD>
constexpr int dkdv_smem_floats() {
  // K, V, Q, dO tiles (64 x HD+1), P^T and dS^T tiles (64 x 65), lse and D.
  return 4 * 64 * (HD + 1) + 2 * 64 * LDP + 2 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   T* __restrict__ dk, T* __restrict__ dv, int H, int KV,
                   int S, float scale, int causal, int window) {
  constexpr int LD = HD + 1;
  constexpr int OPT = HD / TX;     // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;       // P^T: key rows, query columns
  float* dSs = Ps + BK * LDP;      // dS^T
  float* Ls = dSs + BK * LDP;
  float* Ds = Ls + BQ;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const size_t kv_off = ((size_t)b * KV + kvh) * S * HD;
  const int tx = threadIdx.x % TX;
  const int r0 = (threadIdx.x / TX) * RPT;   // this thread's key rows

  load_tile<T, HD>(k + kv_off, k0, S, Ks);
  load_tile<T, HD>(v + kv_off, k0, S, Vs);

  float acc_dk[RPT][OPT], acc_dv[RPT][OPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc_dk[r][j] = acc_dv[r][j] = 0.f;

  // Query rows that see a key of this tile: [q_lo, q_hi).
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(S, k0 + BK - 1 + window) : S;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    const size_t q_off = ((size_t)b * H + h) * S;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();             // last tile's reads of Q, dO, P, dS done
      load_tile<T, HD>(q + q_off * HD, q0, S, Qs);
      load_tile<T, HD>(dout + q_off * HD, q0, S, dOs);
      load_rows(lse + q_off, D + q_off, q0, S, Ls, Ds);
      __syncthreads();
      const bool edge = edge_tile(q0, k0, S, causal, window);

      // P^T[j][i] = exp(scale * k_j . q_i - lse_i) on visible pairs.
      float s[RPT][CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float kr[RPT], qc[CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) kr[r] = Ks[(r0 + r) * LD + d];
#pragma unroll
        for (int c = 0; c < CPT; ++c) qc[c] = Qs[(tx + c * TX) * LD + d];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(kr[r], qc[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int i = tx + c * TX;
          const bool ok = !edge || visible(q0 + i, k0 + r0 + r, S, causal,
                                           window);
          Ps[(r0 + r) * LDP + i] = ok ? expf(s[r][c] * scale - Ls[i]) : 0.f;
        }

      // dS^T[j][i] = P^T[j][i] * (v_j . dO_i - D_i).  Each thread reads
      // back only the P entries it wrote itself.
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float vr[RPT], oc[CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) vr[r] = Vs[(r0 + r) * LD + d];
#pragma unroll
        for (int c = 0; c < CPT; ++c) oc[c] = dOs[(tx + c * TX) * LD + d];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(vr[r], oc[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int i = tx + c * TX;
          dSs[(r0 + r) * LDP + i] = Ps[(r0 + r) * LDP + i] * (s[r][c] - Ds[i]);
        }
      __syncthreads();             // the whole P and dS tiles are written

      // dV_j += sum_i P^T[j][i] dO_i;  dK_j += sum_i dS^T[j][i] q_i.
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pr[RPT], sr[RPT], oc[OPT], qc[OPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          pr[r] = Ps[(r0 + r) * LDP + i];
          sr[r] = dSs[(r0 + r) * LDP + i];
        }
#pragma unroll
        for (int j = 0; j < OPT; ++j) {
          oc[j] = dOs[i * LD + tx + j * TX];
          qc[j] = Qs[i * LD + tx + j * TX];
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int j = 0; j < OPT; ++j) {
            acc_dv[r][j] = fmaf(pr[r], oc[j], acc_dv[r][j]);
            acc_dk[r][j] = fmaf(sr[r], qc[j], acc_dk[r][j]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int kj = k0 + r0 + r;
    if (kj >= S) continue;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const size_t at = kv_off + (size_t)kj * HD + tx + j * TX;
      store1(dk + at, acc_dk[r][j] * scale);
      store1(dv + at, acc_dv[r][j]);
    }
  }
}

template <int HD>
constexpr int dq_smem_floats() {
  // Q, dO, K, V tiles (64 x HD+1), the dS tile (64 x 65), lse and D.
  return 4 * 64 * (HD + 1) + 64 * LDP + 2 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 T* __restrict__ dq, int H, int KV, int S, float scale,
                 int causal, int window) {
  constexpr int LD = HD + 1;
  constexpr int OPT = HD / TX;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;       // query rows, key columns
  float* Ls = dSs + BQ * LDP;
  float* Ds = Ls + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_off = ((size_t)b * H + h) * S;
  const size_t kv_off = ((size_t)b * KV + kvh) * S * HD;
  const int tx = threadIdx.x % TX;
  const int r0 = (threadIdx.x / TX) * RPT;   // this thread's query rows

  load_tile<T, HD>(q + q_off * HD, q0, S, Qs);
  load_tile<T, HD>(dout + q_off * HD, q0, S, dOs);
  load_rows(lse + q_off, D + q_off, q0, S, Ls, Ds);

  float acc[RPT][OPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[r][j] = 0.f;

  // Keys this query tile sees: [k_lo, k_hi), as in the forward kernel.
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();               // last tile's reads of K, V, dS are done
    load_tile<T, HD>(k + kv_off, k0, S, Ks);
    load_tile<T, HD>(v + kv_off, k0, S, Vs);
    __syncthreads();
    const bool edge = edge_tile(q0, k0, S, causal, window);

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qr[RPT], orow[RPT], kc[CPT], vc[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        qr[r] = Qs[(r0 + r) * LD + d];
        orow[r] = dOs[(r0 + r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        kc[c] = Ks[(tx + c * TX) * LD + d];
        vc[c] = Vs[(tx + c * TX) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
          dp[r][c] = fmaf(orow[r], vc[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = tx + c * TX;
        const bool ok = !edge || visible(q0 + r0 + r, k0 + j, S, causal,
                                         window);
        const float p = ok ? expf(s[r][c] * scale - Ls[r0 + r]) : 0.f;
        dSs[(r0 + r) * LDP + j] = p * (dp[r][c] - Ds[r0 + r]);
      }
    __syncthreads();               // the whole dS tile is written

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sr[RPT], kc[OPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) sr[r] = dSs[(r0 + r) * LDP + j];
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) kc[jj] = Ks[j * LD + tx + jj * TX];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int jj = 0; jj < OPT; ++jj)
          acc[r][jj] = fmaf(sr[r], kc[jj], acc[r][jj]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= S) continue;
#pragma unroll
    for (int jj = 0; jj < OPT; ++jj)
      store1(dq + (q_off + qi) * HD + tx + jj * TX, acc[r][jj] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int H, int KV, int S, float scale, int causal,
           int window, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int rows = B * H * S;
  fa_bwd_dot_kernel<T, HD><<<(rows + 3) / 4, THREADS, 0, stream>>>(
      static_cast<const T*>(o), dop, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_kv = dkdv_smem_floats<HD>() * (int)sizeof(float);
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv_kernel<T, HD>
      <<<dim3((S + BK - 1) / BK, KV, B), THREADS, smem_kv, stream>>>(
          qp, kp, vp, dop, lse, D, static_cast<T*>(dk), static_cast<T*>(dv),
          H, KV, S, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_q = dq_smem_floats<HD>() * (int)sizeof(float);
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_kernel<T, HD>
      <<<dim3((S + BQ - 1) / BQ, H, B), THREADS, smem_q, stream>>>(
          qp, kp, vp, dop, lse, D, static_cast<T*>(dq), H, KV, S, scale,
          causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, H, S, hd); k, v, dk, dv: (B, KV, S, hd); lse and the
// scratch D: (B, H, S) f32.  All contiguous and 16-byte aligned; dtype
// 0 = float32, 1 = bfloat16 for every tensor but lse and D; hd 64 or 128.
extern "C" int fa_backward(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* D, void* dq, void* dk, void* dv, int B, int H,
                           int KV, int S, int hd, float scale, int causal,
                           int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, KV, S,
                             scale, causal, window, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, KV, S,
                              scale, causal, window, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, dout, l, d, dq, dk, dv, B, H,
                                     KV, S, scale, causal, window, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, dout, l, d, dq, dk, dv, B,
                                      H, KV, S, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
