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
// ragged S (rows and keys at or past S are zero-filled and masked).  O is
// f32 in D: for bf16, the forward's output before its rounding, as
// autograd of the plain version has it.
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
// over the key tiles it can see.  Causal grids hand out their longest
// blocks first (the first key tiles, the last query tiles).
//
// bf16 (fa_bwd_dkdv_tc_kernel, fa_bwd_dq_tc_kernel): all five products on
// the tensor cores, mma.sync m16n8k16 with bf16 operands and f32 sums
// (mma_bf16.cuh): S = Q K^T and dP = dO V^T (recomputed per tile),
// dV += P^T dO, dK += dS^T Q and dQ += dS K.  Each of the 4 warps owns 16
// keys (dK/dV) or 16 query rows (dQ); its S and dP tiles stay in
// registers, where P = exp2(S * scale * log2(e) - lse * log2(e)) and
// dS = P (dP - D) are formed in f32 and become the A operands of the
// gradient products, whose sums stay f32 in registers.
//
// Precision.  P and dS enter as bf16 pairs hi + lo (hi = bf16(x),
// lo = bf16(x - hi): about 16 bits of x), two products each for dV, dK and
// dQ, so 8 products where 5 would do.  A single bf16 rounding of each
// measured (in the CPU emulation of tests/test_torch_kernels_emulated.py)
// as the largest errors of the bf16 gradients: each row of dS sums to zero
// over its keys, so dQ_i = scale sum_j dS_ij (k_j - kbar), and a rounding
// of dS reaches dQ times the keys' common part kbar (and dK times the
// queries'); with all-positive q and k that put dQ past the 2e-2
// tolerance, and P's rounding took dV to 0.8 of it, against 0.17 to 0.3
// for the pairs.  D needs the forward's f32 output for the same reason.
//
// The transposed operands come from ldmatrix.trans.  The tiles a block
// walks (Q, dO, lse and D for dK/dV; K and V for dQ) come through a
// double-buffered cp.async ring; the tiles it owns are loaded once.  A
// dK/dV block takes 64-row query tiles at hd 64 and 32-row ones at hd 128,
// which keeps its two f32 accumulators and two score tiles in registers.
// wgmma, TMA and warp specialisation are later work.
//
// f32 (fa_bwd_dkdv_kernel, fa_bwd_dq_kernel): tiles of 64 x 64 staged in
// shared memory as f32 and products as f32 FMAs on the CUDA cores (128
// threads, each owning an 8-row x 4-column patch of a 64 x 64 tile), which
// keeps f32 inputs at f32 accuracy: the tensor cores' bf16 and TF32 could
// not.  Its grids run in plain order.
//
// Interface: plain C, loaded with ctypes.  Launches three kernels on the
// caller's stream, allocates nothing (D is caller-provided scratch), does
// not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int THREADS = 128;       // bf16: 4 warps of 16 rows each
constexpr int TX = 16;             // threads across a tile's columns
constexpr int RPT = 8;             // rows per thread: 64 / (THREADS / TX)
constexpr int CPT = 4;             // tile columns per thread: 64 / TX
constexpr int LDP = 65;            // row stride of a 64 x 64 tile in smem

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }

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

// D = rowsum(dO * O) with O in f32: one warp per row of the (rows, HD)
// slabs.
template <typename T, int HD>
__global__ void fa_bwd_dot_kernel(const float* __restrict__ o,
                                  const T* __restrict__ dout,
                                  float* __restrict__ D, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;              // whole warps leave together
  const float* orow = o + (size_t)row * HD;
  const T* drow = dout + (size_t)row * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(orow[d], to_f32(drow[d]), acc);
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
      static_cast<const float*>(o), dop, D, rows);
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

// ---- bf16: the five products on the tensor cores ---------------------------

constexpr float LOG2E = 1.4426950408889634f;

// Query rows per tile of a dK/dV block: 64 at hd 64, 32 at hd 128.
template <int HD>
__host__ __device__ constexpr int dkdv_bq() { return HD == 64 ? 64 : 32; }

template <int HD>
constexpr int dkdv_tc_smem_bytes() {
  // K and V (BK rows), two stages of Q and dO (dkdv_bq rows), bf16; two
  // stages of lse and D (f32).
  return (2 * BK + 4 * dkdv_bq<HD>()) * (HD + tc::PAD) * 2 +
         4 * dkdv_bq<HD>() * 4;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int KV, int S,
                      float scale, int causal, int window) {
  constexpr int LD = HD + tc::PAD;
  constexpr int BQT = dkdv_bq<HD>();
  constexpr int KS = HD / 16;      // k-steps over the head dim
  constexpr int NT = BQT / 8;      // n8 tiles (queries) of S^T and dP^T
  constexpr int OT = HD / 8;       // n8 tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LD;
  __nv_bfloat16* Qs = Vs + BK * LD;          // stages at Qs, Qs + BQT * LD
  __nv_bfloat16* dOs = Qs + 2 * BQT * LD;
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQT * LD);
  float* Ds = Ls + 2 * BQT;

  // Grid (B * KV, key tiles): a causal grid's first key tiles, seen by
  // the most query tiles, go first.
  const int k0 = blockIdx.y * BK;
  const int kvh = blockIdx.x % KV;
  const int b = blockIdx.x / KV;
  const int G = H / KV;
  const size_t kv_off = ((size_t)b * KV + kvh) * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;                  // the warp's first key row
  const float sl2 = scale * LOG2E;

  // Query tiles that see a key of this tile, per head of the group.
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(S, k0 + BK - 1 + window) : S;
  const int qt_lo = q_lo / BQT;
  const int n_per = (q_hi + BQT - 1) / BQT - qt_lo;
  const int n_it = G * n_per;

  auto load_stage = [&](int it, int stg) {
    const int h = kvh * G + it / n_per;
    const int q0 = (qt_lo + it % n_per) * BQT;
    const size_t q_off = ((size_t)b * H + h) * S;
    tc::load_tile_async<HD, BQT, THREADS>(q + q_off * HD, q0, S,
                                             Qs + stg * BQT * LD);
    tc::load_tile_async<HD, BQT, THREADS>(dout + q_off * HD, q0, S,
                                             dOs + stg * BQT * LD);
    for (int i = threadIdx.x; i < BQT; i += THREADS) {
      const bool ok = q0 + i < S;
      const size_t at = q_off + (ok ? q0 + i : 0);
      tc::cp_async4(Ls + stg * BQT + i, lse + at, ok ? 4 : 0);
      tc::cp_async4(Ds + stg * BQT + i, D + at, ok ? 4 : 0);
    }
  };

  tc::load_tile_async<HD, BK, THREADS>(k + kv_off, k0, S, Ks);
  tc::load_tile_async<HD, BK, THREADS>(v + kv_off, k0, S, Vs);
  load_stage(0, 0);
  tc::cp_async_commit();

  float acc_dk[OT][4], acc_dv[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {
      load_stage(it + 1, stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();                   // this iteration's tiles landed
    const int q0 = (qt_lo + it % n_per) * BQT;
    const __nv_bfloat16* Qt = Qs + stage * BQT * LD;
    const __nv_bfloat16* dOt = dOs + stage * BQT * LD;
    const float* Lt = Ls + stage * BQT;
    const float* Dt = Ds + stage * BQT;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQT queries per warp.
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      tc::ldmatrix_x4(ka, Ks + tc::a_off<LD>(lane, wr, ks * 16));
      tc::ldmatrix_x4(va, Vs + tc::a_off<LD>(lane, wr, ks * 16));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bq[4], bo[4];
        tc::ldmatrix_x4(bq, Qt + tc::b_off<LD>(lane, np * 16, ks * 16));
        tc::mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        tc::mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
        tc::ldmatrix_x4(bo, dOt + tc::b_off<LD>(lane, np * 16, ks * 16));
        tc::mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
        tc::mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp(scale s - lse) on visible pairs; dS^T = P^T (dP^T - D).
    const bool edge = (q0 + BQT > S) || (k0 + BK > S) ||
                      (causal && k0 + BK - 1 > q0) ||
                      (window && q0 + BQT - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + wr + g + (e >> 1) * 8;
        const int ci = j * 8 + 2 * t4 + (e & 1);
        const bool ok = !edge || visible(q0 + ci, kj, S, causal, window);
        const float p = ok ? exp2f(st[j][e] * sl2 - Lt[ci] * LOG2E) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Dt[ci]);
      }

    // dV += P^T dO and dK += dS^T Q, the queries as the k dimension; P
    // and dS as hi + lo pairs (see the header).
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      tc::pack_a_hilo(ph, pl, st[2 * kk], st[2 * kk + 1]);
      tc::pack_a_hilo(dh, dl, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int op = 0; op < OT / 2; ++op) {
        uint32_t bo[4], bq[4];
        tc::ldmatrix_x4_trans(bo, dOt + tc::a_off<LD>(lane, kk * 16, op * 16));
        tc::mma_bf16(acc_dv[2 * op], ph, bo[0], bo[1]);
        tc::mma_bf16(acc_dv[2 * op + 1], ph, bo[2], bo[3]);
        tc::mma_bf16(acc_dv[2 * op], pl, bo[0], bo[1]);
        tc::mma_bf16(acc_dv[2 * op + 1], pl, bo[2], bo[3]);
        tc::ldmatrix_x4_trans(bq, Qt + tc::a_off<LD>(lane, kk * 16, op * 16));
        tc::mma_bf16(acc_dk[2 * op], dh, bq[0], bq[1]);
        tc::mma_bf16(acc_dk[2 * op + 1], dh, bq[2], bq[3]);
        tc::mma_bf16(acc_dk[2 * op], dl, bq[0], bq[1]);
        tc::mma_bf16(acc_dk[2 * op + 1], dl, bq[2], bq[3]);
      }
    }
    __syncthreads();                   // this stage may be refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + wr + g + i * 8;
    if (kj >= S) continue;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const size_t at = kv_off + (size_t)kj * HD + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dk + at) = tc::pack_bf16(
          acc_dk[j][2 * i] * scale, acc_dk[j][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          tc::pack_bf16(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
    }
  }
}

template <int HD>
constexpr int dq_tc_smem_bytes() {
  // Q and dO (BQ rows), two stages of K and V (BK rows), all bf16.
  return (2 * BQ + 4 * BK) * (HD + tc::PAD) * 2;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D,
                    __nv_bfloat16* __restrict__ dq, int H, int KV, int S,
                    float scale, int causal, int window) {
  constexpr int LD = HD + tc::PAD;
  constexpr int KS = HD / 16;
  constexpr int NT = BK / 8;       // n8 tiles (keys) of S and dP
  constexpr int OT = HD / 8;       // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * LD;
  __nv_bfloat16* Ks = dOs + BQ * LD;         // stages at Ks, Ks + BK * LD
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;

  // Grid (B * H, query tiles): a causal grid's last query tiles, which
  // see the most keys, go first.
  const int n_qt = gridDim.y;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const size_t q_off = ((size_t)b * H + h) * S;
  const size_t kv_off = ((size_t)b * KV + kvh) * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;                  // the warp's first query row
  const float sl2 = scale * LOG2E;

  // Keys this query tile sees: [k_lo, k_hi), as in the forward kernel.
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_lo / BK, t_end = (k_hi + BK - 1) / BK;

  tc::load_tile_async<HD, BQ, THREADS>(q + q_off * HD, q0, S, Qs);
  tc::load_tile_async<HD, BQ, THREADS>(dout + q_off * HD, q0, S, dOs);
  tc::load_tile_async<HD, BK, THREADS>(k + kv_off, t_begin * BK, S, Ks);
  tc::load_tile_async<HD, BK, THREADS>(v + kv_off, t_begin * BK, S, Vs);
  tc::cp_async_commit();

  float lse2[2], Dr[2];                      // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + wr + g + i * 8;
    lse2[i] = qi < S ? lse[q_off + qi] * LOG2E : 0.f;
    Dr[i] = qi < S ? D[q_off + qi] : 0.f;
  }
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      const int nxt = (stage ^ 1) * BK * LD;
      tc::load_tile_async<HD, BK, THREADS>(k + kv_off, (t + 1) * BK, S,
                                              Ks + nxt);
      tc::load_tile_async<HD, BK, THREADS>(v + kv_off, (t + 1) * BK, S,
                                              Vs + nxt);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();                   // tile t (and at first Q, dO) landed
    const __nv_bfloat16* Kt = Ks + stage * BK * LD;
    const __nv_bfloat16* Vt = Vs + stage * BK * LD;

    // S = Q K^T and dP = dO V^T: 16 query rows x 64 keys per warp.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      tc::ldmatrix_x4(qa, Qs + tc::a_off<LD>(lane, wr, ks * 16));
      tc::ldmatrix_x4(oa, dOs + tc::a_off<LD>(lane, wr, ks * 16));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4], bv[4];
        tc::ldmatrix_x4(bk, Kt + tc::b_off<LD>(lane, np * 16, ks * 16));
        tc::mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        tc::mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        tc::ldmatrix_x4(bv, Vt + tc::b_off<LD>(lane, np * 16, ks * 16));
        tc::mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
        tc::mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }

    // dS = P (dP - D), with P = exp(scale s - lse) on visible pairs.
    const int k0 = t * BK;
    const bool edge = edge_tile(q0, k0, S, causal, window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + wr + g + (e >> 1) * 8;
        const int kj = k0 + j * 8 + 2 * t4 + (e & 1);
        const bool ok = !edge || visible(qi, kj, S, causal, window);
        const float p = ok ? exp2f(s[j][e] * sl2 - lse2[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - Dr[e >> 1]);
      }

    // dQ += dS K, the keys as the k dimension; dS as a hi + lo pair.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t dh[4], dl[4];
      tc::pack_a_hilo(dh, dl, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int op = 0; op < OT / 2; ++op) {
        uint32_t bk[4];
        tc::ldmatrix_x4_trans(bk, Kt + tc::a_off<LD>(lane, kk * 16, op * 16));
        tc::mma_bf16(acc[2 * op], dh, bk[0], bk[1]);
        tc::mma_bf16(acc[2 * op + 1], dh, bk[2], bk[3]);
        tc::mma_bf16(acc[2 * op], dl, bk[0], bk[1]);
        tc::mma_bf16(acc[2 * op + 1], dl, bk[2], bk[3]);
      }
    }
    __syncthreads();                   // this stage may be refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + wr + g + i * 8;
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<uint32_t*>(dq + (q_off + qi) * HD + j * 8 + 2 * t4) =
          tc::pack_bf16(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* D, void* dq, void* dk,
              void* dv, int B, int H, int KV, int S, float scale, int causal,
              int window, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const int n_kt = (S + BK - 1) / BK, n_qt = (S + BQ - 1) / BQ;
  if (n_kt > 65535 || n_qt > 65535) return (int)cudaErrorInvalidValue;
  const int rows = B * H * S;
  fa_bwd_dot_kernel<bf16, HD><<<(rows + 3) / 4, THREADS, 0, stream>>>(
      static_cast<const float*>(o), dop, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_kv = dkdv_tc_smem_bytes<HD>();
  err = cudaFuncSetAttribute(fa_bwd_dkdv_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv_tc_kernel<HD>
      <<<dim3(B * KV, n_kt), THREADS, smem_kv, stream>>>(
          qp, kp, vp, dop, lse, D, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), H, KV, S, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_q = dq_tc_smem_bytes<HD>();
  err = cudaFuncSetAttribute(fa_bwd_dq_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_tc_kernel<HD><<<dim3(B * H, n_qt), THREADS, smem_q, stream>>>(
      qp, kp, vp, dop, lse, D, static_cast<bf16*>(dq), H, KV, S, scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, H, S, hd); k, v, dk, dv: (B, KV, S, hd); lse and the
// scratch D: (B, H, S) f32.  All contiguous and 16-byte aligned; dtype
// 0 = float32, 1 = bfloat16 for every tensor but o, lse and D, which are
// f32 (o: the forward's output before any rounding); hd 64 or 128.
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
    return launch_tc<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, KV, S,
                         scale, causal, window, st);
  if (dtype == 1 && hd == 128)
    return launch_tc<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, KV, S,
                          scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
