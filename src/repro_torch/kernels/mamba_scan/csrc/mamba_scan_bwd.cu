// The backward of the Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/mamba_scan/kernel.py::ssd_scan has no
// backward: the JAX package trains through jax.grad of the jnp path
// (models/ssm.py::ssd_chunked).  This kernel is the gradient of the
// forward that csrc/mamba_scan.cu computes, per (batch b, head h) over the
// chunks of q tokens (cum = the chunk's inclusive prefix sum of dt * a,
// total = cum_{q-1}, L_ij = exp(cum_i - cum_j) for j <= i, else 0):
//   y_i   = sum_j (C_i . B_j) L_ij dt_j x_j + exp(cum_i) S_in C_i
//   S_out = exp(total) S_in + sum_j w_j x_j B_j^T,
// w_j = exp(total - cum_j) dt_j.  Given dy and the final state's gradient
// (or 0), with dS the gradient of the state leaving a chunk, walked from
// the last chunk to the first, M1_ij = (C_i . B_j) L_ij dt_j and M2_ij =
// (dy_i . x_j) L_ij dt_j:
//   dx_j   = sum_i M1_ij dy_i + w_j dS B_j
//   dB_j   = sum_i M2_ij C_i + w_j dS^T x_j
//   dC_i   = sum_j M2_ij B_j + exp(cum_i) S_in^T dy_i
//   dS_in  = exp(total) dS + sum_i exp(cum_i) dy_i C_i^T
//   dcum_i = sum_j G_ij - sum_j G_ji + C_i . (exp(cum_i) S_in^T dy_i)
//            - w_i (x_i . dS B_i),  G_ij = M1_ij (dy_i . x_j),
//            and d total = sum_j w_j (x_j . dS B_j) + exp(total) <dS, S_in>
//            joins dcum_{q-1}
//   d dt_k = sum_i (C_i . B_k) L_ik (dy_i . x_k) + exp(total - cum_k)
//            (x_k . dS B_k) + a r_k,   r_k = sum_{i >= k} dcum_i
//   d a    = sum over (b, chunk, k) of dt_k r_k
// and dB, dC and d a summed over the heads (b and c are shared by them).
//
// Two routes, one per dtype.  Reruns are bit-equal on both: no atomics,
// every sum in a fixed order.
//
// The bf16 route, chunk-parallel on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 sums; kernels/include/mma_bf16.cuh).  The state and
// its gradient cross the chunks by element-wise recurrences, and nothing
// in dS's recurrence depends on the gates' gradients, so no block walks
// the chunks:
//   1. msb_cb (grid (chunks, B)): C B^T of each chunk once for all the
//      heads (b and c are bf16 inputs: one exact product), and every
//      head's cum in order (thread h for head h, with the forward's
//      chunk_cumsum of kernels/include/ssd_tc.cuh: one product and one sum
//      a token; another order moves the decays enough to fail zamba2's
//      full-depth check).
//   2. msb_own (grid (chunks, H, B)): each chunk's own contributions to
//      the state and to its gradient, (w o X)^T B and (exp(cum) o dY)^T C.
//   3. msb_state (a thread a state element (b, h, p, n)): the state
//      entering each chunk, forward over the chunks, and the gradient of
//      the state leaving it, backward, with the f32 recurrence g S + own
//      of the f32 route; in place over the own parts.
//   4. msb_chunk (grid (chunks, H, B), 2560 blocks at zamba2's training
//      shape against the f32 route's B H = 160): M1 and M2 from C B^T,
//      dY X^T and cum; dx, each head's dB and dC, and the token sums of the
//      gates' gradients, each warp over 16 whole rows, so a row's sums
//      are warp shuffles; the column sums across the four warps in warp
//      order; d cum's reverse prefix by one warp's scan in a fixed order;
//      d dt, and d a's partial a chunk.
//   5. msb_heads: dB and dC summed over the heads in head order, d a over
//      (b, chunk) in order.
// f32 operands enter the products in three bf16 parts (split3 of
// ssd_tc.cuh, as the forward's ms_ssd_tc keeps f32's ~24 bits: a hi + lo
// pair moved y enough to fail zamba2's full-depth prefill): M1, M2, the
// state S_in, dS, and the scaled w o X and exp(cum) o dY.  x, dy, b and c
// enter once.  The inputs are staged by cp.async.
//
// The f32 route keeps the CUDA-core walk: msb_walk (grid (H, B), 256
// threads), a forward walk over the chunks that rebuilds the state
// entering each chunk into f32 scratch, then the reverse walk with dS in
// shared memory, every product a 64 x 64 tile product from shared memory
// (a 4 x 4 register block a thread); then msb_heads.
//
// What bounds it on this card.  At zamba2's training shape (rank batch 2
// x 1024 tokens, H 80, P = N = q = 64) the gradient needs ~8 GFLOP of
// products (0.008 ms at the bf16 tensor-core peak) and moves ~65 MB of
// inputs and outputs (0.02 ms): bytes.  The bf16 route does the f32
// operands' products three times over (split3, ~30 GFLOP of mma.sync) and
// keeps the states, their gradients and each head's dB and dC in f32
// scratch (~170 MB written once and read once): the passes are bound by
// those bytes.
//
// Edges: q <= 64, P <= 64, N <= 64; q divides L (the wrapper checks).
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the wrapper passes the scratch), does not
// synchronise, returns the first CUDA error of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "ssd_tc.cuh"

namespace {

using ssd::chunk_cumsum;
using ssd::LDT;
using ssd::load64;
using ssd::NPART;
using ssd::PL;
using ssd::split3;
using ssd::store3;
using ssd::T64;

typedef __nv_bfloat16 bf16;

constexpr int T = 64;              // tile side: chunk, P and N at most T
constexpr int LD = T + 1;          // row stride of an f32 tile
constexpr int THREADS = 256;       // 16 x 16 threads, a 4 x 4 block each
constexpr int TILE = T * LD;
constexpr int NTILE = 8;           // X, dY, B, C, S_in, dS, M1, M2
constexpr int NVEC = 4;            // dt, cum, w, exp(cum)
constexpr int NRED = 5;            // partial sums: rowG, colG, colH, dw, dci
constexpr int SMEM_FLOATS =
    NTILE * TILE + NVEC * T + NRED * 16 * T + THREADS;

__device__ __forceinline__ void stf(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// acc[r][c] += sum_{k < K} A(ti + 16 r, k) B(tj + 16 c, k) (times ks[k]
// where ks is given), with A(m, k) = A[m * ars + k * aks] and B(n, k) =
// B[n * bcs + k * bks]: every product of the walk, in either orientation.
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* A,
                                   int ars, int aks, const float* B, int bcs,
                                   int bks, int K, int ti, int tj,
                                   const float* ks = nullptr) {
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[(ti + 16 * r) * ars + k * aks];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = B[(tj + 16 * c) * bcs + k * bks];
    if (ks != nullptr) {
      const float s = ks[k];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] *= s;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// A T x T tile of f32 from rows of src (row stride rs): rows at or past nr
// and columns at or past nc read as 0.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t rs, int nr, int nc) {
  for (int i = threadIdx.x; i < T * T; i += THREADS) {
    const int r = i / T, c = i % T;
    dst[r * LD + c] = (r < nr && c < nc) ? src[(size_t)r * rs + c] : 0.f;
  }
}

// The factor that carries the state (and its gradient) across a chunk.
__device__ __forceinline__ float state_carry(float total) {
  return expf(total);
}

// The gradient of the state entering a chunk from the one leaving it (ds)
// and the chunk's own outputs' part (own); both routes take it here.
__device__ __forceinline__ float carry_back(float g, float ds, float own) {
  return g * ds + own;
}

// Sum over the 16 partials red[k * T + i], k = 0..15, in order.
__device__ __forceinline__ float sum16(const float* red, int i) {
  float s = 0.f;
  for (int k = 0; k < 16; ++k) s += red[k * T + i];
  return s;
}

__global__ void __launch_bounds__(THREADS)
msb_walk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ dy,
                const float* __restrict__ ds_fin, float* __restrict__ s_in,
                float* __restrict__ dx, float* __restrict__ ddt,
                float* __restrict__ dbp, float* __restrict__ dcp,
                float* __restrict__ dap, int L, int H, int P, int N, int q) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                // [j][p]
  float* dYs = Xs + TILE;          // [i][p]
  float* Bs = dYs + TILE;          // [j][n]
  float* Cs = Bs + TILE;           // [i][n]
  float* Ss = Cs + TILE;           // [p][n]: the state entering the chunk
  float* dS = Ss + TILE;           // [p][n]: the gradient of the state
                                   // leaving it
  float* M1 = dS + TILE;           // [i][j]
  float* M2 = M1 + TILE;           // [i][j]
  float* dts = M2 + TILE;
  float* cum = dts + T;
  float* wv = cum + T;
  float* ec = wv + T;
  float* red = ec + T;             // NRED x 16 x T partial sums
  float* red_row = red, *red_col = red + 16 * T, *red_colh = red + 32 * T,
       *red_dw = red + 48 * T, *red_dci = red + 64 * T;
  float* red_blk = red + NRED * 16 * T;     // THREADS

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int h = blockIdx.x, bb = blockIdx.y, nc = L / q;
  const float ah = a[h];
  const size_t HP = (size_t)H * P;
  float* sbh = s_in + ((size_t)bb * H + h) * nc * P * N;

  // ---- 1. the state entering each chunk ----
  float s[4][4];
  zero(s);
  for (int ci = 0; ci < nc; ++ci) {
    const size_t row0 = (size_t)bb * L + (size_t)ci * q;
    load_tile(Xs, x + row0 * HP + (size_t)h * P, HP, q, P);
    load_tile(Bs, b + row0 * N, N, q, N);
    if (tid < T) dts[tid] = tid < q ? dt[(row0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) chunk_cumsum(dts, 1, ah, q, cum);
    __syncthreads();
    const float total = cum[q - 1];
    if (tid < T) wv[tid] = tid < q ? expf(total - cum[tid]) * dts[tid] : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = ti + 16 * r, n = tj + 16 * cc;
        if (p < P && n < N) sbh[((size_t)ci * P + p) * N + n] = s[r][cc];
      }
    __syncthreads();
    const float g = state_carry(total);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[r][cc] *= g;
    mm(s, Xs, 1, LD, Bs, 1, LD, q, ti, tj, wv);  // (w o X)^T B
    __syncthreads();
  }

  // ---- 2. the reverse walk ----
  for (int i = tid; i < T * T; i += THREADS) {
    const int p = i / T, n = i % T;
    dS[p * LD + n] = (ds_fin != nullptr && p < P && n < N)
                         ? ds_fin[(((size_t)bb * H + h) * P + p) * N + n]
                         : 0.f;
  }
  float da_run = 0.f;                       // thread 0's, in chunk order
  for (int ci = nc - 1; ci >= 0; --ci) {
    const size_t row0 = (size_t)bb * L + (size_t)ci * q;
    load_tile(Xs, x + row0 * HP + (size_t)h * P, HP, q, P);
    load_tile(dYs, dy + row0 * HP + (size_t)h * P, HP, q, P);
    load_tile(Bs, b + row0 * N, N, q, N);
    load_tile(Cs, c + row0 * N, N, q, N);
    load_tile(Ss, sbh + (size_t)ci * P * N, N, P, N);
    if (tid < T) dts[tid] = tid < q ? dt[(row0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) chunk_cumsum(dts, 1, ah, q, cum);
    __syncthreads();
    const float total = cum[q - 1];
    if (tid < T) {
      wv[tid] = tid < q ? expf(total - cum[tid]) * dts[tid] : 0.f;
      ec[tid] = tid < q ? expf(cum[tid]) : 0.f;
    }

    // C B^T and dY X^T, then M1, M2 and the sums of G and H = G / dt
    float cb[4][4], dx4[4][4];
    zero(cb);
    zero(dx4);
    mm(cb, Cs, LD, 1, Bs, LD, 1, N, ti, tj);
    mm(dx4, dYs, LD, 1, Xs, LD, 1, P, ti, tj);
    float grow[4] = {0.f, 0.f, 0.f, 0.f}, gcol[4] = {0.f, 0.f, 0.f, 0.f},
          hcol[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = ti + 16 * r, j = tj + 16 * cc;
        const float lij = (j <= i && i < q) ? expf(cum[i] - cum[j]) : 0.f;
        const float hv = cb[r][cc] * lij * dx4[r][cc];
        const float gv = hv * dts[j];
        M1[i * LD + j] = cb[r][cc] * lij * dts[j];
        M2[i * LD + j] = dx4[r][cc] * lij * dts[j];
        grow[r] += gv;
        gcol[cc] += gv;
        hcol[cc] += hv;
      }
#pragma unroll
    for (int r = 0; r < 4; ++r) red_row[tj * T + ti + 16 * r] = grow[r];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      red_col[ti * T + tj + 16 * cc] = gcol[cc];
      red_colh[ti * T + tj + 16 * cc] = hcol[cc];
    }
    __syncthreads();

    // dx = M1^T dY + w o (B dS^T), and dw_j = x_j . (dS B_j)
    float acc[4][4], v[4][4];
    zero(acc);
    zero(v);
    mm(acc, M1, 1, LD, dYs, 1, LD, q, ti, tj);
    mm(v, Bs, LD, 1, dS, LD, 1, N, ti, tj);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ti + 16 * r;
      float dwp = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tj + 16 * cc;
        dwp += Xs[j * LD + p] * v[r][cc];
        if (j < q && p < P)
          dx[(row0 + j) * HP + (size_t)h * P + p] =
              acc[r][cc] + wv[j] * v[r][cc];
      }
      red_dw[tj * T + j] = dwp;
    }

    // this head's dB = M2^T C + w o (X dS)
    float* dbh = dbp + ((size_t)bb * H + h) * L * N;
    float* dch = dcp + ((size_t)bb * H + h) * L * N;
    zero(acc);
    zero(v);
    mm(acc, M2, 1, LD, Cs, 1, LD, q, ti, tj);
    mm(v, Xs, LD, 1, dS, 1, LD, P, ti, tj);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = ti + 16 * r, n = tj + 16 * cc;
        if (j < q && n < N)
          dbh[((size_t)ci * q + j) * N + n] = acc[r][cc] + wv[j] * v[r][cc];
      }

    // this head's dC = M2 B + exp(cum) o (dY S_in), and C_i . its second
    // term (d cum through y's inter-chunk term)
    zero(acc);
    zero(v);
    mm(acc, M2, LD, 1, Bs, 1, LD, q, ti, tj);
    mm(v, dYs, LD, 1, Ss, 1, LD, P, ti, tj);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti + 16 * r;
      float dcip = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = tj + 16 * cc;
        const float u = ec[i] * v[r][cc];
        dcip += Cs[i * LD + n] * u;
        if (i < q && n < N)
          dch[((size_t)ci * q + i) * N + n] = acc[r][cc] + u;
      }
      red_dci[tj * T + i] = dcip;
    }

    // <dS, S_in>, then dS_in = exp(total) dS + (exp(cum) o dY)^T C
    float cd = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int o = (ti + 16 * r) * LD + tj + 16 * cc;
        cd += dS[o] * Ss[o];
      }
    red_blk[tid] = cd;
    zero(acc);
    mm(acc, dYs, 1, LD, Cs, 1, LD, q, ti, tj, ec);
    const float g = state_carry(total);
    __syncthreads();               // every read of dS and the partials done
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int o = (ti + 16 * r) * LD + tj + 16 * cc;
        dS[o] = carry_back(g, dS[o], acc[r][cc]);
      }

    // the gates: d cum, its reverse prefix sum, d dt and d a (thread 0,
    // in order)
    if (tid == 0) {
      float carry_dot = 0.f;
      for (int k = 0; k < THREADS; ++k) carry_dot += red_blk[k];
      float dtotal = g * carry_dot;
      for (int j = 0; j < q; ++j) dtotal += wv[j] * sum16(red_dw, j);
      float run = 0.f;
      for (int k = q - 1; k >= 0; --k) {
        const float dwk = sum16(red_dw, k);
        float dcum = sum16(red_row, k) - sum16(red_col, k) +
                     sum16(red_dci, k) - wv[k] * dwk;
        if (k == q - 1) dcum += dtotal;
        run += dcum;
        ddt[(row0 + k) * H + h] =
            sum16(red_colh, k) + expf(total - cum[k]) * dwk + ah * run;
        da_run += dts[k] * run;
      }
    }
    __syncthreads();               // the chunk's tiles are free again
  }
  if (tid == 0) dap[(size_t)bb * H + h] = da_run;
}

// dB and dC: the heads' partials summed in head order, rounded once; d a:
// the partials (np a batch row and head: its chunks', or one) summed in
// order.
template <typename E>
__global__ void msb_heads_kernel(const float* __restrict__ dbp,
                                 const float* __restrict__ dcp,
                                 const float* __restrict__ dap,
                                 E* __restrict__ db, E* __restrict__ dc,
                                 float* __restrict__ da, int B, int L, int H,
                                 int N, int np) {
  const size_t total = (size_t)B * L * N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (size_t)H) {
    float s = 0.f;
    for (int bb = 0; bb < B; ++bb)
      for (int k = 0; k < np; ++k)
        s += dap[((size_t)bb * H + idx) * np + k];
    da[idx] = s;
  }
  if (idx >= total) return;
  const size_t bb = idx / ((size_t)L * N), ln = idx % ((size_t)L * N);
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    const size_t o = ((size_t)bb * H + h) * L * N + ln;
    sb += dbp[o];
    sc += dcp[o];
  }
  stf(db, idx, sb);
  stf(dc, idx, sc);
}

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores.  A warp's fragments follow
// mma_bf16.cuh: g = lane / 4 and t = lane % 4 own rows g, g + 8 and
// columns 2t, 2t + 1 of each 16 x 8 accumulator tile; warp w owns rows
// 16 w.. of each 64 x 64 output.
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;    // 4 warps
constexpr int ST_THREADS = 256;    // msb_state

// A chunk's dt (past q: 0) and its head's cum (from msb_cb) into dts and
// cum, by cp.async.
__device__ __forceinline__ void load_gates(float* dts, float* cum,
                                           const float* dt, const float* cumc,
                                           size_t row0, int H, int h, int q) {
  const int tid = threadIdx.x;
  if (tid < T64)
    tc::cp_async4(dts + tid, dt + (row0 + min(tid, q - 1)) * H + h,
                  tid < q ? 4 : 0);
  else if (tid < T64 + T64 / 4)
    tc::cp_async16(cum + (tid - T64) * 4, cumc + (tid - T64) * 4, 16);
}

// A (P, N) f32 state tile from src (row stride N; past P or N: 0) into
// three part planes [p][n]; with other given, dot += the sum of its
// elements' products with other's, this thread's, in order.  A thread's
// pairs go in batches of SB, each batch's loads all out before its first
// store (the planes' stores would otherwise hold each load back behind
// the one before it).
template <int THR>
__device__ __forceinline__ void state_parts(bf16* planes,
                                            const float* __restrict__ src,
                                            int P, int N,
                                            const float* __restrict__ other =
                                                nullptr,
                                            float* dot = nullptr) {
  constexpr int PER = T64 * T64 / 2 / THR, SB = 8;  // pairs a thread
  static_assert(PER % SB == 0, "whole batches");
  for (int t0 = 0; t0 < PER; t0 += SB) {
    float v[SB][2], o[SB][2];
#pragma unroll
    for (int t = 0; t < SB; ++t) {
      const int i = threadIdx.x + (t0 + t) * THR;
      const int r = i / (T64 / 2), c = (i % (T64 / 2)) * 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = r < P && c + e < N;
        v[t][e] = ok ? src[r * N + c + e] : 0.f;
        o[t][e] = ok && other != nullptr ? other[r * N + c + e] : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < SB; ++t) {
      const int i = threadIdx.x + (t0 + t) * THR;
      const int r = i / (T64 / 2), c = (i % (T64 / 2)) * 2;
      if (other != nullptr) *dot += v[t][0] * o[t][0] + v[t][1] * o[t][1];
      uint32_t w3[NPART];
      split3(v[t][0], v[t][1], w3);
      store3(planes, r * LDT + c, w3);
    }
  }
}

// acc += A B for the warp's 16 rows wr.. and 64 columns over the k tiles
// [k0, k1) of 16: A(m, k) stored [m][k] (AT false) or [k][m] (AT true),
// B(k, n) stored [n][k] (BT false) or [k][n] (BT true); NA and NB the bf16
// parts of each (PL apart; at most one of them above 1).
template <bool AT, bool BT, int NA, int NB>
__device__ __forceinline__ void mm64(float (&acc)[8][4], const bf16* A,
                                     const bf16* B, int wr, int k0, int k1) {
  const int lane = threadIdx.x & 31;
  for (int kk = k0; kk < k1; ++kk) {
    uint32_t af[NA][4];
#pragma unroll
    for (int pa = 0; pa < NA; ++pa) {
      if (AT)
        tc::ldmatrix_x4_trans(af[pa], A + pa * PL + tc::b_off<LDT>(
                                          lane, kk * 16, wr));
      else
        tc::ldmatrix_x4(af[pa], A + pa * PL + tc::a_off<LDT>(lane, wr,
                                                             kk * 16));
    }
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int pb = 0; pb < NB; ++pb) {
        uint32_t b4[4];
        if (BT)
          tc::ldmatrix_x4_trans(b4, B + pb * PL + tc::a_off<LDT>(
                                        lane, kk * 16, np * 16));
        else
          tc::ldmatrix_x4(b4, B + pb * PL + tc::b_off<LDT>(lane, np * 16,
                                                           kk * 16));
#pragma unroll
        for (int pa = 0; pa < NA; ++pa) {
          tc::mma_bf16(acc[2 * np], af[pa], b4[0], b4[1]);
          tc::mma_bf16(acc[2 * np + 1], af[pa], b4[2], b4[3]);
        }
      }
  }
}

__device__ __forceinline__ void zero8(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
}

// The sum over the 4 lanes of a row (t = 0..3), in a fixed order.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The sum over the 8 row groups g of a column, in a fixed order.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// C B^T of one chunk of one batch row, for all the heads ((64, 64) f32,
// rows and columns past the chunk 0), and each head's cum over it ((64,)
// f32 a head, thread h for head h).
__global__ void __launch_bounds__(TC_THREADS)
msb_cb_kernel(const bf16* __restrict__ b, const bf16* __restrict__ c,
              const float* __restrict__ dt, const float* __restrict__ a,
              float* __restrict__ cbm, float* __restrict__ cumg, int L, int H,
              int N, int q) {
  extern __shared__ __align__(16) bf16 tsm[];
  bf16* Cs = tsm;                  // [i][n]
  bf16* Bs = Cs + PL;              // [j][n]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const int ci = blockIdx.x, bb = blockIdx.y, nc = L / q;
  const size_t row0 = (size_t)bb * L + (size_t)ci * q;
  const bool vec = N % 8 == 0;
  load64(Cs, c + row0 * N, N, q, N, vec);
  load64(Bs, b + row0 * N, N, q, N, vec);
  tc::cp_async_commit();
  for (int h = threadIdx.x; h < H; h += TC_THREADS)
    chunk_cumsum(dt + row0 * H + h, H, a[h], q,
                 cumg + (((size_t)bb * nc + ci) * H + h) * T64);
  tc::cp_async_wait<0>();
  __syncthreads();
  float acc[8][4];
  zero8(acc);
  mm64<false, false, 1, 1>(acc, Cs, Bs, wr, 0, 4);
  float* out = cbm + ((size_t)bb * nc + ci) * T64 * T64;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[(wr + g + (r >> 1) * 8) * T64 + nt * 8 + 2 * t4 + (r & 1)] =
          acc[nt][r];
}

// Each chunk's own parts, (P, N) f32 each: the state's, (w o X)^T B, and
// its gradient's, (exp(cum) o dY)^T C.
__global__ void __launch_bounds__(TC_THREADS)
msb_own_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ b, const bf16* __restrict__ c,
               const bf16* __restrict__ dy, const float* __restrict__ cumg,
               float* __restrict__ own_s, float* __restrict__ own_ds, int L,
               int H, int P, int N, int q) {
  extern __shared__ __align__(16) bf16 tsm[];
  bf16* Xs = tsm;                  // [j][p]
  bf16* dYs = Xs + PL;             // [i][p]
  bf16* Bs = dYs + PL;             // [j][n]
  bf16* Cs = Bs + PL;              // [i][n]
  bf16* Wp = Cs + PL;              // [j][p]: (w_j x_j)'s parts
  bf16* Ep = Wp + NPART * PL;      // [i][p]: (exp(cum_i) dy_i)'s parts
  float* dts = reinterpret_cast<float*>(Ep + NPART * PL);
  float* cum = dts + T64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const int ci = blockIdx.x, h = blockIdx.y, bb = blockIdx.z, nc = L / q;
  const size_t row0 = (size_t)bb * L + (size_t)ci * q;
  const size_t HP = (size_t)H * P;
  const bool vecx = P % 8 == 0, vecn = N % 8 == 0;
  load64(Xs, x + row0 * HP + (size_t)h * P, HP, q, P, vecx);
  load64(dYs, dy + row0 * HP + (size_t)h * P, HP, q, P, vecx);
  load64(Bs, b + row0 * N, N, q, N, vecn);
  load64(Cs, c + row0 * N, N, q, N, vecn);
  load_gates(dts, cum, dt, cumg + (((size_t)bb * nc + ci) * H + h) * T64,
             row0, H, h, q);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const float total = cum[q - 1];
  for (int i = threadIdx.x; i < T64 * T64 / 2; i += TC_THREADS) {
    const int r = i / (T64 / 2), c2 = (i % (T64 / 2)) * 2;
    const float w = r < q ? expf(total - cum[r]) * dts[r] : 0.f;
    const float e = r < q ? expf(cum[r]) : 0.f;
    uint32_t w3[NPART];
    split3(w * __bfloat162float(Xs[r * LDT + c2]),
           w * __bfloat162float(Xs[r * LDT + c2 + 1]), w3);
    store3(Wp, r * LDT + c2, w3);
    split3(e * __bfloat162float(dYs[r * LDT + c2]),
           e * __bfloat162float(dYs[r * LDT + c2 + 1]), w3);
    store3(Ep, r * LDT + c2, w3);
  }
  __syncthreads();
  float as[8][4], ad[8][4];
  zero8(as);
  zero8(ad);
  mm64<true, true, NPART, 1>(as, Wp, Bs, wr, 0, 4);
  mm64<true, true, NPART, 1>(ad, Ep, Cs, wr, 0, 4);
  const size_t o = (((size_t)bb * H + h) * nc + ci) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = wr + g + (r >> 1) * 8, n = nt * 8 + 2 * t4 + (r & 1);
      if (p < P && n < N) {
        own_s[o + (size_t)p * N + n] = as[nt][r];
        own_ds[o + (size_t)p * N + n] = ad[nt][r];
      }
    }
}

// One state element (b, h, e) a thread, in place over the own parts: s[c]
// becomes the state entering chunk c, ds[c] the gradient of the state
// leaving it (ds_fin, or 0, leaves the last).  The chunks go in groups of
// SG: the group's carry factors into shared memory, each thread's SG loads
// issued together, then the recurrence.
constexpr int SG = 8;
__global__ void __launch_bounds__(ST_THREADS)
msb_state_kernel(float* __restrict__ s, float* __restrict__ ds,
                 const float* __restrict__ ds_fin,
                 const float* __restrict__ cumg, int H, int nc, int PN) {
  __shared__ float gsh[SG];
  const int e = blockIdx.x * ST_THREADS + threadIdx.x;
  const int h = blockIdx.y, bb = blockIdx.z;
  const bool ok = e < PN;
  const size_t bh = (size_t)bb * H + h;
  float* sp = s + bh * nc * PN + e;
  float* dp = ds + bh * nc * PN + e;
  // the chunk's total sits past its q tokens, at cum[63]
  const float* tot = cumg + (size_t)bb * nc * H * T64 + (size_t)h * T64 +
                     (T64 - 1);
  auto carries = [&](int c0, int n) {   // gsh[k]: chunk c0 + k's factor
    __syncthreads();
    if (threadIdx.x < n)
      gsh[threadIdx.x] =
          state_carry(tot[(size_t)(c0 + threadIdx.x) * H * T64]);
    __syncthreads();
  };
  float run = 0.f, own[SG];
  for (int c0 = 0; c0 < nc; c0 += SG) {
    const int n = min(SG, nc - c0);
    carries(c0, n);
#pragma unroll
    for (int k = 0; k < SG; ++k)
      if (ok && k < n) own[k] = sp[(size_t)(c0 + k) * PN];
#pragma unroll
    for (int k = 0; k < SG; ++k)
      if (ok && k < n) {
        sp[(size_t)(c0 + k) * PN] = run;
        run = gsh[k] * run + own[k];
      }
  }
  run = ds_fin != nullptr && ok ? ds_fin[bh * PN + e] : 0.f;
  for (int c1 = nc; c1 > 0; c1 -= SG) {   // chunks c1 - n .. c1 - 1
    const int n = min(SG, c1), c0 = c1 - n;
    carries(c0, n);
#pragma unroll
    for (int k = 0; k < SG; ++k)
      if (ok && k < n) own[k] = dp[(size_t)(c0 + k) * PN];
#pragma unroll
    for (int k = SG - 1; k >= 0; --k)
      if (ok && k < n) {
        dp[(size_t)(c0 + k) * PN] = run;
        run = carry_back(gsh[k], run, own[k]);
      }
  }
}

// One chunk of one (b, h): dx; this head's dB and dC (into dbp, dcp); d dt;
// this chunk's part of d a (into dap).
__global__ void __launch_bounds__(TC_THREADS)
msb_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const bf16* __restrict__ b,
                 const bf16* __restrict__ c, const bf16* __restrict__ dy,
                 const float* __restrict__ cbm, const float* __restrict__ cumg,
                 const float* __restrict__ s_in, const float* __restrict__ dsg,
                 bf16* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ dbp, float* __restrict__ dcp,
                 float* __restrict__ dap, int L, int H, int P, int N, int q) {
  extern __shared__ __align__(16) bf16 tsm[];
  bf16* Xs = tsm;                  // [j][p]
  bf16* dYs = Xs + PL;             // [i][p]
  bf16* Bs = dYs + PL;             // [j][n]
  bf16* Cs = Bs + PL;              // [i][n]
  bf16* P1 = Cs + PL;              // [i][j]: M1's parts, then M2's
  bf16* P2 = P1 + NPART * PL;      // [p][n]: dS's parts, then S_in's
  float* dts = reinterpret_cast<float*>(P2 + NPART * PL);
  float* cum = dts + T64;
  float* wv = cum + T64;           // w_j = exp(total - cum_j) dt_j
  float* ec = wv + T64;            // exp(cum_i)
  float* rowg = ec + T64;          // sum_j G_ij
  float* dwv = rowg + T64;         // x_j . (dS B_j)
  float* dci = dwv + T64;          // C_i . (exp(cum_i) S_in^T dy_i)
  float* colg = dci + T64;         // 4 warps x 64: sums over i of G_ij
  float* colh = colg + 4 * T64;    // the same of H_ij = G_ij / dt_j
  float* red = colh + 4 * T64;     // 4 warps' parts of <dS, S_in>
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const int ci = blockIdx.x, h = blockIdx.y, bb = blockIdx.z, nc = L / q;
  const size_t row0 = (size_t)bb * L + (size_t)ci * q;
  const size_t HP = (size_t)H * P, PN = (size_t)P * N;
  const bool vecx = P % 8 == 0, vecn = N % 8 == 0;
  const size_t zs = (((size_t)bb * H + h) * nc + ci) * PN;
  load64(Xs, x + row0 * HP + (size_t)h * P, HP, q, P, vecx);
  load64(dYs, dy + row0 * HP + (size_t)h * P, HP, q, P, vecx);
  load64(Bs, b + row0 * N, N, q, N, vecn);
  load64(Cs, c + row0 * N, N, q, N, vecn);
  load_gates(dts, cum, dt, cumg + (((size_t)bb * nc + ci) * H + h) * T64,
             row0, H, h, q);
  tc::cp_async_commit();
  state_parts<TC_THREADS>(P2, dsg + zs, P, N);
  tc::cp_async_wait<0>();
  __syncthreads();
  const float ah = a[h], total = cum[q - 1];
  if (tid < T64) {
    wv[tid] = tid < q ? expf(total - cum[tid]) * dts[tid] : 0.f;
    ec[tid] = tid < q ? expf(cum[tid]) : 0.f;
  }

  // dY X^T, then M1 = (C B^T) L dt_j, M2 = (dY X^T) L dt_j (L_ij =
  // exp(cum_i - cum_j), j <= i < q), G = M1 o (dY X^T) and H = G / dt_j;
  // M2 stays in m2 until M1's planes are free
  float m2[8][4];
  zero8(m2);
  mm64<false, false, 1, 1>(m2, dYs, Xs, wr, 0, 4);
  {
    // this thread's C B^T elements, loaded before the planes' stores
    const float* cb = cbm + ((size_t)bb * nc + ci) * T64 * T64;
    float cbv[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cbv[nt][r] = cb[(wr + g + (r >> 1) * 8) * T64 + nt * 8 + 2 * t4 +
                        (r & 1)];
    float gr[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float gc[2] = {0.f, 0.f}, hc[2] = {0.f, 0.f}, m1[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = wr + g + (r >> 1) * 8, j = nt * 8 + 2 * t4 + (r & 1);
        const float lij = (j <= i && i < q) ? expf(cum[i] - cum[j]) : 0.f;
        const float cl = cbv[nt][r] * lij;
        const float hv = cl * m2[nt][r];
        const float gv = hv * dts[j];
        m1[r] = cl * dts[j];
        m2[nt][r] = m2[nt][r] * lij * dts[j];
        gr[r >> 1] += gv;
        gc[r & 1] += gv;
        hc[r & 1] += hv;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t w3[NPART];
        split3(m1[2 * hf], m1[2 * hf + 1], w3);
        store3(P1, (wr + g + 8 * hf) * LDT + nt * 8 + 2 * t4, w3);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        gc[e] = col_sum(gc[e]);
        hc[e] = col_sum(hc[e]);
        if (g == 0) {
          colg[warp * T64 + nt * 8 + 2 * t4 + e] = gc[e];
          colh[warp * T64 + nt * 8 + 2 * t4 + e] = hc[e];
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      gr[hf] = row_sum(gr[hf]);
      if (t4 == 0) rowg[wr + g + 8 * hf] = gr[hf];
    }
  }
  __syncthreads();                 // M1's and dS's planes complete

  // dx = M1^T dY + w o (B dS^T) (M1 is zero above the diagonal: rows j
  // take k tiles i >= j), and dw_j = x_j . (dS B_j)
  float acc[8][4], v[8][4];
  zero8(acc);
  zero8(v);
  mm64<true, true, NPART, 1>(acc, P1, dYs, wr, warp, 4);
  mm64<false, false, 1, NPART>(v, Bs, P2, wr, 0, 4);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = wr + g + 8 * hf;
    float dwp = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = nt * 8 + 2 * t4 + e;
        const float vv = v[nt][2 * hf + e];
        dwp += __bfloat162float(Xs[j * LDT + p]) * vv;
        if (j < q && p < P)
          dx[(row0 + j) * HP + (size_t)h * P + p] =
              __float2bfloat16(acc[nt][2 * hf + e] + wv[j] * vv);
      }
    dwp = row_sum(dwp);
    if (t4 == 0) dwv[j] = dwp;
  }
  __syncthreads();                 // every read of M1's planes done
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t w3[NPART];
      split3(m2[nt][2 * hf], m2[nt][2 * hf + 1], w3);
      store3(P1, (wr + g + 8 * hf) * LDT + nt * 8 + 2 * t4, w3);
    }
  __syncthreads();                 // M2's planes complete

  // this head's dB = M2^T C + w o (X dS)
  float* dbh = dbp + ((size_t)bb * H + h) * L * N + (size_t)ci * q * N;
  zero8(acc);
  zero8(v);
  mm64<true, true, NPART, 1>(acc, P1, Cs, wr, warp, 4);
  mm64<false, true, 1, NPART>(v, Xs, P2, wr, 0, 4);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = wr + g + (r >> 1) * 8, n = nt * 8 + 2 * t4 + (r & 1);
      if (j < q && n < N)
        dbh[(size_t)j * N + n] = acc[nt][r] + wv[j] * v[nt][r];
    }
  __syncthreads();                 // every read of dS's planes done

  // S_in's planes, and <dS, S_in> (each thread's part, then the warps' in
  // order)
  float cd = 0.f;
  state_parts<TC_THREADS>(P2, s_in + zs, P, N, dsg + zs, &cd);
  cd = warp_sum(cd);
  if (lane == 0) red[warp] = cd;
  __syncthreads();

  // this head's dC = M2 B + exp(cum) o (dY S_in) (M2 is zero above the
  // diagonal: rows i take k tiles j <= i), and C_i . its second term
  float* dch = dcp + ((size_t)bb * H + h) * L * N + (size_t)ci * q * N;
  zero8(acc);
  zero8(v);
  mm64<false, true, NPART, 1>(acc, P1, Bs, wr, 0, warp + 1);
  mm64<false, true, 1, NPART>(v, dYs, P2, wr, 0, 4);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = wr + g + 8 * hf;
    float dcp_ = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t4 + e;
        const float u = ec[i] * v[nt][2 * hf + e];
        dcp_ += __bfloat162float(Cs[i * LDT + n]) * u;
        if (i < q && n < N) dch[(size_t)i * N + n] = acc[nt][2 * hf + e] + u;
      }
    dcp_ = row_sum(dcp_);
    if (t4 == 0) dci[i] = dcp_;
  }
  __syncthreads();                 // the token sums complete

  // the gates, warp 0: lane l holds tokens k1 = 63 - 2l and k0 = k1 - 1;
  // d cum; its reverse prefix r_k = sum_{i >= k} d cum_i by a scan over
  // the lanes; d dt and this chunk's part of d a
  if (warp == 0) {
    const float gs = state_carry(total);
    const float cdot = ((red[0] + red[1]) + red[2]) + red[3];
    const int k1 = T64 - 1 - 2 * lane, k0 = k1 - 1;
    const float dtotal =
        gs * cdot + warp_sum(wv[k1] * dwv[k1] + wv[k0] * dwv[k0]);
    float dc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = e ? k1 : k0;
      const float cg = ((colg[k] + colg[T64 + k]) + colg[2 * T64 + k]) +
                       colg[3 * T64 + k];
      dc[e] = rowg[k] - cg + dci[k] - wv[k] * dwv[k];
      if (k == q - 1) dc[e] += dtotal;
    }
    float run = dc[0] + dc[1];     // inclusive scan over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run += t;
    }
    float before = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) before = 0.f;
    const float r1 = before + dc[1], r0 = r1 + dc[0];
    float dap_ = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = e ? k1 : k0;
      const float r = e ? r1 : r0;
      const float ch = ((colh[k] + colh[T64 + k]) + colh[2 * T64 + k]) +
                       colh[3 * T64 + k];
      if (k < q)
        ddt[(row0 + k) * H + h] = ch + expf(total - cum[k]) * dwv[k] + ah * r;
      dap_ += dts[k] * r;
    }
    dap_ = warp_sum(dap_);
    if (lane == 0) dap[((size_t)bb * H + h) * nc + ci] = dap_;
  }
}

// The scratch (f32): cum (B, L / q, H, 64) and C B^T (B, L / q, 64, 64)
// first (16-byte aligned for cp.async), then the states entering the
// chunks and the gradients of those leaving them (B, H, L / q, P, N) each,
// each head's dB and dC (B, H, L, N) each and d a's partials (B, H, L / q)
// (ops.bwd_scratch_floats counts the same; the f32 route uses s_in, dbp,
// dcp and B H of dap).
struct Scratch {
  float *cumg, *cbm, *s_in, *ds, *dbp, *dcp, *dap;
};

Scratch layout(float* p, int B, int L, int H, int P, int N, int q) {
  const size_t nc = L / q, bh = (size_t)B * H;
  Scratch s;
  s.cumg = p;
  s.cbm = s.cumg + (size_t)B * nc * H * T64;
  s.s_in = s.cbm + (size_t)B * nc * T64 * T64;
  s.ds = s.s_in + bh * nc * P * N;
  s.dbp = s.ds + bh * nc * P * N;
  s.dcp = s.dbp + bh * L * N;
  s.dap = s.dcp + bh * L * N;
  return s;
}

constexpr int CB_SMEM = 2 * PL * (int)sizeof(bf16);
constexpr int OWN_SMEM = (4 + 2 * NPART) * PL * (int)sizeof(bf16) +
                         2 * T64 * (int)sizeof(float);
constexpr int CHUNK_SMEM = (4 + 2 * NPART) * PL * (int)sizeof(bf16) +
                           (15 * T64 + 4) * (int)sizeof(float);

template <typename E>
int heads(const Scratch& s, E* db, E* dc, float* da, int B, int L, int H,
          int N, int np, cudaStream_t stream) {
  const size_t n = (size_t)B * L * N > (size_t)H ? (size_t)B * L * N
                                                 : (size_t)H;
  msb_heads_kernel<E><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      s.dbp, s.dcp, s.dap, db, dc, da, B, L, H, N, np);
  return (int)cudaGetLastError();
}

int launch_f32(const float* x, const float* dt, const float* a,
               const float* b, const float* c, const float* dy,
               const float* ds_fin, float* dx, float* ddt, float* da,
               float* db, float* dc, float* scratch, int B, int L, int H,
               int P, int N, int q, cudaStream_t stream) {
  const Scratch s = layout(scratch, B, L, H, P, N, q);
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      msb_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  msb_walk_kernel<<<dim3(H, B), THREADS, smem, stream>>>(
      x, dt, a, b, c, dy, ds_fin, s.s_in, dx, ddt, s.dbp, s.dcp, s.dap, L, H,
      P, N, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return heads(s, db, dc, da, B, L, H, N, 1, stream);
}

int launch_bf16(const bf16* x, const float* dt, const float* a,
                const bf16* b, const bf16* c, const bf16* dy,
                const float* ds_fin, bf16* dx, float* ddt, float* da,
                bf16* db, bf16* dc, float* scratch, int B, int L, int H,
                int P, int N, int q, cudaStream_t stream) {
  const Scratch s = layout(scratch, B, L, H, P, N, q);
  const int nc = L / q, PN = P * N;
  cudaError_t err = cudaFuncSetAttribute(
      msb_own_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, OWN_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(msb_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               CHUNK_SMEM);
  if (err != cudaSuccess) return (int)err;
  msb_cb_kernel<<<dim3(nc, B), TC_THREADS, CB_SMEM, stream>>>(
      b, c, dt, a, s.cbm, s.cumg, L, H, N, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  msb_own_kernel<<<dim3(nc, H, B), TC_THREADS, OWN_SMEM, stream>>>(
      x, dt, b, c, dy, s.cumg, s.s_in, s.ds, L, H, P, N, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  msb_state_kernel<<<dim3((PN + ST_THREADS - 1) / ST_THREADS, H, B),
                     ST_THREADS, 0, stream>>>(s.s_in, s.ds, ds_fin, s.cumg,
                                              H, nc, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  msb_chunk_kernel<<<dim3(nc, H, B), TC_THREADS, CHUNK_SMEM, stream>>>(
      x, dt, a, b, c, dy, s.cbm, s.cumg, s.s_in, s.ds, dx, ddt, s.dbp, s.dcp,
      s.dap, L, H, P, N, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return heads(s, db, dc, da, B, L, H, N, nc, stream);
}

}  // namespace

// x, dy, dx: (B, L, H, P); dt, ddt: (B, L, H) f32; a, da: (H,) f32; b, c,
// db, dc: (B, L, N); ds_fin: (B, H, P, N) f32 or null (a zero gradient of
// the final state); scratch: f32, of the floats layout() lists
// (ops.bwd_scratch_floats); all contiguous.  x, b, c, dy, dx, db and dc
// share one dtype (0 = float32, the CUDA-core route; 1 = bfloat16, the
// tensor-core route).  q = the chunk, 1 <= q <= 64, dividing L; P, N <=
// 64.
extern "C" int msb_ssd_bwd(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, const void* dy,
                           const void* ds_fin, void* dx, void* ddt, void* da,
                           void* db, void* dc, void* scratch, int B, int L,
                           int H, int P, int N, int q, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || P > T || N <= 0 || N > T ||
      q <= 0 || q > T || L % q != 0 || H > 65535 || B > 65535 ||
      L / q > 65535 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* dsf = static_cast<const float*>(ds_fin);
  float* ddtf = static_cast<float*>(ddt);
  float* daf = static_cast<float*>(da);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), dtf, af,
                      static_cast<const float*>(b),
                      static_cast<const float*>(c),
                      static_cast<const float*>(dy), dsf,
                      static_cast<float*>(dx), ddtf, daf,
                      static_cast<float*>(db), static_cast<float*>(dc), sc,
                      B, L, H, P, N, q, st);
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(x), dtf, af,
                       static_cast<const bf16*>(b),
                       static_cast<const bf16*>(c),
                       static_cast<const bf16*>(dy), dsf,
                       static_cast<bf16*>(dx), ddtf, daf,
                       static_cast<bf16*>(db), static_cast<bf16*>(dc), sc, B,
                       L, H, P, N, q, st);
  return (int)cudaErrorInvalidValue;
}
