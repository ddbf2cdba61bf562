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
// one block loops over the chunks itself, with S in registers.
//
// What bounds it on this card.  Bytes, in bf16: a 1024-token, 80-head
// zamba2 layer moves about 22.6 MB (x and y 10.5 MB each; 0.0067 ms at
// 3.35 TB/s) for about 2.7 GFLOP (0.0027 ms at the bf16 tensor-core peak).
// In practice it is latency: the chunk loop is sequential, and a B = 1
// prefill has only H = 80 (b, h) pairs for 132 SMs.
//
// The bf16 route, on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 sums; kernels/include/mma_bf16.cuh):
//   1. ms_cb (grid (chunks, B)): C B^T of every chunk once for all the
//      heads (b and c are (B, L, N), shared by the heads: Mamba2 with one
//      group; b and c are bf16 inputs, so the products are exact), and
//      every head's prefix sum of dt * a over the chunk (in order:
//      ssd_tc.cuh's chunk_cumsum says why), into f32 scratch the wrapper
//      allocates;
//   2. ms_ssd_tc (grid (P / 64, H, B), 16 warps): the walk over the
//      chunks, the next chunk's x, b, c, C B^T, dt and cum staged by
//      cp.async while one runs: M from C B^T with the head's decay and dt,
//      then y = C S^T (scaled by exp(cum)) + M X and S = exp(cum_q) S +
//      (w o X)^T B, warp w on rows 16 (w % 4).. and 16 columns.  S stays
//      f32 in the mma accumulators between chunks; M, S and w o X are
//      f32, so each enters its product in three bf16 parts (split3),
//      which keep f32's ~24 bits; x, b and c enter once.  One rounding
//      would cost ~2^-9, more than the state's tolerance; a hi + lo pair
//      (~16 bits) passes the tolerances but moves y ~1e-5 from the plain
//      version, which zamba2's full-depth bf16 prefill amplifies past its
//      check (PERF.md, PR 18).
// The f32 route keeps the CUDA-core kernel (ms_ssd): one block owns
// PS = 16 of the P state rows of one (b, h), recomputing the chunk's
// C B^T for its slice, f32 FMAs.
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

#include "mma_bf16.cuh"
#include "ssd_tc.cuh"

namespace {

using ssd::chunk_cumsum;
using ssd::LDT;
using ssd::load64;
using ssd::NPART;
using ssd::split3;
using ssd::store3;
using ssd::T64;

typedef __nv_bfloat16 bf16;

constexpr int QMAX = 64;           // longest chunk
constexpr int NMAX = 64;           // largest state dimension
constexpr int PS = 16;             // state rows (P) per f32 block
constexpr int THREADS = 128;
constexpr int LDN = NMAX + 1;      // row strides padded against bank
constexpr int LDQ = QMAX + 1;      // conflicts
constexpr float NEG_INF = -1e30f;
// the tensor-core route: 64 x 64 tiles (chunk, P slab, N; ssd_tc.cuh)
constexpr int PT = 64;             // state rows (P) per tensor-core block
constexpr int LDC = T64 + 4;       // row stride of a staged C B^T (f32)
// a chunk's staged inputs: x, b, c (bf16), C B^T, dt and cum (f32)
constexpr int STAGE_BYTES =
    3 * T64 * LDT * 2 + (T64 * LDC + 2 * T64) * 4;
static_assert(STAGE_BYTES % 16 == 0, "16-byte aligned stages");
constexpr int TC_THREADS = 512;    // 16 warps: 4 row groups x 4 of WC
constexpr int WC = 16;             // columns of y and S per warp
constexpr int NTW = WC / 8;        // their n8 tiles
static_assert(QMAX == T64 && NMAX == T64 && PT == T64, "64 x 64 tiles");

// The factor that carries the state from one chunk into the next; both
// routes read it here.
__device__ __forceinline__ float state_carry(float total) {
  return expf(total);
}

constexpr int smem_floats() {
  // B, C (q x N), M (q x q), X (q x PS), S (PS x N), cum, dt, w (q)
  return 2 * QMAX * LDN + QMAX * LDQ + QMAX * PS + PS * LDN + 3 * QMAX;
}

// The f32 route (see the header).
__global__ void __launch_bounds__(THREADS)
ms_ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ c, float* __restrict__ y,
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
      Bs[j * LDN + n] = ok ? b[off] : 0.f;
      Cs[j * LDN + n] = ok ? c[off] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < QMAX * PS / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int j = i / PS, p = i % PS;
      const bool ok = j < q && p0 + p < P;
      Xs[i] = ok ? x[((row0 + j) * H + h) * P + p0 + p] : 0.f;
    }
    __syncthreads();
    if (tid == 0) chunk_cumsum(dts, 1, ah, q, cum);
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
            y[((row0 + i) * H + h) * P + p0 + sp] =
                intra[r] + expf(cum[i]) * inter[r];
        }
      }
    }
    __syncthreads();               // every read of Ss is done

    // S = exp(total) S + sum_j w_j x_j B_j^T
    {
      const float g = state_carry(total);
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

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores.  Warp w's fragments follow
// mma_bf16.cuh: g = lane / 4 and t = lane % 4 own rows g, g + 8 and
// columns 2t, 2t + 1 of each 16 x 8 accumulator tile.
// ---------------------------------------------------------------------------

// C B^T of one chunk of one batch row, for all the heads: (64, 64) f32,
// rows i and columns j past the chunk 0 (warp w computes rows 16 w..);
// and each head's cum over the chunk, (64,) f32 a head, thread h for
// head h, so the walk over the chunks reads it ready.
__global__ void __launch_bounds__(THREADS)
ms_cb_kernel(const bf16* __restrict__ b, const bf16* __restrict__ c,
             const float* __restrict__ dt, const float* __restrict__ a,
             float* __restrict__ cbm, float* __restrict__ cumg, int L,
             int H, int N, int q) {
  extern __shared__ __align__(16) bf16 tsm[];
  bf16* Cs = tsm;                  // [i][n]
  bf16* Bs = Cs + T64 * LDT;       // [j][n]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int ci = blockIdx.x, bb = blockIdx.y, nc = L / q;
  const size_t row0 = (size_t)bb * L + (size_t)ci * q;
  const bool vec = N % 8 == 0;
  load64(Cs, c + row0 * N, N, q, N, vec);
  load64(Bs, b + row0 * N, N, q, N, vec);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < T64 / 16; ++kk) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, Cs + tc::a_off<LDT>(lane, warp * 16, kk * 16));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b4[4];
      tc::ldmatrix_x4(b4, Bs + tc::b_off<LDT>(lane, np * 16, kk * 16));
      tc::mma_bf16(acc[2 * np], a, b4[0], b4[1]);
      tc::mma_bf16(acc[2 * np + 1], a, b4[2], b4[3]);
    }
  }
  for (int h = threadIdx.x; h < H; h += THREADS)
    chunk_cumsum(dt + row0 * H + h, H, a[h], q,
                 cumg + (((size_t)bb * nc + ci) * H + h) * T64);
  float* out = cbm + ((size_t)bb * nc + ci) * T64 * T64;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[(warp * 16 + g + (r >> 1) * 8) * T64 + nt * 8 + 2 * t4 + (r & 1)] =
          acc[nt][r];
}

// The scan of one (b, h) over the chunks for 64 state rows p0.. (P slab).
// Warp w owns rows 16 (w % 4).. and columns WC (w / 4).. of y (tokens i,
// state rows p) and of S (state rows p, n).
__global__ void __launch_bounds__(TC_THREADS)
ms_ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const bf16* __restrict__ b, const bf16* __restrict__ c,
                 const float* __restrict__ cbm, const float* __restrict__ cumg,
                 bf16* __restrict__ y, float* __restrict__ s_fin, int L,
                 int H, int P, int N, int q) {
  extern __shared__ __align__(16) bf16 tsm[];
  constexpr int PL = T64 * LDT;    // one plane
  bf16* Mp = tsm;                  // [i][j]: M's parts, NPART planes
  bf16* Wp = Mp + NPART * PL;      // [j][p]: (w_j x_j)'s parts
  bf16* Sp = Wp + NPART * PL;      // [p][n]: the parts of the state
                                   // entering the chunk
  bf16* stages = Sp + NPART * PL;  // 2 x STAGE_BYTES: a chunk's inputs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * WC;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, bb = blockIdx.z;
  const int nc = L / q, npv = min(PT, P - p0);
  const bool vecx = P % 8 == 0, vecn = N % 8 == 0;

  // Chunk ci's x slab, b, c, C B^T and dt into stage ci % 2, by cp.async
  // (the element loads of an unaligned P or N land at once).
  auto stage = [&](int ci) {
    return reinterpret_cast<unsigned char*>(stages) +
           (ci & 1) * STAGE_BYTES;
  };
  auto issue = [&](int ci) {
    unsigned char* st = stage(ci);
    const size_t row0 = (size_t)bb * L + (size_t)ci * q;
    bf16* xs = reinterpret_cast<bf16*>(st);
    load64(xs, x + (row0 * H + h) * P + p0, (size_t)H * P, q, npv, vecx);
    load64(xs + T64 * LDT, b + row0 * N, N, q, N, vecn);
    load64(xs + 2 * T64 * LDT, c + row0 * N, N, q, N, vecn);
    float* cbs = reinterpret_cast<float*>(st + 3 * T64 * LDT * 2);
    const float* cbc = cbm + ((size_t)bb * nc + ci) * T64 * T64;
    for (int i = tid; i < T64 * (T64 / 4); i += TC_THREADS) {
      const int r = i / (T64 / 4), c4 = (i % (T64 / 4)) * 4;
      tc::cp_async16(cbs + r * LDC + c4, cbc + r * T64 + c4, 16);
    }
    float* dts = cbs + T64 * LDC;
    if (tid < T64)
      tc::cp_async4(dts + tid, dt + (row0 + min(tid, q - 1)) * H + h,
                    tid < q ? 4 : 0);
    else if (tid < 2 * T64)
      tc::cp_async4(dts + tid, cumg + (((size_t)bb * nc + ci) * H + h) * T64 +
                                   tid - T64, 4);
  };

  float sacc[NTW][4];              // S rows p0 + wr + g (+ 8), columns n
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) sacc[n][r] = 0.f;

  issue(0);
  tc::cp_async_commit();
  for (int ci = 0; ci < nc; ++ci) {
    const size_t row0 = (size_t)bb * L + (size_t)ci * q;   // (b, l) row
    if (ci + 1 < nc) issue(ci + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();               // chunk ci's inputs landed
    const bf16* Xs = reinterpret_cast<const bf16*>(stage(ci));   // [j][p]
    const bf16* Bs = Xs + T64 * LDT;                             // [j][n]
    const bf16* Cs = Bs + T64 * LDT;                             // [i][n]
    const float* cbs = reinterpret_cast<const float*>(Cs + T64 * LDT);
    const float* dts = cbs + T64 * LDC;
    const float* cum = dts + T64;
    const float total = cum[q - 1];

    // M = (C B^T) .* decay .* dt_j (zero above the diagonal) and
    // w_j x_j with w_j = exp(total - cum_j) dt_j, each in three parts
    for (int idx = tid; idx < T64 * T64 / 2; idx += TC_THREADS) {
      const int r = idx / (T64 / 2), c2 = (idx % (T64 / 2)) * 2;
      float m[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (r < q && c2 + e <= r)
          m[e] = (cbs[r * LDC + c2 + e] * expf(cum[r] - cum[c2 + e])) *
                 dts[c2 + e];
      uint32_t w3[NPART];
      split3(m[0], m[1], w3);
      store3(Mp, r * LDT + c2, w3);
      const float w = expf(total - cum[r]) * dts[r];     // row r is token j
      split3(w * __bfloat162float(Xs[r * LDT + c2]),
             w * __bfloat162float(Xs[r * LDT + c2 + 1]), w3);
      store3(Wp, r * LDT + c2, w3);
    }
    __syncthreads();

    // y = exp(cum) .* (C S^T) + M X, S the state entering the chunk
    float yacc[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) yacc[n][r] = 0.f;
    if (ci > 0) {
#pragma unroll
      for (int kk = 0; kk < T64 / 16; ++kk) {
        uint32_t af[4];
        tc::ldmatrix_x4(af, Cs + tc::a_off<LDT>(lane, wr, kk * 16));
#pragma unroll
        for (int np = 0; np < NTW / 2; ++np) {
#pragma unroll
          for (int k = 0; k < NPART; ++k) {   // the state's parts
            uint32_t s4[4];
            tc::ldmatrix_x4(s4, Sp + k * PL + tc::b_off<LDT>(
                                    lane, wc + np * 16, kk * 16));
            tc::mma_bf16(yacc[2 * np], af, s4[0], s4[1]);
            tc::mma_bf16(yacc[2 * np + 1], af, s4[2], s4[3]);
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float f = expf(cum[wr + g + 8 * hf]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          yacc[nt][2 * hf] *= f;
          yacc[nt][2 * hf + 1] *= f;
        }
      }
    }
    for (int kk = 0; kk <= (warp & 3); ++kk) {    // M is zero past row i
      uint32_t mf[NPART][4];
#pragma unroll
      for (int k = 0; k < NPART; ++k)
        tc::ldmatrix_x4(mf[k], Mp + k * PL + tc::a_off<LDT>(lane, wr,
                                                            kk * 16));
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        uint32_t xb[4];
        tc::ldmatrix_x4_trans(xb, Xs + tc::a_off<LDT>(lane, kk * 16,
                                                      wc + np * 16));
#pragma unroll
        for (int k = 0; k < NPART; ++k) {
          tc::mma_bf16(yacc[2 * np], mf[k], xb[0], xb[1]);
          tc::mma_bf16(yacc[2 * np + 1], mf[k], xb[2], xb[3]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = wr + g + 8 * hf;
      if (i < q) {
        bf16* yr = y + ((row0 + i) * H + h) * P + p0;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = wc + nt * 8 + 2 * t4 + e;
            if (p < npv) yr[p] = __float2bfloat16(yacc[nt][2 * hf + e]);
          }
      }
    }

    // S = exp(total) S + (w o X)^T B
    const float gs = state_carry(total);
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) sacc[n][r] *= gs;
#pragma unroll
    for (int kk = 0; kk < T64 / 16; ++kk) {
      uint32_t wf[NPART][4];
#pragma unroll
      for (int k = 0; k < NPART; ++k)
        tc::ldmatrix_x4_trans(wf[k], Wp + k * PL + tc::b_off<LDT>(
                                         lane, kk * 16, wr));
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        uint32_t b4[4];
        tc::ldmatrix_x4_trans(b4, Bs + tc::a_off<LDT>(lane, kk * 16,
                                                      wc + np * 16));
#pragma unroll
        for (int k = 0; k < NPART; ++k) {
          tc::mma_bf16(sacc[2 * np], wf[k], b4[0], b4[1]);
          tc::mma_bf16(sacc[2 * np + 1], wf[k], b4[2], b4[3]);
        }
      }
    }
    __syncthreads();               // every read of the old pair is done
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t w3[NPART];
        split3(sacc[nt][2 * hf], sacc[nt][2 * hf + 1], w3);
        store3(Sp, (wr + g + 8 * hf) * LDT + wc + nt * 8 + 2 * t4, w3);
      }
    __syncthreads();               // the chunk's stage is free again
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = p0 + wr + g + 8 * hf;
    if (p < P) {
      float* sb = s_fin + (((size_t)bb * H + h) * P + p) * N;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wc + nt * 8 + 2 * t4 + e;
          if (n < N) sb[n] = sacc[nt][2 * hf + e];
        }
    }
  }
}

constexpr int CB_SMEM = 2 * T64 * LDT * (int)sizeof(bf16);
constexpr int TC_SMEM =
    3 * NPART * T64 * LDT * (int)sizeof(bf16) + 2 * STAGE_BYTES;

int launch_f32(const float* x, const float* dt, const float* a,
               const float* b, const float* c, float* y, float* s_fin, int B,
               int L, int H, int P, int N, int q, cudaStream_t stream) {
  const int smem = smem_floats() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ms_ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + PS - 1) / PS, H, B);
  ms_ssd_kernel<<<grid, THREADS, smem, stream>>>(x, dt, a, b, c, y, s_fin,
                                                 L, H, P, N, q);
  return (int)cudaGetLastError();
}

// The bf16 route's f32 scratch, in floats: C B^T (B, L / q, 64, 64) and
// cum (B, L / q, H, 64) (ops.scratch_floats is the same count).
int launch_bf16(const bf16* x, const float* dt, const float* a,
                const bf16* b, const bf16* c, bf16* y, float* s_fin,
                float* scratch, int B, int L, int H, int P, int N, int q,
                cudaStream_t stream) {
  float* cbm = scratch;
  float* cum = cbm + (size_t)B * (L / q) * T64 * T64;
  cudaError_t err = cudaFuncSetAttribute(
      ms_ssd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  ms_cb_kernel<<<dim3(L / q, B), THREADS, CB_SMEM, stream>>>(
      b, c, dt, a, cbm, cum, L, H, N, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ms_ssd_tc_kernel<<<dim3((P + PT - 1) / PT, H, B), TC_THREADS, TC_SMEM,
                     stream>>>(x, dt, b, c, cbm, cum, y, s_fin, L, H, P, N,
                               q);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, L, H, P); dt: (B, L, H) f32; a: (H,) f32; b, c: (B, L, N);
// s_fin: (B, H, P, N) f32; scratch: for bf16 the f32 scratch that
// launch_bf16 lists, null for f32; all contiguous.  x, b, c and y share
// one dtype (0 = float32, 1 = bfloat16).  q = the chunk, 1 <= q <= 64,
// dividing L; N <= 64.
extern "C" int ms_ssd(const void* x, const void* dt, const void* a,
                      const void* b, const void* c, void* y, void* s_fin,
                      void* scratch, int B, int L, int H, int P, int N,
                      int q, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      q <= 0 || q > QMAX || L % q != 0 || H > 65535 || B > 65535 ||
      L / q > 65535)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(s_fin);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), dtf, af,
                      static_cast<const float*>(b),
                      static_cast<const float*>(c), static_cast<float*>(y),
                      sf, B, L, H, P, N, q, st);
  if (dtype == 1 && scratch != nullptr)
    return launch_bf16(static_cast<const bf16*>(x), dtf, af,
                       static_cast<const bf16*>(b),
                       static_cast<const bf16*>(c), static_cast<bf16*>(y), sf,
                       static_cast<float*>(scratch), B, L, H, P, N, q, st);
  return (int)cudaErrorInvalidValue;
}
