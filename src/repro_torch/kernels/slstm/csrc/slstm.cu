// The sLSTM recurrence over a sequence for Hopper (sm_90a): the forward.
//
// Replaces no Pallas kernel.  The JAX package runs each sLSTM layer as one
// jax.lax.scan over _slstm_cell (src/repro/models/xlstm.py:263-290), which
// XLA compiles into one device-side loop; the port's counterpart was a
// Python loop launching some twenty small kernels a token.  This kernel is
// that scan on the card: one launch a layer, prefill (L tokens) or decode
// (L = 1) alike.  Per step t, for every batch row b and index j < D (D =
// H hd, gates laid out gate-major: i, f, z, o each D wide):
//   g        = gx_t + R h_{t-1}, the (H, 4 hd) product flattened
//              head-major: gate k of index j takes p = k D + j, that is
//              column p % (4 hd) of head p / (4 hd)'s R (the JAX layout,
//              models/xlstm.py:265-269), summed in f32 (R's bf16 words
//              are exact in f32, as params["r"].astype(f32) is)
//   lf       = log(sigmoid(g_f + bf) + 1e-9)
//   m        = max(lf + m_{t-1}, g_i)
//   c        = exp(lf + m_{t-1} - m) c_{t-1} + exp(g_i - m) tanh(g_z)
//   n        = exp(lf + m_{t-1} - m) n_{t-1} + exp(g_i - m)
//   h_t      = sigmoid(g_o) c / max(n, 1e-6)
// from an initial (c, n, h, m) (B, D) f32.  Out: h for every step (B, L,
// D) f32, the final state, and, for the backward (slstm_bwd.cu), each
// step's g (B, L, 4D) and c, n, m (B, L, D) where the caller asks.
//
// What bounds it on this card.  The bytes/FLOPs bound is the recurrent
// product: per token and row 2 4D hd FLOPs of f32 FMAs (xlstm-1.3b, D
// 2048, hd 512: 8.4 MFLOP, 0.125 us at the f32 CUDA-core peak), against
// 40 KB of gx and h a row and R (8.4 MB) once a call.  The recurrence is
// sequential, so a step also pays, on its critical path, the latency of
// handing h_t from every block to every block; at the main path's 1-4 rows
// a step that exchange (about one L2 round trip) and the product of B rows
// at the f32 rate are what a step costs.
//
// Design: one persistent grid of co-resident blocks, one an SM, launched
// cooperatively (cudaLaunchCooperativeKernel refuses a grid that cannot be
// co-resident, and the wrapper raises then: every block waits on every
// other, which only co-residency makes safe).  Block x owns indices j in
// [x JB, x JB + JB), JB = ceil(D / SMs), and gate k's column of each, 4
// JBP columns (JB padded to CW = 8).
//  - R stays in registers.  The product is scan_ring.cuh's: each warp
//    task sums CW columns over 128-element chunks of hd, a lane 4 elements
//    of each chunk, so a thread holds a fixed (column, k) slice of R (at
//    xlstm-1.3b on 256 threads: 8 columns x 4 chunks x 4, as bf16 pairs
//    in 64 registers), loaded once a call through shared memory, and runs it
//    against h_{t-1} broadcast from shared memory as float4 into 8
//    independent accumulators; a warp_sum8 (9 shuffles) ends a task, and
//    where a group's chunks span several tasks the cell sums their
//    partials.  No tensor cores: f32 FMAs of R's exact words, as the plain
//    version's f32 einsum.
//  - The step's inputs are prefetched: the thread that runs the cell of
//    (row, j) copies gx_{t+1}'s four gates with cp.async while step t runs.
//  - The state (c, n, m) stays in that thread's registers for the whole
//    call, written out only to the histories and as the final state.
//  - One step-tagged exchange a step in place of a grid barrier: the cell
//    publishes h_t as (f32 bits, step + 1) words into a ring of two slots
//    (L2-resident, scratch from the wrapper, zeroed here under one grid
//    barrier before the first step, where L > 1), and every block waits on
//    the tag of each word of h_t it reads, WB words a thread at a time,
//    reading again at once those not yet tagged: one L2 round trip once
//    h_t is out.  Two slots suffice: a block publishes step v + 1 only
//    after it has read all of step v, which every block published only
//    after reading all of step v - 1, the slot's old content (each step's
//    stores depend on its reads of the ring, through the values or the
//    poll loop's exit).  Every poll loop counts its rounds and __trap()s
//    past POLL_LIMIT, so a fault shows as a launch error, not a hang.
// Rows go in tiles of BT (at most NT / JB, a cell thread each), one tile
// after another, each from its own initial state; the ring's step counter
// v runs across tiles with one unused step between two, so that a tile's
// first publication lands in the slot its predecessor's last reads did
// not touch.  No atomic enters a sum: the result is deterministic.
// Compiled without fast math.  sl_exchange times the exchange alone on the
// same grid (and, beside it, a form with one release/acquire flag per
// block, the data read after it); sl_barrier the grid barrier that this
// design replaced.
// Registers: the compiler takes all 255 and spills what stays live across
// the step loop beyond them, so R's pairs are widened inside their FMAs,
// the ring's addresses are hidden from hoisting (ring::opaque64) and the
// prologue keeps LB loads in flight a thread: ptxas reports no spills.
//
// Edges: any B >= 1, L >= 1, D a multiple of H, any hd (chunks padded with
// zeros), a ragged last block; threads a multiple of 32, at most 256.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "scan_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using ring::u64;
using slt::CW;
using slt::QW;

constexpr int SMEM_MAX = 200 * 1024;   // a block's dynamic shared memory
constexpr int BT_MAX = 16;             // rows of a tile
constexpr int MAX_THREADS = 256;
constexpr int WB = 8;                  // ring words a thread reads at once
constexpr long long POLL_LIMIT = 1ll << 26;   // rounds before __trap()
constexpr int RST = QW + 4;            // a column's row in R's staging
constexpr int LB = 4;                  // loads a thread has in flight

struct FwdArgs {
  const float* gx;          // (B, L, 4D)
  const void* r;            // (H, hd, 4 hd) in T
  const float* bf;          // (D,)
  const float* c0;          // (B, D) each: the initial state
  const float* n0;
  const float* h0;
  const float* m0;
  float* y;                 // (B, L, D): h of every step
  float* c;                 // (B, D) each: the final state
  float* n;
  float* h;
  float* m;
  float* g_hist;            // (B, L, 4D), or null
  float* c_hist;            // (B, L, D) each, or null with g_hist
  float* n_hist;
  float* m_hist;
  u64* ring;                // (2, BT, D) words
  int B, L, H, D, hd, jb, jbp, bt, hp;
  slt::Geo geo;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets of a block's shared memory: h of a tile (BT, H HP) f32,
// first R's staging (4 JBP, RST); the tasks' partial sums (ntasks, BT,
// CW); the cells' prefetched gx (2, threads, 4); each column's and each
// group's offset into a row of h; R's slots past the `smax` a thread
// holds in registers (warps, slots - smax, CW, 32, 4).
struct Layout {
  size_t red, gxs, csrc, gsrc, rsm, total;
};

__host__ __device__ inline Layout layout_fwd(int bt, int H, int hp, int jbp,
                                             int threads, const slt::Geo& geo,
                                             int smax) {
  Layout o;
  const size_t hs = (size_t)bt * H * hp, stage = (size_t)4 * jbp * RST;
  o.red = align16((hs > stage ? hs : stage) * sizeof(float));
  o.gxs = o.red + align16((size_t)geo.ntasks * bt * CW * sizeof(float));
  o.csrc = o.gxs + (size_t)2 * threads * 4 * sizeof(float);
  o.gsrc = o.csrc + align16((size_t)4 * jbp * sizeof(int));
  o.rsm = o.gsrc + align16((size_t)geo.ng * sizeof(int));
  const int extra = geo.slots > smax ? geo.slots - smax : 0;
  o.total = o.rsm + (size_t)(threads / 32) * extra * CW * 32 * 4 *
                        sizeof(float);
  return o;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// Where gate k of index j takes its recurrent term: head `head`'s column
// `e` of R.  The product is flattened head-major, as the JAX package adds
// it: flat index p = k D + j of the (H, 4 hd) product.
__device__ __forceinline__ void col_source(int k, int j, int D, int hd,
                                           int& head_out, int& e_out) {
  const int p = k * D + j;
  const int head = p / (4 * hd), e = p % (4 * hd);
  head_out = head;
  e_out = e;
}

// h of the step before from the ring slot `slot`: each of `nrows` rows' D
// words (row b at slot + b D) tagged `want`, staged into hs (row b at b
// HS, index j at (j / hd) HP + j % hd).  A thread takes words tid, tid +
// NT, ..., WB at a time: it reads them all, then again, all at once, those
// whose tag is not yet `want`, so a round costs one L2 round trip.
// DENSE: HP = hd, so HS = D and hs's index is the word's.
template <bool DENSE>
__device__ __forceinline__ void fetch_h(const u64* slot, float* hs,
                                        int nrows, int D, int hd, int HP,
                                        int HS, unsigned want) {
  const int NT = blockDim.x, n = nrows * D;
#pragma unroll 1
  for (int base = threadIdx.x; base < n; base += NT * WB) {
    u64 w[WB];
    unsigned todo = 0;
#pragma unroll
    for (int u = 0; u < WB; ++u)
      if (base + u * NT < n) todo |= 1u << u;
    long long polls = 0;
    while (todo != 0) {
      const u64* p = reinterpret_cast<const u64*>(
          ring::opaque64(reinterpret_cast<u64>(slot + base)));
#pragma unroll
      for (int u = 0; u < WB; ++u)
        if (todo >> u & 1) w[u] = ring::ld_relaxed_u64(p + u * NT);
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        if ((todo >> u & 1) && (unsigned)(w[u] >> 32) == want) {
          todo &= ~(1u << u);
          const int idx = base + u * NT;
          const float v = __uint_as_float((unsigned)w[u]);
          if (DENSE) {
            hs[idx] = v;
          } else {
            const int b = idx / D, j = idx % D;
            hs[(size_t)b * HS + (j / hd) * HP + j % hd] = v;
          }
        }
      }
      if (todo != 0) {
        if (++polls > POLL_LIMIT) __trap();
        ring::poll_pause();
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) sl_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, L = a.L, hd = a.hd, JB = a.jb, JBP = a.jbp;
  const int BT = a.bt, HP = a.hp, HS = a.H * HP, ncol = 4 * JBP;
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid % 32;
  const int w = tid / 32, NW = NT / 32;
  const slt::Geo geo = a.geo;
  const int j0 = blockIdx.x * JB, jn = min(JB, D - j0);
  const Layout lay = layout_fwd(BT, a.H, HP, JBP, NT, geo,
                                slt::Reg<T>::SMAX);
  float* hs = reinterpret_cast<float*>(smem);             // (BT, HS)
  float* red = reinterpret_cast<float*>(smem + lay.red);  // (ntasks, BT, CW)
  float* gxs = reinterpret_cast<float*>(smem + lay.gxs);  // (2, NT, 4)
  int* csrc = reinterpret_cast<int*>(smem + lay.csrc);    // (4 JBP)
  int* gsrc = reinterpret_cast<int*>(smem + lay.gsrc);    // (ng)
  float* rsm = reinterpret_cast<float*>(smem + lay.rsm);
  constexpr int S = slt::Reg<T>::SMAX;
  const int xslots = geo.slots > S ? geo.slots - S : 0;
  const T* r = static_cast<const T*>(a.r);

  // column k JBP + jj is gate k of index j0 + jj; its vector offset is its
  // head's in a row of h
  for (int col = tid; col < ncol; col += NT) {
    const int k = col / JBP, jj = col % JBP;
    int head = -1, e;
    if (jj < jn) col_source(k, j0 + jj, D, hd, head, e);
    csrc[col] = head < 0 ? -1 : head * HP;
  }
  slt::group_sources(csrc, gsrc, ncol);

  // R's slots, chunk by chunk through shared memory (coalesced: a gate's
  // JB columns are adjacent in R's rows; LB loads in flight a thread)
  typename slt::Reg<T>::type rr[S][slt::Reg<T>::N];
  unsigned sd[S];
  int hoff[S];
  slt::slot_table<S>(geo, w, NW, lane, gsrc, sd, hoff);
  float* rsm_w = rsm + (size_t)w * xslots * CW * 128 + lane * 4;
  float* stg = hs;                                         // (4 JBP, RST)
  for (int q = 0; q < geo.kqt; ++q) {
#pragma unroll 1
    for (int base = tid; base < QW * ncol; base += NT * LB) {
      float v[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int idx = base + u * NT, ii = idx / ncol, col = idx % ncol;
        const int k = col / JBP, jj = col % JBP, i = q * QW + ii;
        v[u] = 0.f;
        if (idx < QW * ncol && jj < jn && i < hd) {
          int head, e;
          col_source(k, j0 + jj, D, hd, head, e);
          v[u] = to_f(r[((size_t)head * hd + i) * 4 * hd + e]);
        }
      }
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int idx = base + u * NT;
        if (idx < QW * ncol)
          stg[(size_t)(idx % ncol) * RST + idx / ncol] = v[u];
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const unsigned d = sd[s];
      const bool mine = d != slt::NO_SLOT && (int)(d >> 24 & 0x3F) == q;
      const float* src = stg + (size_t)(d >> 12 & 0xFFF) * CW * RST +
                         lane * 4;
      if (mine || q == 0)
#pragma unroll
        for (int i = 0; i < CW * 4; i += 2)
          slt::put2(rr[s], i, mine ? src[(i / 4) * RST + i % 4] : 0.f,
                    mine ? src[(i / 4) * RST + i % 4 + 1] : 0.f);
      // one slot's values in flight at a time, not all slots' at once
      asm volatile("" ::: "memory");
    }
    for (int s = S; s < geo.slots; ++s) {
      const slt::Slot sl = slt::slot_of(geo, s, w, NW);
      if (sl.valid && sl.q == q)
        for (int i = 0; i < CW * 4; ++i)
          rsm_w[((size_t)(s - S) * CW + i / 4) * 128 + i % 4] =
              stg[(size_t)(sl.g * CW + i / 4) * RST + lane * 4 + i % 4];
    }
    __syncthreads();
  }
  for (int i = tid; i < BT * HS; i += NT) hs[i] = 0.f;     // the chunks' pad

  // the ring's step counter: v = ti (L + 1) + t, one unused between two
  // tiles, so that a tile's first publication lands in the slot its
  // predecessor's last reads did not touch; the ring is used where L > 1
  const int ntiles = (a.B + BT - 1) / BT;
  if (L > 1) {
    const size_t nring = (size_t)2 * BT * D;
    for (size_t i = (size_t)blockIdx.x * NT + tid; i < nring;
         i += (size_t)gridDim.x * NT)
      a.ring[i] = 0;
    cg::this_grid().sync();
  }
  __syncthreads();

  // the cell of (row cb of a tile, index j0 + cj)
  const int cb = tid / JB, cj = tid % JB;
  const bool cell_thread = cb < BT && cj < jn;
  const float bfj = cell_thread ? a.bf[j0 + cj] : 0.f;
  const size_t D4 = (size_t)4 * D;
  const bool vec = HP == hd && D % 4 == 0;  // h0's rows staged as float4
#pragma unroll 1
  for (int ti = 0; ti < ntiles; ++ti) {
    const int r0 = ti * BT, bn = min(BT, a.B - r0);
    const bool cell = cell_thread && cb < bn;
    const size_t s0 = (size_t)(r0 + cb) * D + j0 + cj;
    float cst = 0.f, nst = 0.f, mst = 0.f;
    if (cell) {
      cst = a.c0[s0];
      nst = a.n0[s0];
      mst = a.m0[s0];
      const float* g0 = a.gx + (size_t)(r0 + cb) * L * D4 + j0 + cj;
      for (int k = 0; k < 4; ++k)
        tc::cp_async4(gxs + (size_t)tid * 4 + k, g0 + (size_t)k * D, 4);
    }
    tc::cp_async_commit();
#pragma unroll 1
    for (int t = 0; t < L; ++t) {
      const long long v = (long long)ti * (L + 1) + t;
      if (cell && t + 1 < L) {
        const float* gn =
            a.gx + ((size_t)(r0 + cb) * L + t + 1) * D4 + j0 + cj;
        for (int k = 0; k < 4; ++k)
          tc::cp_async4(gxs + ((size_t)((t + 1) & 1) * NT + tid) * 4 + k,
                        gn + (size_t)k * D, 4);
      }
      tc::cp_async_commit();
      // h_{t-1}: the ring's step v - 1, or the tile's h0
      if (t > 0 && HP == hd) {
        fetch_h<true>(a.ring + (size_t)((v - 1) & 1) * BT * D, hs, bn, D, hd,
                      HP, HS, (unsigned)v);
      } else if (t > 0) {
        fetch_h<false>(a.ring + (size_t)((v - 1) & 1) * BT * D, hs, bn, D,
                       hd, HP, HS, (unsigned)v);
      } else if (vec) {
        const float4* h0 = reinterpret_cast<const float4*>(a.h0 +
                                                           (size_t)r0 * D);
        float4* h4 = reinterpret_cast<float4*>(hs);
#pragma unroll 1
        for (int base = tid; base < bn * D / 4; base += NT * LB) {
          float4 x[LB];
#pragma unroll
          for (int u = 0; u < LB; ++u)
            if (base + u * NT < bn * D / 4) x[u] = h0[base + u * NT];
#pragma unroll
          for (int u = 0; u < LB; ++u)
            if (base + u * NT < bn * D / 4) h4[base + u * NT] = x[u];
        }
      } else {
#pragma unroll 1
        for (int base = tid; base < bn * D; base += NT * LB) {
          float x[LB];
#pragma unroll
          for (int u = 0; u < LB; ++u)
            if (base + u * NT < bn * D)
              x[u] = a.h0[(size_t)r0 * D + base + u * NT];
#pragma unroll
          for (int u = 0; u < LB; ++u) {
            const int idx = base + u * NT, b = idx / D, jx = idx % D;
            if (idx < bn * D)
              hs[(size_t)b * HS + (jx / hd) * HP + jx % hd] = x[u];
          }
        }
      }
      tc::cp_async_wait<1>();
      __syncthreads();
      // the recurrent term: each warp's tasks, row by row, R from its slots
#pragma unroll 1
      for (int b = 0; b < bn; ++b)
        slt::row_product<T>(rr, sd, hoff, rsm_w, a.geo, w, NW,
                            hs + (size_t)b * HS, csrc, gsrc, red, BT, b,
                            lane);
      __syncthreads();
      if (!cell) continue;
      // the cell (its indices recomputed here, not held across the step)
      const int j = j0 + (int)ring::opaque32(cj);
      const size_t s_ix = (size_t)(r0 + cb) * D + j;
      const float* gxv = gxs + ((size_t)(t & 1) * NT + tid) * 4;
      float g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        g[k] = gxv[k] + slt::column_sum(red, geo, k * JBP + cj, BT, cb);
      const float gi = g[0], gf = g[1], gz = g[2], go = g[3];
      const float lf = logf(sigm(gf + bfj) + 1e-9f);
      const float a1 = lf + mst;
      const float mn = fmaxf(a1, gi);
      const float fi = expf(a1 - mn);
      const float ii = expf(gi - mn);
      const float c = fi * cst + ii * tanhf(gz);
      const float n = fi * nst + ii;
      const float hy = sigm(go) * c / fmaxf(n, 1e-6f);
      if (t + 1 < L)
        ring::st_relaxed_u64(a.ring + ((size_t)(v & 1) * BT + cb) * D + j,
                             ring::word((unsigned)(v + 1), hy));
      cst = c;
      nst = n;
      mst = mn;
      const size_t o = ((size_t)(r0 + cb) * L + t) * D + j;
      a.y[o] = hy;
      if (a.g_hist != nullptr) {
        for (int k = 0; k < 4; ++k)
          a.g_hist[((size_t)(r0 + cb) * L + t) * D4 + (size_t)k * D + j] =
              g[k];
        a.c_hist[o] = c;
        a.n_hist[o] = n;
        a.m_hist[o] = mn;
      }
      if (t == L - 1) {
        a.c[s_ix] = c;
        a.n[s_ix] = n;
        a.m[s_ix] = mn;
        a.h[s_ix] = hy;
      }
    }
  }
  tc::cp_async_wait<0>();
}

// The exchange alone on the grid of a call, `steps` times: each block
// publishes its jb values of each of `rows` rows and stages all rows x D
// of them in shared memory.  form 0: the kernel's (step-tagged words,
// fetch_h); form 1: f32 values, then a release flag per block, acquired by
// the readers before one read of the values.
__global__ void __launch_bounds__(MAX_THREADS, 1)
    sl_exchange_kernel(u64* ring, unsigned* flags, int D, int jb, int rows,
                       int steps, int form) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);
  const int NT = blockDim.x, tid = threadIdx.x, x = blockIdx.x;
  const int j0 = x * jb, jn = min(jb, D - j0), n = rows * D;
  for (size_t i = (size_t)x * NT + tid; i < (size_t)2 * n;
       i += (size_t)gridDim.x * NT)
    ring[i] = 0;
  for (int i = x * NT + tid; i < (int)gridDim.x; i += gridDim.x * NT)
    flags[i] = 0;
  cg::this_grid().sync();
  float* data = reinterpret_cast<float*>(ring);
  for (int s = 0; s < steps; ++s) {
    const unsigned tag = s + 1;
    const size_t slot = (size_t)(s & 1) * n;
    if (form == 0) {
      for (int q = tid; q < rows * jn; q += NT)
        ring::st_relaxed_u64(ring + slot + (size_t)(q / jn) * D + j0 + q % jn,
                             ring::word(tag, (float)s));
      fetch_h<true>(ring + slot, hs, rows, D, D, D, D, tag);
      __syncthreads();
      continue;
    }
    for (int q = tid; q < rows * jn; q += NT)
      data[slot + (size_t)(q / jn) * D + j0 + q % jn] = (float)s;
    __syncthreads();
    if (tid == 0) ring::st_release_u32(flags + x, tag);
    for (int i = tid; i < (int)gridDim.x; i += NT) {
      long long polls = 0;
      while (ring::ld_acquire_u32(flags + i) < tag) {
        if (++polls > POLL_LIMIT) __trap();
        ring::poll_pause();
      }
    }
    __syncthreads();
    for (int base = tid; base < n; base += NT * WB) {
      float v[WB];
#pragma unroll
      for (int u = 0; u < WB; ++u)
        if (base + u * NT < n) v[u] = __ldcg(data + slot + base + u * NT);
#pragma unroll
      for (int u = 0; u < WB; ++u)
        if (base + u * NT < n) hs[base + u * NT] = v[u];
    }
    __syncthreads();
  }
}

// A grid of the same shape that only meets at the grid barrier, `steps`
// times: the barrier's own cost a step (what PR 28's design paid a step).
__global__ void sl_barrier_kernel(int steps) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < steps; ++s) grid.sync();
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// R's slots a thread holds in registers, by r's dtype (0 f32, 1 bf16)
int smax_of(int rdtype) {
  return rdtype == 0 ? slt::Reg<float>::SMAX : slt::Reg<__nv_bfloat16>::SMAX;
}

struct Plan {
  int jb, jbp, blocks, bt, hp, smem;
  slt::Geo geo;
};

// JB indices a block over ceil(D / JB) <= SMs blocks; the tasks of 4 JBP
// columns over hd on threads / 32 warps; BT rows a tile, at most threads /
// JB (a cell thread each) and BT_MAX, within SMEM_MAX.
Plan plan_fwd(int B, int D, int H, int threads, int smax) {
  Plan p{};
  const int nsm = sm_count();
  if (nsm <= 0 || threads < 32) return p;
  const int hd = D / H;
  p.jb = (D + nsm - 1) / nsm;
  p.blocks = (D + p.jb - 1) / p.jb;
  p.jbp = (p.jb + CW - 1) / CW * CW;
  p.geo = slt::geometry(4 * p.jbp, hd, threads / 32);
  p.hp = p.geo.kqt * QW;
  int bt = threads / p.jb;
  bt = bt < B ? bt : B;
  bt = bt < BT_MAX ? bt : BT_MAX;
  while (bt >= 1 &&
         layout_fwd(bt, H, p.hp, p.jbp, threads, p.geo, smax).total >
             SMEM_MAX)
    --bt;
  p.bt = bt;
  p.smem = bt >= 1
               ? (int)layout_fwd(bt, H, p.hp, p.jbp, threads, p.geo, smax)
                     .total
               : 0;
  return p;
}

template <typename K>
int launch_coop(K kern, int blocks, int threads, int smem, void** args,
                cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * sm_count() < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(threads), args,
                                  smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of a call, for the wrapper: out[0..14] = JB, blocks, BT,
// dynamic shared memory bytes, threads, ring words, slots a thread (of
// which at most 4 (bf16) or 2 (f32) in registers), tasks, chunks a task,
// tasks a
// group, JBP, the kernel's registers a thread and local (spilled) bytes.
extern "C" int sl_plan(int B, int D, int H, int rdtype, int threads,
                       void* out) {
  if (B <= 0 || H <= 0 || D <= 0 || D % H != 0 || rdtype < 0 ||
      rdtype > 1 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_fwd(B, D, H, threads, smax_of(rdtype));
  cudaFuncAttributes attr{};
  if (rdtype == 0)
    cudaFuncGetAttributes(&attr, sl_fwd_kernel<float>);
  else
    cudaFuncGetAttributes(&attr, sl_fwd_kernel<__nv_bfloat16>);
  int* o = static_cast<int*>(out);
  const int v[] = {p.jb,       p.blocks,     p.bt,         p.smem,
                   threads,    2 * p.bt * D, p.geo.slots,
                   smax_of(rdtype),
                   p.geo.ntasks, p.geo.kpw,  p.geo.tpg,    p.jbp,
                   attr.numRegs, (int)attr.localSizeBytes, 0};
  for (int i = 0; i < 15; ++i) o[i] = v[i];
  return p.bt >= 1 ? 0 : (int)cudaErrorInvalidValue;
}

// gx, r (rdtype 0: f32, 1: bf16), bf, the initial c, n, h, m; y, the final
// c, n, h, m; the histories g, c, n, m (all null, or none); the ring (the
// plan's words of 8 bytes); B, L, H, D, rdtype, threads; stream.
extern "C" int sl_forward(const void* gx, const void* r, const void* bf,
                          const void* c0, const void* n0, const void* h0,
                          const void* m0, void* y, void* c, void* n, void* h,
                          void* m, void* g_hist, void* c_hist, void* n_hist,
                          void* m_hist, void* ring, int B, int L, int H,
                          int D, int rdtype, int threads, void* stream) {
  const bool hist = g_hist != nullptr;
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D % H != 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || rdtype < 0 ||
      rdtype > 1 || !gx || !r || !bf || !c0 || !n0 || !h0 || !m0 || !y ||
      !c || !n || !h || !m || !ring ||
      hist != (c_hist != nullptr) || hist != (n_hist != nullptr) ||
      hist != (m_hist != nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_fwd(B, D, H, threads, smax_of(rdtype));
  if (p.bt < 1) return (int)cudaErrorInvalidValue;
  FwdArgs a{static_cast<const float*>(gx), r,
            static_cast<const float*>(bf), static_cast<const float*>(c0),
            static_cast<const float*>(n0), static_cast<const float*>(h0),
            static_cast<const float*>(m0), static_cast<float*>(y),
            static_cast<float*>(c), static_cast<float*>(n),
            static_cast<float*>(h), static_cast<float*>(m),
            static_cast<float*>(g_hist), static_cast<float*>(c_hist),
            static_cast<float*>(n_hist), static_cast<float*>(m_hist),
            static_cast<u64*>(ring), B, L, H, D, D / H, p.jb, p.jbp, p.bt,
            p.hp, p.geo};
  void* args[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rdtype == 0)
    return launch_coop(sl_fwd_kernel<float>, p.blocks, threads, p.smem,
                       args, s);
  return launch_coop(sl_fwd_kernel<__nv_bfloat16>, p.blocks, threads,
                     p.smem, args, s);
}

// The exchange alone (sl_exchange_kernel) on `blocks` co-resident blocks
// of `threads`, each owning jb of D indices, for `rows` rows and `steps`
// steps in form `form`; ring: 2 rows D words, flags: `blocks` words.
extern "C" int sl_exchange(int blocks, int threads, int D, int jb, int rows,
                           int steps, int form, void* ring, void* flags,
                           void* stream) {
  if (blocks <= 0 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || D <= 0 || jb <= 0 || rows <= 0 || steps < 0 ||
      form < 0 || form > 1 || !ring || !flags ||
      (size_t)rows * D * sizeof(float) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  u64* rg = static_cast<u64*>(ring);
  unsigned* fl = static_cast<unsigned*>(flags);
  void* args[] = {&rg, &fl, &D, &jb, &rows, &steps, &form};
  return launch_coop(sl_exchange_kernel, blocks, threads,
                     (int)(rows * D * sizeof(float)), args,
                     static_cast<cudaStream_t>(stream));
}

// `steps` grid barriers on `blocks` co-resident blocks of `threads`.
extern "C" int sl_barrier(int blocks, int threads, int steps, void* stream) {
  if (blocks <= 0 || threads < 32 || threads > 1024 || steps < 0)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&steps};
  return launch_coop(sl_barrier_kernel, blocks, threads, 0, args,
                     static_cast<cudaStream_t>(stream));
}
