// The sLSTM recurrence over a sequence for Hopper (sm_90a): the backward.
//
// Replaces no Pallas kernel: it is the gradient of slstm.cu, which stands
// for the JAX package's jax.lax.scan over _slstm_cell
// (src/repro/models/xlstm.py:263-290; JAX differentiates that scan by
// its own reverse scan).  A reverse-time walk of the same shape as the
// forward.  Per step t, from L - 1 down to 0, for row b and index j:
//   dh_t     = dy_t + (R^T dg_{t+1})_j + (t = L - 1: the final h's grad)
// and the cell's gradient, from the step's g (saved by the forward), the
// state before it (c, n, m of step t - 1, or the initial state) and the
// carries (dc, dn, dm) of step t + 1 (at L - 1 the final state's grads,
// or 0), as autograd of the plain cell (ref.slstm_cell) forms it:
//   h = sigmoid(g_o) c / max(n, 1e-6)      (n's grad only where n >= 1e-6)
//   c = fi c' + ii tanh(g_z), n = fi n' + ii,
//   fi = exp(a1 - m), ii = exp(g_i - m), m = max(a1, g_i) (a tie splits
//   the gradient in halves, as torch.maximum's), a1 = lf + m',
//   lf = log(sigmoid(g_f + bf) + 1e-9).
// The stabiliser's terms are carried as autograd carries them: dm and the
// max's branch.  In exact arithmetic they cancel (h does not depend on m
// where the floor 1e-6 does not bind), so carrying them costs only their
// rounding, the same as autograd's.
// Out: dg (B, L, 4D) f32 (the gradient of gx, gate-major), dbf (D,) and
// the initial state's gradient (dc, dn, dh, dm) (B, D).  dR = sum_t
// h_{t-1}^T dg_t per head is one large product after the scan, left to
// the wrapper (torch.einsum), as the JAX package leaves it to XLA.
//
// What bounds it on this card: per token and row 2 4D hd FLOPs (R^T dg,
// f32 FMAs; 0.125 us at xlstm-1.3b) against the saved g, c, n, m, dy and
// dg (72 KB a row); as in the forward, a step also pays the exchange of
// dg_{t+1} between the blocks, about one L2 round trip.
//
// Design: the forward's (slstm.cu), transposed.  One cooperative
// persistent grid, block x owning indices j in [x JB, x JB + JB) and R's
// rows j (R viewed as (D, 4 hd): row j is head j / hd's row j % hd, what
// dh_j sums over).
//  - R stays in registers: scan_ring.cuh's product with the block's JBP
//    indices as columns and K = 4 hd (at xlstm-1.3b on 256 threads: 2
//    groups of 8 indices, each over 4 tasks of 4 chunks, bf16 pairs in 64
//    registers a thread), read straight from R's rows once a call; dg_{t+1}'s
//    segments (the heads the block's indices touch) broadcast from shared
//    memory as float4; the 4 tasks' partials summed by the cell.
//  - The saved g, c, n, m and dy of step t - 1 are copied by the cell's
//    thread with cp.async while step t runs.
//  - The carries (dc, dn, dm) and each row's share of dbf stay in that
//    thread's registers; dbf is summed over the rows once, at the end.
//  - dg_t goes to the consumers through the forward's two-slot tagged
//    ring, each row's words laid out as dg (4D, flat).  A block reads only
//    its segments of dg; where a head's 4 hd words come from every block
//    (4 hd >= D, as at xlstm-1.3b) it has then heard from all blocks, and a
//    slot is rewritten only after every block has read it, as in the
//    forward.  Where they do not (more than 4 heads), each row also holds
//    one sentinel word a block, which every block waits on too.  Every wait
//    is bounded (__trap past POLL_LIMIT).
// Rows in tiles of BT, one reverse walk each, t = -1 being a step of its
// own (R^T dg_0, the initial h's gradient).  No atomics.
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

constexpr int SMEM_MAX = 200 * 1024;
constexpr int BT_MAX = 16;
constexpr int MAX_THREADS = 256;
constexpr int WB = 8;                  // ring words a thread reads at once
constexpr long long POLL_LIMIT = 1ll << 26;
constexpr int PV = 8;                  // a cell's prefetched values

struct BwdArgs {
  const void* r;            // (H, hd, 4 hd) in T
  const float* bf;          // (D,)
  const float* c0;          // (B, D) each: the initial state
  const float* n0;
  const float* m0;
  const float* g_hist;      // (B, L, 4D): each step's gate preactivations
  const float* c_hist;      // (B, L, D) each: the state after each step
  const float* n_hist;
  const float* m_hist;
  const float* dy;          // (B, L, D)
  const float* dc_fin;      // (B, D) each: the final state's grads, or null
  const float* dn_fin;
  const float* dh_fin;
  const float* dm_fin;
  float* dg;                // (B, L, 4D)
  float* dbf;               // (D,)
  float* dc;                // (B, D) each: the initial state's gradient
  float* dn;
  float* dh;
  float* dm;
  u64* ring;                // (2, BT, 4D + sentinels) words
  int B, L, H, D, hd, jb, jbp, bt, seg, kp, sent;
  slt::Geo geo;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets of a block's shared memory: dg's segments of a tile (BT,
// seg KP) f32; the tasks' partials (ntasks, BT, CW); the cells'
// prefetched values (2, threads, PV); each index's and each group's
// offset into a row of segments; R's slots past the `smax` a thread holds
// in registers.
struct Layout {
  size_t red, pbuf, csrc, gsrc, rsm, total;
};

__host__ __device__ inline Layout layout_bwd(int bt, int seg, int kp,
                                             int jbp, int threads,
                                             const slt::Geo& geo, int smax) {
  Layout o;
  o.red = align16((size_t)bt * seg * kp * sizeof(float));
  o.pbuf = o.red + align16((size_t)geo.ntasks * bt * CW * sizeof(float));
  o.csrc = o.pbuf + (size_t)2 * threads * PV * sizeof(float);
  o.gsrc = o.csrc + align16((size_t)jbp * sizeof(int));
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

__device__ __forceinline__ float opt(const float* p, size_t i) {
  return p != nullptr ? p[i] : 0.f;
}

// dg_{t+1} from the ring slot `slot`: of each of `nrows` rows (row b at
// slot + b RW) the `nsw` words from `seg0` (this block's segments) and the
// `nblk` sentinels from `sent0` (none where every block writes into the
// segments), all tagged `want`; the segment words staged into dgs (row b at b SW, word x
// at (x / hd4) KP + x % hd4).  Each row's words are padded to a multiple
// of the block's threads, so a thread's next word is NT further in the
// same row or the same place of the next; WB words a thread are read at
// once, and those not yet tagged read again at once.
__device__ void fetch_dg(const u64* slot, float* dgs, int nrows, int RW,
                         int seg0, int nsw, int sent0, int nblk, int hd4,
                         int KP, int SW, unsigned want) {
  const int NT = blockDim.x, tid = threadIdx.x, per = nsw + nblk;
  const int perp = (per + NT - 1) / NT * NT;
  const int n = nrows * perp;
  const bool dense = KP == hd4;
#pragma unroll 1
  for (int base = tid; base < n; base += NT * WB) {
    u64 w[WB];
    int at[WB];              // (row << 20) | word of the row
    unsigned todo = 0;
    int b = (base - tid) / perp, x = tid + (base - tid) % perp;
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      at[u] = b << 20 | x;
      if (b < nrows && x < per) todo |= 1u << u;
      x += NT;
      if (x >= perp) {
        x -= perp;
        ++b;
      }
    }
    long long polls = 0;
    while (todo != 0) {
      const u64* p = reinterpret_cast<const u64*>(
          ring::opaque64(reinterpret_cast<u64>(slot)));
#pragma unroll
      for (int u = 0; u < WB; ++u)
        if (todo >> u & 1) {
          const int bb = at[u] >> 20, xx = at[u] & 0xFFFFF;
          w[u] = ring::ld_relaxed_u64(
              p + (size_t)bb * RW + (xx < nsw ? seg0 + xx
                                              : sent0 + xx - nsw));
        }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        if ((todo >> u & 1) && (unsigned)(w[u] >> 32) == want) {
          todo &= ~(1u << u);
          const int bb = at[u] >> 20, xx = at[u] & 0xFFFFF;
          if (xx >= nsw) continue;
          dgs[(size_t)bb * SW + (dense ? xx : xx / hd4 * KP + xx % hd4)] =
              __uint_as_float((unsigned)w[u]);
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
__global__ void __launch_bounds__(MAX_THREADS, 1) sl_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, L = a.L, hd = a.hd, hd4 = 4 * hd, JB = a.jb;
  const int JBP = a.jbp, BT = a.bt, KP = a.kp, SW = a.seg * KP;
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid % 32;
  const int w = tid / 32, NW = NT / 32;
  const int nsent = a.sent ? (int)gridDim.x : 0;
  const int RW = 4 * D + nsent;                // a ring row: dg, sentinels
  const slt::Geo geo = a.geo;
  const int j0 = blockIdx.x * JB, jn = min(JB, D - j0);
  const int hlo = j0 / hd, nseg = (j0 + jn - 1) / hd - hlo + 1;
  const Layout lay = layout_bwd(BT, a.seg, KP, JBP, NT, geo,
                                slt::Reg<T>::SMAX);
  float* dgs = reinterpret_cast<float*>(smem);            // (BT, SW)
  float* red = reinterpret_cast<float*>(smem + lay.red);  // (ntasks, BT, CW)
  float* pbuf = reinterpret_cast<float*>(smem + lay.pbuf);  // (2, NT, PV)
  int* csrc = reinterpret_cast<int*>(smem + lay.csrc);    // (JBP)
  int* gsrc = reinterpret_cast<int*>(smem + lay.gsrc);    // (ng)
  float* rsm = reinterpret_cast<float*>(smem + lay.rsm);
  constexpr int S = slt::Reg<T>::SMAX;
  const int xslots = geo.slots > S ? geo.slots - S : 0;
  const T* r = static_cast<const T*>(a.r);

  for (int jj = tid; jj < JBP; jj += NT)
    csrc[jj] = jj < jn ? ((j0 + jj) / hd - hlo) * KP : -1;
  slt::group_sources(csrc, gsrc, JBP);

  // R's rows of this block's indices, once a call, into the slots (the
  // register slots' loads all in flight at once)
  typename slt::Reg<T>::type rr[S][slt::Reg<T>::N];
  unsigned sd[S];
  int hoff[S];
  slt::slot_table<S>(geo, w, NW, lane, gsrc, sd, hoff);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned d = sd[s];
    const int jb0 = (d >> 12 & 0xFFF) * CW, e0 = (d >> 24 & 0x3F) * QW +
                                               lane * 4;
#pragma unroll
    for (int i = 0; i < CW * 4; i += 2) {
      float v[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int jj = jb0 + (i + x) / 4, e = e0 + (i + x) % 4;
        v[x] = d != slt::NO_SLOT && jj < jn && e < hd4
                   ? to_f(r[(size_t)(j0 + jj) * hd4 + e])
                   : 0.f;
      }
      slt::put2(rr[s], i, v[0], v[1]);
    }
  }
  float* rsm_w = rsm + (size_t)w * xslots * CW * 128 + lane * 4;
  for (int s = S; s < geo.slots; ++s) {
    const slt::Slot sl = slt::slot_of(geo, s, w, NW);
    for (int i = 0; i < CW * 4; ++i) {
      const int jj = sl.g * CW + i / 4, e = sl.q * QW + lane * 4 + i % 4;
      rsm_w[((size_t)(s - S) * CW + i / 4) * 128 + i % 4] =
          sl.valid && jj < jn && e < hd4
              ? to_f(r[(size_t)(j0 + jj) * hd4 + e])
              : 0.f;
    }
  }
  for (int i = tid; i < BT * SW; i += NT) dgs[i] = 0.f;    // the chunks' pad

  // the ring's step counter: v = ti (L + 2) + (L - 1 - t), one unused
  // between two tiles (see slstm.cu)
  const int ntiles = (a.B + BT - 1) / BT;
  {
    const size_t nring = (size_t)2 * BT * RW;
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
  float dbfr = 0.f;             // this thread's rows' share of dbf_j
#pragma unroll 1
  for (int ti = 0; ti < ntiles; ++ti) {
    const int r0 = ti * BT, bn = min(BT, a.B - r0);
    const bool cell = cell_thread && cb < bn;
    const size_t s0 = (size_t)(r0 + cb) * D + j0 + cj;
    float dcr = 0.f, dnr = 0.f, dmr = 0.f;
    if (cell) {
      dcr = opt(a.dc_fin, s0);
      dnr = opt(a.dn_fin, s0);
      dmr = opt(a.dm_fin, s0);
    }
    // the cell's inputs of step tt: dy, g (4 gates), c, n, m before it
    const auto prefetch = [&](int tt) {
      float* dst = pbuf + ((size_t)(tt & 1) * NT + tid) * PV;
      const size_t o = (size_t)(r0 + cb) * L + tt;
      tc::cp_async4(dst, a.dy + o * D + j0 + cj, 4);
      for (int k = 0; k < 4; ++k)
        tc::cp_async4(dst + 1 + k,
                      a.g_hist + o * D4 + (size_t)k * D + j0 + cj, 4);
      if (tt == 0) {
        tc::cp_async4(dst + 5, a.c0 + s0, 4);
        tc::cp_async4(dst + 6, a.n0 + s0, 4);
        tc::cp_async4(dst + 7, a.m0 + s0, 4);
      } else {
        tc::cp_async4(dst + 5, a.c_hist + (o - 1) * D + j0 + cj, 4);
        tc::cp_async4(dst + 6, a.n_hist + (o - 1) * D + j0 + cj, 4);
        tc::cp_async4(dst + 7, a.m_hist + (o - 1) * D + j0 + cj, 4);
      }
    };
    if (cell) prefetch(L - 1);
    tc::cp_async_commit();
    // t = -1 is a step of its own: the initial h's gradient, R^T dg_0
#pragma unroll 1
    for (int t = L - 1; t >= -1; --t) {
      const long long v = (long long)ti * (L + 2) + (L - 1 - t);
      if (cell && t >= 1) prefetch(t - 1);
      tc::cp_async_commit();
      const bool rec = t + 1 < L;      // dg of step t + 1 feeds dh_t
      if (rec)
        fetch_dg(a.ring + (size_t)((v - 1) & 1) * BT * RW, dgs, bn, RW,
                 hlo * hd4, nseg * hd4, 4 * D, nsent, hd4, KP, SW,
                 (unsigned)v);
      tc::cp_async_wait<1>();
      __syncthreads();
      if (rec)
#pragma unroll 1
        for (int b = 0; b < bn; ++b)
          slt::row_product<T>(rr, sd, hoff, rsm_w, a.geo, w, NW,
                              dgs + (size_t)b * SW, csrc, gsrc, red, BT, b,
                              lane);
      __syncthreads();
      if (!cell) continue;
      // the cell (its indices recomputed here, not held across the step)
      const int j = j0 + (int)ring::opaque32(cj);
      const size_t s_ix = (size_t)(r0 + cb) * D + j;
      const size_t slot = (size_t)(v & 1) * BT * RW + (size_t)cb * RW;
      float dhr = 0.f;
      if (rec) dhr = slt::column_sum(red, geo, cj, BT, cb);
      if (t < 0) {
        a.dh[s_ix] = dhr;
        continue;
      }
      const float* pv = pbuf + ((size_t)(t & 1) * NT + tid) * PV;
      float dh = pv[0] + (rec ? dhr : 0.f);
      if (t == L - 1) dh += opt(a.dh_fin, s_ix);
      const float dc = dcr, dn = dnr, dm = dmr;
      const float cp = pv[5], np = pv[6], mp = pv[7];
      const float gi = pv[1], gf = pv[2], gz = pv[3], go = pv[4];
      // the cell again, as the forward ran it
      const float sf = sigm(gf + bfj);
      const float lf = logf(sf + 1e-9f);
      const float a1 = lf + mp;
      const float mn = fmaxf(a1, gi);
      const float fi = expf(a1 - mn);
      const float ii = expf(gi - mn);
      const float tz = tanhf(gz);
      const float c = fi * cp + ii * tz;
      const float n = fi * np + ii;
      const float so = sigm(go);
      const float nn = fmaxf(n, 1e-6f);
      const float num = so * c;
      // h = num / nn
      const float dnum = dh / nn;
      const float dn_t = dn + (n >= 1e-6f ? -dh * (num / nn) / nn : 0.f);
      const float dc_t = dc + dnum * so;
      const float dgo = dnum * c * so * (1.f - so);
      // c = fi c' + ii tz, n = fi n' + ii
      const float dfi = dc_t * cp + dn_t * np;
      const float dii = dc_t * tz + dn_t;
      const float dgz = dc_t * ii * (1.f - tz * tz);
      // fi = exp(a1 - m), ii = exp(g_i - m), m = max(a1, g_i)
      const float xf = dfi * fi, xi = dii * ii;
      const float dm_t = dm - xf - xi;
      float da1 = xf, dgi = xi;
      if (a1 > gi) {
        da1 += dm_t;
      } else if (a1 < gi) {
        dgi += dm_t;
      } else {
        da1 += 0.5f * dm_t;
        dgi += 0.5f * dm_t;
      }
      // a1 = lf + m', lf = log(sigmoid(g_f + bf) + 1e-9)
      const float dgf = da1 / (sf + 1e-9f) * (sf * (1.f - sf));
      const float dgk[4] = {dgi, dgf, dgz, dgo};
      for (int k = 0; k < 4; ++k)
        ring::st_relaxed_u64(a.ring + slot + (size_t)k * D + j,
                             ring::word((unsigned)(v + 1), dgk[k]));
      if (nsent > 0 && cj == 0)
        ring::st_relaxed_u64(a.ring + slot + 4 * D + blockIdx.x,
                             ring::word((unsigned)(v + 1), 0.f));
      float* dgp = a.dg + ((size_t)(r0 + cb) * L + t) * D4 + j;
      for (int k = 0; k < 4; ++k) dgp[(size_t)k * D] = dgk[k];
      dcr = dc_t * fi;
      dnr = dn_t * fi;
      dmr = da1;
      dbfr += dgf;
    }
    if (cell) {
      a.dc[s0] = dcr;
      a.dn[s0] = dnr;
      a.dm[s0] = dmr;
    }
  }
  tc::cp_async_wait<0>();
  // dbf: each thread's share, then over the rows in order
  __syncthreads();
  float* part = dgs;                                       // (BT, JB)
  if (tid < BT * JB) part[tid] = cell_thread ? dbfr : 0.f;
  __syncthreads();
  for (int jj = tid; jj < jn; jj += NT) {
    float sum = 0.f;
    for (int b = 0; b < BT; ++b) sum += part[b * JB + jj];
    a.dbf[j0 + jj] = sum;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

int smax_of(int rdtype) {
  return rdtype == 0 ? slt::Reg<float>::SMAX : slt::Reg<__nv_bfloat16>::SMAX;
}

struct Plan {
  int jb, jbp, blocks, bt, smem, seg, kp, sent;
  slt::Geo geo;
};

// The forward's JB and blocks; seg the most heads a block's indices
// touch; the tasks of JBP columns over 4 hd; BT rows a tile as the
// forward's, within SMEM_MAX.
Plan plan_bwd(int B, int D, int H, int threads, int smax) {
  Plan p{};
  const int nsm = sm_count();
  if (nsm <= 0 || threads < 32) return p;
  const int hd = D / H;
  p.jb = (D + nsm - 1) / nsm;
  p.blocks = (D + p.jb - 1) / p.jb;
  p.jbp = (p.jb + CW - 1) / CW * CW;
  for (int x = 0; x < p.blocks; ++x) {
    const int j0 = x * p.jb, j1 = (j0 + p.jb < D ? j0 + p.jb : D) - 1;
    const int seg = j1 / hd - j0 / hd + 1;
    p.seg = seg > p.seg ? seg : p.seg;
  }
  p.geo = slt::geometry(p.jbp, 4 * hd, threads / 32);
  p.kp = p.geo.kqt * QW;
  p.sent = 4 * hd < D;   // a head's 4 hd words then miss some producers
  int bt = threads / p.jb;
  bt = bt < B ? bt : B;
  bt = bt < BT_MAX ? bt : BT_MAX;
  while (bt >= 1 &&
         layout_bwd(bt, p.seg, p.kp, p.jbp, threads, p.geo, smax).total >
             SMEM_MAX)
    --bt;
  p.bt = bt;
  p.smem = bt >= 1 ? (int)layout_bwd(bt, p.seg, p.kp, p.jbp, threads,
                                     p.geo, smax).total
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

// out[0..15] = JB, blocks, BT, dynamic shared memory bytes, threads, ring
// words, slots a thread (of which at most 4 (bf16) or 2 (f32)
// in registers), tasks,
// chunks a task, tasks a group, JBP, the kernel's registers a thread and
// local (spilled) bytes, seg.
extern "C" int sl_bwd_plan(int B, int D, int H, int rdtype, int threads,
                           void* out) {
  if (B <= 0 || H <= 0 || D <= 0 || D % H != 0 || rdtype < 0 ||
      rdtype > 1 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_bwd(B, D, H, threads, smax_of(rdtype));
  cudaFuncAttributes attr{};
  if (rdtype == 0)
    cudaFuncGetAttributes(&attr, sl_bwd_kernel<float>);
  else
    cudaFuncGetAttributes(&attr, sl_bwd_kernel<__nv_bfloat16>);
  int* o = static_cast<int*>(out);
  const int v[] = {p.jb,         p.blocks,
                   p.bt,         p.smem,
                   threads,      2 * p.bt * (4 * D + p.sent * p.blocks),
                   p.geo.slots,  smax_of(rdtype),
                   p.geo.ntasks, p.geo.kpw,
                   p.geo.tpg,    p.jbp,
                   attr.numRegs, (int)attr.localSizeBytes,
                   p.seg};
  for (int i = 0; i < 15; ++i) o[i] = v[i];
  return p.bt >= 1 ? 0 : (int)cudaErrorInvalidValue;
}

// r (rdtype 0: f32, 1: bf16), bf, the initial c, n, m; the histories g,
// c, n, m; dy; the final state's grads dc, dn, dh, dm (each may be null);
// dg, dbf, the initial state's grads dc, dn, dh, dm; the ring (the plan's
// words of 8 bytes); B, L, H, D, rdtype, threads; stream.
extern "C" int sl_backward(const void* r, const void* bf, const void* c0,
                           const void* n0, const void* m0,
                           const void* g_hist, const void* c_hist,
                           const void* n_hist, const void* m_hist,
                           const void* dy, const void* dc_fin,
                           const void* dn_fin, const void* dh_fin,
                           const void* dm_fin, void* dg, void* dbf, void* dc,
                           void* dn, void* dh, void* dm, void* ring, int B,
                           int L, int H, int D, int rdtype, int threads,
                           void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D % H != 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || rdtype < 0 ||
      rdtype > 1 || !r || !bf || !c0 || !n0 || !m0 || !g_hist || !c_hist ||
      !n_hist || !m_hist || !dy || !dg || !dbf || !dc || !dn || !dh || !dm ||
      !ring)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_bwd(B, D, H, threads, smax_of(rdtype));
  if (p.bt < 1) return (int)cudaErrorInvalidValue;
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  const auto w = [](void* x) { return static_cast<float*>(x); };
  BwdArgs a{r, f(bf), f(c0), f(n0), f(m0), f(g_hist), f(c_hist),
            f(n_hist), f(m_hist), f(dy), f(dc_fin), f(dn_fin), f(dh_fin),
            f(dm_fin), w(dg), w(dbf), w(dc), w(dn), w(dh), w(dm),
            static_cast<u64*>(ring), B, L, H, D, D / H, p.jb, p.jbp, p.bt,
            p.seg, p.kp, p.sent, p.geo};
  void* args[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rdtype == 0)
    return launch_coop(sl_bwd_kernel<float>, p.blocks, threads, p.smem,
                       args, s);
  return launch_coop(sl_bwd_kernel<__nv_bfloat16>, p.blocks, threads,
                     p.smem, args, s);
}
