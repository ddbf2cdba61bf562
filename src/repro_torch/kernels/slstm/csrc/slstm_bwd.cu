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
// the wrapper (torch.matmul), as the JAX package leaves it to XLA.
//
// What bounds it on this card: per token 2 B 4D hd FLOPs (R^T dg, f32
// FMAs) against the saved g, c, n, m, dy and dg (72 KB a row at
// xlstm-1.3b); like the forward, a step also pays one grid barrier.
//
// Design: the forward's persistent cooperative grid.  Block x owns indices
// j in [x JB, x JB + JB) and R's rows j of R viewed as (D, 4 hd) (row j is
// head j / hd's row j % hd: what dh_j sums over), held in shared memory
// in R's dtype for the whole call.  A step stages dg_{t+1}'s segments of
// the heads the block's j touch, runs R^T dg a warp per (row, 2 j), 16
// lanes a j, then one thread per (row, j) runs the cell's gradient and
// writes dg_t.
// dg_t is the output's row t, so a block reads dg_{t+1} only from a row
// no block writes in this step; one grid barrier a step orders it.  The
// carries live in the output (dc, dn, dm), owned per j; dbf sums each
// row's share in scratch and then over the rows.  No atomics.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_MAX = 200 * 1024;
constexpr int BT_MAX = 16;
constexpr int MAX_THREADS = 256;
// R^T dg: a warp takes COLS indices of one row at a time, PARTS lanes an
// index, each lane every PARTS-th element of 4 hd; a row of R in shared
// memory is 4 hd + PARTS long, so the 32 lanes' words fall in 32 banks.
constexpr int COLS = 2, PARTS = 16;

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
  float* dc;                // (B, D) each: the carries, then the initial
  float* dn;                //   state's gradient
  float* dh;
  float* dm;
  float* dbf_rows;          // (B, D) scratch
  int B, L, H, D, hd, jb, bt, seg;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
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

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) sl_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, L = a.L, hd = a.hd, JB = a.jb, BT = a.bt;
  const int hd4 = 4 * hd, seg4 = a.seg * hd4;
  const int j0 = blockIdx.x * JB, jn = min(JB, D - j0);
  const int hlo = j0 / hd, nseg = (j0 + jn - 1) / hd - hlo + 1;
  const int rst = hd4 + PARTS;                            // R's row
  T* rr = reinterpret_cast<T*>(smem);                     // (JB, rst)
  float* dgs = reinterpret_cast<float*>(
      smem + align16((size_t)JB * rst * sizeof(T)));      // (BT, seg 4 hd)
  float* dhr = dgs + (size_t)BT * seg4;                   // (BT, JB)
  const T* r = static_cast<const T*>(a.r);

  // R's rows of this block's indices, once a call (R as (D, 4 hd))
  for (int idx = threadIdx.x; idx < jn * hd4; idx += blockDim.x)
    rr[(size_t)(idx / hd4) * rst + idx % hd4] = r[(size_t)j0 * hd4 + idx];
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarp = blockDim.x / 32;
  const size_t D4 = (size_t)4 * D;
  cg::grid_group grid = cg::this_grid();
  // t = -1 is not a step: it takes the initial h's gradient, R^T dg_0
  for (int t = L - 1; t >= -1; --t) {
    for (int b0 = 0; b0 < a.B; b0 += BT) {
      const int bn = min(BT, a.B - b0);
      const bool rec = t + 1 < L;      // dg of step t + 1 feeds dh_t
      if (rec) {
        for (int idx = threadIdx.x; idx < bn * nseg * hd4;
             idx += blockDim.x) {
          const int bb = idx / (nseg * hd4), s = idx % (nseg * hd4);
          dgs[(size_t)bb * seg4 + s] = __ldcg(
              a.dg + ((size_t)(b0 + bb) * L + t + 1) * D4 +
              (size_t)hlo * hd4 + s);
        }
        __syncthreads();
        const int groups = (jn + COLS - 1) / COLS;
        for (int q = warp; q < bn * groups; q += nwarp) {
          const int bb = q / groups, jj = q % groups * COLS + lane % COLS;
          const bool valid = jj < jn;
          float acc = 0.f;
          if (valid) {
            const float* dgrow = dgs + (size_t)bb * seg4 +
                                 (size_t)((j0 + jj) / hd - hlo) * hd4;
            const T* row = rr + (size_t)jj * rst;
            for (int e = lane / COLS; e < hd4; e += PARTS)
              acc += dgrow[e] * to_f(row[e]);
          }
          for (int off = COLS; off < 32; off <<= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (valid && lane < COLS) dhr[bb * JB + jj] = acc;
        }
        __syncthreads();
      }
      for (int q = threadIdx.x; q < bn * jn; q += blockDim.x) {
        const int bb = q / jn, jj = q % jn, b = b0 + bb, j = j0 + jj;
        const size_t s = (size_t)b * D + j;
        if (t < 0) {
          a.dh[s] = dhr[bb * JB + jj];
          continue;
        }
        const size_t o = ((size_t)b * L + t) * D + j;
        const bool last = t == L - 1;
        float dh = a.dy[o] + (rec ? dhr[bb * JB + jj] : 0.f);
        if (last) dh += opt(a.dh_fin, s);
        const float dc = last ? opt(a.dc_fin, s) : a.dc[s];
        const float dn = last ? opt(a.dn_fin, s) : a.dn[s];
        const float dm = last ? opt(a.dm_fin, s) : a.dm[s];
        const size_t po = o - D;       // step t - 1's, where t > 0
        const float cp = t == 0 ? a.c0[s] : a.c_hist[po];
        const float np = t == 0 ? a.n0[s] : a.n_hist[po];
        const float mp = t == 0 ? a.m0[s] : a.m_hist[po];
        const float* g = a.g_hist + ((size_t)b * L + t) * D4 + j;
        const float gi = g[0], gf = g[D], gz = g[2 * (size_t)D],
                    go = g[3 * (size_t)D];
        // the cell again, as the forward ran it
        const float sf = sigm(gf + a.bf[j]);
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
        float* dg = a.dg + ((size_t)b * L + t) * D4 + j;
        dg[0] = dgi;
        dg[D] = dgf;
        dg[2 * (size_t)D] = dgz;
        dg[3 * (size_t)D] = dgo;
        a.dc[s] = dc_t * fi;
        a.dn[s] = dn_t * fi;
        a.dm[s] = da1;
        a.dbf_rows[s] = (last ? 0.f : a.dbf_rows[s]) + dgf;
      }
      __syncthreads();
    }
    if (t >= 0) grid.sync();
  }
  for (int jj = threadIdx.x; jj < jn; jj += blockDim.x) {
    float sum = 0.f;
    for (int b = 0; b < a.B; ++b) sum += a.dbf_rows[(size_t)b * D + j0 + jj];
    a.dbf[j0 + jj] = sum;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

struct Plan {
  int jb, blocks, bt, smem, seg;
};

// The forward's JB and blocks; seg the most heads a block's indices
// touch; BT rows a step within SMEM_MAX: R's rows, then dg's segments
// (BT, seg 4 hd) and R^T dg (BT, JB).
Plan plan_bwd(int B, int D, int hd, int esize) {
  Plan p{};
  const int nsm = sm_count();
  if (nsm <= 0) return p;
  p.jb = (D + nsm - 1) / nsm;
  p.blocks = (D + p.jb - 1) / p.jb;
  for (int x = 0; x < p.blocks; ++x) {
    const int j0 = x * p.jb, j1 = (j0 + p.jb < D ? j0 + p.jb : D) - 1;
    const int seg = j1 / hd - j0 / hd + 1;
    p.seg = seg > p.seg ? seg : p.seg;
  }
  const size_t fixed = align16((size_t)p.jb * (4 * hd + PARTS) * esize);
  const size_t row = ((size_t)p.seg * 4 * hd + p.jb) * sizeof(float);
  long long bt = fixed < (size_t)SMEM_MAX
                     ? (long long)((SMEM_MAX - fixed) / row) : 0;
  bt = bt < B ? bt : B;
  bt = bt < BT_MAX ? bt : BT_MAX;
  p.bt = (int)bt;
  p.smem = (int)(fixed + (size_t)p.bt * row);
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

// out[0..4] = JB, blocks, BT, dynamic shared memory bytes, seg.
extern "C" int sl_bwd_plan(int B, int D, int H, int rdtype, void* out) {
  if (B <= 0 || H <= 0 || D <= 0 || D % H != 0 || rdtype < 0 || rdtype > 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_bwd(B, D, D / H, rdtype == 0 ? 4 : 2);
  int* o = static_cast<int*>(out);
  o[0] = p.jb;
  o[1] = p.blocks;
  o[2] = p.bt;
  o[3] = p.smem;
  o[4] = p.seg;
  return p.bt >= 1 ? 0 : (int)cudaErrorInvalidValue;
}

// r (rdtype 0: f32, 1: bf16), bf, the initial c, n, m; the histories g,
// c, n, m; dy; the final state's grads dc, dn, dh, dm (each may be null);
// dg, dbf, the initial state's grads dc, dn, dh, dm; the (B, D) scratch;
// B, L, H, D, rdtype, threads; stream.
extern "C" int sl_backward(const void* r, const void* bf, const void* c0,
                           const void* n0, const void* m0,
                           const void* g_hist, const void* c_hist,
                           const void* n_hist, const void* m_hist,
                           const void* dy, const void* dc_fin,
                           const void* dn_fin, const void* dh_fin,
                           const void* dm_fin, void* dg, void* dbf, void* dc,
                           void* dn, void* dh, void* dm, void* dbf_rows,
                           int B, int L, int H, int D, int rdtype,
                           int threads, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D % H != 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || rdtype < 0 ||
      rdtype > 1 || !r || !bf || !c0 || !n0 || !m0 || !g_hist || !c_hist ||
      !n_hist || !m_hist || !dy || !dg || !dbf || !dc || !dn || !dh || !dm ||
      !dbf_rows)
    return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const Plan p = plan_bwd(B, D, hd, rdtype == 0 ? 4 : 2);
  if (p.bt < 1) return (int)cudaErrorInvalidValue;
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  const auto w = [](void* x) { return static_cast<float*>(x); };
  BwdArgs a{r, f(bf), f(c0), f(n0), f(m0), f(g_hist), f(c_hist),
            f(n_hist), f(m_hist), f(dy), f(dc_fin), f(dn_fin), f(dh_fin),
            f(dm_fin), w(dg), w(dbf), w(dc), w(dn), w(dh), w(dm),
            w(dbf_rows), B, L, H, D, hd, p.jb, p.bt, p.seg};
  void* args[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rdtype == 0)
    return launch_coop(sl_bwd_kernel<float>, p.blocks, threads, p.smem,
                       args, s);
  return launch_coop(sl_bwd_kernel<__nv_bfloat16>, p.blocks, threads,
                     p.smem, args, s);
}
