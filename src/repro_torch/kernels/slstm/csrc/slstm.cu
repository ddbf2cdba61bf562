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
// What bounds it on this card.  Per token 2 B 4D hd FLOPs of f32 FMAs
// (xlstm-1.3b, D 2048, hd 512: 8.4 MFLOP a row, 0.13 us at the f32
// CUDA-core peak) against gx and h (40 KB a row, 0.01 us) and R (8.4 MB
// once a call): the bytes/FLOPs bound is ~0.13 us a token a row.  The
// recurrence is sequential, so a step also pays the latency of one
// grid-wide barrier and of reading h_{t-1} back from L2, which that
// bound does not see (chip_smoke.py reports both).
//
// Design: one persistent grid of co-resident blocks, launched
// cooperatively (cudaLaunchCooperativeKernel refuses a grid that cannot be
// co-resident; the wrapper raises then).  Block x owns indices j in [x JB,
// x JB + JB), JB = ceil(D / SMs), and all four gates' columns of R for
// them, held in shared memory in R's dtype for the whole call (at
// xlstm-1.3b 64 columns x 516 x 2 bytes = 66 KB), so R is read from HBM
// once a call, not once a token.  A step stages h_{t-1} of a tile of BT
// rows in shared memory, runs the product a warp per (row, 8 columns), 4
// lanes a column (a two-shuffle sum), then one thread per (row, j) runs
// the cell.
// The running state lives in the output (c, n, h, m), each element
// written and read by the block that owns its j.  h_{t-1} is read from
// y's row t - 1, written in the step before; every step writes a new row,
// so h is never overwritten while another block may still read it (y is
// the double buffer), and one grid barrier a step orders the writes of
// step t - 1 before the reads of step t.  The reads bypass L1 (__ldcg).
// No atomics: the result is deterministic.  Compiled without fast math.
//
// Edges: any B >= 1 (rows in tiles of BT), L >= 1, D a multiple of H, a
// ragged last block; threads a multiple of 32, at most 256.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_MAX = 200 * 1024;   // a block's dynamic shared memory
constexpr int BT_MAX = 16;             // rows a step stages at once
constexpr int MAX_THREADS = 256;
// The recurrent product: a warp takes COLS columns of one row at a time,
// PARTS lanes a column, each lane every PARTS-th element of hd; a column
// of R in shared memory is hd + PARTS long, so the 32 lanes' words fall in
// 32 banks.
constexpr int COLS = 8, PARTS = 4;

struct FwdArgs {
  const float* gx;          // (B, L, 4D)
  const void* r;            // (H, hd, 4 hd) in T
  const float* bf;          // (D,)
  const float* c0;          // (B, D) each: the initial state
  const float* n0;
  const float* h0;
  const float* m0;
  float* y;                 // (B, L, D): h of every step
  float* c;                 // (B, D) each: the running, then final state
  float* n;
  float* h;
  float* m;
  float* g_hist;            // (B, L, 4D), or null
  float* c_hist;            // (B, L, D) each, or null with g_hist
  float* n_hist;
  float* m_hist;
  int B, L, H, D, hd, jb, bt;
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

// h of step t - 1 for row b: the initial state's at t = 0, else y's row.
__device__ __forceinline__ const float* h_before(const FwdArgs& a, int b,
                                                 int t) {
  return t == 0 ? a.h0 + (size_t)b * a.D
                : a.y + ((size_t)b * a.L + t - 1) * a.D;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) sl_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, L = a.L, hd = a.hd, JB = a.jb, BT = a.bt;
  const int ncol = 4 * JB;
  const int j0 = blockIdx.x * JB, jn = min(JB, D - j0);
  const int rst = hd + PARTS;                             // R's column
  T* rs = reinterpret_cast<T*>(smem);                     // (4 JB, rst)
  float* hs = reinterpret_cast<float*>(
      smem + align16((size_t)ncol * rst * sizeof(T)));    // (BT, D)
  float* gs = hs + (size_t)BT * D;                        // (BT, 4 JB)
  int* src = reinterpret_cast<int*>(gs + BT * ncol);      // (4 JB)
  const T* r = static_cast<const T*>(a.r);

  // this block's columns of R, once a call: column k JB + jj is gate k of
  // index j0 + jj
  for (int idx = threadIdx.x; idx < 4 * jn * hd; idx += blockDim.x) {
    const int i = idx / (4 * jn), q = idx % (4 * jn);
    const int k = q / jn, jj = q % jn;
    int head, e;
    col_source(k, j0 + jj, D, hd, head, e);
    rs[(size_t)(k * JB + jj) * rst + i] =
        r[((size_t)head * hd + i) * 4 * hd + e];
  }
  for (int q = threadIdx.x; q < 4 * jn; q += blockDim.x) {
    const int k = q / jn, jj = q % jn;
    int head, e;
    col_source(k, j0 + jj, D, hd, head, e);
    src[k * JB + jj] = head * hd;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarp = blockDim.x / 32;
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < L; ++t) {
    for (int b0 = 0; b0 < a.B; b0 += BT) {
      const int bn = min(BT, a.B - b0);
      for (int idx = threadIdx.x; idx < bn * D; idx += blockDim.x) {
        const int bb = idx / D, jx = idx % D;
        hs[idx] = __ldcg(h_before(a, b0 + bb, t) + jx);
      }
      __syncthreads();
      // the recurrent term: a warp per (row, COLS columns), PARTS lanes
      // a column
      const int groups = (4 * jn + COLS - 1) / COLS;
      for (int q = warp; q < bn * groups; q += nwarp) {
        const int bb = q / groups, kq = q % groups * COLS + lane % COLS;
        const int k = kq / jn, jj = kq % jn, col = k * JB + jj;
        const bool valid = kq < 4 * jn;
        float acc = 0.f;
        if (valid) {
          const float* hrow = hs + (size_t)bb * D + src[col];
          const T* rcol = rs + (size_t)col * rst;
          for (int i = lane / COLS; i < hd; i += PARTS)
            acc += hrow[i] * to_f(rcol[i]);
        }
        for (int off = COLS; off < 32; off <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (valid && lane < COLS)
          gs[bb * ncol + col] =
              a.gx[((size_t)(b0 + bb) * L + t) * 4 * D + (size_t)k * D +
                   j0 + jj] + acc;
      }
      __syncthreads();
      // the cell: a thread per (row, index)
      for (int q = threadIdx.x; q < bn * jn; q += blockDim.x) {
        const int bb = q / jn, jj = q % jn, b = b0 + bb, j = j0 + jj;
        const float* g = gs + bb * ncol;
        const float gi = g[jj], gf = g[JB + jj], gz = g[2 * JB + jj],
                    go = g[3 * JB + jj];
        const size_t s = (size_t)b * D + j;
        const float cp = t == 0 ? a.c0[s] : a.c[s];
        const float np = t == 0 ? a.n0[s] : a.n[s];
        const float mp = t == 0 ? a.m0[s] : a.m[s];
        const float lf = logf(sigm(gf + a.bf[j]) + 1e-9f);
        const float a1 = lf + mp;
        const float mn = fmaxf(a1, gi);
        const float fi = expf(a1 - mn);
        const float ii = expf(gi - mn);
        const float c = fi * cp + ii * tanhf(gz);
        const float n = fi * np + ii;
        const float hy = sigm(go) * c / fmaxf(n, 1e-6f);
        const size_t o = ((size_t)b * L + t) * D + j;
        a.y[o] = hy;
        a.c[s] = c;
        a.n[s] = n;
        a.m[s] = mn;
        a.h[s] = hy;
        if (a.g_hist != nullptr) {
          for (int k = 0; k < 4; ++k)
            a.g_hist[((size_t)b * L + t) * 4 * D + (size_t)k * D + j] =
                g[k * JB + jj];
          a.c_hist[o] = c;
          a.n_hist[o] = n;
          a.m_hist[o] = mn;
        }
      }
      __syncthreads();
    }
    if (t + 1 < L) grid.sync();
  }
}

// A grid of the same shape that only meets at the barrier, `steps` times:
// the barrier's own cost a step.
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

struct Plan {
  int jb, blocks, bt, smem;
};

// JB indices a block over ceil(D / JB) <= SMs blocks; BT rows a step
// within SMEM_MAX: R's columns, then h (BT, D), g (BT, 4 JB), the
// columns' sources.
Plan plan_fwd(int B, int D, int hd, int esize) {
  Plan p{};
  const int nsm = sm_count();
  if (nsm <= 0) return p;
  p.jb = (D + nsm - 1) / nsm;
  p.blocks = (D + p.jb - 1) / p.jb;
  const size_t fixed = align16((size_t)4 * p.jb * (hd + PARTS) * esize) +
                       (size_t)4 * p.jb * sizeof(int);
  const size_t row = ((size_t)D + 4 * p.jb) * sizeof(float);
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

// The plan of a call, for the wrapper's reports: out[0..3] = JB, blocks,
// BT, dynamic shared memory bytes.
extern "C" int sl_plan(int B, int D, int H, int rdtype, void* out) {
  if (B <= 0 || H <= 0 || D <= 0 || D % H != 0 || rdtype < 0 || rdtype > 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_fwd(B, D, D / H, rdtype == 0 ? 4 : 2);
  int* o = static_cast<int*>(out);
  o[0] = p.jb;
  o[1] = p.blocks;
  o[2] = p.bt;
  o[3] = p.smem;
  return p.bt >= 1 ? 0 : (int)cudaErrorInvalidValue;
}

// gx, r (rdtype 0: f32, 1: bf16), bf, the initial c, n, h, m; y, the final
// c, n, h, m; the histories g, c, n, m (all null, or none); B, L, H, D,
// rdtype, threads; stream.
extern "C" int sl_forward(const void* gx, const void* r, const void* bf,
                          const void* c0, const void* n0, const void* h0,
                          const void* m0, void* y, void* c, void* n, void* h,
                          void* m, void* g_hist, void* c_hist, void* n_hist,
                          void* m_hist, int B, int L, int H, int D,
                          int rdtype, int threads, void* stream) {
  const bool hist = g_hist != nullptr;
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D % H != 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || rdtype < 0 ||
      rdtype > 1 || !gx || !r || !bf || !c0 || !n0 || !h0 || !m0 || !y ||
      !c || !n || !h || !m ||
      hist != (c_hist != nullptr) || hist != (n_hist != nullptr) ||
      hist != (m_hist != nullptr))
    return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const Plan p = plan_fwd(B, D, hd, rdtype == 0 ? 4 : 2);
  if (p.bt < 1) return (int)cudaErrorInvalidValue;
  FwdArgs a{static_cast<const float*>(gx), r,
            static_cast<const float*>(bf), static_cast<const float*>(c0),
            static_cast<const float*>(n0), static_cast<const float*>(h0),
            static_cast<const float*>(m0), static_cast<float*>(y),
            static_cast<float*>(c), static_cast<float*>(n),
            static_cast<float*>(h), static_cast<float*>(m),
            static_cast<float*>(g_hist), static_cast<float*>(c_hist),
            static_cast<float*>(n_hist), static_cast<float*>(m_hist),
            B, L, H, D, hd, p.jb, p.bt};
  void* args[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rdtype == 0)
    return launch_coop(sl_fwd_kernel<float>, p.blocks, threads, p.smem,
                       args, s);
  return launch_coop(sl_fwd_kernel<__nv_bfloat16>, p.blocks, threads,
                     p.smem, args, s);
}

// `steps` grid barriers on `blocks` co-resident blocks of `threads`.
extern "C" int sl_barrier(int blocks, int threads, int steps, void* stream) {
  if (blocks <= 0 || threads < 32 || threads > 1024 || steps < 0)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&steps};
  return launch_coop(sl_barrier_kernel, blocks, threads, 0, args,
                     static_cast<cudaStream_t>(stream));
}
