// Stabilised chunkwise mLSTM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mlstm/kernel.py:23
// (_mlstm_kernel, reached through ops.mlstm at models/xlstm.py:186-188)
// in every prefill of every mLSTM block.  It computes the same function
// as models/xlstm.py's mlstm_chunk_body over the sequence cut into chunks
// of q tokens, per (batch b, head h), with the matrix memory C (hd_v x
// hd_k), the normaliser n (hd_k) and the stabiliser m carried in f32:
//   cumf     = cumsum(logf)                              (q,)
//   m_comb_i = max(max_{j<=i} (cumf_i - cumf_j + logi_j), cumf_i + m)
//   S_ij     = (q_i . k_j) scale exp(cumf_i - cumf_j + logi_j - m_comb_i)
//              for j <= i, else 0
//   den_i    = max(|sum_j S_ij + exp(cumf_i + m - m_comb_i) (q_i . n) scale|,
//                  exp(-m_comb_i))
//   h_i      = (S V + exp(cumf_i + m - m_comb_i) (C q_i) scale)_i / den_i
//   C        = carry C + sum_j wexp_j v_j k_j^T,  n = carry n + sum_j wexp_j k_j
// with w_j = cumf_q - cumf_j + logi_j, m' = max(m + cumf_q, max_j w_j),
// wexp_j = exp(w_j - m'), carry = exp(m + cumf_q - m').  Unlike the TPU
// kernel it takes an initial state (the Pallas path starts from zero) and a
// ragged last chunk (the Pallas kernel asserts L % chunk == 0).  h is
// rounded once to the inputs' dtype; the final state is f32.
//
// What bounds it on this card.  Operations: xlstm-1.3b (hd = 1024, 4 heads)
// at a 1024-token prefill with q = 128 is about 17 GFLOP (0.26 ms at the
// f32 CUDA-core peak, 0.017 ms at the bf16 tensor-core peak) against about
// 50 MB of traffic (0.015 ms).
//
// What does not carry over from the TPU.  The TPU kernel keeps each head's
// whole C (hd x hd f32, 4 MiB at hd = 1024) in VMEM scratch and walks the
// chunks on the sequential grid axis; a Hopper block has 227 KB of shared
// memory, and at B = 1 the (B, H) grid has 4 pairs for 132 SMs.  So the
// hd_v rows of C are split over blocks: one block of the state pass owns
// TV = 32 rows (a 128 KB f32 tile, kept transposed in shared memory) and
// loops over the chunks itself, in the place of the TPU's "arbitrary"
// chunk axis; 4 heads x 32 tiles = 128 blocks at B = 1.
//
// Shared by every tile.  m, the decays, S (q x q, which contracts all of
// hd_k) and den (which needs q . n over all of hd_k) are the same for all
// 32 tiles of a head.  Recomputing them in each tile would repeat the
// 2 q^2 hd work of S 32 times (about 3x the whole function's work at
// hd = 1024), so two first passes compute them once instead:
//   1. ml_gates (grid (H, B)): the scalar scan of the gates over the chunks
//      (m depends only on the gates) and the hd_k-wide recurrence of n,
//      which writes the n entering each chunk;
//   2. ml_scores (grid (chunks x 32-row blocks, H, B)): S for every chunk
//      at once (chunks are independent given m and n), stored transposed,
//      and den;
//   3. ml_state (grid (hd / TV, H, B)): per chunk, h for the tile's hd_v
//      columns from S V and Q C^T, then the tile's C update.
// All products are f32 FMAs on the CUDA cores (tensor cores are later
// work), each thread a 4 x 4 register tile fed by float4 reads of shared
// memory; no atomics, so the result is deterministic.  Compiled without
// fast math: exp(-1e30 - m) is 0, as in the plain version.
//
// Edges: chunk q <= 128, hd <= 1024 and a multiple of 4; the last chunk may
// be shorter than q.  The three passes run in order on the caller's
// stream: one call is one launch of the kernel in the wrapper's count.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the wrapper passes the scratch), does not
// synchronise, returns the first CUDA error of the three launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CMAX = 128;          // longest chunk
constexpr int DMAX = 1024;         // largest head dim
constexpr int TV = 32;             // rows of C (hd_v) per state-pass block
constexpr int THREADS = 256;
constexpr int RB = 32;             // rows of S per scores-pass block
constexpr int EK = 32;             // contraction slice of a staged tile
constexpr int EU = 128;            // hd_k columns per step of the C update
constexpr int STAGE = CMAX * EK;   // floats of the state pass's stage
constexpr float NEG = -1e30f;

static_assert(EK * EU == STAGE, "the C update's K slice fills the stage");
static_assert((CMAX / 4) * (TV / 4) == THREADS, "4 x 4 tiles cover q x TV");
static_assert((EU / 4) * (TV / 4) == THREADS, "4 x 4 tiles cover EU x TV");
static_assert((RB / 4) * (CMAX / 4) == THREADS, "4 x 4 tiles cover RB x q");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements (p 16-byte aligned for f32, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float comp(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}
// acc[r][c] += a[r] * b[c]
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4& a,
                                       const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// Per-chunk scratch, f32, for N = B * H * nc (b, h, chunk) triples:
//   gvec  (N, 4, q): cumf, m_comb, inter_scale, wexp (zero past the chunk)
//   carry (N)
//   nin   (N, D):    n entering the chunk
//   st    (N, q, q): S transposed, st[j][i] = S_ij
//   den   (N, q)

// Pass 1: the gates' scalar scan and the n recurrence, one block per (h, b).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ml_gates_kernel(const T* __restrict__ k, const float* __restrict__ logi,
                const float* __restrict__ logf, const float* __restrict__ n0,
                const float* __restrict__ m0, float* __restrict__ gvec,
                float* __restrict__ gcarry, float* __restrict__ nin,
                float* __restrict__ n_fin, float* __restrict__ m_fin, int L,
                int H, int D, int q) {
  __shared__ float li[CMAX], cum[CMAX], wv[CMAX], wex[CMAX];
  __shared__ float m_next;
  constexpr int NPT = DMAX / THREADS;          // n entries per thread
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int bh = b * H + h;
  const int nc = (L + q - 1) / q;
  const size_t rs = (size_t)H * D;             // one token's stride in k

  float n_reg[NPT];
#pragma unroll
  for (int r = 0; r < NPT; ++r) {
    const int e = tid + r * THREADS;
    n_reg[r] = (n0 != nullptr && e < D) ? n0[(size_t)bh * D + e] : 0.f;
  }
  float m_in = m0 != nullptr ? m0[bh] : NEG;

  for (int ci = 0; ci < nc; ++ci) {
    const int l0 = ci * q, cl = min(q, L - l0);
    const size_t cb = (size_t)bh * nc + ci;
    float* gv = gvec + cb * 4 * q;
    if (tid < cl) {
      const size_t g = ((size_t)b * L + l0 + tid) * H + h;
      li[tid] = logi[g];
      cum[tid] = logf[g];
    }
    __syncthreads();
    if (tid == 0) {                // inclusive prefix sum, in order
      float run = 0.f;
      for (int i = 0; i < cl; ++i) {
        run += cum[i];
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[cl - 1];
    if (tid < q) {
      float cf = 0.f, mc = 0.f, is = 0.f;
      if (tid < cl) {
        const int i = tid;
        cf = cum[i];
        float mi = NEG;
        for (int j = 0; j <= i; ++j) mi = fmaxf(mi, (cf - cum[j]) + li[j]);
        const float bi = cf + m_in;
        mc = fmaxf(mi, bi);
        is = expf(bi - mc);
        wv[i] = (total - cf) + li[i];
      }
      gv[tid] = cf;
      gv[q + tid] = mc;
      gv[2 * q + tid] = is;
    }
    __syncthreads();
    if (tid == 0) {
      float wm = wv[0];
      for (int j = 1; j < cl; ++j) wm = fmaxf(wm, wv[j]);
      m_next = fmaxf(m_in + total, wm);
    }
    __syncthreads();
    const float m_out = m_next;
    const float carry = expf((m_in + total) - m_out);
    if (tid < q) {
      const float we = tid < cl ? expf(wv[tid] - m_out) : 0.f;
      wex[tid] = we;
      gv[3 * q + tid] = we;
    }
    if (tid == 0) gcarry[cb] = carry;
    __syncthreads();
    const T* kb = k + ((size_t)b * L + l0) * rs + (size_t)h * D;
#pragma unroll
    for (int r = 0; r < NPT; ++r) {
      const int e = tid + r * THREADS;
      if (e < D) {
        nin[cb * D + e] = n_reg[r];
        float acc = 0.f;
#pragma unroll 4
        for (int j = 0; j < cl; ++j)
          acc = fmaf(wex[j], to_f32(kb[(size_t)j * rs + e]), acc);
        n_reg[r] = carry * n_reg[r] + acc;
      }
    }
    m_in = m_out;
    __syncthreads();               // li, cum, wv and wex are reused
  }
#pragma unroll
  for (int r = 0; r < NPT; ++r) {
    const int e = tid + r * THREADS;
    if (e < D) n_fin[(size_t)bh * D + e] = n_reg[r];
  }
  if (tid == 0) m_fin[bh] = m_in;
}

// Pass 2: S and den of every chunk.  Block (ci, rows r0..r0+RB-1) of
// (h, b); thread (ti, tj) owns rows r0 + 4 ti + r and columns 4 tj + c.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ml_scores_kernel(const T* __restrict__ qx, const T* __restrict__ kx,
                 const float* __restrict__ logi,
                 const float* __restrict__ gvec,
                 const float* __restrict__ nin, float* __restrict__ st,
                 float* __restrict__ den, int L, int H, int D, int q,
                 float scale) {
  __shared__ __align__(16) float Qs[EK][RB];    // Qs[e][i - r0]
  __shared__ __align__(16) float Ks[EK][CMAX];  // Ks[e][j]
  __shared__ float red[RB][CMAX / 4 + 1];       // row partial sums
  __shared__ float qn[RB];
  const int tid = threadIdx.x;
  const int rblk = (q + RB - 1) / RB;
  const int ci = blockIdx.x / rblk, r0 = (blockIdx.x % rblk) * RB;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int nc = (L + q - 1) / q;
  const int l0 = ci * q, cl = min(q, L - l0);
  const int jn = min(cl, r0 + RB);             // columns that can be unmasked
  const size_t cb = (size_t)bh * nc + ci;
  const size_t rs = (size_t)H * D;
  const T* qb = qx + ((size_t)b * L + l0) * rs + (size_t)h * D;
  const T* kb = kx + ((size_t)b * L + l0) * rs + (size_t)h * D;
  const int ti = tid / (CMAX / 4), tj = tid % (CMAX / 4);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int e0 = 0; e0 < D; e0 += EK) {
    {                              // Q rows, transposed: one quad a thread
      const int i = tid % RB, eq = tid / RB;
      const int e = e0 + 4 * eq;
      const float4 x = (r0 + i < cl && e < D)
                           ? load4(qb + (size_t)(r0 + i) * rs + e) : zero4();
      Qs[4 * eq + 0][i] = x.x;
      Qs[4 * eq + 1][i] = x.y;
      Qs[4 * eq + 2][i] = x.z;
      Qs[4 * eq + 3][i] = x.w;
    }
#pragma unroll
    for (int it = 0; it < CMAX * EK / 4 / THREADS; ++it) {   // K, transposed
      const int idx = tid + it * THREADS;
      const int j = idx % CMAX, eq = idx / CMAX;
      const int e = e0 + 4 * eq;
      const float4 x = (j < jn && e < D) ? load4(kb + (size_t)j * rs + e)
                                         : zero4();
      Ks[4 * eq + 0][j] = x.x;
      Ks[4 * eq + 1][j] = x.y;
      Ks[4 * eq + 2][j] = x.z;
      Ks[4 * eq + 3][j] = x.w;
    }
    __syncthreads();
    const int ne = min(EK, D - e0);
    for (int e = 0; e < ne; ++e)
      fma4x4(acc, lds4(&Qs[e][4 * ti]), lds4(&Ks[e][4 * tj]));
    __syncthreads();
  }

  // q . n for the block's rows: thread (row, part) sums a strided slice
  {
    const float* nb = nin + cb * D;
    const int row = tid / (THREADS / RB), part = tid % (THREADS / RB);
    const int i = r0 + row;
    float s = 0.f;
    if (i < cl)
      for (int e = 4 * part; e < D; e += 4 * (THREADS / RB)) {
        const float4 x = load4(qb + (size_t)i * rs + e);
        const float4 nv = load4(nb + e);
        s = fmaf(x.x, nv.x, s);
        s = fmaf(x.y, nv.y, s);
        s = fmaf(x.z, nv.z, s);
        s = fmaf(x.w, nv.w, s);
      }
    red[row][part] = s;
    __syncthreads();
    if (part == 0) {
      float t = 0.f;
      for (int p = 0; p < THREADS / RB; ++p) t += red[row][p];
      qn[row] = t;
    }
    __syncthreads();
  }

  // S = (q . k) scale * decay, zero above the diagonal and past the chunk
  const float* gv = gvec + cb * 4 * q;
  float* sb = st + cb * q * q;
  float gj[4], lj[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = 4 * tj + c;
    gj[c] = j < cl ? gv[j] : 0.f;
    lj[c] = j < cl ? logi[((size_t)b * L + l0 + j) * H + h] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + 4 * ti + r;
    const float cfi = i < cl ? gv[i] : 0.f;
    const float mci = i < cl ? gv[q + i] : 0.f;
    float rsum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * tj + c;
      float sv = 0.f;
      if (i < cl && j <= i) {
        const float d = expf(((cfi - gj[c]) + lj[c]) - mci);
        sv = (acc[r][c] * scale) * d;
      }
      if (i < q && j < q) sb[(size_t)j * q + i] = sv;
      rsum += sv;
    }
    red[4 * ti + r][tj] = rsum;
  }
  __syncthreads();
  if (tid < RB) {
    const int i = r0 + tid;
    if (i < q) {
      float dn = 1.f;              // rows past the chunk are never read
      if (i < cl) {
        float rsum = 0.f;
        for (int p = 0; p < CMAX / 4; ++p) rsum += red[tid][p];
        const float mci = gv[q + i];
        dn = rsum + (gv[2 * q + i] * qn[tid]) * scale;
        dn = fmaxf(fabsf(dn), expf(-mci));
      }
      den[cb * q + i] = dn;
    }
  }
}

// Pass 3: the chunk loop over one TV-row tile of C.  Thread (ta, tb) owns
// rows 4 ta + r (tokens i in the h products, hd_k columns e in the C
// update) and hd_v columns v0 + 4 tb + c.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ml_state_kernel(const T* __restrict__ qx, const T* __restrict__ kx,
                const T* __restrict__ vx, const float* __restrict__ c0,
                const float* __restrict__ gvec,
                const float* __restrict__ gcarry,
                const float* __restrict__ st, const float* __restrict__ den,
                T* __restrict__ hx, float* __restrict__ c_fin, int L, int H,
                int D, int q, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;                  // (D, TV): Ct[e][v] = C[v0 + v][e]
  float* Vs = Ct + D * TV;           // (CMAX, TV): the chunk's V columns
  float* Vw = Vs + CMAX * TV;        // (CMAX, TV): wexp_j * V
  float* Sg = Vw + CMAX * TV;        // (STAGE): the staged slice
  float* dens = Sg + STAGE;          // (CMAX)
  float* iss = dens + CMAX;          // (CMAX): inter_scale

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * TV, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int nc = (L + q - 1) / q;
  const size_t rs = (size_t)H * D;
  const int ta = tid / (TV / 4), tb = tid % (TV / 4);

  // C's initial tile; lanes walk e, so the global reads coalesce
  for (int idx = tid; idx < D * (TV / 4); idx += THREADS) {
    const int e = idx % D, vq = idx / D;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if (c0 != nullptr)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = v0 + 4 * vq + r;
        if (v < D) c[r] = c0[((size_t)bh * D + v) * D + e];
      }
    *reinterpret_cast<float4*>(&Ct[e * TV + 4 * vq]) =
        make_float4(c[0], c[1], c[2], c[3]);
  }

  for (int ci = 0; ci < nc; ++ci) {
    const int l0 = ci * q, cl = min(q, L - l0);
    const size_t cb = (size_t)bh * nc + ci;
    const float* gv = gvec + cb * 4 * q;
    const float carry = gcarry[cb];
    const T* qb = qx + ((size_t)b * L + l0) * rs + (size_t)h * D;
    const T* kb = kx + ((size_t)b * L + l0) * rs + (size_t)h * D;
    const T* vb = vx + ((size_t)b * L + l0) * rs + (size_t)h * D;
    __syncthreads();               // the last chunk's readers are done

    // A: the chunk's V columns, weighted and not, den and inter_scale
    for (int idx = tid; idx < CMAX * (TV / 4); idx += THREADS) {
      const int j = idx / (TV / 4), vq = idx % (TV / 4);
      const int v = v0 + 4 * vq;
      const float4 x = (j < cl && v < D) ? load4(vb + (size_t)j * rs + v)
                                         : zero4();
      const float w = j < cl ? gv[3 * q + j] : 0.f;
      store4(&Vs[j * TV + 4 * vq], x);
      store4(&Vw[j * TV + 4 * vq],
             make_float4(w * x.x, w * x.y, w * x.z, w * x.w));
    }
    for (int i = tid; i < CMAX; i += THREADS) {
      dens[i] = i < cl ? den[cb * q + i] : 1.f;
      iss[i] = i < cl ? gv[2 * q + i] : 0.f;
    }

    // B: inter[i][v] = sum_e Q[i][e] C[v][e], Q staged transposed
    float inter[4][4], intra[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) inter[r][c] = intra[r][c] = 0.f;
    for (int e0 = 0; e0 < D; e0 += EK) {
      __syncthreads();
#pragma unroll
      for (int it = 0; it < CMAX * EK / 4 / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int i = idx % CMAX, eq = idx / CMAX;
        const int e = e0 + 4 * eq;
        const float4 x = (i < cl && e < D) ? load4(qb + (size_t)i * rs + e)
                                           : zero4();
        Sg[(4 * eq + 0) * CMAX + i] = x.x;
        Sg[(4 * eq + 1) * CMAX + i] = x.y;
        Sg[(4 * eq + 2) * CMAX + i] = x.z;
        Sg[(4 * eq + 3) * CMAX + i] = x.w;
      }
      __syncthreads();
      const int ne = min(EK, D - e0);
      for (int e = 0; e < ne; ++e)
        fma4x4(inter, lds4(&Sg[e * CMAX + 4 * ta]),
               lds4(&Ct[(e0 + e) * TV + 4 * tb]));
    }

    // C: intra[i][v] = sum_{j <= i} S[i][j] V[j][v], S staged as stored
    const float* sb = st + cb * q * q;
    for (int j0 = 0; j0 < cl; j0 += EK) {
      __syncthreads();
#pragma unroll
      for (int it = 0; it < EK * CMAX / 4 / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int jj = idx / (CMAX / 4), iq = idx % (CMAX / 4);
        const int j = j0 + jj, i = 4 * iq;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (j < cl)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (i + r < q) x[r] = sb[(size_t)j * q + i + r];
        store4(&Sg[jj * CMAX + i], make_float4(x[0], x[1], x[2], x[3]));
      }
      __syncthreads();
      const int jend = min(min(EK, cl - j0), 4 * ta + 4 - j0);
      for (int jj = 0; jj < jend; ++jj)
        fma4x4(intra, lds4(&Sg[jj * CMAX + 4 * ta]),
               lds4(&Vs[(j0 + jj) * TV + 4 * tb]));
    }

    // E: h = (intra + inter_scale * inter * scale) / den
    if (v0 + 4 * tb < D) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ta + r;
        if (i < cl) {
          const float is = iss[i], dn = dens[i];
          float o[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            o[c] = (intra[r][c] + (is * inter[r][c]) * scale) / dn;
          store4(hx + ((size_t)b * L + l0 + i) * rs + (size_t)h * D + v0 +
                     4 * tb,
                 make_float4(o[0], o[1], o[2], o[3]));
        }
      }
    }

    // D: C[v][e] = carry C[v][e] + sum_j K[j][e] (wexp_j V[j][v])
    for (int e0 = 0; e0 < D; e0 += EU) {
      float upd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) upd[r][c] = 0.f;
      for (int j0 = 0; j0 < cl; j0 += EK) {
        __syncthreads();
#pragma unroll
        for (int it = 0; it < EK * EU / 4 / THREADS; ++it) {
          const int idx = tid + it * THREADS;
          const int jj = idx / (EU / 4), eq = idx % (EU / 4);
          const int j = j0 + jj, e = e0 + 4 * eq;
          const float4 x = (j < cl && e < D) ? load4(kb + (size_t)j * rs + e)
                                             : zero4();
          store4(&Sg[jj * EU + 4 * eq], x);
        }
        __syncthreads();
        const int nj = min(EK, cl - j0);
        for (int jj = 0; jj < nj; ++jj)
          fma4x4(upd, lds4(&Sg[jj * EU + 4 * ta]),
                 lds4(&Vw[(j0 + jj) * TV + 4 * tb]));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = e0 + 4 * ta + r;
        if (e < D) {
          float4* p = reinterpret_cast<float4*>(&Ct[e * TV + 4 * tb]);
          float4 c = *p;
          c.x = carry * c.x + upd[r][0];
          c.y = carry * c.y + upd[r][1];
          c.z = carry * c.z + upd[r][2];
          c.w = carry * c.w + upd[r][3];
          *p = c;
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < D * (TV / 4); idx += THREADS) {
    const int e = idx % D, vq = idx / D;
    const float4 c = lds4(&Ct[e * TV + 4 * vq]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int v = v0 + 4 * vq + r;
      if (v < D) c_fin[((size_t)bh * D + v) * D + e] = comp(c, r);
    }
  }
}

int state_smem_bytes(int D) {
  return (D * TV + 2 * CMAX * TV + STAGE + 2 * CMAX) * (int)sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* logi,
           const float* logf, const float* c0, const float* n0,
           const float* m0, void* h, float* c_fin, float* n_fin,
           float* m_fin, float* gvec, float* gcarry, float* nin, float* st,
           float* den, int B, int L, int H, int D, int qc,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int nc = (L + qc - 1) / qc;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaError_t err;

  ml_gates_kernel<T><<<dim3(H, B), THREADS, 0, stream>>>(
      kt, logi, logf, n0, m0, gvec, gcarry, nin, n_fin, m_fin, L, H, D, qc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rblk = (qc + RB - 1) / RB;
  ml_scores_kernel<T><<<dim3(nc * rblk, H, B), THREADS, 0, stream>>>(
      qt, kt, logi, gvec, nin, st, den, L, H, D, qc, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int smem = state_smem_bytes(D);
  err = cudaFuncSetAttribute(ml_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + TV - 1) / TV, H, B);
  ml_state_kernel<T><<<grid, THREADS, smem, stream>>>(
      qt, kt, vt, c0, gvec, gcarry, st, den, static_cast<T*>(h), c_fin, L,
      H, D, qc, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, h: (B, L, H, D) of one dtype (0 = float32, 1 = bfloat16);
// logi, logf: (B, L, H) f32; c0 (B, H, D, D), n0 (B, H, D), m0 (B, H) f32,
// all three null for the zero state; c_fin, n_fin, m_fin likewise, written;
// the scratch as listed above, N = B * H * ceil(L / qc).  All contiguous.
// 1 <= qc <= min(L, 128); D <= 1024, a multiple of 4.
extern "C" int ml_mlstm(const void* q, const void* k, const void* v,
                        const void* logi, const void* logf, const void* c0,
                        const void* n0, const void* m0, void* h, void* c_fin,
                        void* n_fin, void* m_fin, void* gvec, void* gcarry,
                        void* nin, void* st, void* den, int B, int L, int H,
                        int D, int qc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool no_state = c0 == nullptr && n0 == nullptr && m0 == nullptr;
  const bool state = c0 != nullptr && n0 != nullptr && m0 != nullptr;
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D > DMAX || D % 4 != 0 ||
      qc <= 0 || qc > CMAX || qc > L || B > 65535 || H > 65535 ||
      !(no_state || state))
    return (int)cudaErrorInvalidValue;
  const float* lif = static_cast<const float*>(logi);
  const float* lff = static_cast<const float*>(logf);
  const float* c0f = static_cast<const float*>(c0);
  const float* n0f = static_cast<const float*>(n0);
  const float* m0f = static_cast<const float*>(m0);
  float* cf = static_cast<float*>(c_fin);
  float* nf = static_cast<float*>(n_fin);
  float* mf = static_cast<float*>(m_fin);
  float* gv = static_cast<float*>(gvec);
  float* gc = static_cast<float*>(gcarry);
  float* ni = static_cast<float*>(nin);
  float* sf = static_cast<float*>(st);
  float* df = static_cast<float*>(den);
  if (dtype == 0)
    return launch<float>(q, k, v, lif, lff, c0f, n0f, m0f, h, cf, nf, mf, gv,
                         gc, ni, sf, df, B, L, H, D, qc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lif, lff, c0f, n0f, m0f, h, cf, nf,
                                 mf, gv, gc, ni, sf, df, B, L, H, D, qc, s);
  return (int)cudaErrorInvalidValue;
}
