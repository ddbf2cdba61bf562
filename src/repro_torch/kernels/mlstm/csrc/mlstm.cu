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
//   C        = carry C + sum_j wexp_j v_j k_j^T,
//   n        = carry n + sum_j wexp_j k_j
// with w_j = cumf_q - cumf_j + logi_j, m' = max(m + cumf_q, max_j w_j),
// wexp_j = exp(w_j - m'), carry = exp(m + cumf_q - m').  Unlike the TPU
// kernel it takes an initial state (the Pallas path starts from zero) and a
// ragged last chunk (the Pallas kernel asserts L % chunk == 0).  h is
// rounded once to the inputs' dtype; the final state is f32.
//
// What bounds it on this card.  Operations: xlstm-1.3b (hd = 1024, 4 heads)
// at a 1024-token prefill with q = 128 is about 17 GFLOP (0.017 ms at the
// bf16 tensor-core peak, 0.26 ms at the f32 CUDA-core peak) against about
// 50 MB of traffic (0.015 ms).
//
// What does not carry over from the TPU.  The TPU kernel keeps each head's
// whole C (hd x hd f32, 4 MiB at hd = 1024) in VMEM scratch and walks the
// chunks on the sequential grid axis; a Hopper block has 227 KB of shared
// memory and at most 255 registers a thread, and at B = 1 the (B, H) grid
// has 4 pairs for 132 SMs.
//
// The gate pass (both routes).  The gates' scalars are small (q values a
// chunk), so it runs in parallel over the chunks: ml_gate_chunks (grid
// (chunks, H, B)) takes each chunk's cumf by a block-wide shuffle scan,
// max_{j<=i} (logi_j - cumf_j) by a prefix max (so m_comb is O(1) a row,
// not an O(q) loop) and the chunk's total and max_j w_j; ml_gate_state
// (grid (hd / 32, H, B)) carries the scalar m over the chunks, writes the
// per-row vectors, and runs the n recurrence on 32 columns of n a block,
// each chunk's sum_j wexp_j k_j taken by all 256 threads.
//
// The bf16 route: three passes on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 sums; kernels/include/mma_bf16.cuh), in the
// chunk-parallel form:
//   1. ml_scores_tc (grid (chunks x 64-row blocks, H, B)): S = Q K^T of
//      every chunk, decayed and masked, and den; S leaves in NPART bf16
//      parts (S is f32: one rounding would cost ~2^-9 of h);
//   2. ml_state_tc (grid (hd / 128, hd / 128, H x B)): one block holds a
//      128 x 128 tile of C as mma accumulators in f32 and walks the
//      chunks: it writes the C entering each chunk in parts, then adds
//      K^T (wexp o V) with wexp o V in parts (its products are f32);
//   3. ml_hout_tc (grid (hd / 128, chunks, H x B)): h for every chunk at
//      once, Q C^T from C's parts (scaled by inter_scale), then + S V
//      from S's parts, over den.
// q, k and v are bf16 inputs, so they enter a product once and exactly;
// each f32 operand x enters as NPART = 3 bf16 parts, hi = bf16(x), mid =
// bf16(x - hi) and lo = bf16(x - hi - mid), three products keeping ~24
// bits of x, as f32 does (mamba_scan keeps its states so).  With two
// (~16 bits), h at xlstm-1.3b's layer inputs came out off the bf16
// rounding of a float64 h on 0.13-0.19% of its elements, against
// 0.07-0.09% with three and 0.03% for the plain version (S's third part
// moved that share; C's and wexp o V's keep the state's precision where
// slow gates carry it over chunks, which ref.precision's C check sees).
// The chunk-parallel form materialises the C entering each chunk (nc H
// hd^2 4 bytes, 128 MB at L 1024: ~0.08 ms of traffic) so that no block
// walks the chunks with the head's whole Q and K re-staged for each
// 32-row tile of C, as a block holding its tile of C across the chunks
// must.  No atomics: the result is deterministic.
//
// The f32 route keeps the CUDA-core passes (f32 FMAs, a 4 x 4 register
// tile a thread): ml_scores (S and den, stored as f32) and ml_state (one
// block per 32-row tile of C, kept transposed in shared memory, walking
// the chunks).  Compiled without fast math: exp(-1e30 - m) is 0, as in
// the plain version.
//
// Edges: chunk q <= 128, hd <= 1024 and a multiple of 4; the last chunk may
// be shorter than q.  The passes run in order on the caller's stream: one
// call is one launch of the kernel in the wrapper's count.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the wrapper passes the scratch), does not
// synchronise, returns the first CUDA error of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

// Block-wide inclusive scans and reductions by warp shuffles, for the
// gate passes: O(log n) steps where a loop on one thread takes n.  Every
// thread of the block calls them (they synchronise); the block's size is
// a multiple of 32, at most 1024; `sh` is a shared scratch of at least 33
// floats, free again on return.
namespace scan {

constexpr float NEG = -1e30f;      // the max's identity

template <bool MAX>
__device__ __forceinline__ float op(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}

// Inclusive scan over the 32 lanes of a warp.
template <bool MAX>
__device__ __forceinline__ float warp_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = op<MAX>(u, v);
  }
  return v;
}

// Inclusive scan over the block's threads in the order of threadIdx.x
// (sum, or max with MAX).
template <bool MAX>
__device__ __forceinline__ float block_scan(float v, float* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_scan<MAX>(v);
  if (lane == 31) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    float t = lane < nw ? sh[lane] : (MAX ? NEG : 0.f);
    t = warp_scan<MAX>(t);
    sh[lane] = t;
  }
  __syncthreads();
  if (w > 0) v = op<MAX>(sh[w - 1], v);
  __syncthreads();
  return v;
}

// The sum (or max) of v over the block, returned to every thread.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op<MAX>(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) sh[w] = v;
  __syncthreads();
  float r = sh[0];
  for (int i = 1; i < nw; ++i) r = op<MAX>(r, sh[i]);
  __syncthreads();
  return r;
}

}  // namespace scan

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CMAX = 128;          // longest chunk
constexpr int DMAX = 1024;         // largest head dim
constexpr int TV = 32;             // rows of C (hd_v) per f32 state block
constexpr int THREADS = 256;
constexpr int RB = 32;             // rows of S per f32 scores block
constexpr int EK = 32;             // contraction slice of a staged tile
constexpr int EU = 128;            // hd_k columns per step of the C update
constexpr int STAGE = CMAX * EK;   // floats of the f32 state pass's stage
constexpr int NE = 32;             // columns of n per gate-state block
constexpr float NEG = -1e30f;
// the tensor-core passes
constexpr int TT = 128;            // tile side (rows of C / h, chunk rows)
constexpr int TLD = TT + tc::PAD;  // its smem row stride
constexpr int SR = 64;             // rows of S per scores block (4 warps)
constexpr int HK = 64;             // contraction slice of Q C^T and Q K^T
constexpr int HLD = HK + tc::PAD;
constexpr int SC_STAGES = 4;       // cp.async stages of ml_scores_tc
constexpr int HO_STAGES = 3;       // and of ml_hout_tc's Q C^T
constexpr int NPART = 3;           // bf16 parts of an f32 operand

static_assert(EK * EU == STAGE, "the C update's K slice fills the stage");
static_assert((CMAX / 4) * (TV / 4) == THREADS, "4 x 4 tiles cover q x TV");
static_assert((EU / 4) * (TV / 4) == THREADS, "4 x 4 tiles cover EU x TV");
static_assert((RB / 4) * (CMAX / 4) == THREADS, "4 x 4 tiles cover RB x q");
static_assert(THREADS >= CMAX && THREADS % NE == 0, "gate-state layout");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Four consecutive elements (p 16-byte aligned for f32, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
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

// The factor that carries C from one chunk into the next; both routes'
// state passes read it here.
__device__ __forceinline__ float c_carry(const float* gcarry, size_t cb) {
  return gcarry[cb];
}

// Per-chunk scratch, f32, for N = B * H * nc (b, h, chunk) triples:
//   gvec  (N, 4, q): cumf, m_comb, inter_scale, wexp (zero past the chunk)
//   gscal (N, 2):    the chunk's cumf_q and max_j w_j
//   carry (N)
//   nin   (N, D):    n entering the chunk
//   den   (N, q)
//   st    f32 route: (N, q, q) S transposed, st[j][i] = S_ij;
//         bf16 route: (N, NPART, SQ, SQ) bf16, S's part planes, [i][j],
//         SQ = q rounded up to 16, zero above the diagonal and past the
//         chunk
//   cin   bf16 route: (N, NPART, D, DP) bf16, the part planes of the C
//         entering the chunk, [v][e], DP = D rounded up to 8 (the pad
//         columns 0); chunk 0's is not written when the state is zero

// Gate pass 1: each chunk's local scans, one block of CMAX threads per
// (chunk, h, b), thread i on token i of the chunk.
__global__ void __launch_bounds__(CMAX)
ml_gate_chunks_kernel(const float* __restrict__ logi,
                      const float* __restrict__ logf,
                      float* __restrict__ gvec, float* __restrict__ gscal,
                      int L, int H, int q) {
  __shared__ float sh[33];
  __shared__ float tot;
  const int i = threadIdx.x, ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = (L + q - 1) / q;
  const int l0 = ci * q, cl = min(q, L - l0);
  const size_t cb = ((size_t)b * H + h) * nc + ci;
  const bool in = i < cl;
  const size_t g = ((size_t)b * L + l0 + i) * H + h;
  const float lf = in ? logf[g] : 0.f;
  const float li = in ? logi[g] : 0.f;
  const float cf = scan::block_scan<false>(lf, sh);   // cumf (total past cl)
  if (i == CMAX - 1) tot = cf;
  const float pm = scan::block_scan<true>(in ? li - cf : NEG, sh);
  const float total = tot;         // block_scan synchronised after the write
  const float w = in ? (total - cf) + li : NEG;
  const float wmax = scan::block_reduce<true>(w, sh);
  float* gv = gvec + cb * 4 * q;
  if (i < q) {
    gv[i] = in ? cf : 0.f;
    gv[2 * q + i] = pm;            // max_{j<=i} (logi_j - cumf_j), for now
  }
  if (i == 0) {
    gscal[2 * cb] = total;
    gscal[2 * cb + 1] = wmax;
  }
}

// Gate pass 2: m over the chunks (every block, redundantly: a few scalar
// ops a chunk), the per-row vectors (block x 0), and the n recurrence on
// NE columns of n: thread (jg, el) sums wexp_j k_j[e0 + el] over j = jg
// mod THREADS / NE.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ml_gate_state_kernel(const T* __restrict__ k, const float* __restrict__ logi,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0, float* __restrict__ gvec,
                     const float* __restrict__ gscal,
                     float* __restrict__ gcarry, float* __restrict__ nin,
                     float* __restrict__ n_fin, float* __restrict__ m_fin,
                     int L, int H, int D, int q) {
  constexpr int JG = THREADS / NE;
  __shared__ float wex[CMAX];
  __shared__ float red[JG][NE];
  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const bool first = blockIdx.x == 0;
  const int el = tid % NE, jg = tid / NE, e = blockIdx.x * NE + el;
  const int nc = (L + q - 1) / q;
  const size_t rs = (size_t)H * D;             // one token's stride in k
  float n_run = (n0 != nullptr && tid < NE && e < D)
                    ? n0[(size_t)bh * D + e] : 0.f;
  float m_in = m0 != nullptr ? m0[bh] : NEG;

  for (int ci = 0; ci < nc; ++ci) {
    const int l0 = ci * q, cl = min(q, L - l0);
    const size_t cb = (size_t)bh * nc + ci;
    float* gv = gvec + cb * 4 * q;
    const float total = gscal[2 * cb], wmax = gscal[2 * cb + 1];
    const float m_out = fmaxf(m_in + total, wmax);
    const float carry = expf((m_in + total) - m_out);
    if (tid < CMAX) {
      float we = 0.f;
      if (tid < cl) {
        const float cf = gv[tid];
        const float li = logi[((size_t)b * L + l0 + tid) * H + h];
        we = expf(((total - cf) + li) - m_out);
        if (first) {
          const float bi = cf + m_in;
          const float mc = fmaxf(cf + gv[2 * q + tid], bi);
          gv[q + tid] = mc;
          gv[2 * q + tid] = expf(bi - mc);
        }
      } else if (first && tid < q) {
        gv[q + tid] = 0.f;
        gv[2 * q + tid] = 0.f;
      }
      wex[tid] = we;
      if (first && tid < q) gv[3 * q + tid] = we;
    }
    if (first && tid == 0) gcarry[cb] = carry;
    __syncthreads();
    const T* kb = k + ((size_t)b * L + l0) * rs + (size_t)h * D;
    float part = 0.f;
    if (e < D)
      for (int j = jg; j < cl; j += JG)
        part = fmaf(wex[j], to_f32(kb[(size_t)j * rs + e]), part);
    red[jg][el] = part;
    __syncthreads();
    if (tid < NE && e < D) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < JG; ++p) s += red[p][el];
      nin[cb * D + e] = n_run;
      n_run = carry * n_run + s;
    }
    m_in = m_out;
    __syncthreads();               // wex and red are reused
  }
  if (tid < NE && e < D) n_fin[(size_t)bh * D + e] = n_run;
  if (first && tid == 0) m_fin[bh] = m_in;
}

// f32 route, pass 1: S and den of every chunk.  Block (ci, rows r0..r0+RB-1) of
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

// f32 route, pass 2: the chunk loop over one TV-row tile of C.  Thread
// (ta, tb) owns rows 4 ta + r (tokens i in the h products, hd_k columns e
// in the C update) and hd_v columns v0 + 4 tb + c.
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
    const float carry = c_carry(gcarry, cb);
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

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores.  Warp w's fragments follow
// mma_bf16.cuh: g = lane / 4 and t = lane % 4 own rows g, g + 8 and
// columns 2t, 2t + 1 of each 16 x 8 accumulator tile.
// ---------------------------------------------------------------------------

// Rows [0, ROWS) x columns [0, COLS) of a bf16 matrix into shared memory
// (row stride LD) by cp.async: src is the tile's (0, 0), rs its row
// stride; rows at or past nr and columns at or past ncols read as 0.
// vec: 16-byte copies (rs, ncols and src's offset multiples of 8), else
// 4-byte ones (multiples of 2).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t rs, int nr, int ncols,
                                          bool vec) {
  if (vec) {
    constexpr int CH = COLS / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r < nr && c < ncols;
      tc::cp_async16(dst + r * LD + c, ok ? src + (size_t)r * rs + c : src,
                     ok ? 16 : 0);
    }
  } else {
    constexpr int CH = COLS / 2;
    for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 2;
      const bool ok = r < nr && c < ncols;
      tc::cp_async4(dst + r * LD + c, ok ? src + (size_t)r * rs + c : src,
                    ok ? 4 : 0);
    }
  }
}

// x's NPART bf16 parts as words of two bf16 (x0 in the low halves): part
// p is bf16 of what the parts before it leave of x.
__device__ __forceinline__ void split_parts(float x0, float x1,
                                            uint32_t (&w)[NPART]) {
#pragma unroll
  for (int p = 0; p < NPART; ++p) {
    w[p] = tc::pack_bf16(x0, x1);
    x0 -= __bfloat162float(__float2bfloat16(x0));
    x1 -= __bfloat162float(__float2bfloat16(x1));
  }
}

// bf16 route, pass 1: S = Q K^T of every chunk on the tensor cores,
// decayed and masked, stored in NPART bf16 parts, and den.  Block (ci, rows
// r0..r0+SR-1) of (h, b), 4 warps of 16 rows, each over all the columns
// j <= its rows; Q, K and n stream through shared memory in HK-column
// slices (SC_STAGES stages); q . n runs on the CUDA cores beside them.
__global__ void __launch_bounds__(128)
ml_scores_tc_kernel(const bf16* __restrict__ qx, const bf16* __restrict__ kx,
                    const float* __restrict__ logi,
                    const float* __restrict__ gvec,
                    const float* __restrict__ nin, bf16* __restrict__ sp,
                    float* __restrict__ den, int L, int H, int D, int q,
                    float scale) {
  extern __shared__ __align__(16) bf16 tsm[];
  __shared__ float cfs[CMAX], lis[CMAX], qns[SR];
  constexpr int STG = (SR + CMAX) * HLD + 2 * HK;   // Q, K; n in f32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rblk = (q + SR - 1) / SR;
  const int ci = blockIdx.x / rblk, r0 = (blockIdx.x % rblk) * SR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (L + q - 1) / q, l0 = ci * q, cl = min(q, L - l0);
  const size_t cb = ((size_t)b * H + h) * nc + ci;
  const size_t rs = (size_t)H * D;
  const int SQ = (q + 15) / 16 * 16;
  const float* gv = gvec + cb * 4 * q;
  const float* nb = nin + cb * D;
  const bf16* qb = qx + ((size_t)b * L + l0 + r0) * rs + (size_t)h * D;
  const bf16* kb = kx + ((size_t)b * L + l0) * rs + (size_t)h * D;
  const int nq = max(0, min(SR, cl - r0));     // Q rows of the block
  const int jn = min(cl, r0 + SR);             // K rows that can be unmasked
  const int wr = warp * 16;                    // the warp's first row
  const int jw = min(cl, r0 + wr + 16);        // its columns j < jw
  const int npw = jw > 0 ? (jw + 15) / 16 : 0; // n-tile pairs it computes
  const bool vec = D % 8 == 0;
  for (int i = tid; i < CMAX; i += 128) {
    cfs[i] = i < cl ? gv[i] : 0.f;
    lis[i] = i < cl ? logi[((size_t)b * L + l0 + i) * H + h] : 0.f;
  }

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  float qn = 0.f;                  // row tid / 2, half tid % 2 of the slice
  const int KT = (D + HK - 1) / HK;
  // slice kt of Q, K and n into stage kt % 2
  auto issue = [&](int kt) {
    bf16* st = tsm + (kt % SC_STAGES) * STG;
    const int e0 = kt * HK;
    load_tile<SR, HK, HLD>(st, qb + e0, rs, nq, D - e0, vec);
    load_tile<CMAX, HK, HLD>(st + SR * HLD, kb + e0, rs, jn, D - e0, vec);
    float* ns = reinterpret_cast<float*>(st + (SR + CMAX) * HLD);
    for (int i = tid; i < HK / 4; i += 128)
      tc::cp_async16(ns + 4 * i, nb + (e0 + 4 * i < D ? e0 + 4 * i : 0),
                     e0 + 4 * i < D ? 16 : 0);
  };
  for (int kt = 0; kt < SC_STAGES - 1; ++kt) {
    if (kt < KT) issue(kt);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<SC_STAGES - 2>();
    __syncthreads();               // slice kt landed; kt - 1's stage free
    if (kt + SC_STAGES - 1 < KT) issue(kt + SC_STAGES - 1);
    tc::cp_async_commit();
    const bf16* qs = tsm + (kt % SC_STAGES) * STG;
    const bf16* ks = qs + SR * HLD;
    {                              // q . n (both 0 past hd)
      const float* ns = reinterpret_cast<const float*>(ks + CMAX * HLD);
      const int row = tid >> 1, c0 = (tid & 1) * (HK / 2);
#pragma unroll 8
      for (int c = 0; c < HK / 2; ++c)
        qn = fmaf(__bfloat162float(qs[row * HLD + c0 + c]), ns[c0 + c], qn);
    }
#pragma unroll
    for (int kk = 0; kk < HK / 16; ++kk) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, qs + tc::a_off<HLD>(lane, wr, kk * 16));
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        if (np < npw) {
          uint32_t bb[4];
          tc::ldmatrix_x4(bb, ks + tc::b_off<HLD>(lane, np * 16, kk * 16));
          tc::mma_bf16(acc[2 * np], a, bb[0], bb[1]);
          tc::mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if ((tid & 1) == 0) qns[tid >> 1] = qn;
  __syncthreads();

  bf16* s0 = sp + cb * NPART * SQ * SQ;     // the parts, SQ^2 apart
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int il = wr + g + 8 * hf, i = r0 + il;
    const bool valid = i < cl;
    const float cfi = valid ? cfs[i] : 0.f;
    const float mci = valid ? gv[q + i] : 0.f;
    float rsum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = nt * 8 + 2 * t4 + c;
        s[c] = 0.f;
        if (valid && j <= i) {
          const float d = expf(((cfi - cfs[j]) + lis[j]) - mci);
          s[c] = (acc[nt][2 * hf + c] * scale) * d;
        }
        rsum += s[c];
      }
      const int j0 = nt * 8 + 2 * t4;
      if (i < SQ && j0 < SQ) {
        uint32_t w[NPART];
        split_parts(s[0], s[1], w);
#pragma unroll
        for (int p = 0; p < NPART; ++p)
          *reinterpret_cast<uint32_t*>(s0 + (size_t)p * SQ * SQ + i * SQ +
                                       j0) = w[p];
      }
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    if (t4 == 0 && i < q) {
      float dn = 1.f;              // rows past the chunk are never read
      if (valid) {
        dn = rsum + (gv[2 * q + i] * qns[il]) * scale;
        dn = fmaxf(fabsf(dn), expf(-mci));
      }
      den[cb * q + i] = dn;
    }
  }
}

// bf16 route, pass 2: a 128 x 128 tile of C (rows v0.., columns e0..) as
// mma accumulators, walking the chunks: the C entering each chunk leaves
// in NPART bf16 parts, then C = carry C + (wexp o V)^T K over the chunk's
// tokens.  Warp w owns rows 32 (w / 2).. and columns 64 (w % 2)..; the
// chunk's K and V tiles are staged one chunk ahead; wexp o V (f32) is
// built from V in parts [j][v] (the first two in their own tiles, the
// third over the V tile it is built from) and read transposed as the A
// operand, K [j][e] as the B operand.
__global__ void __launch_bounds__(THREADS)
ml_state_tc_kernel(const bf16* __restrict__ kx, const bf16* __restrict__ vx,
                   const float* __restrict__ c0,
                   const float* __restrict__ gvec,
                   const float* __restrict__ gcarry, bf16* __restrict__ cin,
                   float* __restrict__ c_fin, int L, int H, int D, int q) {
  extern __shared__ __align__(16) bf16 tsm[];
  __shared__ float wex[CMAX];
  bf16* W0 = tsm;                  // (TT, TLD): wexp_j v_j's part 0, [j][v]
  bf16* W1 = W0 + TT * TLD;        // part 1
  bf16* stages = W1 + TT * TLD;    // 2 x (K [j][e], V [j][v]), (TT, TLD)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int e0 = blockIdx.x * TT, v0 = blockIdx.y * TT, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int nc = (L + q - 1) / q;
  const size_t rs = (size_t)H * D;
  const int DP = (D + 7) / 8 * 8;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;
  const int nv = min(TT, D - v0), ne = min(TT, D - e0);
  const bool vec = D % 8 == 0;
  // chunk ci's K and V tiles into stage ci % 2
  auto issue = [&](int ci) {
    const int l0 = ci * q, cl = min(q, L - l0);
    const size_t off = ((size_t)b * L + l0) * rs + (size_t)h * D;
    bf16* ks = stages + (ci & 1) * 2 * TT * TLD;
    load_tile<TT, TT, TLD>(ks, kx + off + e0, rs, cl, ne, vec);
    load_tile<TT, TT, TLD>(ks + TT * TLD, vx + off + v0, rs, cl, nv, vec);
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = v0 + wr + mt * 16 + g + (r >> 1) * 8;
        const int e = e0 + wc + nt * 8 + 2 * t4 + (r & 1);
        acc[mt][nt][r] = (c0 != nullptr && v < D && e < D)
                             ? c0[((size_t)bh * D + v) * D + e] : 0.f;
      }

  issue(0);
  tc::cp_async_commit();
  for (int ci = 0; ci < nc; ++ci) {
    const int cl = min(q, L - ci * q);
    const size_t cb = (size_t)bh * nc + ci;
    const float* gv = gvec + cb * 4 * q;
    if (ci + 1 < nc) issue(ci + 1);
    tc::cp_async_commit();
    if (ci > 0 || c0 != nullptr) {   // the C entering the chunk, in parts
      bf16* cp = cin + cb * NPART * (size_t)D * DP;   // D DP apart
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int v = v0 + wr + mt * 16 + g + 8 * hf;
            const int e = e0 + wc + nt * 8 + 2 * t4;
            if (v < D && e < DP) {
              uint32_t w[NPART];
              split_parts(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1], w);
#pragma unroll
              for (int p = 0; p < NPART; ++p)
                *reinterpret_cast<uint32_t*>(
                    cp + ((size_t)p * D + v) * DP + e) = w[p];
            }
          }
    }
    for (int j = tid; j < CMAX; j += THREADS)
      wex[j] = j < cl ? gv[3 * q + j] : 0.f;
    tc::cp_async_wait<1>();
    __syncthreads();               // chunk ci's K and V landed
    const bf16* Ks = stages + (ci & 1) * 2 * TT * TLD;
    bf16* Vs = stages + (ci & 1) * 2 * TT * TLD + TT * TLD;
    bf16* const Wp[3] = {W0, W1, Vs};   // the parts' tiles
    static_assert(NPART <= 3, "wexp o V's parts: two tiles and V's");
    for (int idx = tid; idx < TT * (TT / 2); idx += THREADS) {
      const int j = idx / (TT / 2), c = (idx % (TT / 2)) * 2;
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Vs + j * TLD + c));
      uint32_t w[NPART];
      split_parts(wex[j] * x.x, wex[j] * x.y, w);
#pragma unroll
      for (int p = 0; p < NPART; ++p)   // a thread overwrites only the V
        *reinterpret_cast<uint32_t*>(Wp[p] + j * TLD + c) = w[p];  // it read
    }
    __syncthreads();               // the parts are built
    const float carry = c_carry(gcarry, cb);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] *= carry;
    const int kend = (cl + 15) / 16;
    for (int kk = 0; kk < kend; ++kk) {
      uint32_t aw[NPART][2][4];
#pragma unroll
      for (int p = 0; p < NPART; ++p)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::ldmatrix_x4_trans(
              aw[p][mt], Wp[p] + tc::b_off<TLD>(lane, kk * 16, wr + mt * 16));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        tc::ldmatrix_x4_trans(bb,
                              Ks + tc::a_off<TLD>(lane, kk * 16, wc + np * 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int p = 0; p < NPART; ++p) {
            tc::mma_bf16(acc[mt][2 * np], aw[p][mt], bb[0], bb[1]);
            tc::mma_bf16(acc[mt][2 * np + 1], aw[p][mt], bb[2], bb[3]);
          }
      }
    }
    __syncthreads();               // the chunk's tiles are free again
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = v0 + wr + mt * 16 + g + (r >> 1) * 8;
        const int e = e0 + wc + nt * 8 + 2 * t4 + (r & 1);
        if (v < D && e < D)
          c_fin[((size_t)bh * D + v) * D + e] = acc[mt][nt][r];
      }
}

// bf16 route, pass 3: h of one chunk for 128 columns v0.. of hd_v: Q C^T
// from the parts of the C entering the chunk (HK-column slices, HO_STAGES
// stages; skipped for the first chunk from a zero state), its rows
// scaled by inter_scale * scale, then + S V from S's parts, over den.
// Warp w owns rows 32 (w / 2).. and columns 64 (w % 2)...
__global__ void __launch_bounds__(THREADS)
ml_hout_tc_kernel(const bf16* __restrict__ qx, const bf16* __restrict__ vx,
                  const bf16* __restrict__ cin,
                  const float* __restrict__ gvec,
                  const bf16* __restrict__ sp, const float* __restrict__ den,
                  bf16* __restrict__ hx, int L, int H, int D, int q,
                  int has_state, float scale) {
  extern __shared__ __align__(16) bf16 tsm[];
  constexpr int STG = (1 + NPART) * TT * HLD;   // Q and C's parts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int v0 = blockIdx.x * TT, ci = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int nc = (L + q - 1) / q, l0 = ci * q, cl = min(q, L - l0);
  const size_t cb = (size_t)bh * nc + ci;
  const size_t rs = (size_t)H * D;
  const int DP = (D + 7) / 8 * 8, SQ = (q + 15) / 16 * 16;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;
  const int nv = min(TT, D - v0);
  const bool vec = D % 8 == 0;
  const float* gv = gvec + cb * 4 * q;
  const bf16* qb = qx + ((size_t)b * L + l0) * rs + (size_t)h * D;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  if (ci > 0 || has_state) {
    const bf16* cp = cin + cb * NPART * (size_t)D * DP + (size_t)v0 * DP;
    const int KT = (DP + HK - 1) / HK;
    // slice kt of Q and of C's parts into stage kt % HO_STAGES
    auto issue = [&](int kt) {
      bf16* st = tsm + (kt % HO_STAGES) * STG;
      const int e0 = kt * HK;
      load_tile<TT, HK, HLD>(st, qb + e0, rs, cl, D - e0, vec);
      for (int p = 0; p < NPART; ++p)
        load_tile<TT, HK, HLD>(st + (1 + p) * TT * HLD,
                               cp + (size_t)p * D * DP + e0, DP, nv, DP - e0,
                               true);
    };
    for (int kt = 0; kt < HO_STAGES - 1; ++kt) {
      if (kt < KT) issue(kt);
      tc::cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      tc::cp_async_wait<HO_STAGES - 2>();
      __syncthreads();             // slice kt landed; kt - 1's stage free
      if (kt + HO_STAGES - 1 < KT) issue(kt + HO_STAGES - 1);
      tc::cp_async_commit();
      const bf16* qs = tsm + (kt % HO_STAGES) * STG;
      const bf16* hs = qs + TT * HLD;          // C's parts, TT HLD apart
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::ldmatrix_x4(a[mt],
                          qs + tc::a_off<HLD>(lane, wr + mt * 16, kk * 16));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bh4[4];
          tc::ldmatrix_x4(bh4, hs + tc::b_off<HLD>(lane, wc + np * 16,
                                                   kk * 16));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            tc::mma_bf16(acc[mt][2 * np], a[mt], bh4[0], bh4[1]);
            tc::mma_bf16(acc[mt][2 * np + 1], a[mt], bh4[2], bh4[3]);
          }
#pragma unroll
          for (int p = 1; p < NPART; ++p) {     // C's lower parts
            uint32_t bl4[4];
            tc::ldmatrix_x4(bl4, hs + p * TT * HLD +
                                     tc::b_off<HLD>(lane, wc + np * 16,
                                                    kk * 16));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              tc::mma_bf16(acc[mt][2 * np], a[mt], bl4[0], bl4[1]);
              tc::mma_bf16(acc[mt][2 * np + 1], a[mt], bl4[2], bl4[3]);
            }
          }
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();               // the stages are free for S V's tiles
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = wr + mt * 16 + g + 8 * hf;
        const float f = i < cl ? gv[2 * q + i] * scale : 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[mt][nt][2 * hf] *= f;
          acc[mt][nt][2 * hf + 1] *= f;
        }
      }
  }

  // + S V: S's parts [i][j] as the A operand, V [j][v] as the B operand
  bf16* Ss = tsm;                            // S's parts, TT TLD apart
  bf16* Vs = Ss + NPART * TT * TLD;
  const bf16* s0 = sp + cb * NPART * SQ * SQ;
  for (int p = 0; p < NPART; ++p)
    load_tile<TT, TT, TLD>(Ss + p * TT * TLD, s0 + (size_t)p * SQ * SQ, SQ,
                           SQ, SQ, true);
  const bf16* vb = vx + ((size_t)b * L + l0) * rs + (size_t)h * D + v0;
  load_tile<TT, TT, TLD>(Vs, vb, rs, cl, nv, vec);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const int kend = min(SQ, wr + 32) / 16;     // S is 0 past the diagonal
  for (int kk = 0; kk < kend; ++kk) {
    uint32_t as[NPART][2][4];
#pragma unroll
    for (int p = 0; p < NPART; ++p)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tc::ldmatrix_x4(as[p][mt], Ss + p * TT * TLD +
                                       tc::a_off<TLD>(lane, wr + mt * 16,
                                                      kk * 16));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      tc::ldmatrix_x4_trans(bb,
                            Vs + tc::a_off<TLD>(lane, kk * 16, wc + np * 16));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int p = 0; p < NPART; ++p) {
          tc::mma_bf16(acc[mt][2 * np], as[p][mt], bb[0], bb[1]);
          tc::mma_bf16(acc[mt][2 * np + 1], as[p][mt], bb[2], bb[3]);
        }
    }
  }

  // h = acc / den, rows of the chunk, columns of hd_v
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = wr + mt * 16 + g + 8 * hf;
      if (i < cl) {
        const float dn = den[cb * q + i];
        bf16* hrow = hx + ((size_t)b * L + l0 + i) * rs + (size_t)h * D;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int v = v0 + wc + nt * 8 + 2 * t4;
          if (v < D)
            *reinterpret_cast<__nv_bfloat162*>(hrow + v) =
                __floats2bfloat162_rn(acc[mt][nt][2 * hf] / dn,
                                      acc[mt][nt][2 * hf + 1] / dn);
        }
      }
    }
}

int state_smem_bytes(int D) {
  return (D * TV + 2 * CMAX * TV + STAGE + 2 * CMAX) * (int)sizeof(float);
}
constexpr int SCORES_TC_SMEM =
    SC_STAGES * ((SR + CMAX) * HLD + 2 * HK) * (int)sizeof(bf16);
constexpr int STATE_TC_SMEM = 6 * TT * TLD * (int)sizeof(bf16);
constexpr int HOUT_TC_SMEM =
    (HO_STAGES * (1 + NPART) * TT * HLD > (NPART + 1) * TT * TLD
         ? HO_STAGES * (1 + NPART) * TT * HLD
         : (NPART + 1) * TT * TLD) *
    (int)sizeof(bf16);

template <typename T>
int launch_gates(const T* k, const float* logi, const float* logf,
                 const float* n0, const float* m0, float* n_fin,
                 float* m_fin, float* gvec, float* gscal, float* gcarry,
                 float* nin, int B, int L, int H, int D, int qc,
                 cudaStream_t stream) {
  const int nc = (L + qc - 1) / qc;
  ml_gate_chunks_kernel<<<dim3(nc, H, B), CMAX, 0, stream>>>(
      logi, logf, gvec, gscal, L, H, qc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ml_gate_state_kernel<T><<<dim3((D + NE - 1) / NE, H, B), THREADS, 0,
                            stream>>>(k, logi, n0, m0, gvec, gscal, gcarry,
                                      nin, n_fin, m_fin, L, H, D, qc);
  return (int)cudaGetLastError();
}

int launch_f32(const float* q, const float* k, const float* v,
               const float* logi, const float* logf, const float* c0,
               const float* n0, const float* m0, float* h, float* c_fin,
               float* n_fin, float* m_fin, float* gvec, float* gscal,
               float* gcarry, float* nin, float* st, float* den, int B,
               int L, int H, int D, int qc, cudaStream_t stream) {
  const int nc = (L + qc - 1) / qc;
  const float scale = (float)(1.0 / sqrt((double)D));
  int rc = launch_gates<float>(k, logi, logf, n0, m0, n_fin, m_fin, gvec,
                               gscal, gcarry, nin, B, L, H, D, qc, stream);
  if (rc != 0) return rc;
  const int rblk = (qc + RB - 1) / RB;
  ml_scores_kernel<float><<<dim3(nc * rblk, H, B), THREADS, 0, stream>>>(
      q, k, logi, gvec, nin, st, den, L, H, D, qc, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = state_smem_bytes(D);
  err = cudaFuncSetAttribute(ml_state_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + TV - 1) / TV, H, B);
  ml_state_kernel<float><<<grid, THREADS, smem, stream>>>(
      q, k, v, c0, gvec, gcarry, st, den, h, c_fin, L, H, D, qc, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const float* logi, const float* logf, const float* c0,
                const float* n0, const float* m0, bf16* h, float* c_fin,
                float* n_fin, float* m_fin, float* gvec, float* gscal,
                float* gcarry, float* nin, bf16* sp, bf16* cin, float* den,
                int B, int L, int H, int D, int qc, cudaStream_t stream) {
  const int nc = (L + qc - 1) / qc;
  const float scale = (float)(1.0 / sqrt((double)D));
  int rc = launch_gates<bf16>(k, logi, logf, n0, m0, n_fin, m_fin, gvec,
                              gscal, gcarry, nin, B, L, H, D, qc, stream);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      ml_scores_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SCORES_TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  ml_scores_tc_kernel<<<dim3(nc * ((qc + SR - 1) / SR), H, B), 128,
                        SCORES_TC_SMEM, stream>>>(
      q, k, logi, gvec, nin, sp, den, L, H, D, qc, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ml_state_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STATE_TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (D + TT - 1) / TT;
  ml_state_tc_kernel<<<dim3(tiles, tiles, B * H), THREADS, STATE_TC_SMEM,
                       stream>>>(k, v, c0, gvec, gcarry, cin, c_fin, L, H, D,
                                 qc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ml_hout_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             HOUT_TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  ml_hout_tc_kernel<<<dim3(tiles, nc, B * H), THREADS, HOUT_TC_SMEM,
                      stream>>>(q, v, cin, gvec, sp, den, h, L, H, D, qc,
                                c0 != nullptr, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, h: (B, L, H, D) of one dtype (0 = float32, 1 = bfloat16);
// logi, logf: (B, L, H) f32; c0 (B, H, D, D), n0 (B, H, D), m0 (B, H) f32,
// all three null for the zero state; c_fin, n_fin, m_fin likewise, written;
// the scratch as listed above, N = B * H * ceil(L / qc) (cin null for
// float32).  All contiguous.  1 <= qc <= min(L, 128); D <= 1024, a
// multiple of 4.
extern "C" int ml_mlstm(const void* q, const void* k, const void* v,
                        const void* logi, const void* logf, const void* c0,
                        const void* n0, const void* m0, void* h, void* c_fin,
                        void* n_fin, void* m_fin, void* gvec, void* gscal,
                        void* gcarry, void* nin, void* st, void* cin,
                        void* den, int B, int L, int H, int D, int qc,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool no_state = c0 == nullptr && n0 == nullptr && m0 == nullptr;
  const bool state = c0 != nullptr && n0 != nullptr && m0 != nullptr;
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D > DMAX || D % 4 != 0 ||
      qc <= 0 || qc > CMAX || qc > L || B > 65535 || H > 65535 ||
      (long long)B * H > 65535 || (L + qc - 1) / qc > 65535 ||
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
  float* gs = static_cast<float*>(gscal);
  float* gc = static_cast<float*>(gcarry);
  float* ni = static_cast<float*>(nin);
  float* df = static_cast<float*>(den);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), lif, lff, c0f, n0f, m0f,
                      static_cast<float*>(h), cf, nf, mf, gv, gs, gc, ni,
                      static_cast<float*>(st), df, B, L, H, D, qc, s);
  if (dtype == 1 && cin != nullptr)
    return launch_bf16(static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), lif, lff, c0f, n0f, m0f,
                       static_cast<bf16*>(h), cf, nf, mf, gv, gs, gc, ni,
                       static_cast<bf16*>(st), static_cast<bf16*>(cin), df,
                       B, L, H, D, qc, s);
  return (int)cudaErrorInvalidValue;
}
