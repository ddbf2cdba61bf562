// The backward of the stabilised chunkwise mLSTM, for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/mlstm/kernel.py::mlstm_scan has no
// backward: the JAX package trains through jax.grad of the jnp path
// (models/xlstm.py::mlstm_chunked).  This kernel is the gradient of the
// forward that csrc/mlstm.cu computes from the zero state, per (batch b,
// head h) over chunks of Q tokens (the last may be shorter), with the
// forward's names (mlstm.cu's header): cumf, m_comb_i, the decay d_ij =
// exp(cumf_i - cumf_j + logi_j - m_comb_i) (j <= i), s_ij = scale (q_i .
// k_j) d_ij, inter_i = exp(cumf_i + m - m_comb_i), the state (C, n, m)
// entering the chunk, wexp_j and carry.
//
// The stabiliser does not enter the gradient.  h_i = num_i / max(|den_i|,
// exp(-m_comb_i)) is the same function of the inputs whatever m_comb_i is
// (num, den and the floor all scale with exp(-m_comb_i)), and so are the
// next chunks' outputs of the state (C, n, m) (C and n scale with
// exp(-m)).  So every m is held constant here, as the published xLSTM
// kernels hold it, and the gradient is that of the function.
//
// The floor decides it, row by row.  Where |den_i| < exp(-m_comb_i) the
// floor binds, h_i = num_i exp(m_comb_i), and no gradient flows through
// den_i; elsewhere d den_i = -sign(den_i) (dh_i . num_i) / den_i^2.  With
// rinv_i = 1 / max(|den_i|, exp(-m_comb_i)), U_i = C^T dh_i and VD_ij =
// dh_i . v_j:
//   dh_i . num_i = sum_j s_ij VD_ij + scale inter_i (q_i . U_i)
//   ds_ij  = VD_ij rinv_i + dden_i           (j <= i),  G_ij = s_ij ds_ij
//   dq_i   = scale sum_j d_ij ds_ij k_j + scale inter_i (rinv_i U_i + dden_i n)
//   dk_j   = scale sum_i d_ij ds_ij q_i + wexp_j (dC^T v_j + dn)
//   dv_j   = sum_i s_ij rinv_i dh_i + wexp_j dC k_j
// with (dC, dn) the gradient of the state leaving the chunk, walked from
// the last chunk (0: training never reads the final state) back:
//   dC_in  = carry dC + scale sum_i inter_i rinv_i dh_i q_i^T
//   dn_in  = carry dn + scale sum_i inter_i dden_i q_i
// and the gates in log space: dlogi_j = sum_i G_ij + W_j, d cumf_i =
// sum_j G_ij - sum_j G_ji + scale inter_i (rinv_i q_i . U_i + dden_i q_i .
// n) - W_j, W_j = wexp_j (v_j . dC k_j + dn . k_j); d total = sum_j W_j +
// carry (<dC, C> + dn . n) joins the chunk's last row, and dlogf is the
// reverse prefix sum of d cumf over the chunk.
//
// Design.  The recurrences over the chunks are elementwise, so the
// chunk-parallel form of the forward's tensor-core route carries over:
// each chunk's own contribution is a product over all chunks at once, and
// a scan walks the chunks for each element.
//   1. mlb_gates (grid (H, B)): the gates' vectors and scalars, chunk by
//      chunk, as mlstm.cu's gate pass forms them.
//   2. One batched product (Gemm: operands of any strides with a unit one,
//      either orientation, f32 or bf16, a scale along k and an f32
//      addend): each chunk's own C (K^T (wexp o V)), Q K^T and dH V^T;
//      later U = dH C, the chunk's own dC, dC k_j and dC^T v_j, and last
//      dq, dk and dv.  The products nothing reads are skipped (their out
//      gets the addend, or 0): the last chunk's own C (no chunk follows
//      it), the first chunk's U and own dC (no state enters it), the last
//      chunk's dC k_j and dC^T v_j (no gradient leaves it).
//      bf16 route: mlb_gemm_tc (grid (N / 128, M / 128, B H chunks), 8
//      warps of 64 x 32) on the tensor cores, mma.sync m16n8k16 fed by
//      cp.async double-buffering; an f32 operand (C, dC, F, S rinv, the
//      k-scaled wexp o V and kvec o dH) enters as a bf16 hi + lo pair, as
//      mlstm.cu keeps C; bf16 inputs enter once.
//      f32 route: mlb_gemm (grid (N / 64, M / 64, B H chunks)) on the
//      CUDA cores, 64 x 64 tiles, a 4 x 4 register block a thread.
//   3. mlb_nvec: each chunk's own n and dn (sums of q_i or k_j rows).
//   4. mlb_scan: the C and n entering each chunk (forward), the dC and dn
//      leaving it (reverse), in place, and the partial sums of <dC, C> +
//      dn . n for d total.
//   5. mlb_rows (grid (chunks, H, B), a warp a row): den and its floor,
//      rinv, dden, G and the products' operands d ds and s rinv; then
//      mlb_wrows the state's part of dk and dv and W; mlb_gate_grads
//      dlogi and dlogf.
// Every sum runs in a fixed order (no atomics): a rerun is bit-equal.
//
// What bounds it on this card.  Operations: at xlstm-1.3b's training shape
// (rank batch 2 x 512 tokens, 4 heads of hd 1024, chunk 128) the hd^2 Q
// products a chunk (its own C, U, its own dC, dC k, dC^T v; fewer at the
// ends) and the Q^2 hd ones make ~35 GFLOP a layer (0.035 ms at the bf16
// tensor-core peak; the hi + lo operands double the products the tensor
// cores run) against ~0.6 GB of traffic through the f32 states C and dC
// of each chunk, which the scan reads and writes in place.
//
// Edges: chunk Q <= 128, hd <= 1024, the zero initial state (the wrapper
// refuses a gradient through an initial state or into the final one).
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the wrapper passes the scratch), does not
// synchronise, returns the first CUDA error of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int QMAX = 128;          // longest chunk
constexpr int DMAX = 1024;         // widest head
constexpr int TM = 64;             // product tile (m and n)
constexpr int TK = 16;             // its contraction slice
constexpr int TLD = TM + 4;        // row stride of a staged slice
constexpr int GT = 256;            // product threads: 16 x 16, 4 x 4 each
constexpr int ST = 256;            // scan and vector threads
constexpr int RT = 128;            // row-pass threads: 4 warps
constexpr float NEG = -1e30f;      // the stabiliser's "minus infinity"

__device__ __forceinline__ float ld_el(const void* p, int bf, long long i) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void st_el(void* p, int bf, long long i, float v) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// An operand of a batched product: element (z, r, c) of batch z = (b, h,
// chunk) at p[b sb + h sh + chunk sc + r rs + c cs], bf16 or f32; parts:
// the bf16 parts it enters the tensor-core product in (1: a bf16 input;
// NPART: f32).
struct Op {
  const void* p;
  int bf;
  long long rs, cs, sb, sh, sc;
  int parts;
};
// A scale along a product's k (stride 1), f32; p null = none.
struct Vec {
  const float* p;
  long long sb, sh, sc;
};
// out(m, n) = sum_k A(m, k) ks[k] B(k, n) + add(m, n).  An extent of -1
// is the chunk's own row count (Q, or the ragged last chunk's).  skip: a
// chunk whose product nothing reads (SKIP_FIRST: the first, SKIP_LAST: the
// last), where out gets add, or 0, alone.
enum { SKIP_NONE = 0, SKIP_FIRST = 1, SKIP_LAST = 2 };
struct Gemm {
  Op a, b, add, out;
  Vec ks;
  int M, N, K;
  int skip;
};
// The batch: B x H x nc chunks of Q rows over a sequence of L.
struct Batch {
  int H, nc, Q, L;
};

__device__ __forceinline__ long long base(long long sb, long long sh,
                                          long long sc, int b, int h, int c) {
  return (long long)b * sb + (long long)h * sh + (long long)c * sc;
}

__global__ void __launch_bounds__(GT)
mlb_gemm_kernel(Gemm g, Batch bt) {
  __shared__ float As[TK][TLD];    // [k][m]
  __shared__ float Bs[TK][TLD];    // [k][n]
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int z = blockIdx.z, c = z % bt.nc, h = (z / bt.nc) % bt.H,
            b = z / (bt.nc * bt.H);
  const int rows = min(bt.Q, bt.L - c * bt.Q);
  const int M = g.M < 0 ? rows : g.M, N = g.N < 0 ? rows : g.N;
  int K = g.K < 0 ? rows : g.K;
  if ((g.skip == SKIP_FIRST && c == 0) ||
      (g.skip == SKIP_LAST && c == bt.nc - 1))
    K = 0;                           // an unread product: out = add or 0
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TM;
  if (m0 >= M || n0 >= N) return;
  const long long ab = base(g.a.sb, g.a.sh, g.a.sc, b, h, c);
  const long long bbase = base(g.b.sb, g.b.sh, g.b.sc, b, h, c);
  const float* ks = g.ks.p ? g.ks.p + base(g.ks.sb, g.ks.sh, g.ks.sc, b, h, c)
                           : nullptr;
  // the slices' loads along the operand's unit stride (coalesced)
  const bool a_kfast = g.a.cs == 1, b_nfast = g.b.cs == 1;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int t = 0; t < TM * TK / GT; ++t) {
      const int idx = tid + t * GT;
      const int kk = a_kfast ? idx % TK : idx / TM;
      const int mm = a_kfast ? idx / TK : idx % TM;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        v = ld_el(g.a.p, g.a.bf, ab + m * g.a.rs + k * g.a.cs);
        if (ks) v *= ks[k];
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int t = 0; t < TM * TK / GT; ++t) {
      const int idx = tid + t * GT;
      const int kk = b_nfast ? idx / TM : idx % TK;
      const int nn = b_nfast ? idx % TM : idx / TK;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K)
                       ? ld_el(g.b.p, g.b.bf, bbase + k * g.b.rs + n * g.b.cs)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[kk][ti + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bs[kk][tj + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }
  const long long ob = base(g.out.sb, g.out.sh, g.out.sc, b, h, c);
  const long long db = g.add.p ? base(g.add.sb, g.add.sh, g.add.sc, b, h, c)
                               : 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ti + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tj + 16 * q;
      if (n >= N) continue;
      float v = acc[r][q];
      if (g.add.p) v += ld_el(g.add.p, 0, db + m * g.add.rs + n * g.add.cs);
      st_el(const_cast<void*>(g.out.p), g.out.bf,
            ob + m * g.out.rs + n * g.out.cs, v);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 route's product on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 sums; kernels/include/mma_bf16.cuh): the same Gemm, a
// BM x BN tile of out a block, 8 warps of 64 x 32.  Each BK-deep slice of
// A and B is copied raw (f32 or bf16, in the operand's own orientation) by
// cp.async into one of two stages while the slice before it runs, then
// converted into bf16 part planes in the same orientation: an operand of
// one part (a bf16 input) enters once, an f32 one (or one scaled along k)
// in hi + lo, so that its product keeps about 16 bits.  ldmatrix reads a
// plane in either orientation (.trans for [k][m] and [k][n]).
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int TG = 256;            // 8 warps: 2 (m) x 4 (n)
constexpr int NPART = 2;           // bf16 parts of an f32 operand
constexpr int RAW = BM * BK * 4;   // a raw slice's bytes (f32 at most)
constexpr int LDK = BK + tc::PAD;  // plane row stride, k-fast ([o][k])
constexpr int LDO = BM + tc::PAD;  // plane row stride, o-fast ([k][o])
constexpr int PLANE = BM * LDK > BK * LDO ? BM * LDK : BK * LDO;
static_assert(BM == BN, "one plane and raw size for A and B");
constexpr int TC_SMEM = 2 * 2 * RAW + 2 * NPART * PLANE * 2;

// Rows o0.. (BM of them, the operand's m or n) and k0.. (BK) of an operand
// X(o, k) = p[base + o so + k sk] into raw, by cp.async where 16 bytes are
// whole and aligned, else element by element (0 past O or K).  KF: k is
// the unit stride (raw [o][k]); else o is (raw [k][o]).
template <bool KF>
__device__ __forceinline__ void stage_raw(unsigned char* raw, const Op& x,
                                          long long base, long long so,
                                          long long sk, int o0, int O,
                                          int k0, int K, bool vec) {
  const int es = x.bf ? 2 : 4, per = 16 / es;        // elements a chunk
  constexpr int FAST = KF ? BK : BM, SLOW = KF ? BM : BK;
  const int chunks = SLOW * FAST / per;
  for (int i = threadIdx.x; i < chunks; i += TG) {
    const int sl = i / (FAST / per), f = (i % (FAST / per)) * per;
    const int o = KF ? o0 + sl : o0 + f, k = KF ? k0 + f : k0 + sl;
    const int fast_left = KF ? K - k : O - o;       // valid along the fast
    const bool slow_ok = KF ? o < O : k < K;
    unsigned char* dst = raw + (sl * FAST + f) * es;
    const long long off = base + (long long)o * so + (long long)k * sk;
    if (vec && slow_ok && fast_left >= per) {
      tc::cp_async16(dst, static_cast<const unsigned char*>(x.p) + off * es,
                     16);
      continue;
    }
    const long long step = KF ? sk : so;
    for (int e = 0; e < per; ++e) {
      const bool ok = slow_ok && e < fast_left;
      if (x.bf)
        reinterpret_cast<bf16*>(dst)[e] =
            ok ? static_cast<const bf16*>(x.p)[off + e * step]
               : __float2bfloat16(0.f);
      else
        reinterpret_cast<float*>(dst)[e] =
            ok ? static_cast<const float*>(x.p)[off + e * step] : 0.f;
    }
  }
}

// A raw slice into its parts' planes (PLANE apart), scaled along k by ks
// (k0 + its index; null: none).
template <bool KF>
__device__ __forceinline__ void to_planes(bf16* planes,
                                          const unsigned char* raw, int bf,
                                          int parts, const float* ks, int k0,
                                          int K) {
  constexpr int FAST = KF ? BK : BM, SLOW = KF ? BM : BK;
  constexpr int LD = KF ? LDK : LDO;
  for (int i = threadIdx.x; i < SLOW * FAST / 2; i += TG) {
    const int sl = i / (FAST / 2), f = (i % (FAST / 2)) * 2;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = sl * FAST + f + e;
      v[e] = bf ? __bfloat162float(reinterpret_cast<const bf16*>(raw)[idx])
                : reinterpret_cast<const float*>(raw)[idx];
      if (ks != nullptr) {
        const int k = k0 + (KF ? f + e : sl);
        v[e] *= k < K ? ks[k] : 0.f;
      }
    }
    const int off = sl * LD + f;
    *reinterpret_cast<uint32_t*>(planes + off) = tc::pack_bf16(v[0], v[1]);
    if (parts > 1)
      *reinterpret_cast<uint32_t*>(planes + PLANE + off) = tc::pack_bf16(
          v[0] - __bfloat162float(__float2bfloat16(v[0])),
          v[1] - __bfloat162float(__float2bfloat16(v[1])));
  }
}

// Whether an operand's slices can go by 16-byte cp.async: its pointer and
// every offset a multiple of 16 bytes.
__host__ __device__ inline bool vec16(const Op& x, long long so) {
  const long long per = x.bf ? 8 : 4;
  return (reinterpret_cast<uintptr_t>(x.p) % 16) == 0 && so % per == 0 &&
         x.sb % per == 0 && x.sh % per == 0 && x.sc % per == 0;
}

// AK: A's unit stride is k (else m); BKF: B's is k (else n).
template <bool AK, bool BKF>
__global__ void __launch_bounds__(TG)
mlb_gemm_tc_kernel(Gemm g, Batch bt) {
  extern __shared__ __align__(16) unsigned char gsm[];
  unsigned char* rawA = gsm;                       // 2 stages
  unsigned char* rawB = rawA + 2 * RAW;            // 2 stages
  bf16* pa = reinterpret_cast<bf16*>(rawB + 2 * RAW);   // NPART planes
  bf16* pb = pa + NPART * PLANE;                        // NPART planes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int z = blockIdx.z, c = z % bt.nc, h = (z / bt.nc) % bt.H,
            b = z / (bt.nc * bt.H);
  const int rows = min(bt.Q, bt.L - c * bt.Q);
  const int M = g.M < 0 ? rows : g.M, N = g.N < 0 ? rows : g.N;
  int K = g.K < 0 ? rows : g.K;
  if ((g.skip == SKIP_FIRST && c == 0) ||
      (g.skip == SKIP_LAST && c == bt.nc - 1))
    K = 0;                           // an unread product: out = add or 0
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= M || n0 >= N) return;
  const long long ab = base(g.a.sb, g.a.sh, g.a.sc, b, h, c);
  const long long bb = base(g.b.sb, g.b.sh, g.b.sc, b, h, c);
  const float* ks = g.ks.p ? g.ks.p + base(g.ks.sb, g.ks.sh, g.ks.sc, b, h, c)
                           : nullptr;
  const int na = ks != nullptr ? NPART : g.a.parts, nb = g.b.parts;
  // A(m, k): so = rs, sk = cs; B(k, n) as X(o = n, k): so = cs, sk = rs
  const bool va = vec16(g.a, AK ? g.a.rs : g.a.cs);
  const bool vb = vec16(g.b, BKF ? g.b.cs : g.b.rs);
  auto issue = [&](int k0, int st) {
    stage_raw<AK>(rawA + st * RAW, g.a, ab, g.a.rs, g.a.cs, m0, M, k0, K,
                  va);
    stage_raw<BKF>(rawB + st * RAW, g.b, bb, g.b.cs, g.b.rs, n0, N, k0, K,
                   vb);
  };
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  const int nk = (K + BK - 1) / BK;
  if (nk > 0) issue(0, 0);
  tc::cp_async_commit();
  for (int ki = 0; ki < nk; ++ki) {
    if (ki + 1 < nk) issue((ki + 1) * BK, (ki + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();               // slice ki landed; the planes are free
    to_planes<AK>(pa, rawA + (ki & 1) * RAW, g.a.bf, na, ks, ki * BK, K);
    to_planes<BKF>(pb, rawB + (ki & 1) * RAW, g.b.bf, nb, nullptr, 0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[NPART][4][4];
#pragma unroll
      for (int p = 0; p < NPART; ++p) {
        if (p >= na) break;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const bf16* src = pa + p * PLANE;
          if (AK)
            tc::ldmatrix_x4(af[p][mt], src + tc::a_off<LDK>(
                                           lane, wm + 16 * mt, kk));
          else
            tc::ldmatrix_x4_trans(af[p][mt], src + tc::b_off<LDO>(
                                                 lane, kk, wm + 16 * mt));
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np)
#pragma unroll
        for (int q = 0; q < NPART; ++q) {
          if (q >= nb) break;
          uint32_t b4[4];
          const bf16* src = pb + q * PLANE;
          if (BKF)
            tc::ldmatrix_x4(b4, src + tc::b_off<LDK>(lane, wn + 16 * np, kk));
          else
            tc::ldmatrix_x4_trans(b4, src + tc::a_off<LDO>(
                                          lane, kk, wn + 16 * np));
#pragma unroll
          for (int p = 0; p < NPART; ++p) {
            if (p >= na || p + q >= NPART) break;  // hi hi, hi lo, lo hi
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              tc::mma_bf16(acc[mt][2 * np], af[p][mt], b4[0], b4[1]);
              tc::mma_bf16(acc[mt][2 * np + 1], af[p][mt], b4[2], b4[3]);
            }
          }
        }
    }
  }
  tc::cp_async_wait<0>();
  const long long ob = base(g.out.sb, g.out.sh, g.out.sc, b, h, c);
  const long long db = g.add.p ? base(g.add.sb, g.add.sh, g.add.sc, b, h, c)
                               : 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + wm + 16 * mt + gq + (r >> 1) * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + 8 * nt + 2 * t4 + (r & 1);
        if (n >= N) continue;
        float v = acc[mt][nt][r];
        if (g.add.p) v += ld_el(g.add.p, 0, db + m * g.add.rs + n * g.add.cs);
        st_el(const_cast<void*>(g.out.p), g.out.bf,
              ob + m * g.out.rs + n * g.out.cs, v);
      }
    }
}

// The gates, per (b, h), chunk by chunk (m carried): the vectors cumf,
// m_comb, inter, wexp (B, H, L) and each chunk's carry (B, H, nc).
__global__ void __launch_bounds__(QMAX)
mlb_gates_kernel(const float* __restrict__ logi,
                 const float* __restrict__ logf, float* __restrict__ cumf,
                 float* __restrict__ mcomb, float* __restrict__ inter,
                 float* __restrict__ wexp, float* __restrict__ carry, int L,
                 int H, int Q) {
  __shared__ float cf[QMAX], li[QMAX], wv[QMAX];
  __shared__ float m_in_s, total_s;
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int nc = (L + Q - 1) / Q;
  const size_t vb = ((size_t)b * H + h) * L;
  if (tid == 0) m_in_s = NEG;
  for (int c = 0; c < nc; ++c) {
    const int l0 = c * Q, rows = min(Q, L - l0);
    if (tid < rows) {
      const size_t g = ((size_t)b * L + l0 + tid) * H + h;
      li[tid] = logi[g];
      cf[tid] = logf[g];
    }
    __syncthreads();
    if (tid == 0) {                // cumf in order
      float run = 0.f;
      for (int i = 0; i < rows; ++i) {
        run += cf[i];
        cf[i] = run;
      }
      total_s = run;
    }
    __syncthreads();
    const float m_in = m_in_s, total = total_s;
    if (tid < rows) {
      const int i = tid;
      float mi = NEG;
      for (int j = 0; j <= i; ++j) mi = fmaxf(mi, cf[i] - cf[j] + li[j]);
      const float bi = cf[i] + m_in;
      const float mc = fmaxf(mi, bi);
      cumf[vb + l0 + i] = cf[i];
      mcomb[vb + l0 + i] = mc;
      inter[vb + l0 + i] = expf(bi - mc);
      wv[i] = total - cf[i] + li[i];
    }
    __syncthreads();
    if (tid == 0) {
      float mw = NEG;
      for (int j = 0; j < rows; ++j) mw = fmaxf(mw, wv[j]);
      const float m_out = fmaxf(m_in + total, mw);
      carry[((size_t)b * H + h) * nc + c] = expf(m_in + total - m_out);
      total_s = m_out;             // m_out, read below
    }
    __syncthreads();
    if (tid < rows) wexp[vb + l0 + tid] = expf(wv[tid] - total_s);
    __syncthreads();
    if (tid == 0) m_in_s = total_s;
    __syncthreads();
  }
}

// out[z][e] = sum_{i < rows} coef[z][i] X(z, i, e): a chunk's own n (coef
// wexp, X = k) or dn (coef scale inter dden, X = q).
__global__ void __launch_bounds__(ST)
mlb_nvec_kernel(Op x, const float* __restrict__ coef, float* __restrict__ out,
                Batch bt, int D) {
  const int e = blockIdx.x * ST + threadIdx.x, z = blockIdx.y;
  const int c = z % bt.nc, h = (z / bt.nc) % bt.H, b = z / (bt.nc * bt.H);
  if (e >= D) return;
  const int rows = min(bt.Q, bt.L - c * bt.Q);
  const long long xb = base(x.sb, x.sh, x.sc, b, h, c);
  const float* cf = coef + ((long long)b * bt.H + h) * bt.L + c * bt.Q;
  float s = 0.f;
  for (int i = 0; i < rows; ++i)
    s = fmaf(cf[i], ld_el(x.p, x.bf, xb + i * x.rs + e * x.cs), s);
  out[(long long)z * D + e] = s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The walk over the chunks of each element of (C, n) (M1 + M2 elements a
// chunk: buffers x1 (B, H, nc, M1) and x2 (B, H, nc, M2)), in place.
// Forward: x[c] = the state entering chunk c from x[c] = the chunk's own
// part.  Reverse: x[c] = the gradient of the state leaving chunk c, from
// x[c] = the gradient chunk c's own outputs send into the state entering
// it; and part[(b, h), c, block] = the block's sum of x[c] y[c] (y: the
// states entering the chunks), for d total: each warp's by shuffles, then
// the warps' in order.  The chunks go in groups of SG: the group's carry
// factors into shared memory and each thread's loads issued together.
constexpr int SG = 8;
template <bool REVERSE>
__global__ void __launch_bounds__(ST)
mlb_scan_kernel(float* __restrict__ x1, float* __restrict__ x2,
                const float* __restrict__ y1, const float* __restrict__ y2,
                const float* __restrict__ carry, float* __restrict__ part,
                int nc, long long M1, long long M2) {
  __shared__ float cg[SG], red[SG][ST / 32];
  const long long e = (long long)blockIdx.x * ST + threadIdx.x;
  const int bh = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in1 = e < M1, ok = e < M1 + M2;
  float* x = in1 ? x1 + (long long)bh * nc * M1 + e
                 : x2 + (long long)bh * nc * M2 + (e - M1);
  const float* y = nullptr;
  if (REVERSE)
    y = in1 ? y1 + (long long)bh * nc * M1 + e
            : y2 + (long long)bh * nc * M2 + (e - M1);
  const long long stride = in1 ? M1 : M2;
  const float* cr = carry + (long long)bh * nc;
  auto chunk = [&](int t) { return REVERSE ? nc - 1 - t : t; };
  float prev = 0.f;
  for (int t0 = 0; t0 < nc; t0 += SG) {
    const int n = min(SG, nc - t0);
    __syncthreads();               // the group before's cg and red read
    if (threadIdx.x < n) cg[threadIdx.x] = cr[chunk(t0 + threadIdx.x)];
    float own[SG], yv[SG];
#pragma unroll
    for (int k = 0; k < SG; ++k)
      if (ok && k < n) {
        own[k] = x[chunk(t0 + k) * stride];
        if (REVERSE) yv[k] = y[chunk(t0 + k) * stride];
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      float mine = 0.f;
      if (ok && k < n) {
        x[chunk(t0 + k) * stride] = prev;
        if (REVERSE) mine = prev * yv[k];
        prev = cg[k] * prev + own[k];
      }
      if (REVERSE && k < n) {
        mine = warp_sum(mine);
        if (lane == 0) red[k][warp] = mine;
      }
    }
    if (REVERSE) {
      __syncthreads();
      if (threadIdx.x < n) {
        float sum = 0.f;
        for (int w = 0; w < ST / 32; ++w) sum += red[threadIdx.x][w];
        part[((long long)bh * nc + chunk(t0 + threadIdx.x)) * gridDim.x +
             blockIdx.x] = sum;
      }
    }
  }
}

// The row pass of RPB rows of one chunk (grid (chunks x row groups, H,
// B)), a warp a row i: den and the floor's branch, rinv and dden; then G,
// d ds (into vd, the products' F) and s rinv (into s, Sr); U_i becomes
// scale inter_i (rinv_i U_i + dden_i n) (dq's inter-chunk part); rowG,
// interG, scale inter rinv and scale inter dden per row.  mlb_colg then
// sums G's columns.
constexpr int RPB = 8;             // rows a block of the row passes
__global__ void __launch_bounds__(RT)
mlb_rows_kernel(Op qop, float* __restrict__ s, float* __restrict__ vd,
                float* __restrict__ gm, float* __restrict__ u,
                const float* __restrict__ nst, const float* __restrict__ cumf,
                const float* __restrict__ mcomb,
                const float* __restrict__ inter, const float* __restrict__ logi,
                float* __restrict__ rowg, float* __restrict__ colg,
                float* __restrict__ interg, float* __restrict__ kvec,
                float* __restrict__ dncoef, float* __restrict__ binds,
                Batch bt, int D, float scale) {
  const int ng = (bt.Q + RPB - 1) / RPB;
  const int c = blockIdx.x / ng, i0 = (blockIdx.x % ng) * RPB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Q = bt.Q, rows = min(Q, bt.L - c * Q);
  const long long z = ((long long)b * bt.H + h) * bt.nc + c;
  const long long vb = ((long long)b * bt.H + h) * bt.L + (long long)c * Q;
  const long long qb = base(qop.sb, qop.sh, qop.sc, b, h, c);
  float* sz = s + z * Q * Q;
  float* vz = vd + z * Q * Q;
  float* gz = gm + z * Q * Q;
  float* uz = u + z * Q * D;
  const float* nz = nst + z * D;
  // logi of the chunk's rows, indexed as the gates are ((B, L, H) input)
  for (int i = i0 + warp; i < min(Q, i0 + RPB); i += RT / 32) {
    if (i >= rows) {               // the ragged chunk's missing rows: 0
      for (int j = lane; j < Q; j += 32) sz[i * Q + j] = vz[i * Q + j] =
          gz[i * Q + j] = 0.f;
      continue;
    }
    float qu = 0.f, nq = 0.f;
    for (int e = lane; e < D; e += 32) {
      const float qe = ld_el(qop.p, qop.bf, qb + i * qop.rs + e * qop.cs);
      qu = fmaf(qe, uz[(long long)i * D + e], qu);
      nq = fmaf(qe, nz[e], nq);
    }
    qu = warp_sum(qu);
    nq = warp_sum(nq);
    const float ci = cumf[vb + i], mi = mcomb[vb + i], it = inter[vb + i];
    float den = 0.f, ndh = 0.f;
    for (int j = lane; j <= i; j += 32) {
      const float lj = logi[(((long long)b * bt.L + c * Q + j) * bt.H) + h];
      const float d = expf(ci - cumf[vb + j] + lj - mi);
      const float sij = sz[i * Q + j] * scale * d;
      den += sij;
      ndh = fmaf(sij, vz[i * Q + j], ndh);
    }
    den = warp_sum(den) + it * scale * nq;
    ndh = warp_sum(ndh) + it * scale * qu;
    const float floor_ = expf(-mi);
    const bool bind = fabsf(den) < floor_;
    const float rinv = 1.f / fmaxf(fabsf(den), floor_);
    const float sgn = den > 0.f ? 1.f : (den < 0.f ? -1.f : 0.f);
    const float dden = bind ? 0.f : -sgn * ndh * rinv * rinv;
    float rg = 0.f;
    for (int j = lane; j < Q; j += 32) {
      float f = 0.f, sr = 0.f, gv = 0.f;
      if (j <= i) {
        const float lj = logi[(((long long)b * bt.L + c * Q + j) * bt.H) + h];
        const float d = expf(ci - cumf[vb + j] + lj - mi);
        const float sij = sz[i * Q + j] * scale * d;
        const float ds = vz[i * Q + j] * rinv + dden;
        gv = sij * ds;
        f = scale * d * ds;
        sr = sij * rinv;
      }
      rg += gv;
      gz[i * Q + j] = gv;
      vz[i * Q + j] = f;
      sz[i * Q + j] = sr;
    }
    rg = warp_sum(rg);
    for (int e = lane; e < D; e += 32) {
      float* ue = uz + (long long)i * D + e;
      *ue = scale * it * (*ue * rinv + nz[e] * dden);
    }
    if (lane == 0) {
      rowg[vb + i] = rg;
      interg[vb + i] = it * scale * (rinv * qu + dden * nq);
      kvec[vb + i] = scale * it * rinv;
      dncoef[vb + i] = scale * it * dden;
      binds[vb + i] = bind ? 1.f : 0.f;
    }
  }
}

// The column sums of G over a chunk's rows, in order (grid (chunks, H, B)).
__global__ void __launch_bounds__(RT)
mlb_colg_kernel(const float* __restrict__ gm, float* __restrict__ colg,
                Batch bt) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = bt.Q, rows = min(Q, bt.L - c * Q);
  const long long z = ((long long)b * bt.H + h) * bt.nc + c;
  const long long vb = ((long long)b * bt.H + h) * bt.L + (long long)c * Q;
  const float* gz = gm + z * Q * Q;
  for (int j = threadIdx.x; j < rows; j += RT) {
    float cg = 0.f;
    for (int i = j; i < rows; ++i) cg += gz[i * Q + j];
    colg[vb + j] = cg;
  }
}

// The state's part of dk and dv, RPB rows of a chunk a block (grid
// (chunks x row groups, H, B)), a warp a row j: W_j = wexp_j (v_j . tv_j
// + dn . k_j); tv_j *= wexp_j (dv's part); tk_j = wexp_j (tk_j + dn)
// (dk's part).
__global__ void __launch_bounds__(RT)
mlb_wrows_kernel(Op kop, Op vop, float* __restrict__ tv,
                 float* __restrict__ tk, const float* __restrict__ dnst,
                 const float* __restrict__ wexp, float* __restrict__ wterm,
                 Batch bt, int D) {
  const int ng = (bt.Q + RPB - 1) / RPB;
  const int c = blockIdx.x / ng, j0 = (blockIdx.x % ng) * RPB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Q = bt.Q, rows = min(Q, bt.L - c * Q);
  const long long z = ((long long)b * bt.H + h) * bt.nc + c;
  const long long vb = ((long long)b * bt.H + h) * bt.L + (long long)c * Q;
  const long long kb = base(kop.sb, kop.sh, kop.sc, b, h, c);
  const long long vvb = base(vop.sb, vop.sh, vop.sc, b, h, c);
  const float* dn = dnst + z * D;
  for (int j = j0 + warp; j < min(rows, j0 + RPB); j += RT / 32) {
    float* tvj = tv + (z * Q + j) * D;
    float* tkj = tk + (z * Q + j) * D;
    const float we = wexp[vb + j];
    float acc = 0.f;
    for (int e = lane; e < D; e += 32) {
      const float ke = ld_el(kop.p, kop.bf, kb + j * kop.rs + e * kop.cs);
      const float ve = ld_el(vop.p, vop.bf, vvb + j * vop.rs + e * vop.cs);
      acc = fmaf(ve, tvj[e], acc);
      acc = fmaf(dn[e], ke, acc);
      tvj[e] *= we;
      tkj[e] = we * (tkj[e] + dn[e]);
    }
    acc = warp_sum(acc);
    if (lane == 0) wterm[vb + j] = we * acc;
  }
}

// dlogi and dlogf per (b, h), one warp: per chunk d total (the lanes'
// strided sums in order, then a shuffle tree), d cumf, and its reverse
// prefix sum over the chunk: lane l holds R rows counted back from the
// chunk's end, l R .. l R + R - 1; a scan over the lanes in a fixed order.
__global__ void __launch_bounds__(32)
mlb_gate_grads_kernel(
    const float* __restrict__ rowg, const float* __restrict__ colg,
    const float* __restrict__ interg, const float* __restrict__ wterm,
    const float* __restrict__ carry, const float* __restrict__ part,
    float* __restrict__ dlogi, float* __restrict__ dlogf, int L, int H,
    int Q, int nc, int nblk) {
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const size_t vb = ((size_t)b * H + h) * L;
  for (int c = 0; c < nc; ++c) {
    const int l0 = c * Q, rows = min(Q, L - l0);
    const float* pc = part + (((size_t)b * H + h) * nc + c) * nblk;
    float cd = 0.f, ws = 0.f;
    for (int k = lane; k < nblk; k += 32) cd += pc[k];
    for (int j = lane; j < rows; j += 32) ws += wterm[vb + l0 + j];
    const float dtotal =
        carry[((size_t)b * H + h) * nc + c] * warp_sum(cd) + warp_sum(ws);
    const int R = (rows + 31) / 32;
    float dcs[QMAX / 32], local = 0.f;
#pragma unroll
    for (int r = 0; r < QMAX / 32; ++r) {
      const int i = rows - 1 - (lane * R + r);
      dcs[r] = 0.f;
      if (r < R && i >= 0) {
        const size_t v = vb + l0 + i;
        dcs[r] = rowg[v] - colg[v] + interg[v] - wterm[v];
        if (i == rows - 1) dcs[r] += dtotal;
      }
      local += dcs[r];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {   // inclusive scan over the lanes
      const float t = __shfl_up_sync(0xffffffffu, local, o);
      if (lane >= o) local += t;
    }
    float run = __shfl_up_sync(0xffffffffu, local, 1);
    if (lane == 0) run = 0.f;
#pragma unroll
    for (int r = 0; r < QMAX / 32; ++r) {
      const int i = rows - 1 - (lane * R + r);
      if (r < R && i >= 0) {
        run += dcs[r];
        const size_t v = vb + l0 + i;
        const size_t g = ((size_t)b * L + l0 + i) * H + h;
        dlogf[g] = run;
        dlogi[g] = colg[v] + wterm[v];
      }
    }
  }
}

struct Scratch {
  float *cumf, *mcomb, *inter, *wexp, *rowg, *colg, *interg, *kvec, *dncoef,
      *wterm, *binds, *carry, *s, *vd, *gm, *cst, *dcst, *nst, *dnst, *u, *tv,
      *tk, *part;
};

long long scan_blocks(int D) {
  return ((long long)D * D + D + ST - 1) / ST;
}

// The scratch's layout from p; returns its floats.
long long layout(float* p, int B, int L, int H, int D, int Q, Scratch* s) {
  const long long nc = (L + Q - 1) / Q, bh = (long long)B * H;
  const long long v = bh * L, qq = bh * nc * Q * Q, dd = bh * nc * D * D,
                  nd = bh * nc * D, qd = bh * nc * Q * D;
  const long long sizes[] = {v, v, v, v, v, v, v, v, v, v, v, bh * nc,
                             qq, qq, qq, dd, dd, nd, nd, qd, qd, qd,
                             bh * nc * scan_blocks(D)};
  float** slots[] = {&s->cumf, &s->mcomb, &s->inter, &s->wexp, &s->rowg,
                     &s->colg, &s->interg, &s->kvec, &s->dncoef, &s->wterm,
                     &s->binds, &s->carry, &s->s, &s->vd, &s->gm, &s->cst,
                     &s->dcst, &s->nst, &s->dnst, &s->u, &s->tv, &s->tk,
                     &s->part};
  long long off = 0;
  for (int i = 0; i < (int)(sizeof(sizes) / sizeof(sizes[0])); ++i) {
    *slots[i] = p + off;
    off += sizes[i];
  }
  return off;
}

// One batched product: the f32 route's kernel on the CUDA cores, or (bf16)
// the tensor-core one for the operands' orientations.
int gemm(const Gemm& g, const Batch& bt, int B, int mmax, int nmax, int bf,
         cudaStream_t stream) {
  if (!bf) {
    const dim3 grid((nmax + TM - 1) / TM, (mmax + TM - 1) / TM,
                    B * bt.H * bt.nc);
    mlb_gemm_kernel<<<grid, GT, 0, stream>>>(g, bt);
    return (int)cudaGetLastError();
  }
  const bool ak = g.a.cs == 1, bk = g.b.rs == 1;
  if (!(ak || g.a.rs == 1) || !(bk || g.b.cs == 1))
    return (int)cudaErrorInvalidValue;     // no unit stride to copy along
  void (*kern)(Gemm, Batch) =
      ak ? (bk ? mlb_gemm_tc_kernel<true, true>
               : mlb_gemm_tc_kernel<true, false>)
         : (bk ? mlb_gemm_tc_kernel<false, true>
               : mlb_gemm_tc_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nmax + BN - 1) / BN, (mmax + BM - 1) / BM,
                  B * bt.H * bt.nc);
  kern<<<grid, TG, TC_SMEM, stream>>>(g, bt);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dh, dq, dk, dv: (B, L, H, D); logi, logf, dlogi, dlogf: (B, L,
// H) f32; binds: (B, H, L) f32, 1 where the row's floor binds, or null;
// scratch: f32, of the floats ml_bwd_scratch_floats gives; all
// contiguous.  q, k, v, dh and the gradients of q, k, v share one dtype
// (0 = float32, 1 = bfloat16).  Q = the chunk, 1 <= Q <= 128 (the last
// chunk may be shorter); D <= 1024.  From the zero state.
extern "C" int ml_bwd_scratch_floats(int B, int L, int H, int D, int Q,
                                     long long* floats) {
  Scratch s;
  *floats = layout(nullptr, B, L, H, D, Q, &s);
  return 0;
}

extern "C" int ml_mlstm_bwd(const void* q, const void* k, const void* v,
                            const void* logi, const void* logf,
                            const void* dh, void* dq, void* dk, void* dv,
                            void* dlogi, void* dlogf, void* binds_out,
                            void* scratch, int B, int L, int H, int D, int Q,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || D > DMAX || Q <= 0 ||
      Q > QMAX || (dtype != 0 && dtype != 1) || scratch == nullptr ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int nc = (L + Q - 1) / Q, bf = dtype;
  const Batch bt{H, nc, Q, L};
  Scratch s;
  layout(static_cast<float*>(scratch), B, L, H, D, Q, &s);
  if (binds_out != nullptr) s.binds = static_cast<float*>(binds_out);
  const float scale = 1.f / sqrtf((float)D);
  const long long HD = (long long)H * D, LHD = (long long)L * HD;
  const long long QHD = (long long)Q * HD;
  // the (B, L, H, D) inputs a chunk at a time: rows i, columns d (seq) or
  // rows d, columns i (seqT)
  auto seq = [&](const void* p) {
    return Op{p, bf, HD, 1, LHD, D, QHD, bf ? 1 : NPART};
  };
  auto seqT = [&](const void* p) {
    return Op{p, bf, 1, HD, LHD, D, QHD, bf ? 1 : NPART};
  };
  const long long qqs = (long long)Q * Q, dds = (long long)D * D,
                  qds = (long long)Q * D;
  auto qq = [&](float* p) {
    return Op{p, 0, Q, 1, H * nc * qqs, nc * qqs, qqs, NPART};
  };
  auto qqT = [&](float* p) {
    return Op{p, 0, 1, Q, H * nc * qqs, nc * qqs, qqs, NPART};
  };
  auto dd = [&](float* p) {
    return Op{p, 0, D, 1, H * nc * dds, nc * dds, dds, NPART};
  };
  auto ddT = [&](float* p) {
    return Op{p, 0, 1, D, H * nc * dds, nc * dds, dds, NPART};
  };
  auto qd = [&](float* p) {
    return Op{p, 0, D, 1, H * nc * qds, nc * qds, qds, NPART};
  };
  auto vec = [&](const float* p) {
    return Vec{p, (long long)H * L, L, Q};
  };
  const Op none{nullptr, 0, 0, 0, 0, 0, 0, 1};
  const Vec nov{nullptr, 0, 0, 0};
  const int R = -1;                // the chunk's own rows
  const int qm = min(Q, L);
  int err;
#define MLB_CHECK(x)                                   \
  if ((err = (x)) != 0) return err;                    \
  if ((err = (int)cudaGetLastError()) != 0) return err;

  mlb_gates_kernel<<<dim3(H, B), QMAX, 0, st>>>(
      static_cast<const float*>(logi), static_cast<const float*>(logf),
      s.cumf, s.mcomb, s.inter, s.wexp, s.carry, L, H, Q);
  MLB_CHECK(0);
  // each chunk's own C = sum_j wexp_j v_j k_j^T and n = sum_j wexp_j k_j,
  // then the states entering the chunks
  // (the last chunk's own C: no chunk follows it)
  MLB_CHECK(gemm(Gemm{seqT(v), seq(k), none, dd(s.cst), vec(s.wexp), D,
                      D, R, SKIP_LAST}, bt, B, D, D, bf, st));
  mlb_nvec_kernel<<<dim3((D + ST - 1) / ST, B * H * nc), ST, 0, st>>>(
      seq(k), s.wexp, s.nst, bt, D);
  MLB_CHECK(0);
  const long long nblk = scan_blocks(D);
  mlb_scan_kernel<false><<<dim3((unsigned)nblk, B * H), ST, 0, st>>>(
      s.cst, s.nst, nullptr, nullptr, s.carry, nullptr, nc, dds, D);
  MLB_CHECK(0);
  // Q K^T, dH V^T and U = dH C
  // (no state enters the first chunk: its U is 0)
  MLB_CHECK(gemm(Gemm{seq(q), seqT(k), none, qq(s.s), nov, R, R, D}, bt,
                 B, qm, qm, bf, st));
  MLB_CHECK(gemm(Gemm{seq(dh), seqT(v), none, qq(s.vd), nov, R, R, D},
                 bt, B, qm, qm, bf, st));
  MLB_CHECK(gemm(Gemm{seq(dh), dd(s.cst), none, qd(s.u), nov, R, D, D,
                      SKIP_FIRST}, bt, B, qm, D, bf, st));
  const int ng = (Q + RPB - 1) / RPB;     // row groups a chunk
  mlb_rows_kernel<<<dim3(nc * ng, H, B), RT, 0, st>>>(
      seq(q), s.s, s.vd, s.gm, s.u, s.nst, s.cumf, s.mcomb, s.inter,
      static_cast<const float*>(logi), s.rowg, s.colg, s.interg, s.kvec,
      s.dncoef, s.binds, bt, D, scale);
  MLB_CHECK(0);
  mlb_colg_kernel<<<dim3(nc, H, B), RT, 0, st>>>(s.gm, s.colg, bt);
  MLB_CHECK(0);
  // each chunk's own dC = sum_i kvec_i dh_i q_i^T and dn = sum_i dncoef_i
  // q_i, then the gradients of the states leaving the chunks
  // (the first chunk's own dC: no state enters it)
  MLB_CHECK(gemm(Gemm{seqT(dh), seq(q), none, dd(s.dcst), vec(s.kvec),
                      D, D, R, SKIP_FIRST}, bt, B, D, D, bf, st));
  mlb_nvec_kernel<<<dim3((D + ST - 1) / ST, B * H * nc), ST, 0, st>>>(
      seq(q), s.dncoef, s.dnst, bt, D);
  MLB_CHECK(0);
  mlb_scan_kernel<true><<<dim3((unsigned)nblk, B * H), ST, 0, st>>>(
      s.dcst, s.dnst, s.cst, s.nst, s.carry, s.part, nc, dds, D);
  MLB_CHECK(0);
  // dC k_j and dC^T v_j, the state's parts of dv and dk (0 in the last
  // chunk: no gradient leaves it)
  MLB_CHECK(gemm(Gemm{seq(k), ddT(s.dcst), none, qd(s.tv), nov, R, D,
                      D, SKIP_LAST}, bt, B, qm, D, bf, st));
  MLB_CHECK(gemm(Gemm{seq(v), dd(s.dcst), none, qd(s.tk), nov, R, D,
                      D, SKIP_LAST}, bt, B, qm, D, bf, st));
  mlb_wrows_kernel<<<dim3(nc * ng, H, B), RT, 0, st>>>(
      seq(k), seq(v), s.tv, s.tk, s.dnst, s.wexp, s.wterm, bt, D);
  MLB_CHECK(0);
  // dq = F K + U', dk = F^T Q + tk, dv = Sr^T dH + tv
  MLB_CHECK(gemm(Gemm{qq(s.vd), seq(k), qd(s.u), seq(dq), nov, R, D,
                      R}, bt, B, qm, D, bf, st));
  MLB_CHECK(gemm(Gemm{qqT(s.vd), seq(q), qd(s.tk), seq(dk), nov, R, D,
                      R}, bt, B, qm, D, bf, st));
  MLB_CHECK(gemm(Gemm{qqT(s.s), seq(dh), qd(s.tv), seq(dv), nov, R, D,
                      R}, bt, B, qm, D, bf, st));
  mlb_gate_grads_kernel<<<dim3(H, B), 32, 0, st>>>(
      s.rowg, s.colg, s.interg, s.wterm, s.carry, s.part,
      static_cast<float*>(dlogi), static_cast<float*>(dlogf), L, H, Q, nc,
      (int)nblk);
  MLB_CHECK(0);
#undef MLB_CHECK
  return 0;
}
