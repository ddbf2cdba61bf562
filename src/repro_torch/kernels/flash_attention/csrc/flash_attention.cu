// Causal / windowed GQA FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_fa_kernel
// (reached through ops.flash_attention from models/attention.py in every
// prefill).  It computes the same function: softmax(q k^T * scale) v per
// (batch, head), with the query head h reading kv head h / (H / KV), a causal
// mask and an optional sliding window (qpos - kpos < window), and an online
// softmax whose running max, denominator and accumulator stay in f32.
//
// What bounds it on this card.  At long S the work is 4*B*H*pairs*hd FLOPs
// (two products over the causal triangle); with bf16 on the tensor cores
// that is the bound (989 TFLOP/s).  At short S it is the bytes of Q, K, V
// and O (3.35 TB/s).  The logits never need to reach device memory.
//
// Both paths keep the S x S logits out of device memory entirely: one
// thread block owns a 64-row query tile of one (batch, head) and loops over
// 64-key K/V tiles from the window's left edge up to the causal bound only,
// so each K/V byte is read once per query tile and the masked half of the
// triangle is never computed.  Masks are applied elementwise only on tiles
// that cross the diagonal, the window edge or a ragged end of S (S need not
// be a multiple of the tile).  Blocks run in parallel across (query tile,
// head, batch); nothing carries between them.
//
// bf16 (fa_fwd_tc_kernel): FlashAttention-2 on the tensor cores, mma.sync
// m16n8k16 with bf16 operands and f32 sums (mma_bf16.cuh).  Q, K and V stay
// bf16 in shared memory, rows padded for conflict-free ldmatrix; K/V tiles
// come through a double-buffered cp.async ring, so tile t + 1 is in flight
// while tile t is used.  Each of the 4 warps owns 16 query rows: its Q
// fragments live in registers for the whole loop, the 16 x 64 logits tile
// S = Q K^T stays in registers, and the online softmax runs on it there
// (row max and sum over the four threads of a quad by shuffles, in exp2
// with log2(e) folded into the scale; the sum stays per thread until the
// end).  P is rounded to bf16 in registers into the A fragments of P V,
// as SDPA's kernels do, so it never touches shared memory; V is read
// through ldmatrix.trans.  The causal grid runs its longest query tiles
// first.  wgmma, TMA and warp specialisation are later work.
//
// Precision.  Serving rounds P to bf16 once, as SDPA's kernels do; the
// output's own bf16 rounding is the larger error.  Training (o32 given)
// runs P V with P as a bf16 pair hi + lo, three products where two would
// do: the backward's D = rowsum(dO * O) takes this f32 O, and an error in
// D reaches dQ = scale sum_j dS_ij k_j times the keys' common part (all
// P_ij (dP_ij - D_i) share it), which with all-positive q and k put dQ
// past the 2e-2 tolerance when P was rounded once.
//
// f32 (fa_fwd_kernel): both products as f32 FMAs on the CUDA cores (128
// threads, each owning an 8 x 4 patch of the logits tile and an 8 x hd/16
// patch of the output), with K/V tiles widened in shared memory, which
// keeps f32 inputs at f32 accuracy: the tensor cores' bf16 and TF32 could
// not.
//
// With a non-null lse pointer it also writes each row's log-sum-exp
// (m + log l, f32), which the backward kernels (flash_attention_bwd.cu)
// use to recompute the probabilities; serving passes null.  For training
// the bf16 kernel also writes the output in f32 before its rounding (o32),
// from which the backward takes D = rowsum(dO * O): D from the rounded
// output would carry its rounding into every dS = P (dP - D) and, through
// dQ = scale sum_j dS_ij k_j, times the keys' common part.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per K/V tile
constexpr int THREADS = 128;       // bf16: 4 warps of 16 rows each
constexpr int TX = 16;             // threads across a row (logit columns)
constexpr int RPT = BQ / (THREADS / TX);  // rows per thread: 8
constexpr int CPT = BK / TX;       // logit columns per thread: 4
constexpr float NEG_INF = -1e30f;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };

// One 16-byte global load.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }

// Rows [row0, row0 + ROWS) of a contiguous (S, HD) slab into shared memory
// as f32 with row stride LD.  Rows at or past S are zero-filled.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int S, float* dst) {
  constexpr int N = VecWidth<T>::N;
  constexpr int PER_ROW = HD / N;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
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

template <int HD>
constexpr int smem_floats() {
  // Q (BQ x HD+1), K (BK x HD+1), V (BK x HD), P (BQ x BK+1); the +1 pads
  // keep column reads of Q, K and P free of bank conflicts.
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int H, int KV, int S, float scale,
              int causal, int window) {
  constexpr int LDQ = HD + 1, LDK = HD + 1, LDV = HD, LDP = BK + 1;
  constexpr int OPT = HD / TX;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qb = q + ((size_t)b * H + h) * S * HD;
  const T* kb = k + ((size_t)b * KV + kvh) * S * HD;
  const T* vb = v + ((size_t)b * KV + kvh) * S * HD;
  T* ob = o + ((size_t)b * H + h) * S * HD;

  const int tx = threadIdx.x % TX;   // lane % 16: a row group is half a warp
  const int r0 = (threadIdx.x / TX) * RPT;

  load_tile<T, HD, BQ, LDQ>(qb, q0, S, Qs);

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[r][j] = 0.f;
  }

  // Keys this query tile can see: [k_lo, k_hi).
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_hi + BK - 1) / BK;

  for (int t = k_lo / BK; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();               // last tile's reads of K, V, P are done
    load_tile<T, HD, BK, LDK>(kb, k0, S, Ks);
    load_tile<T, HD, BK, LDV>(vb, k0, S, Vs);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qv[r] = Qs[(r0 + r) * LDQ + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[(tx + c * TX) * LDK + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    // Elementwise masks only where the tile crosses the diagonal, the
    // window's edge or the ragged end of S.
    const bool edge = (k0 + BK > S) || (causal && k0 + BK - 1 > q0) ||
                      (window && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qi = q0 + r0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kj = k0 + tx + c * TX;
        float x = s[r][c] * scale;
        if (edge && !(kj < S && (!causal || kj <= qi) &&
                      (!window || qi - kj < window)))
          x = NEG_INF;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = s[r][c] <= NEG_INF ? 0.f : expf(s[r][c] - m_new);
        Ps[(r0 + r) * LDP + tx + c * TX] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[r][j] *= corr;
    }
    __syncthreads();               // the whole P tile is written

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pv[r] = Ps[(r0 + r) * LDP + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) vv[j] = Vs[c * LDV + tx + j * TX];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < OPT; ++j)
      store1(ob + (size_t)qi * HD + tx + j * TX, acc[r][j] / denom);
    // Every row sees at least its own key, so l >= 1 here; the backward
    // pass recomputes P = exp(s - lse) from it.
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + qi] = m[r] + logf(denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KV, S, scale,
      causal, window);
  return (int)cudaGetLastError();
}

// ---- bf16: FlashAttention-2 on the tensor cores ---------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
constexpr int tc_smem_bytes() {
  // Q (BQ rows), then two stages each of K and V (BK rows), all bf16.
  return (BQ + 4 * BK) * (HD + tc::PAD) * 2;
}

// PAIR (training, with o32): P enters P V as a bf16 pair hi + lo (see
// mma_bf16.cuh), so the f32 output the backward takes for D is not
// limited by P's rounding.
template <int HD, bool PAIR>
__global__ void __launch_bounds__(THREADS)
fa_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ o32,
                 float* __restrict__ lse, int H, int KV, int S, float scale,
                 int causal, int window) {
  constexpr int LD = HD + tc::PAD;
  constexpr int KS = HD / 16;      // k-steps of Q K^T
  constexpr int NT = BK / 8;       // n8 tiles of a warp's logits: 8
  constexpr int OT = HD / 8;       // n8 tiles of a warp's output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;      // stages at Ks, Ks + BK * LD
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;

  // Grid (B * H, query tiles): the causal grid hands out its longest
  // query tiles (the last ones) first.
  const int n_qt = gridDim.y;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const __nv_bfloat16* qb = q + ((size_t)b * H + h) * S * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * KV + kvh) * S * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * KV + kvh) * S * HD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;              // the warp's first row in the tile
  const float sl2 = scale * LOG2E;       // logits into log2 units

  // Keys this query tile can see: [k_lo, k_hi).
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_lo / BK, t_end = (k_hi + BK - 1) / BK;

  tc::load_tile_async<HD, BQ, THREADS>(qb, q0, S, Qs);
  tc::load_tile_async<HD, BK, THREADS>(kb, t_begin * BK, S, Ks);
  tc::load_tile_async<HD, BK, THREADS>(vb, t_begin * BK, S, Vs);
  tc::cp_async_commit();

  uint32_t qf[KS][4];
  float m_r[2] = {NEG_INF, NEG_INF};     // rows g and g + 8, log2 units
  float l_r[2] = {0.f, 0.f};             // this thread's part of the sums
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {               // the next tile into the other stage
      const int nxt = (stage ^ 1) * BK * LD;
      tc::load_tile_async<HD, BK, THREADS>(kb, (t + 1) * BK, S, Ks + nxt);
      tc::load_tile_async<HD, BK, THREADS>(vb, (t + 1) * BK, S, Vs + nxt);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();                   // tile t (and at first Q) landed
    if (t == t_begin) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        tc::ldmatrix_x4(qf[ks], Qs + tc::a_off<LD>(lane, wr, ks * 16));
    }
    const __nv_bfloat16* Kt = Ks + stage * BK * LD;
    const __nv_bfloat16* Vt = Vs + stage * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        tc::ldmatrix_x4(bf, Kt + tc::b_off<LD>(lane, np * 16, ks * 16));
        tc::mma_bf16(s[2 * np], qf[ks], bf[0], bf[1]);
        tc::mma_bf16(s[2 * np + 1], qf[ks], bf[2], bf[3]);
      }
    }

    // Elementwise masks only where the tile crosses the diagonal, the
    // window's edge or the ragged end of S.
    const int k0 = t * BK;
    const bool edge = (k0 + BK > S) || (causal && k0 + BK - 1 > q0) ||
                      (window && q0 + BQ - 1 - k0 >= window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + wr + g + (e >> 1) * 8;
        const int kj = k0 + j * 8 + 2 * t4 + (e & 1);
        float x = s[j][e] * sl2;
        if (edge && !(kj < S && (!causal || kj <= qi) &&
                      (!window || qi - kj < window)))
          x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x <= NEG_INF ? 0.f : exp2f(x - m_r[e >> 1]);
        s[j][e] = p;
        l_r[e >> 1] += p;
      }

    // O += P V: P's C tiles become A fragments in registers.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4], pl[4];
      if (PAIR)
        tc::pack_a_hilo(pa, pl, s[2 * kk], s[2 * kk + 1]);
      else
        tc::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int op = 0; op < OT / 2; ++op) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, Vt + tc::a_off<LD>(lane, kk * 16, op * 16));
        tc::mma_bf16(acc[2 * op], pa, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * op + 1], pa, bf[2], bf[3]);
        if (PAIR) {
          tc::mma_bf16(acc[2 * op], pl, bf[0], bf[1]);
          tc::mma_bf16(acc[2 * op + 1], pl, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                   // this stage may be refilled
  }

  __nv_bfloat16* ob = o + ((size_t)b * H + h) * S * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q0 + wr + g + i * 8;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const size_t row = ((size_t)b * H + h) * S + qi;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const float x0 = acc[j][2 * i] * inv, x1 = acc[j][2 * i + 1] * inv;
      *reinterpret_cast<uint32_t*>(ob + (size_t)qi * HD + j * 8 + 2 * t4) =
          tc::pack_bf16(x0, x1);
      if (o32 != nullptr) {
        o32[row * HD + j * 8 + 2 * t4] = x0;
        o32[row * HD + j * 8 + 2 * t4 + 1] = x1;
      }
    }
    // Every row sees at least its own key, so l >= 1 here.
    if (lse != nullptr && t4 == 0)
      lse[row] = (m_r[i] + log2f(fmaxf(l, 1e-30f))) * LN2;
  }
}

template <int HD, bool PAIR>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* o32, float* lse, int B, int H, int KV, int S,
              float scale, int causal, int window, cudaStream_t stream) {
  if ((S + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;  // grid y
  const int smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_tc_kernel<HD, PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  fa_fwd_tc_kernel<HD, PAIR><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      o32, lse, H, KV, S, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, S, hd); k, v: (B, KV, S, hd); all contiguous, 16-byte aligned.
// lse: (B, H, S) f32, the per-row log-sum-exp of the scaled logits that the
// backward pass needs, or null (serving) to skip it.  o32: (B, H, S, hd)
// f32, the bf16 output before its rounding, for the backward pass, or
// null; unread for f32 (whose o is already that).
// dtype 0 = float32, 1 = bfloat16; hd 64 or 128.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          void* o32, void* lse, int B, int H, int KV, int S,
                          int hd, float scale, int causal, int window,
                          int dtype, void* stream) {
  float* l = static_cast<float*>(lse);
  float* o2 = static_cast<float*>(o32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, l, B, H, KV, S, scale, causal,
                             window, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, l, B, H, KV, S, scale, causal,
                              window, st);
  if (dtype == 1 && hd == 64 && o2 == nullptr)
    return launch_tc<64, false>(q, k, v, o, o2, l, B, H, KV, S, scale, causal,
                                window, st);
  if (dtype == 1 && hd == 64)
    return launch_tc<64, true>(q, k, v, o, o2, l, B, H, KV, S, scale, causal,
                               window, st);
  if (dtype == 1 && hd == 128 && o2 == nullptr)
    return launch_tc<128, false>(q, k, v, o, o2, l, B, H, KV, S, scale,
                                 causal, window, st);
  if (dtype == 1 && hd == 128)
    return launch_tc<128, true>(q, k, v, o, o2, l, B, H, KV, S, scale,
                                causal, window, st);
  return (int)cudaErrorInvalidValue;
}
