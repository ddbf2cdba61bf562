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
// What this design does about it.  It keeps the S x S logits out of device
// memory entirely: one thread block owns a 64-row query tile of one
// (batch, head), holds it in shared memory, and loops over 64-key K/V tiles
// (shared memory, converted to f32 on load), from the window's left edge up
// to the causal bound only, so each K/V byte is read once per query tile and
// the masked half of the triangle is never computed.  Masks are applied
// elementwise only on tiles that cross the diagonal, the window edge or a
// ragged end of S (S need not be a multiple of the tile).  Blocks run in
// parallel across (query tile, head, batch); nothing carries between them.
// Both products run as f32 FMAs on the CUDA cores (128 threads, each owning
// an 8 x 4 patch of the logits tile and an 8 x hd/16 patch of the output),
// which keeps f32 inputs at f32 accuracy but leaves the tensor cores idle:
// the kernel is bound by the FMA and shared-memory pipes, far from the
// tensor-core bound.  mma.sync / wgmma products for bf16 are later work.
//
// With a non-null lse pointer it also writes each row's log-sum-exp
// (m + log l, f32), which the backward kernels (flash_attention_bwd.cu)
// use to recompute the probabilities; serving passes null.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per K/V tile
constexpr int THREADS = 128;
constexpr int TX = 16;             // threads across a row (logit columns)
constexpr int RPT = BQ / (THREADS / TX);  // rows per thread: 8
constexpr int CPT = BK / TX;       // logit columns per thread: 4
constexpr float NEG_INF = -1e30f;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// One 16-byte global load, widened to f32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

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

}  // namespace

// q, o: (B, H, S, hd); k, v: (B, KV, S, hd); all contiguous, 16-byte aligned.
// lse: (B, H, S) f32, the per-row log-sum-exp of the scaled logits that the
// backward pass needs, or null (serving) to skip it.
// dtype 0 = float32, 1 = bfloat16; hd 64 or 128.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          void* lse, int B, int H, int KV, int S, int hd,
                          float scale, int causal, int window, int dtype,
                          void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, l, B, H, KV, S, scale, causal,
                             window, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, l, B, H, KV, S, scale, causal,
                              window, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, l, B, H, KV, S, scale, causal,
                                     window, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, l, B, H, KV, S, scale, causal,
                                      window, st);
  return (int)cudaErrorInvalidValue;
}
