// Backward of the fused expert FFN (moe_gmm.cu) for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/moe_gmm/kernel.py::_ffn_kernel has no
// backward: the JAX package trains its MoE layers through the jnp path.
// The port trains through its forward kernel, so this is the gradient of
// the function that kernel computes.  For each expert e, with x (E, M, d),
// w1 and w3 (E, d, ff), w2 (E, ff, d) and the output's gradient dy
// (E, M, d):
//   g = x w1,  u = x w3,  h = silu(g) u  (act 0)  or  h = gelu_tanh(g)
//   y = h w2                                         (the forward)
//   dh = dy w2^T
//   dg = dh u silu'(g),  du = dh silu(g)   (act 0)
//   dg = dh gelu_tanh'(g),  du = 0         (act 1: w3 unused, dw3 = 0)
//   dx = dg w1^T + du w3^T
//   dw1 = x^T dg,  dw3 = x^T du,  dw2 = h^T dy   (each summed over M)
// every sum in f32, each output rounded once to the input dtype.
//
// Three launches on the caller's stream, each a grid of 64 x 64 output
// tiles (bf16: 4 warps, each a 32 x 32 patch on mma.sync m16n8k16; f32: 256
// threads, each 4 x 4 outputs as f32 FMAs on the CUDA cores):
//   1. gate-up (M-tiles, ff-tiles, E): recomputes g and u (x w1, x w3 over
//      d) and forms dh (dy w2^T over d) for its tile, then writes h, dg and
//      du to a workspace in an epilogue.
//   2. dx (M-tiles, d-tiles, E): dg w1^T + du w3^T over ff.
//   3. dw (tiles of dw1 and dw3, then tiles of dw2; E): x^T dg and x^T du
//      for a (d, ff) tile, or h^T dy for an (ff, d) tile, each over the
//      whole of M in one block.  No float atomics and a fixed order of
//      every sum, so two runs are bit-equal.
// The workspace is (planes, E, M, ldh) with ldh = ff rounded up to 64 and
// the columns in [ff, ldh) written as 0, so the second and third launches
// read whole tiles of it; bf16 planes h_hi, h_lo, dg, du, f32 planes h, dg,
// du.
//
// Precision (bf16).  The operands of the first launch (x, dy, w1, w3, w2)
// are exact as bf16.  h enters dw2 as the forward keeps it, a bf16 pair
// hi = bf16(h), lo = bf16(h - hi), and dw2 sums hi^T dy + lo^T dy: where h
// has a large part common to each row and dy's columns sum to about zero
// over M, one rounding of h errs by more than the tolerance (ref.py,
// common_part_grad; the checks plant that fault).  dg and du are rounded
// once to bf16: in the same case that costs at most about half the
// tolerance of dx, dw1 and dw3 (the tests' common-part cases), so they
// stay single bf16 operands, as a framework's bf16 autograd keeps them.
//
// Tiles are staged through a cp.async ring of 3 k-tiles 32 deep (16-byte
// copies, rows padded for conflict-free ldmatrix; element loads where d or
// ff is not a multiple of 8, template VEC).  An operand is read as it lies
// in device memory: a tile whose k runs along the rows of its matrix (x, h
// and dy in the third launch, w1 and w3 in the first) is loaded k-major and
// given to mma.sync through ldmatrix.trans.  Everything past an edge (M,
// d, ff) reads as 0 and is not stored.
//
// What bounds it.  Eight products of 2 E M d ff operations each (five with
// gelu): at granite's training shape (E 32, M 1280, d 1024, ff 512) 344
// GFLOP, 0.35 ms at 989 TFLOP/s; the bytes (x, dy, the weights and their
// gradients, dx) are about 0.11 ms at 3.35 TB/s.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the workspace is the caller's), does not synchronise,
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int HCOLS = 64;           // workspace rows: ff rounded up to this
constexpr int MAX_GRID_YZ = 65535;  // gridDim.y and gridDim.z limit

__host__ __device__ __forceinline__ int h_cols(int ff) {
  return (ff + HCOLS - 1) / HCOLS * HCOLS;
}

// h and the gradients dg, du of the loss through h = act(g, u), given dh:
// act 0 is silu(g) u (jax.nn.silu), act 1 the tanh-approximated gelu(g)
// (jax.nn.gelu's default), for which du is 0.  In f32.
template <int ACT>
__device__ __forceinline__ void act_grad(float g, float u, float dh,
                                         float* h, float* dg, float* du) {
  if (ACT == 0) {
    const float s = 1.f / (1.f + expf(-g));
    const float sg = g * s;
    *h = sg * u;
    *dg = dh * u * s * (1.f + g * (1.f - s));
    *du = dh * sg;
  } else {
    const float k = 0.7978845608028654f;      // sqrt(2 / pi)
    const float c = 0.044715f;
    const float t = tanhf(k * (g + c * g * g * g));
    *h = 0.5f * g * (1.f + t);
    *dg = dh * (0.5f * (1.f + t) +
                0.5f * g * (1.f - t * t) * k * (1.f + 3.f * c * g * g));
    *du = 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16: three kernels on the tensor cores.
// ---------------------------------------------------------------------------
namespace tcb {

using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = 64;     // a block's output tile
constexpr int BK = 32, STAGES = 3;  // k-tiles, and their ring
constexpr int WM = 2, WN = 2;       // warps
constexpr int THREADS = 32 * WM * WN;
constexpr int MT = BM / (16 * WM), NT = BN / (8 * WN);
static_assert(HCOLS % BN == 0 && HCOLS % BM == 0 && HCOLS % BK == 0,
              "whole tiles of the workspace");
static_assert(NT % 2 == 0, "ldmatrix.x4 loads n8 tiles in pairs");

// The shared tile of one operand: EXT rows of A (or columns of B) by BK of
// k.  KM (k-major): the operand's matrix runs k along its rows, and the
// tile keeps that layout, (BK, EXT); else (EXT, BK).  Rows padded by PAD.
template <bool KM>
struct Sh {
  static constexpr int ROWS = KM ? BK : BM, COLS = KM ? BM : BK;
  static constexpr int LD = COLS + tc::PAD, ELEMS = ROWS * LD;
};
static_assert(BM == BN, "one tile shape for both operands");

// A ROWS x COLS tile at (r0, c0) of a row-major (R, C) bf16 matrix with
// row stride ld, into shared memory with row stride COLS + PAD; what lies
// past R or C reads as 0.  VEC: 16-byte cp.async copies (C and ld
// multiples of 8, src 16-byte aligned, so a chunk is all in or all out);
// else element loads, visible after the next __syncthreads.
template <int ROWS, int COLS, bool VEC>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          int ld, int R, int C, int r0,
                                          int c0, bf16* dst) {
  constexpr int CH = COLS / 8;
  constexpr int LD = COLS + tc::PAD;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * LD + c;
    if (VEC) {
      const bool ok = gr < R && gc < C;
      tc::cp_async16(d, ok ? src + (size_t)gr * ld + gc : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = gr < R && gc + j < C ? src[(size_t)gr * ld + gc + j]
                                    : __float2bfloat16(0.f);
    }
  }
}

// The tile of an operand at e0 (its rows of A or columns of B) and k0,
// from its row-major (R, C) matrix: k runs along the rows if KM.
template <bool KM, bool VEC>
__device__ __forceinline__ void load_op(const bf16* src, int ld, int R,
                                        int C, int e0, int k0, bf16* dst) {
  if (KM)
    load_tile<BK, BM, VEC>(src, ld, R, C, k0, e0, dst);
  else
    load_tile<BM, BK, VEC>(src, ld, R, C, e0, k0, dst);
}

// The A fragment of rows r.. and k.. from a staged tile: ldmatrix, or
// ldmatrix.trans of a k-major tile (its 8 x 8 blocks are A's transposed).
template <bool KM>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int lane, int r, int k) {
  if (KM)
    tc::ldmatrix_x4_trans(a, s + tc::b_off<Sh<true>::LD>(lane, k, r));
  else
    tc::ldmatrix_x4(a, s + tc::a_off<Sh<false>::LD>(lane, r, k));
}

// Two B fragments (n tiles n.. and n + 8..) of k.. from a staged tile.
template <bool KM>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s,
                                       int lane, int k, int n) {
  if (KM)
    tc::ldmatrix_x4_trans(b, s + tc::a_off<Sh<true>::LD>(lane, k, n));
  else
    tc::ldmatrix_x4(b, s + tc::b_off<Sh<false>::LD>(lane, n, k));
}

// acc += A B over the 16-deep slice ks of two staged tiles, for the warp's
// MT x NT fragments at (wr, wc).
template <bool AKM, bool BKM>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4],
                                         const bf16* as, const bf16* bs,
                                         int lane, int wr, int wc, int ks) {
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    frag_a<AKM>(a[mt], as, lane, wr + mt * 16, ks * 16);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b[4];
    frag_b<BKM>(b, bs, lane, ks * 16, wc + np * 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      tc::mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
      tc::mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
}

// A block's k-loop over KT k-tiles through the cp.async ring: load(stage,
// kt) stages k-tile kt, step(stage) runs the products on a staged one.
template <int STAGE_ELEMS, class Load, class Step>
__device__ __forceinline__ void pipeline(bf16* sm, int KT, Load load,
                                         Step step) {
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(sm + s * STAGE_ELEMS, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();     // tile kt landed; tile kt - 1's stage is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(sm + (nk % STAGES) * STAGE_ELEMS, nk);
    tc::cp_async_commit();
    step(sm + (kt % STAGES) * STAGE_ELEMS);
  }
  tc::cp_async_wait<0>();
}

// Each accumulator element's (row, column) in the block's tile: fragment
// (mt, nt), register pair i (rows g and g + 8) and j (columns 2t, 2t + 1).
struct Frag {
  int wr, wc, g, t4;
  __device__ __forceinline__ int row(int mt, int i) const {
    return wr + mt * 16 + g + 8 * i;
  }
  __device__ __forceinline__ int col(int nt) const {
    return wc + nt * 8 + 2 * t4;
  }
};

__device__ __forceinline__ Frag frag_of(int warp, int lane) {
  return {(warp / WN) * MT * 16, (warp % WN) * NT * 8, lane >> 2, lane & 3};
}

// Store a block's (BM, BN) f32 tile at (r0, c0) of a row-major (R, C)
// bf16 matrix, rounded once.  VEC: C even, so pairs are 4-byte stores.
template <bool VEC>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][NT][4],
                                           const Frag& f, bf16* out, int R,
                                           int C, int r0, int c0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + f.row(mt, i), c = c0 + f.col(nt);
        if (r >= R || c >= C) continue;
        const float v0 = acc[mt][nt][2 * i], v1 = acc[mt][nt][2 * i + 1];
        bf16* p = out + (size_t)r * C + c;
        if (VEC) {
          *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(v0, v1);
        } else {
          p[0] = __float2bfloat16(v0);
          if (c + 1 < C) p[1] = __float2bfloat16(v1);
        }
      }
}

// 1. g, u and dh of a (BM, BN) tile over d; h as a bf16 pair, dg and du
// into the workspace.
template <int ACT, bool VEC>
__global__ void __launch_bounds__(THREADS)
bw_gate_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ w3, const bf16* __restrict__ w2,
                  const bf16* __restrict__ dy, bf16* __restrict__ ws, int M,
                  int d, int ff) {
  constexpr int A = Sh<false>::ELEMS, B = Sh<true>::ELEMS;
  constexpr int STAGE = 2 * A + 2 * B + Sh<false>::ELEMS;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  bf16* sm = reinterpret_cast<bf16*>(bw_smem);
  const int m0 = blockIdx.x * BM, f0 = blockIdx.y * BN, e = blockIdx.z;
  const int E = gridDim.z;
  const bf16* xb = x + (size_t)e * M * d;
  const bf16* dyb = dy + (size_t)e * M * d;
  const bf16* w1b = w1 + (size_t)e * d * ff;
  const bf16* w3b = w3 + (size_t)e * d * ff;
  const bf16* w2b = w2 + (size_t)e * ff * d;
  const int lane = threadIdx.x % 32;
  const Frag f = frag_of(threadIdx.x / 32, lane);
  float ag[MT][NT][4], au[MT][NT][4], adh[MT][NT][4];
  zero(ag);
  zero(au);
  zero(adh);
  // stage: x, dy (M-major), w1, w3 (k-major), w2 (ff-major: w2^T's tile)
  pipeline<STAGE>(
      sm, (d + BK - 1) / BK,
      [&](bf16* st, int kt) {
        const int k0 = kt * BK;
        load_op<false, VEC>(xb, d, M, d, m0, k0, st);
        load_op<false, VEC>(dyb, d, M, d, m0, k0, st + A);
        load_op<true, VEC>(w1b, ff, d, ff, f0, k0, st + 2 * A);
        if (ACT == 0)
          load_op<true, VEC>(w3b, ff, d, ff, f0, k0, st + 2 * A + B);
        load_op<false, VEC>(w2b, d, ff, d, f0, k0, st + 2 * A + 2 * B);
      },
      [&](const bf16* st) {
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          mma_step<false, true>(ag, st, st + 2 * A, lane, f.wr, f.wc, ks);
          if (ACT == 0)
            mma_step<false, true>(au, st, st + 2 * A + B, lane, f.wr, f.wc,
                                  ks);
          mma_step<false, false>(adh, st + A, st + 2 * A + 2 * B, lane, f.wr,
                                 f.wc, ks);
        }
      });

  const int ldh = h_cols(ff);
  const size_t plane = (size_t)E * M * ldh;
  bf16* hhi = ws + (size_t)e * M * ldh;
  bf16* hlo = hhi + plane;
  bf16* dgp = hhi + 2 * plane;
  bf16* dup = hhi + 3 * plane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + f.row(mt, i), c = f0 + f.col(nt);
        if (r >= M) continue;
        float h[2], hl[2], dg[2], du[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = 2 * i + j;
          act_grad<ACT>(ag[mt][nt][k], au[mt][nt][k], adh[mt][nt][k], &h[j],
                        &dg[j], &du[j]);
          if (c + j >= ff) h[j] = dg[j] = du[j] = 0.f;
          hl[j] = h[j] - __bfloat162float(__float2bfloat16(h[j]));
        }
        const size_t off = (size_t)r * ldh + c;
        *reinterpret_cast<uint32_t*>(hhi + off) = tc::pack_bf16(h[0], h[1]);
        *reinterpret_cast<uint32_t*>(hlo + off) = tc::pack_bf16(hl[0], hl[1]);
        *reinterpret_cast<uint32_t*>(dgp + off) = tc::pack_bf16(dg[0], dg[1]);
        if (ACT == 0)
          *reinterpret_cast<uint32_t*>(dup + off) =
              tc::pack_bf16(du[0], du[1]);
      }
}

// 2. dx = dg w1^T + du w3^T of a (BM, BN) tile, over ff.
template <int ACT, bool VEC>
__global__ void __launch_bounds__(THREADS)
bw_dx_kernel(const bf16* __restrict__ w1, const bf16* __restrict__ w3,
             const bf16* __restrict__ ws, bf16* __restrict__ dx, int M, int d,
             int ff) {
  constexpr int A = Sh<false>::ELEMS;
  constexpr int STAGE = 4 * A;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  bf16* sm = reinterpret_cast<bf16*>(bw_smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int ldh = h_cols(ff);
  const size_t plane = (size_t)gridDim.z * M * ldh;
  const bf16* dgp = ws + 2 * plane + (size_t)e * M * ldh;
  const bf16* dup = dgp + plane;
  const bf16* w1b = w1 + (size_t)e * d * ff;
  const bf16* w3b = w3 + (size_t)e * d * ff;
  const int lane = threadIdx.x % 32;
  const Frag f = frag_of(threadIdx.x / 32, lane);
  float acc[MT][NT][4];
  zero(acc);
  // stage: dg, du (M-major), w1, w3 (d-major: w1^T's and w3^T's tiles)
  pipeline<STAGE>(
      sm, ldh / BK,
      [&](bf16* st, int kt) {
        const int k0 = kt * BK;
        load_op<false, true>(dgp, ldh, M, ldh, m0, k0, st);
        load_op<false, VEC>(w1b, ff, d, ff, n0, k0, st + 2 * A);
        if (ACT == 0) {
          load_op<false, true>(dup, ldh, M, ldh, m0, k0, st + A);
          load_op<false, VEC>(w3b, ff, d, ff, n0, k0, st + 3 * A);
        }
      },
      [&](const bf16* st) {
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          mma_step<false, false>(acc, st, st + 2 * A, lane, f.wr, f.wc, ks);
          if (ACT == 0)
            mma_step<false, false>(acc, st + A, st + 3 * A, lane, f.wr, f.wc,
                                   ks);
        }
      });
  store_tile<VEC>(acc, f, dx + (size_t)e * M * d, M, d, m0, n0);
}

// 3. The weight gradients, each tile over the whole of M in one block:
// blocks [0, t13) a (BM, BN) tile of dw1 = x^T dg and dw3 = x^T du (rows
// d, columns ff), the rest a tile of dw2 = h^T dy (rows ff, columns d)
// with h as its bf16 pair.
template <int ACT, bool VEC>
__global__ void __launch_bounds__(THREADS)
bw_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
             const bf16* __restrict__ ws, bf16* __restrict__ dw1,
             bf16* __restrict__ dw3, bf16* __restrict__ dw2, int M, int d,
             int ff) {
  constexpr int B = Sh<true>::ELEMS;
  constexpr int STAGE = 3 * B;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  bf16* sm = reinterpret_cast<bf16*>(bw_smem);
  const int e = blockIdx.y;
  const int ldh = h_cols(ff);
  const size_t plane = (size_t)gridDim.y * M * ldh;
  const bf16* hhi = ws + (size_t)e * M * ldh;
  const bf16* hlo = hhi + plane;
  const bf16* dgp = hhi + 2 * plane;
  const bf16* dup = hhi + 3 * plane;
  const bf16* xb = x + (size_t)e * M * d;
  const bf16* dyb = dy + (size_t)e * M * d;
  const int lane = threadIdx.x % 32;
  const Frag f = frag_of(threadIdx.x / 32, lane);
  const int KT = (M + BK - 1) / BK;
  const int f_tiles = ldh / BN, d_tiles = (d + BN - 1) / BN;
  const int t13 = (d + BM - 1) / BM * f_tiles;
  int t = blockIdx.x;
  if (t < t13) {
    const int r0 = t / f_tiles * BM, c0 = t % f_tiles * BN;
    float a1[MT][NT][4], a3[MT][NT][4];
    zero(a1);
    zero(a3);
    // stage: x (k-major: x^T's tile), dg, du (k-major)
    pipeline<STAGE>(
        sm, KT,
        [&](bf16* st, int kt) {
          const int k0 = kt * BK;
          load_op<true, VEC>(xb, d, M, d, r0, k0, st);
          load_op<true, true>(dgp, ldh, M, ldh, c0, k0, st + B);
          if (ACT == 0)
            load_op<true, true>(dup, ldh, M, ldh, c0, k0, st + 2 * B);
        },
        [&](const bf16* st) {
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            mma_step<true, true>(a1, st, st + B, lane, f.wr, f.wc, ks);
            if (ACT == 0)
              mma_step<true, true>(a3, st, st + 2 * B, lane, f.wr, f.wc, ks);
          }
        });
    store_tile<VEC>(a1, f, dw1 + (size_t)e * d * ff, d, ff, r0, c0);
    if (ACT == 0)
      store_tile<VEC>(a3, f, dw3 + (size_t)e * d * ff, d, ff, r0, c0);
    return;
  }
  t -= t13;
  const int r0 = t / d_tiles * BM, c0 = t % d_tiles * BN;
  float acc[MT][NT][4];
  zero(acc);
  // stage: h_hi, h_lo (k-major: h^T's tiles), dy (k-major)
  pipeline<STAGE>(
      sm, KT,
      [&](bf16* st, int kt) {
        const int k0 = kt * BK;
        load_op<true, true>(hhi, ldh, M, ldh, r0, k0, st);
        load_op<true, true>(hlo, ldh, M, ldh, r0, k0, st + B);
        load_op<true, VEC>(dyb, d, M, d, c0, k0, st + 2 * B);
      },
      [&](const bf16* st) {
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          mma_step<true, true>(acc, st, st + 2 * B, lane, f.wr, f.wc, ks);
          // h_lo's product: h^T dy with h to about 16 bits
          mma_step<true, true>(acc, st + B, st + 2 * B, lane, f.wr, f.wc, ks);
        }
      });
  store_tile<VEC>(acc, f, dw2 + (size_t)e * ff * d, ff, d, r0, c0);
}

constexpr int SMEM_GATE_UP =
    STAGES * (3 * Sh<false>::ELEMS + 2 * Sh<true>::ELEMS) * (int)sizeof(bf16);
constexpr int SMEM_DX = STAGES * 4 * Sh<false>::ELEMS * (int)sizeof(bf16);
constexpr int SMEM_DW = STAGES * 3 * Sh<true>::ELEMS * (int)sizeof(bf16);

template <int ACT, bool VEC>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           const void* dy, void* ws, void* dx, void* dw1, void* dw3,
           void* dw2, int E, int M, int d, int ff, cudaStream_t stream) {
  const int ldh = h_cols(ff);
  const int m_tiles = (M + BM - 1) / BM, d_tiles = (d + BN - 1) / BN;
  const int f_tiles = ldh / BN;
  const long long dw_tiles = (long long)((d + BM - 1) / BM) * f_tiles +
                             (long long)(ldh / BM) * d_tiles;
  if (f_tiles > MAX_GRID_YZ || d_tiles > MAX_GRID_YZ ||
      dw_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bw_gate_up_kernel<ACT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_GATE_UP);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bw_dx_kernel<ACT, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_DX);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bw_dw_kernel<ACT, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_DW);
  if (err != cudaSuccess) return (int)err;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* dyp = static_cast<const bf16*>(dy);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* w3p = static_cast<const bf16*>(w3);
  bf16* wsp = static_cast<bf16*>(ws);
  bw_gate_up_kernel<ACT, VEC><<<dim3(m_tiles, f_tiles, E), THREADS,
                                SMEM_GATE_UP, stream>>>(
      xp, w1p, w3p, static_cast<const bf16*>(w2), dyp, wsp, M, d, ff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bw_dx_kernel<ACT, VEC><<<dim3(m_tiles, d_tiles, E), THREADS, SMEM_DX,
                           stream>>>(w1p, w3p, wsp, static_cast<bf16*>(dx),
                                     M, d, ff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bw_dw_kernel<ACT, VEC><<<dim3((unsigned)dw_tiles, E), THREADS, SMEM_DW,
                           stream>>>(xp, dyp, wsp, static_cast<bf16*>(dw1),
                                     static_cast<bf16*>(dw3),
                                     static_cast<bf16*>(dw2), M, d, ff);
  return (int)cudaGetLastError();
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int bwd(const void* x, const void* w1, const void* w3, const void* w2,
        const void* dy, void* ws, void* dx, void* dw1, void* dw3, void* dw2,
        int E, int M, int d, int ff, int act, cudaStream_t st) {
  const bool vec = d % 8 == 0 && ff % 8 == 0 && aligned16(x) &&
                   aligned16(w1) && aligned16(w3) && aligned16(w2) &&
                   aligned16(dy) && aligned16(ws) && aligned16(dx) &&
                   aligned16(dw1) && aligned16(dw3) && aligned16(dw2);
  if (act == 0)
    return vec ? launch<0, true>(x, w1, w3, w2, dy, ws, dx, dw1, dw3, dw2, E,
                                 M, d, ff, st)
               : launch<0, false>(x, w1, w3, w2, dy, ws, dx, dw1, dw3, dw2,
                                  E, M, d, ff, st);
  return vec ? launch<1, true>(x, w1, w3, w2, dy, ws, dx, dw1, dw3, dw2, E, M,
                               d, ff, st)
             : launch<1, false>(x, w1, w3, w2, dy, ws, dx, dw1, dw3, dw2, E,
                                M, d, ff, st);
}

}  // namespace tcb

// ---------------------------------------------------------------------------
// f32: the same three kernels as f32 FMAs on the CUDA cores (f32 runs in
// the checks, with TF32 off).  A block owns a 64 x 64 output tile, each of
// its 256 threads 4 x 4 of it; both operands are staged k-major, (16, 64).
// ---------------------------------------------------------------------------
namespace f32b {

constexpr int BT = 64, BKF = 16, THREADS = 256;

// The (BKF, BT) tile t[k][e] of an operand whose element (e, k) lies at
// src[e * se + k * sk], for e0 + e < En and k0 + k < Kn (0 elsewhere).
__device__ __forceinline__ void load(float* t, const float* __restrict__ src,
                                     size_t se, size_t sk, int En, int Kn,
                                     int e0, int k0) {
  for (int i = threadIdx.x; i < BKF * BT; i += THREADS) {
    const int k = i / BT, e = i % BT;
    t[i] = e0 + e < En && k0 + k < Kn
               ? src[(size_t)(e0 + e) * se + (size_t)(k0 + k) * sk]
               : 0.f;
  }
}

// acc += a^T b over the staged k: the thread's rows 4 tr.. and columns
// 4 tc.. of the tile.
__device__ __forceinline__ void fma_tile(float (&acc)[4][4],
                                         const float* a, const float* b) {
  const int tr = threadIdx.x / 16, tcol = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < BKF; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * BT + 4 * tr);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * BT + 4 * tcol);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// The thread's 4 x 4 of a tile at (r0, c0) of a row-major (R, C) matrix.
__device__ __forceinline__ void store(const float (&acc)[4][4], float* out,
                                      int R, int C, int r0, int c0) {
  const int tr = threadIdx.x / 16, tcol = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * tr + i, c = c0 + 4 * tcol + j;
      if (r < R && c < C) out[(size_t)r * C + c] = acc[i][j];
    }
}

template <int ACT>
__global__ void __launch_bounds__(THREADS)
bw_gate_up_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ w3, const float* __restrict__ w2,
               const float* __restrict__ dy, float* __restrict__ ws, int M,
               int d, int ff) {
  __shared__ __align__(16) float sm[5 * BKF * BT];
  float* xs = sm;
  float* dys = xs + BKF * BT;
  float* w1s = dys + BKF * BT;
  float* w3s = w1s + BKF * BT;
  float* w2s = w3s + BKF * BT;
  const int m0 = blockIdx.x * BT, f0 = blockIdx.y * BT, e = blockIdx.z;
  const float* xb = x + (size_t)e * M * d;
  const float* dyb = dy + (size_t)e * M * d;
  const float* w1b = w1 + (size_t)e * d * ff;
  const float* w3b = w3 + (size_t)e * d * ff;
  const float* w2b = w2 + (size_t)e * ff * d;
  float ag[4][4], au[4][4], adh[4][4];
  zero(ag);
  zero(au);
  zero(adh);
  for (int k0 = 0; k0 < d; k0 += BKF) {
    load(xs, xb, d, 1, M, d, m0, k0);
    load(dys, dyb, d, 1, M, d, m0, k0);
    load(w1s, w1b, 1, ff, ff, d, f0, k0);
    if (ACT == 0) load(w3s, w3b, 1, ff, ff, d, f0, k0);
    load(w2s, w2b, d, 1, ff, d, f0, k0);
    __syncthreads();
    fma_tile(ag, xs, w1s);
    if (ACT == 0) fma_tile(au, xs, w3s);
    fma_tile(adh, dys, w2s);
    __syncthreads();
  }
  const int ldh = h_cols(ff);
  const size_t plane = (size_t)gridDim.z * M * ldh;
  float* hp = ws + (size_t)e * M * ldh;
  const int tr = threadIdx.x / 16, tcol = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + 4 * tr + i, c = f0 + 4 * tcol + j;
      if (r >= M) continue;
      float h, dg, du;
      act_grad<ACT>(ag[i][j], au[i][j], adh[i][j], &h, &dg, &du);
      if (c >= ff) h = dg = du = 0.f;
      const size_t off = (size_t)r * ldh + c;
      hp[off] = h;
      hp[plane + off] = dg;
      hp[2 * plane + off] = du;
    }
}

template <int ACT>
__global__ void __launch_bounds__(THREADS)
bw_dx_f32(const float* __restrict__ w1, const float* __restrict__ w3,
          const float* __restrict__ ws, float* __restrict__ dx, int M, int d,
          int ff) {
  __shared__ __align__(16) float sm[4 * BKF * BT];
  float* dgs = sm;
  float* dus = dgs + BKF * BT;
  float* w1s = dus + BKF * BT;
  float* w3s = w1s + BKF * BT;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * BT, e = blockIdx.z;
  const int ldh = h_cols(ff);
  const size_t plane = (size_t)gridDim.z * M * ldh;
  const float* dgp = ws + plane + (size_t)e * M * ldh;
  const float* dup = dgp + plane;
  const float* w1b = w1 + (size_t)e * d * ff;
  const float* w3b = w3 + (size_t)e * d * ff;
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < ff; k0 += BKF) {
    load(dgs, dgp, ldh, 1, M, ff, m0, k0);
    load(w1s, w1b, ff, 1, d, ff, n0, k0);
    if (ACT == 0) {
      load(dus, dup, ldh, 1, M, ff, m0, k0);
      load(w3s, w3b, ff, 1, d, ff, n0, k0);
    }
    __syncthreads();
    fma_tile(acc, dgs, w1s);
    if (ACT == 0) fma_tile(acc, dus, w3s);
    __syncthreads();
  }
  store(acc, dx + (size_t)e * M * d, M, d, m0, n0);
}

template <int ACT>
__global__ void __launch_bounds__(THREADS)
bw_dw_f32(const float* __restrict__ x, const float* __restrict__ dy,
          const float* __restrict__ ws, float* __restrict__ dw1,
          float* __restrict__ dw3, float* __restrict__ dw2, int M, int d,
          int ff) {
  __shared__ __align__(16) float sm[3 * BKF * BT];
  float* as = sm;
  float* bs = as + BKF * BT;
  float* cs = bs + BKF * BT;
  const int e = blockIdx.y;
  const int ldh = h_cols(ff);
  const size_t plane = (size_t)gridDim.y * M * ldh;
  const float* hp = ws + (size_t)e * M * ldh;
  const float* dgp = hp + plane;
  const float* dup = hp + 2 * plane;
  const float* xb = x + (size_t)e * M * d;
  const float* dyb = dy + (size_t)e * M * d;
  const int f_tiles = (ff + BT - 1) / BT, d_tiles = (d + BT - 1) / BT;
  const int t13 = d_tiles * f_tiles;
  int t = blockIdx.x;
  if (t < t13) {
    const int r0 = t / f_tiles * BT, c0 = t % f_tiles * BT;
    float a1[4][4], a3[4][4];
    zero(a1);
    zero(a3);
    for (int k0 = 0; k0 < M; k0 += BKF) {
      load(as, xb, 1, d, d, M, r0, k0);
      load(bs, dgp, 1, ldh, ff, M, c0, k0);
      if (ACT == 0) load(cs, dup, 1, ldh, ff, M, c0, k0);
      __syncthreads();
      fma_tile(a1, as, bs);
      if (ACT == 0) fma_tile(a3, as, cs);
      __syncthreads();
    }
    store(a1, dw1 + (size_t)e * d * ff, d, ff, r0, c0);
    if (ACT == 0) store(a3, dw3 + (size_t)e * d * ff, d, ff, r0, c0);
    return;
  }
  t -= t13;
  const int r0 = t / d_tiles * BT, c0 = t % d_tiles * BT;
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < M; k0 += BKF) {
    load(as, hp, 1, ldh, ff, M, r0, k0);
    load(bs, dyb, 1, d, d, M, c0, k0);
    __syncthreads();
    fma_tile(acc, as, bs);
    __syncthreads();
  }
  store(acc, dw2 + (size_t)e * ff * d, ff, d, r0, c0);
}

template <int ACT>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           const void* dy, void* ws, void* dx, void* dw1, void* dw3,
           void* dw2, int E, int M, int d, int ff, cudaStream_t stream) {
  const int m_tiles = (M + BT - 1) / BT, d_tiles = (d + BT - 1) / BT;
  const int f_tiles = h_cols(ff) / BT, ff_tiles = (ff + BT - 1) / BT;
  if (f_tiles > MAX_GRID_YZ || d_tiles > MAX_GRID_YZ ||
      2LL * d_tiles * ff_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* dyp = static_cast<const float*>(dy);
  const float* w1p = static_cast<const float*>(w1);
  const float* w3p = static_cast<const float*>(w3);
  float* wsp = static_cast<float*>(ws);
  bw_gate_up_f32<ACT><<<dim3(m_tiles, f_tiles, E), THREADS, 0, stream>>>(
      xp, w1p, w3p, static_cast<const float*>(w2), dyp, wsp, M, d, ff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bw_dx_f32<ACT><<<dim3(m_tiles, d_tiles, E), THREADS, 0, stream>>>(
      w1p, w3p, wsp, static_cast<float*>(dx), M, d, ff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bw_dw_f32<ACT><<<dim3((unsigned)(2 * d_tiles * ff_tiles), E), THREADS, 0,
                   stream>>>(xp, dyp, wsp, static_cast<float*>(dw1),
                             static_cast<float*>(dw3),
                             static_cast<float*>(dw2), M, d, ff);
  return (int)cudaGetLastError();
}

}  // namespace f32b

}  // namespace

// x, dy, dx: (E, M, d); w1, w3, dw1, dw3: (E, d, ff); w2, dw2: (E, ff, d);
// all contiguous, one dtype (0 = float32, 1 = bfloat16).  act 0 = silu
// (SwiGLU), 1 = tanh-approximated gelu (w3 unread, dw3 not written: the
// caller passes it zeroed).  ws: the workspace, (4, E, M, ldh) bf16 or
// (3, E, M, ldh) f32 with ldh = ff rounded up to a multiple of 64.  E at
// most 65535, and so are the tile counts ceil(ff / 64) and ceil(d / 64).
extern "C" int mg_ffn_bwd(const void* x, const void* w1, const void* w3,
                          const void* w2, const void* dy, void* ws, void* dx,
                          void* dw1, void* dw3, void* dw2, int E, int M,
                          int d, int ff, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || M <= 0 || d <= 0 || ff <= 0 || E > MAX_GRID_YZ ||
      (act != 0 && act != 1) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return tcb::bwd(x, w1, w3, w2, dy, ws, dx, dw1, dw3, dw2, E, M, d, ff,
                    act, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return act == 0 ? f32b::launch<0>(x, w1, w3, w2, dy, ws, dx, dw1, dw3,
                                    dw2, E, M, d, ff, st)
                  : f32b::launch<1>(x, w1, w3, w2, dy, ws, dx, dw1, dw3,
                                    dw2, E, M, d, ff, st);
}
