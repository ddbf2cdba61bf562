// Fused expert FFN (the MoE hot loop) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py::_ffn_kernel
// (reached through ops.expert_ffn from models/moe.py in every MoE layer of
// every prefill and decode step).  It computes the same function: for each
// expert e and token row m of the capacity-dispatched input x (E, M, d),
//   h = silu(x w1) * (x w3)   (act 0, SwiGLU)   or   h = gelu_tanh(x w1)
//   y = h w2
// with w1/w3 (E, d, ff) and w2 (E, ff, d), every sum in f32, h kept in f32
// into the second product (to bf16 precision twice over, below), and y
// rounded once to the input dtype.
//
// What bounds it on this card.  At decode (M <= 16 rows per expert) the
// weights' bytes: granite's 32 experts x 3 x 1024 x 512 bf16 are 100.7 MB
// per call (0.030 ms at 3.35 TB/s), phi3.5-moe's 16 x 3 x 4096 x 6400 are
// 2.52 GB (0.751 ms).  At a 1024-token prefill the operations are about
// even with the bytes: 3 x 2 x M x d x ff x E is 32.2 GFLOP for granite
// (M 320; 0.033 ms at 989 TFLOP/s) and 403 GFLOP for phi3.5 (M 160; 0.41
// ms), so the tensor cores have to carry the products.
//
// bf16: two kernels, launched in turn on the caller's stream.
//   mg_ffn_gate_up_kernel, grid (M-tiles, ff-tiles of 64, E): one block
//     computes a (BM, 64) tile of x w1 and of x w3 over the whole of d,
//     applies the activation in f32 and writes h to a workspace.
//   mg_ffn_down_kernel, grid (M-tiles, d-tiles of BN, E): one block
//     computes a (BM, BN) tile of y = h w2 over the whole of ff.
// So no product is computed twice (the TPU kernel keeps h in VMEM; a
// Hopper block's 227 KB cannot hold a (BM, d) f32 accumulator at d 4096,
// and the single-kernel form this replaces recomputed x w1 and x w3 for
// every slab of y's columns).  The M-tile is the grid's fastest
// dimension, so the blocks that share a weight tile run side by side and
// each weight byte crosses HBM about once per call.  The workspace round
// trip is 4 bytes an element of (E, M, ff) each way: 65.5 MB at phi3.5's
// M 160, about 0.04 ms at the memory rate.
//
// Both products run on mma.sync m16n8k16 with bf16 operands and f32 sums
// (mma_bf16.cuh), 4 or 8 warps a block.  Each operand tile comes from device
// memory through a cp.async ring of STAGES tiles (16-byte copies, rows
// padded for conflict-free ldmatrix); A through ldmatrix, B -- w1, w3, w2
// are (K, N) row-major -- through ldmatrix.trans.  x w1 and x w3 are exact
// as bf16 operands.  h w2 is not: h is f32, and one bf16 rounding of it
// computes the JAX package's jnp path (moe.py, h.astype(x.dtype)), not its
// Pallas kernel.  So the gate-up kernel splits h into a bf16 pair, hi =
// bf16(h) and lo = bf16(h - hi), and the down kernel sums hi w2 + lo w2 in
// f32: about 16 bits of h where one rounding keeps 8.  That matters where
// h has a large part common to a row and w2's columns nearly cancel it;
// the checks hold such a case (tests, chip_smoke.check_moe_gmm).
//
// Deviation from a plain f32 workspace: the gate-up kernel writes the
// pair, as two bf16 planes (2, E, M, ldh) with ldh = ff rounded up to 64.
// They hold the same 4 bytes an element as f32 h; the split runs once per
// element instead of once per down block that reads it, and the down
// kernel loads both planes through ldmatrix like any bf16 operand.  The
// columns in [ff, ldh) are written as 0, so the down kernel's last ff-tile
// needs no mask on h (w2's rows past ff read as 0 too).
//
// Tiles (Cfg below).  Prefill (M > 16): gate-up BM 128 x 64 columns of w1
// and of w3, 8 warps as 4 x 2, 3 stages of 64-deep tiles (37 KB each);
// down 64 x 256, 8 warps as 2 x 4, 4 stages 32 deep (27 KB).  Each warp
// owns a 32 x 32 (gate-up, per weight) or 32 x 64 (down) patch.  Among
// the tiles tried on the card (64 x 64 and 64 x 128 with 4 warps, 128 x
// 128 with 8, 32- and 64-deep k-tiles) this pair was the fastest at the
// prefill shapes, and the ones that cut L2 traffic most were not faster:
// the mma.sync throughput of small warp tiles holds the prefill,
// which wgmma would lift.
// Decode (M <= 16) is a weight stream: BM 16, the 4 warps side by side
// over 16 columns each, 4 stages of 64-deep tiles in flight; the m16
// tiles' idle rows cost nothing that counts.  Decode then runs E x ff /
// 64 gate-up blocks (1600 for phi3.5, 256 for granite) and E x d / 64
// down blocks (1024, 512) instead of E x slabs (64, 32).
//
// Unaligned shapes.  16-byte copies need 16-byte rows: with d or ff not a
// multiple of 8 (or a pointer off 16 bytes) the loaders copy element by
// element instead (template VEC), and y is stored element by element.
// Everything past an edge (M, d, ff) reads as 0 and is not stored.
//
// f32 (mg_ffn_kernel): every product as an f32 FMA on the CUDA cores, as
// the checks want it (f32 is used only there, with TF32 off): one block
// owns BM = 32 token rows of one expert and one slab of at most SLAB =
// 1024 of y's columns, keeps their f32 accumulator in shared memory, and
// walks ff in BF = 64-column steps, computing each (32, 64) h tile over
// the whole of d and adding h w2 for its slab at once.  Above d 1024 each
// slab's blocks recompute x w1 and x w3 (at d 4096 about 3x the
// operations); f32 is not on a serving path.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the workspace is the caller's), does not synchronise,
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 32;             // token rows per block
constexpr int BF = 64;             // ff columns per step
constexpr int DK = 32;             // depth of one x / w1 / w3 tile (d)
constexpr int DN = 128;            // output columns of one w2 tile (d)
constexpr int THREADS = 256;
constexpr int SLAB = 1024;         // widest slab of y's columns per block
constexpr int MAX_GRID_YZ = 65535; // gridDim.y and gridDim.z limit
constexpr int LDX = DK + 1;        // x tile row stride (no bank conflicts)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

// jax.nn.silu and jax.nn.gelu(approximate=True), in f32.
__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;        // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// The y accumulator's row stride: the widest slab (d, at most SLAB)
// rounded up to whole DN tiles, so the float4 updates of the last tile
// stay inside the row.
__host__ __device__ __forceinline__ int acc_stride(int d) {
  return ((d < SLAB ? d : SLAB) + DN - 1) / DN * DN;
}

__host__ __device__ __forceinline__ int n_slabs(int d) {
  return (d + SLAB - 1) / SLAB;
}

__host__ __device__ __forceinline__ int smem_floats(int d) {
  return BM * acc_stride(d) + BM * LDX + 2 * DK * BF + BM * BF + BF * DN;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
mg_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
              const T* __restrict__ w3, const T* __restrict__ w2,
              T* __restrict__ y, int M, int d, int ff) {
  extern __shared__ __align__(16) float smem[];
  const int ldy = acc_stride(d);
  float* ys = smem;                  // (BM, ldy) f32 accumulator of y
  float* xs = ys + BM * ldy;         // (BM, LDX) x tile
  float* w1s = xs + BM * LDX;        // (DK, BF) w1 tile
  float* w3s = w1s + DK * BF;        // (DK, BF) w3 tile
  float* hs = w3s + DK * BF;         // (BM, BF) h tile
  float* w2s = hs + BM * BF;         // (BF, DN) w2 tile

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int e = blockIdx.y;
  const int s0 = blockIdx.z * SLAB;          // this block's slab of y
  const int s1 = min(d, s0 + SLAB);
  const T* xb = x + (size_t)e * M * d;
  const T* w1b = w1 + (size_t)e * d * ff;
  const T* w3b = w3 + (size_t)e * d * ff;
  const T* w2b = w2 + (size_t)e * ff * d;

  for (int i = tid; i < BM * ldy; i += THREADS) ys[i] = 0.f;

  // First products: thread (r1, c1) owns rows 2*r1 + {0,1} and columns
  // 4*c1 + {0..3} of the h tile.
  const int c1 = tid % 16, r1 = tid / 16;
  // Second product: thread (r2, c2) owns rows 4*r2 + {0..3} and columns
  // 4*c2 + {0..3} of each (BM, DN) output tile.
  const int c2 = tid % 32, r2 = tid / 32;

  for (int f0 = 0; f0 < ff; f0 += BF) {
    float a1[2][4], a3[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a1[r][c] = a3[r][c] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DK) {
#pragma unroll
      for (int it = 0; it < BM * DK / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / DK, k = i % DK;
        const bool ok = m0 + r < M && d0 + k < d;
        xs[r * LDX + k] = ok ? to_f32(xb[(size_t)(m0 + r) * d + d0 + k]) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < DK * BF / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int k = i / BF, f = i % BF;
        const bool ok = d0 + k < d && f0 + f < ff;
        const size_t off = (size_t)(d0 + k) * ff + f0 + f;
        w1s[i] = ok ? to_f32(w1b[off]) : 0.f;
        if (ACT == 0) w3s[i] = ok ? to_f32(w3b[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < DK; ++k) {
        const float xv0 = xs[(2 * r1) * LDX + k];
        const float xv1 = xs[(2 * r1 + 1) * LDX + k];
        const float4 b1 = *reinterpret_cast<const float4*>(w1s + k * BF + 4 * c1);
        a1[0][0] = fmaf(xv0, b1.x, a1[0][0]); a1[0][1] = fmaf(xv0, b1.y, a1[0][1]);
        a1[0][2] = fmaf(xv0, b1.z, a1[0][2]); a1[0][3] = fmaf(xv0, b1.w, a1[0][3]);
        a1[1][0] = fmaf(xv1, b1.x, a1[1][0]); a1[1][1] = fmaf(xv1, b1.y, a1[1][1]);
        a1[1][2] = fmaf(xv1, b1.z, a1[1][2]); a1[1][3] = fmaf(xv1, b1.w, a1[1][3]);
        if (ACT == 0) {
          const float4 b3 = *reinterpret_cast<const float4*>(w3s + k * BF + 4 * c1);
          a3[0][0] = fmaf(xv0, b3.x, a3[0][0]); a3[0][1] = fmaf(xv0, b3.y, a3[0][1]);
          a3[0][2] = fmaf(xv0, b3.z, a3[0][2]); a3[0][3] = fmaf(xv0, b3.w, a3[0][3]);
          a3[1][0] = fmaf(xv1, b3.x, a3[1][0]); a3[1][1] = fmaf(xv1, b3.y, a3[1][1]);
          a3[1][2] = fmaf(xv1, b3.z, a3[1][2]); a3[1][3] = fmaf(xv1, b3.w, a3[1][3]);
        }
      }
      __syncthreads();             // the x and w tiles are free again
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float h = ACT == 0 ? silu(a1[r][c]) * a3[r][c]
                                 : gelu_tanh(a1[r][c]);
        hs[(2 * r1 + r) * BF + 4 * c1 + c] = f0 + 4 * c1 + c < ff ? h : 0.f;
      }
    }
    // (the next __syncthreads, after the first w2 tile's load, publishes hs)

    for (int n0 = s0; n0 < s1; n0 += DN) {
#pragma unroll
      for (int it = 0; it < BF * DN / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int k = i / DN, n = i % DN;
        const bool ok = f0 + k < ff && n0 + n < s1;
        w2s[i] = ok ? to_f32(w2b[(size_t)(f0 + k) * d + n0 + n]) : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
      for (int k = 0; k < BF; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(w2s + k * DN + 4 * c2);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hv = hs[(4 * r2 + r) * BF + k];
          acc[r][0] = fmaf(hv, wv.x, acc[r][0]);
          acc[r][1] = fmaf(hv, wv.y, acc[r][1]);
          acc[r][2] = fmaf(hv, wv.z, acc[r][2]);
          acc[r][3] = fmaf(hv, wv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* yp = reinterpret_cast<float4*>(ys + (4 * r2 + r) * ldy +
                                               n0 - s0 + 4 * c2);
        float4 v = *yp;
        v.x += acc[r][0]; v.y += acc[r][1]; v.z += acc[r][2]; v.w += acc[r][3];
        *yp = v;
      }
      __syncthreads();             // w2s, and at the last tile hs, are free
    }
  }

  T* yb = y + (size_t)e * M * d;
  const int width = s1 - s0;
  for (int i = tid; i < BM * width; i += THREADS) {
    const int r = i / width, n = i % width;
    if (m0 + r < M)
      store1(yb + (size_t)(m0 + r) * d + s0 + n, ys[r * ldy + n]);
  }
}

template <typename T, int ACT>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           void* y, int E, int M, int d, int ff, cudaStream_t stream) {
  const int smem = smem_floats(d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mg_ffn_kernel<T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, E, n_slabs(d));
  mg_ffn_kernel<T, ACT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<const T*>(w2),
      static_cast<T*>(y), M, d, ff);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the gate-up and down kernels on the tensor cores.
// ---------------------------------------------------------------------------
namespace tcffn {

using bf16 = __nv_bfloat16;

constexpr int HCOLS = 64;          // workspace rows: ff rounded up to this
constexpr int SMALL_M = 16;        // at or below it, the decode tiles

// A block's tiles: BM x BN of the output, k-tiles BK deep through a ring
// of STAGES; the warps as WM x WN, each MT m16 tiles by NT n8 tiles.
// DOWN: operands h_hi, h_lo (BM x BK) and w2 (BK x BN); else x (BM x BK),
// w1 and w3 (BK x BN).
template <int BM_, int BN_, int WM_, int WN_, int BK_, int STAGES_,
          bool DOWN>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = BM / (16 * WM);
  static constexpr int NT = BN / (8 * WN);
  static constexpr int LDA = BK + tc::PAD;
  static constexpr int LDB = BN + tc::PAD;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE_ELEMS =
      DOWN ? 2 * A_ELEMS + B_ELEMS : A_ELEMS + 2 * B_ELEMS;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * (int)sizeof(bf16);
  static_assert(MT * 16 * WM == BM && NT * 8 * WN == BN, "whole tiles");
  static_assert(NT % 2 == 0, "ldmatrix.x4.trans loads n8 tiles in pairs");
  static_assert(HCOLS % (DOWN ? BK : BN) == 0, "whole tiles of h");
};

// Cfg<BIG, DOWN>: BIG above SMALL_M rows per expert (prefill), else the
// decode tiles; DOWN the down kernel, else the gate-up kernel.
template <bool BIG, bool DOWN> struct Cfg;
template <> struct Cfg<false, false> : Tile<16, 64, 1, 4, 64, 4, false> {};
template <> struct Cfg<false, true> : Tile<16, 64, 1, 4, 64, 4, true> {};
template <> struct Cfg<true, false> : Tile<128, 64, 4, 2, 64, 3, false> {};
template <> struct Cfg<true, true> : Tile<64, 256, 2, 4, 32, 4, true> {};
template <bool BIG> using GateUp = Cfg<BIG, false>;
template <bool BIG> using Down = Cfg<BIG, true>;

__host__ __device__ __forceinline__ int h_cols(int ff) {
  return (ff + HCOLS - 1) / HCOLS * HCOLS;
}

// A ROWS x COLS tile at (r0, c0) of a row-major (R, C) bf16 matrix with
// row stride ld, into shared memory with row stride COLS + PAD; what lies
// past R or C reads as 0.  VEC: 16-byte cp.async copies (C and ld
// multiples of 8, src 16-byte aligned, so a chunk is all in or all out);
// else element loads, visible after the next __syncthreads.
template <int ROWS, int COLS, int NTHREADS, bool VEC>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          int ld, int R, int C, int r0,
                                          int c0, bf16* dst) {
  constexpr int CH = COLS / 8;
  constexpr int LD = COLS + tc::PAD;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
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

// Two neighbouring f32 values of h as the bf16 pair hi + lo, stored as
// two bf16 pairs (4-byte aligned: ldh and the column are even).
__device__ __forceinline__ void store_pair(bf16* hi, bf16* lo, float a,
                                           float b) {
  const float ah = __bfloat162float(__float2bfloat16(a));
  const float bh = __bfloat162float(__float2bfloat16(b));
  *reinterpret_cast<uint32_t*>(hi) = tc::pack_bf16(a, b);
  *reinterpret_cast<uint32_t*>(lo) = tc::pack_bf16(a - ah, b - bh);
}

// One stage of the gate-up ring: k-tile kt of x, w1 and (SwiGLU) w3.
template <bool BIG, int ACT, bool VEC>
__device__ __forceinline__ void gate_up_load(
    bf16* st, const bf16* xb, const bf16* w1b, const bf16* w3b, int M,
    int d, int ff, int m0, int f0, int kt) {
  using C = GateUp<BIG>;
  const int k0 = kt * C::BK;
  load_tile<C::BM, C::BK, C::THREADS, VEC>(xb, d, M, d, m0, k0, st);
  load_tile<C::BK, C::BN, C::THREADS, VEC>(w1b, ff, d, ff, k0, f0,
                                           st + C::A_ELEMS);
  if (ACT == 0)
    load_tile<C::BK, C::BN, C::THREADS, VEC>(w3b, ff, d, ff, k0, f0,
                                             st + C::A_ELEMS + C::B_ELEMS);
}

template <bool BIG, int ACT, bool VEC>
__global__ void __launch_bounds__(GateUp<BIG>::THREADS)
mg_ffn_gate_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const bf16* __restrict__ w3, bf16* __restrict__ h,
                      int M, int d, int ff) {
  using C = GateUp<BIG>;
  extern __shared__ __align__(16) unsigned char gu_smem[];
  bf16* sm = reinterpret_cast<bf16*>(gu_smem);
  const int m0 = blockIdx.x * C::BM, f0 = blockIdx.y * C::BN;
  const int e = blockIdx.z;
  const bf16* xb = x + (size_t)e * M * d;
  const bf16* w1b = w1 + (size_t)e * d * ff;
  const bf16* w3b = w3 + (size_t)e * d * ff;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp / C::WN) * C::MT * 16;   // the warp's first row
  const int wc = (warp % C::WN) * C::NT * 8;    // and first column

  float a1[C::MT][C::NT][4], a3[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) a1[i][j][k] = a3[i][j][k] = 0.f;

  const int KT = (d + C::BK - 1) / C::BK;
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT)
      gate_up_load<BIG, ACT, VEC>(sm + s * C::STAGE_ELEMS, xb, w1b, w3b, M,
                                  d, ff, m0, f0, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<C::STAGES - 2>();
    __syncthreads();     // tile kt landed; tile kt - 1's stage is free
    const int nk = kt + C::STAGES - 1;
    if (nk < KT)
      gate_up_load<BIG, ACT, VEC>(sm + (nk % C::STAGES) * C::STAGE_ELEMS,
                                  xb, w1b, w3b, M, d, ff, m0, f0, nk);
    tc::cp_async_commit();
    const bf16* xs = sm + (kt % C::STAGES) * C::STAGE_ELEMS;
    const bf16* w1s = xs + C::A_ELEMS;
    const bf16* w3s = w1s + C::B_ELEMS;
#pragma unroll
    for (int ks = 0; ks < C::BK / 16; ++ks) {
      uint32_t af[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        tc::ldmatrix_x4(af[mt],
                        xs + tc::a_off<C::LDA>(lane, wr + mt * 16, ks * 16));
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(
            b, w1s + tc::a_off<C::LDB>(lane, ks * 16, wc + np * 16));
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          tc::mma_bf16(a1[mt][2 * np], af[mt], b[0], b[1]);
          tc::mma_bf16(a1[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
        if (ACT == 0) {
          tc::ldmatrix_x4_trans(
              b, w3s + tc::a_off<C::LDB>(lane, ks * 16, wc + np * 16));
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            tc::mma_bf16(a3[mt][2 * np], af[mt], b[0], b[1]);
            tc::mma_bf16(a3[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  // h in f32, split into its bf16 pair; columns in [ff, ldh) are 0.
  const int ldh = h_cols(ff);
  bf16* hhi = h + (size_t)e * M * ldh;
  bf16* hlo = hhi + (size_t)gridDim.z * M * ldh;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + wr + mt * 16 + g + 8 * i;
        const int c = f0 + wc + nt * 8 + 2 * t4;
        if (r >= M) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = a1[mt][nt][2 * i + j];
          v[j] = c + j >= ff ? 0.f
                 : ACT == 0  ? silu(p) * a3[mt][nt][2 * i + j]
                             : gelu_tanh(p);
        }
        const size_t off = (size_t)r * ldh + c;
        store_pair(hhi + off, hlo + off, v[0], v[1]);
      }
}

// One stage of the down ring: k-tile kt of h_hi, h_lo and w2.
template <bool BIG, bool VEC>
__device__ __forceinline__ void down_load(bf16* st, const bf16* hhi,
                                          const bf16* hlo, const bf16* w2b,
                                          int M, int d, int ff, int ldh,
                                          int m0, int n0, int kt) {
  using C = Down<BIG>;
  const int k0 = kt * C::BK;
  load_tile<C::BM, C::BK, C::THREADS, true>(hhi, ldh, M, ldh, m0, k0, st);
  load_tile<C::BM, C::BK, C::THREADS, true>(hlo, ldh, M, ldh, m0, k0,
                                            st + C::A_ELEMS);
  load_tile<C::BK, C::BN, C::THREADS, VEC>(w2b, d, ff, d, k0, n0,
                                           st + 2 * C::A_ELEMS);
}

template <bool BIG, bool VEC>
__global__ void __launch_bounds__(Down<BIG>::THREADS)
mg_ffn_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
                   bf16* __restrict__ y, int M, int d, int ff) {
  using C = Down<BIG>;
  extern __shared__ __align__(16) unsigned char dn_smem[];
  bf16* sm = reinterpret_cast<bf16*>(dn_smem);
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int e = blockIdx.z;
  const int ldh = h_cols(ff);
  const bf16* hhi = h + (size_t)e * M * ldh;
  const bf16* hlo = hhi + (size_t)gridDim.z * M * ldh;
  const bf16* w2b = w2 + (size_t)e * ff * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp / C::WN) * C::MT * 16;
  const int wc = (warp % C::WN) * C::NT * 8;

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const int KT = ldh / C::BK;
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT)
      down_load<BIG, VEC>(sm + s * C::STAGE_ELEMS, hhi, hlo, w2b, M, d, ff,
                          ldh, m0, n0, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<C::STAGES - 2>();
    __syncthreads();     // tile kt landed; tile kt - 1's stage is free
    const int nk = kt + C::STAGES - 1;
    if (nk < KT)
      down_load<BIG, VEC>(sm + (nk % C::STAGES) * C::STAGE_ELEMS, hhi, hlo,
                          w2b, M, d, ff, ldh, m0, n0, nk);
    tc::cp_async_commit();
    const bf16* his = sm + (kt % C::STAGES) * C::STAGE_ELEMS;
    const bf16* los = his + C::A_ELEMS;
    const bf16* w2s = los + C::A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < C::BK / 16; ++ks) {
      uint32_t ahi[C::MT][4], alo[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const int off = tc::a_off<C::LDA>(lane, wr + mt * 16, ks * 16);
        tc::ldmatrix_x4(ahi[mt], his + off);
        tc::ldmatrix_x4(alo[mt], los + off);
      }
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(
            b, w2s + tc::a_off<C::LDB>(lane, ks * 16, wc + np * 16));
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            tc::mma_bf16(acc[mt][2 * np + j], ahi[mt], b[2 * j], b[2 * j + 1]);
            tc::mma_bf16(acc[mt][2 * np + j], alo[mt], b[2 * j], b[2 * j + 1]);
          }
      }
    }
  }
  tc::cp_async_wait<0>();

  bf16* yb = y + (size_t)e * M * d;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + wr + mt * 16 + g + 8 * i;
        const int c = n0 + wc + nt * 8 + 2 * t4;
        if (r >= M || c >= d) continue;
        const float v0 = acc[mt][nt][2 * i], v1 = acc[mt][nt][2 * i + 1];
        bf16* p = yb + (size_t)r * d + c;
        if (VEC) {       // d even: c + 1 < d
          *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(v0, v1);
        } else {
          p[0] = __float2bfloat16(v0);
          if (c + 1 < d) p[1] = __float2bfloat16(v1);
        }
      }
}

template <bool BIG, int ACT, bool VEC>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           void* h, void* y, int E, int M, int d, int ff,
           cudaStream_t stream) {
  using G = GateUp<BIG>;
  using D = Down<BIG>;
  const int mt = (M + G::BM - 1) / G::BM;
  const int f_tiles = (ff + G::BN - 1) / G::BN;
  const int n_tiles = (d + D::BN - 1) / D::BN;
  if (f_tiles > MAX_GRID_YZ || n_tiles > MAX_GRID_YZ)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mg_ffn_gate_up_kernel<BIG, ACT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mg_ffn_down_kernel<BIG, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             D::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 gu(mt, f_tiles, E), dn((M + D::BM - 1) / D::BM, n_tiles, E);
  mg_ffn_gate_up_kernel<BIG, ACT, VEC><<<gu, G::THREADS, G::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<bf16*>(h), M, d, ff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mg_ffn_down_kernel<BIG, VEC><<<dn, D::THREADS, D::SMEM, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<bf16*>(y), M, d, ff);
  return (int)cudaGetLastError();
}

template <bool BIG, int ACT>
int launch_any(bool vec, const void* x, const void* w1, const void* w3,
               const void* w2, void* h, void* y, int E, int M, int d, int ff,
               cudaStream_t stream) {
  return vec ? launch<BIG, ACT, true>(x, w1, w3, w2, h, y, E, M, d, ff,
                                      stream)
             : launch<BIG, ACT, false>(x, w1, w3, w2, h, y, E, M, d, ff,
                                       stream);
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int ffn(const void* x, const void* w1, const void* w3, const void* w2,
        void* h, void* y, int E, int M, int d, int ff, int act,
        cudaStream_t st) {
  if (h == nullptr) return (int)cudaErrorInvalidValue;
  const bool vec = d % 8 == 0 && ff % 8 == 0 && aligned16(x) &&
                   aligned16(w1) && aligned16(w3) && aligned16(w2) &&
                   aligned16(h) && aligned16(y);
  if (M <= SMALL_M)
    return act == 0
        ? launch_any<false, 0>(vec, x, w1, w3, w2, h, y, E, M, d, ff, st)
        : launch_any<false, 1>(vec, x, w1, w3, w2, h, y, E, M, d, ff, st);
  return act == 0
      ? launch_any<true, 0>(vec, x, w1, w3, w2, h, y, E, M, d, ff, st)
      : launch_any<true, 1>(vec, x, w1, w3, w2, h, y, E, M, d, ff, st);
}

}  // namespace tcffn

}  // namespace

// x, y: (E, M, d); w1, w3: (E, d, ff); w2: (E, ff, d); all contiguous, one
// dtype (0 = float32, 1 = bfloat16).  act 0 = silu (SwiGLU, reads w3),
// 1 = tanh-approximated gelu (w3 unread).  h: bf16's workspace, (2, E, M,
// ldh) bf16 with ldh = ff rounded up to a multiple of 64 (unread for f32).
// E at most 65535, and so are the f32 slab count ceil(d / 1024) and the
// bf16 tile counts ceil(ff / 64) and ceil(d / BN) (the grid's y and z;
// BN 128 above M 16, else 64).
extern "C" int mg_ffn(const void* x, const void* w1, const void* w3,
                      const void* w2, void* h, void* y, int E, int M, int d,
                      int ff, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || M <= 0 || d <= 0 || ff <= 0 || E > MAX_GRID_YZ ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return tcffn::ffn(x, w1, w3, w2, h, y, E, M, d, ff, act, st);
  if (dtype != 0 || n_slabs(d) > MAX_GRID_YZ)
    return (int)cudaErrorInvalidValue;
  if (act == 0) return launch<float, 0>(x, w1, w3, w2, y, E, M, d, ff, st);
  return launch<float, 1>(x, w1, w3, w2, y, E, M, d, ff, st);
}
