// Fused expert FFN (the MoE hot loop) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py::_ffn_kernel
// (reached through ops.expert_ffn from models/moe.py in every MoE layer of
// every prefill and decode step).  It computes the same function: for each
// expert e and token row m of the capacity-dispatched input x (E, M, d),
//   h = silu(x w1) * (x w3)   (act 0, SwiGLU)   or   h = gelu_tanh(x w1)
//   y = h w2
// with w1/w3 (E, d, ff) and w2 (E, ff, d), every sum in f32, h kept in f32
// into the second product, and y rounded once to the input dtype.  As in
// the TPU kernel, the (M, ff) hidden activations never reach device memory.
//
// What bounds it on this card.  At decode (M = 8 rows per expert) the
// weights' bytes: granite's 32 experts x 3 x 1024 x 512 bf16 are 100.7 MB
// per call, 0.030 ms at 3.35 TB/s.  At a 1024-token prefill (M = 320) the
// operations: 3 x 2 x M x d x ff x E = 32.2 GFLOP, 0.033 ms if all of it ran
// on the bf16 tensor cores (989 TFLOP/s), 0.48 ms at the f32 rate of the
// CUDA cores (67 TFLOP/s) on which this kernel runs.
//
// Where it cannot copy the TPU layout.  The TPU block keeps a (128, d) f32
// accumulator of y in VMEM: 512 KB at d = 1024, more than the 227 KB of
// shared memory a Hopper block can use.  This kernel takes the smaller
// M-tile and cuts y's columns into slabs: one block owns BM = 32 token
// rows of one expert and one slab of at most SLAB = 1024 columns of y,
// keeps their (32, slab) f32 accumulator in shared memory (128 KB at a
// full slab), and walks ff in BF = 64-column steps.  Each step computes
// the (32, 64) h tile over the whole of d (x and w1/w3 tiles staged
// through shared memory, d in DK = 32-deep slices) and at once adds h w2
// for that slice of ff and its own slab of columns into the accumulator
// (w2 staged in DN = 128-column tiles), so h lives only in shared memory
// and every w2 byte is read once per M-tile.  Blocks run in parallel over
// (M-tile, expert, slab); nothing carries between them.  A ragged M, ff,
// d or last slab is masked on load: rows and columns past the edge read
// as 0, so they add nothing (silu(0) * 0 = gelu(0) = 0) and are not stored.
//
// What the slabs cost.  d <= 1024 is one slab: the grid's third dimension
// is 1 and the code path is that of a single-slab kernel.  Above it, each
// slab's blocks recompute the first two products (x w1, x w3) over the
// whole of d: at phi3.5-moe's d = 4096 that is 4 slabs, so about 3x the
// operations of the function at prefill and 4x the w1/w3 bytes at decode.
// That is a repair, not a design: keeping h once per M-tile (in device
// memory, or across a cluster's shared memory) instead of recomputing it
// is the redesign's work.
//
// Precision.  Every product runs as an f32 FMA on the CUDA cores, both for
// x w1 / x w3 (bf16 operands, exact in f32) and for h w2, whose h is f32:
// rounding h to bf16 for a tensor-core product would compute another
// function.  So the kernel matches the f32 plain version up to summation
// order, and leaves the tensor cores idle: mma / wgmma products for the two
// bf16 ones (and a split hi/lo bf16 product for h w2) are later work.  At
// decode only E x slabs blocks run (32 for granite, 64 for phi3.5-moe),
// too few to pull the weights at the card's memory rate; splitting ff
// across blocks is later work too.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

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

}  // namespace

// x, y: (E, M, d); w1, w3: (E, d, ff); w2: (E, ff, d); all contiguous, one
// dtype (0 = float32, 1 = bfloat16).  act 0 = silu (SwiGLU, reads w3),
// 1 = tanh-approximated gelu (w3 unread).  E and d's slab count
// ceil(d / 1024) each at most 65535 (the grid's y and z).
extern "C" int mg_ffn(const void* x, const void* w1, const void* w3,
                      const void* w2, void* y, int E, int M, int d, int ff,
                      int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || M <= 0 || d <= 0 || ff <= 0 || E > MAX_GRID_YZ ||
      n_slabs(d) > MAX_GRID_YZ)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && act == 0)
    return launch<float, 0>(x, w1, w3, w2, y, E, M, d, ff, st);
  if (dtype == 0 && act == 1)
    return launch<float, 1>(x, w1, w3, w2, y, E, M, d, ff, st);
  if (dtype == 1 && act == 0)
    return launch<__nv_bfloat16, 0>(x, w1, w3, w2, y, E, M, d, ff, st);
  if (dtype == 1 && act == 1)
    return launch<__nv_bfloat16, 1>(x, w1, w3, w2, y, E, M, d, ff, st);
  return (int)cudaErrorInvalidValue;
}
