// The pieces of the Mamba2 SSD chunked scan that its forward
// (mamba_scan/csrc/mamba_scan.cu) and its backward (mamba_scan_bwd.cu)
// share, so that both form cum and the bf16 parts of an f32 operand
// alike: the 64 x 64 tiles' sizes, cum in order, a tile's load into
// shared memory and split3.  It lives in
// kernels/include/ (on nvcc's include path), so that a planted copy of
// either source built elsewhere finds it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ssd {

constexpr int T64 = 64;            // tile side: chunk, P slab and N at most
constexpr int LDT = T64 + tc::PAD; // row stride of a bf16 tile
constexpr int PL = T64 * LDT;      // one bf16 tile (or part plane)
constexpr int NPART = 3;           // bf16 parts of an f32 operand

// cum = the inclusive prefix sum of dt * a over a chunk's q tokens (dt
// read with stride ds; cum past q = the total), in order and rounded as
// the plain version's torch.cumsum rounds it: one product, then one sum,
// a token.  The decay exp(cum_i - cum_j) takes the difference of two sums
// that reach -4000 at the model's a = -(1..80), where an f32 ulp is 5e-4:
// a sum in another order (a parallel scan) moves y by ~1e-4 relative from
// the plain version, which a full-depth bf16 prefill amplifies past its
// check (PERF.md, PR 18).
__device__ __forceinline__ void chunk_cumsum(const float* dt, int ds,
                                             float ah, int q, float* cum) {
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < T64; ++i) {    // unrolled: the loads all in flight
    if (i < q) run = __fadd_rn(run, __fmul_rn(dt[(size_t)i * ds], ah));
    cum[i] = run;
  }
}

// A 64 x 64 bf16 tile into shared memory (row stride LDT): src is its
// (0, 0), rs its row stride; rows at or past nr and columns at or past
// ncols read as 0.  vec: by cp.async, 16 bytes (rs, ncols and src's
// offset multiples of 8); else element by element.
__device__ __forceinline__ void load64(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, size_t rs,
                                       int nr, int ncols, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < T64 * (T64 / 8); i += blockDim.x) {
      const int r = i / (T64 / 8), c = (i % (T64 / 8)) * 8;
      const bool ok = r < nr && c < ncols;
      tc::cp_async16(dst + r * LDT + c, ok ? src + (size_t)r * rs + c : src,
                     ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < T64 * T64; i += blockDim.x) {
      const int r = i / T64, c = i % T64;
      dst[r * LDT + c] = (r < nr && c < ncols) ? src[(size_t)r * rs + c]
                                               : __float2bfloat16(0.f);
    }
  }
}

// x's three bf16 parts hi = bf16(x), mid = bf16(x - hi) and lo =
// bf16(x - hi - mid), each a word of two bf16 (x0 in the low halves):
// three products keep about 24 bits of x, as f32 does.
__device__ __forceinline__ void split3(float x0, float x1,
                                       uint32_t (&w)[NPART]) {
  const float r0 = x0 - __bfloat162float(__float2bfloat16(x0));
  const float r1 = x1 - __bfloat162float(__float2bfloat16(x1));
  w[0] = tc::pack_bf16(x0, x1);
  w[1] = tc::pack_bf16(r0, r1);
  w[2] = tc::pack_bf16(r0 - __bfloat162float(__float2bfloat16(r0)),
                       r1 - __bfloat162float(__float2bfloat16(r1)));
}

// The three parts into three planes PL apart, at element off.
__device__ __forceinline__ void store3(__nv_bfloat16* planes, int off,
                                       const uint32_t (&w)[NPART]) {
#pragma unroll
  for (int k = 0; k < NPART; ++k)
    *reinterpret_cast<uint32_t*>(planes + k * PL + off) = w[k];
}

}  // namespace ssd
