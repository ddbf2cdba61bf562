// Warp-level tensor-core building blocks shared by the bf16 paths of
// flash_attention.cu, flash_attention_bwd.cu and moe_gmm.cu (sm_80 and
// later, so sm_90a): cp.async copies into shared memory, ldmatrix loads of
// 8 x 8 bf16 tiles, and mma.sync m16n8k16 with bf16 operands and f32 sums.
// It lives in kernels/include/, which the build puts on nvcc's include
// path and hashes with every source (kernels/_build.py).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of two bf16: a0 = (g, 2t..2t+1),
//     a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..).
//   B (16 x 8), 2 registers: b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g).
//   C/D (16 x 8, f32), 4 registers: c0, c1 = (g, 2t..2t+1),
//     c2, c3 = (g + 8, 2t..2t+1).
// So two neighbouring C tiles (n 0..7 and 8..15) of one product are,
// rounded to bf16 in pairs, the A fragment of the next product with k over
// those 16 columns: a0 = (C0.c0, C0.c1), a1 = (C0.c2, C0.c3),
// a2 = (C1.c0, C1.c1), a3 = (C1.c2, C1.c3) (pack_a below).
//
// Shared-memory tiles are row-major bf16 with rows padded by 8 elements
// (16 bytes): the 8 row addresses of one ldmatrix 8 x 8 tile then fall in
// 8 distinct 16-byte bank groups, free of conflicts for hd 64 and 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int PAD = 8;             // bf16 elements of padding per smem row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, asynchronous; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 tiles; lane l gives the address of row l % 8 of tile
// l / 8, and register j receives tile j's (row g, columns 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each tile transposed: register j receives tile j's
// (rows 2t..2t+1, column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += A B for one m16n8k16 tile, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16 rows x 16 k) from two neighbouring f32 C tiles.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The same A fragment as a bf16 pair hi + lo, hi = bf16(x) and
// lo = bf16(x - hi): two products with it keep about 16 bits of x where
// one keeps 8.
__device__ __forceinline__ void pack_a_hilo(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            const float (&c0)[4],
                                            const float (&c1)[4]) {
  float r0[4], r1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r0[e] = c0[e] - __bfloat162float(__float2bfloat16(c0[e]));
    r1[e] = c1[e] - __bfloat162float(__float2bfloat16(c1[e]));
  }
  pack_a(hi, c0, c1);
  pack_a(lo, r0, r1);
}

// Smem address offsets (in elements, row stride LD) that each lane hands
// to ldmatrix_x4 for a 16 x 16 block at (r0, c0):
//  a_off: the A fragment of rows r0.. and k c0.. (tiles: rows 0-7 / 8-15
//         by lane bit 3, k 0-7 / 8-15 by lane bit 4).  With
//         ldmatrix_x4_trans the same offsets give two B fragments (n tiles
//         c0.. and c0 + 8..) of a matrix stored k-major, [k][n].
//  b_off: two B fragments (n tiles r0.. and r0 + 8..) of a matrix stored
//         n-major, [n][k] (tiles: k halves by lane bit 3, n halves by
//         lane bit 4).
template <int LD>
__device__ __forceinline__ int a_off(int lane, int r0, int c0) {
  return (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int b_off(int lane, int r0, int c0) {
  return (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8;
}

// Rows [row0, row0 + ROWS) of a contiguous (S, HD) bf16 slab into shared
// memory (row stride HD + PAD) by cp.async; rows at or past S read as 0.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(
    const __nv_bfloat16* __restrict__ src, int row0, int S,
    __nv_bfloat16* dst) {
  constexpr int CH = HD / 8;       // 16-byte chunks per row
  constexpr int LD = HD + PAD;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? row0 + r : 0) * HD + c,
               ok ? 16 : 0);
  }
}

}  // namespace tc
