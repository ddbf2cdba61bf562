// What the slstm scan kernels (kernels/slstm/csrc/slstm.cu, slstm_bwd.cu)
// share: the step-tagged exchange's memory operations, and a recurrent
// product whose matrix stays in registers.
//
// The exchange.  Each block of a persistent grid publishes its values of
// step u as 8-byte words (the value's f32 bits, and u + 1 in the upper 32
// bits), stored single-copy-atomically at gpu scope into a ring of two
// slots; a consumer reads the words it needs and reads again those whose
// tag is not yet the one it waits for.  The value travels with its tag, so
// one L2 round trip brings both, where a barrier and a separate read take
// two or three.
//
// The product.  A block sums, for each of its columns (CW to a task), a
// K-long dot product of a fixed matrix with a vector that changes every
// step.  K is cut into chunks of QW = 128 elements, 4 a lane; a warp task
// is one group of CW columns over KPW consecutive chunks, and its sum is a
// partial of the group's TPG tasks.  A thread keeps the matrix's elements
// of its tasks' chunks ("slots", CW x 4 of them) for the whole call: the
// first Reg<T>::SMAX in registers, 64 of them (4 slots of bf16 pairs, or
// 2 of f32), any more in shared memory as f32.  A bf16 element is widened
// inside the asm of its FMA (fma_lo / fma_hi), so that the compiler does
// not hoist widened copies out of the step loop into the registers the
// packing saves.  A slot's product is 4 CW FMAs into CW independent
// accumulators with one float4 of the vector from shared memory; a task
// ends with one warp_sum8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

typedef unsigned long long u64;

__device__ __forceinline__ u64 ld_relaxed_u64(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_u64(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_u32(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Between two reads of words not yet tagged: nothing on the card (each
// read already waits one L2 round trip).
__device__ __forceinline__ void poll_pause() {}

// x, hidden from the compiler: what is computed from it after this point
// is computed there, not hoisted out of the step loop into registers that
// R's slots need.
__device__ __forceinline__ unsigned opaque32(unsigned x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ u64 opaque64(u64 x) {
  asm volatile("" : "+l"(x));
  return x;
}

__device__ __forceinline__ u64 word(unsigned tag, float v) {
  return ((u64)tag << 32) | __float_as_uint(v);
}

}  // namespace ring

namespace slt {

constexpr int CW = 8;      // columns of a task
constexpr int SMAX = 4;    // the most slots a thread holds in registers
constexpr int QW = 128;    // elements of a chunk: 32 lanes x 4
constexpr int TPG_MAX = 4; // tasks a group (partials the cell sums)

// How a slot of R in T sits in registers: bf16 as CW x 2 words of two
// (the low half the even element; exact, as R's words are), f32 as CW x 4
// floats.
template <typename T>
struct Reg;
template <>
struct Reg<__nv_bfloat16> {
  typedef uint32_t type;
  static constexpr int N = CW * 2, SMAX = 4;
};
template <>
struct Reg<float> {
  typedef float type;
  static constexpr int N = CW * 4, SMAX = 2;
};

// acc += h x (the low or high bf16 of the pair word w, widened to f32),
// one fma.rn.f32 as fmaf is.  The widening sits inside the asm, so that the
// compiler does not hoist widened copies of R out of the step loop into
// the registers the packing saves.
__device__ __forceinline__ void fma_lo(float& acc, float h, uint32_t w) {
  asm("{\n.reg .b32 t;\nshl.b32 t, %2, 16;\nfma.rn.f32 %0, %1, t, %0;\n}\n"
      : "+f"(acc)
      : "f"(h), "r"(w));
}

__device__ __forceinline__ void fma_hi(float& acc, float h, uint32_t w) {
  asm("{\n.reg .b32 t;\nand.b32 t, %2, 0xFFFF0000;\n"
      "fma.rn.f32 %0, %1, t, %0;\n}\n"
      : "+f"(acc)
      : "f"(h), "r"(w));
}

// Elements i and i + 1 (i even) of a register slot.
__device__ __forceinline__ void put2(float* r, int i, float v0, float v1) {
  r[i] = v0;
  r[i + 1] = v1;
}

__device__ __forceinline__ void put2(uint32_t* r, int i, float v0,
                                     float v1) {
  r[i / 2] = __float_as_uint(v0) >> 16 | (__float_as_uint(v1) & 0xFFFF0000u);
}

// The tasks of a product of `ncol` columns (a multiple of CW) over K =
// `kdim` on `nw` warps: kqt chunks; kpw chunks a task (the fewest slots a
// warp, ties to the longer task, at most TPG_MAX tasks a group); tpg
// tasks a group; ntasks; tw tasks a warp (task ti nw + w is warp w's
// ti-th); slots = tw kpw.
struct Geo {
  int ng, kqt, kpw, tpg, ntasks, tw, slots;
};

__host__ __device__ inline Geo geometry(int ncol, int kdim, int nw) {
  Geo g{};
  g.ng = ncol / CW;
  g.kqt = (kdim + QW - 1) / QW;
  int best = 1 << 30;
  for (int kpw = 1; kpw <= g.kqt; ++kpw) {
    const int tpg = (g.kqt + kpw - 1) / kpw, ntasks = g.ng * tpg;
    const int tw = (ntasks + nw - 1) / nw, slots = tw * kpw;
    if (tpg <= TPG_MAX && slots <= best) {
      best = slots;
      g.kpw = kpw;
      g.tpg = tpg;
      g.ntasks = ntasks;
      g.tw = tw;
      g.slots = slots;
    }
  }
  return g;
}

// Slot s of warp w: its task, group, chunk q and place in the task.
struct Slot {
  int task, g, q, qq;
  bool valid, last;
};

__device__ __forceinline__ Slot slot_of(const Geo& geo, int s, int w,
                                        int nw) {
  Slot o;
  const int ti = s / geo.kpw;
  o.qq = s % geo.kpw;
  o.task = ti * nw + w;
  o.g = o.task / geo.tpg;
  o.q = (o.task % geo.tpg) * geo.kpw + o.qq;
  o.valid = o.task < geo.ntasks && o.q < geo.kqt;
  o.last = o.qq == geo.kpw - 1 || o.q == geo.kqt - 1;
  return o;
}

// A slot packed into one register: task (12 bits), group (12), chunk (6),
// whether it starts its task and whether it ends it; NO_SLOT where the
// warp has no task there.
constexpr unsigned NO_SLOT = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned pack(const Slot& s) {
  return s.valid ? (unsigned)s.task | (unsigned)s.g << 12 |
                       (unsigned)s.q << 24 | (unsigned)(s.qq == 0) << 30 |
                       (unsigned)s.last << 31
                 : NO_SLOT;
}

// The sum over the warp of each of v's CW = 8 columns, in a fixed order:
// lane l ends with column (l >> 2) & 7's (halving the columns a lane keeps
// at offsets 16, 8 and 4, then summing at 2 and 1).
__device__ __forceinline__ float warp_sum8(float (&v)[CW], int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool hi = lane & 16;
    const float send = hi ? v[i] : v[i + 4];
    const float keep = hi ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool hi = lane & 8;
    const float send = hi ? v[i] : v[i + 2];
    const float keep = hi ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool hi = lane & 4;
  const float send = hi ? v[0] : v[1];
  float s = (hi ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// acc[c] += hv . (column c's 4 elements of this lane's quad) for every
// column, from a register slot of f32 or of bf16 pairs; element by element,
// so that consecutive FMAs go to different accumulators.
__device__ __forceinline__ void slot_fma(float (&acc)[CW], const float4& hv,
                                         const float* r) {
  const float h[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = fmaf(h[e], r[c * 4 + e], acc[c]);
}

__device__ __forceinline__ void slot_fma(float (&acc)[CW], const float4& hv,
                                         const uint32_t* r) {
#pragma unroll
  for (int c = 0; c < CW; ++c) fma_lo(acc[c], hv.x, r[c * 2]);
#pragma unroll
  for (int c = 0; c < CW; ++c) fma_hi(acc[c], hv.y, r[c * 2]);
#pragma unroll
  for (int c = 0; c < CW; ++c) fma_lo(acc[c], hv.z, r[c * 2 + 1]);
#pragma unroll
  for (int c = 0; c < CW; ++c) fma_hi(acc[c], hv.w, r[c * 2 + 1]);
}

// The same for one column c, its vector float4 its own.
__device__ __forceinline__ void quad_fma(float (&acc)[CW], const float4& hv,
                                         const float* r, int c) {
  acc[c] = fmaf(hv.x, r[c * 4], acc[c]);
  acc[c] = fmaf(hv.y, r[c * 4 + 1], acc[c]);
  acc[c] = fmaf(hv.z, r[c * 4 + 2], acc[c]);
  acc[c] = fmaf(hv.w, r[c * 4 + 3], acc[c]);
}

__device__ __forceinline__ void quad_fma(float (&acc)[CW], const float4& hv,
                                         const uint32_t* r, int c) {
  fma_lo(acc[c], hv.x, r[c * 2]);
  fma_hi(acc[c], hv.y, r[c * 2]);
  fma_lo(acc[c], hv.z, r[c * 2 + 1]);
  fma_hi(acc[c], hv.w, r[c * 2 + 1]);
}

__device__ __forceinline__ void quad_fma_smem(float (&acc)[CW],
                                              const float4& hv,
                                              const float* r, int c) {
  const float4 rv = *reinterpret_cast<const float4*>(r + c * 128);
  acc[c] = fmaf(hv.x, rv.x, acc[c]);
  acc[c] = fmaf(hv.y, rv.y, acc[c]);
  acc[c] = fmaf(hv.z, rv.z, acc[c]);
  acc[c] = fmaf(hv.w, rv.w, acc[c]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The end of a task: its warp sum into red[(task bt + b) CW + column].
__device__ __forceinline__ void task_out(float (&acc)[CW], float* red,
                                         int task, int bt, int b, int lane) {
  const float v = warp_sum8(acc, lane);
  if ((lane & 3) == 0) red[((size_t)task * bt + b) * CW + (lane >> 2)] = v;
}

// One row of the product: this warp's tasks over the vector row `hrow`,
// R from the register slots `rr` (descriptors `sd`; hoff[s] the vector's
// offset of slot s where its group's columns share one, else -1 and
// `csrc` gives each column's) and then from the shared-memory slots past
// Reg<T>::SMAX (`rsm`: this warp's, at this lane), each task's sum into
// red[(task bt + b) CW + column].
template <typename T>
__device__ __forceinline__ void row_product(
    const typename Reg<T>::type (&rr)[Reg<T>::SMAX][Reg<T>::N],
    const unsigned (&sd)[Reg<T>::SMAX], const int (&hoff)[Reg<T>::SMAX],
    const float* rsm, const Geo& geo, int w, int nw, const float* hrow,
    const int* csrc, const int* gsrc, float* red, int bt, int b, int lane) {
  constexpr int S = Reg<T>::SMAX;
  float acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned d = sd[s];
    if (d == NO_SLOT) continue;
    if (d >> 30 & 1)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[c] = 0.f;
    if (hoff[s] >= 0) {
      slot_fma(acc, ld4(hrow + hoff[s]), rr[s]);
    } else {
      const int* cs = csrc + (d >> 12 & 0xFFF) * CW;
      const int off = (int)(d >> 24 & 0x3F) * QW + lane * 4;
#pragma unroll
      for (int c = 0; c < CW; ++c)
        quad_fma(acc, ld4(hrow + cs[c] + off), rr[s], c);
    }
    if (d >> 31) task_out(acc, red, d & 0xFFF, bt, b, lane);
  }
#pragma unroll 1
  for (int s = S; s < geo.slots; ++s) {
    const Slot sl = slot_of(geo, s, w, nw);
    if (!sl.valid) continue;
    if (sl.qq == 0)
      for (int c = 0; c < CW; ++c) acc[c] = 0.f;
    const float* r = rsm + (size_t)(s - S) * CW * 128;
    const int off = sl.q * QW + lane * 4;
    if (gsrc[sl.g] >= 0) {
      const float4 h = ld4(hrow + gsrc[sl.g] + off);
      for (int c = 0; c < CW; ++c) quad_fma_smem(acc, h, r, c);
    } else {
      for (int c = 0; c < CW; ++c)
        quad_fma_smem(acc, ld4(hrow + csrc[sl.g * CW + c] + off), r, c);
    }
    if (sl.last) task_out(acc, red, sl.task, bt, b, lane);
  }
}

// The sum of column c's partials of row b over its group's tpg tasks, in
// task order.
__device__ __forceinline__ float column_sum(const float* red, const Geo& geo,
                                            int c, int bt, int b) {
  const float* p = red + ((size_t)(c / CW) * geo.tpg * bt + b) * CW + c % CW;
  float sum = p[0];
#pragma unroll
  for (int tp = 1; tp < TPG_MAX; ++tp)
    if (tp < geo.tpg) sum += p[(size_t)tp * bt * CW];
  return sum;
}

// A thread's register slots: descriptors and vector offsets (see
// row_product) of warp w at `lane`.
template <int S>
__device__ __forceinline__ void slot_table(const Geo& geo, int w, int nw,
                                           int lane, const int* gsrc,
                                           unsigned (&sd)[S],
                                           int (&hoff)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const Slot sl = slot_of(geo, s, w, nw);
    sd[s] = pack(sl);
    hoff[s] = sl.valid && gsrc[sl.g] >= 0
                  ? gsrc[sl.g] + sl.q * QW + lane * 4
                  : -1;
  }
}

// Each column's vector offset (csrc, -1 where the column is padding) and
// each group's shared one (gsrc; -1 where its columns differ), for the
// block's `ncol` columns; then __syncthreads.
__device__ __forceinline__ void group_sources(int* csrc, int* gsrc,
                                              int ncol) {
  __syncthreads();
  for (int g = threadIdx.x; g < ncol / CW; g += blockDim.x) {
    int s0 = -1;
    bool same = true;
    for (int c = 0; c < CW; ++c) {
      const int s = csrc[g * CW + c];
      if (s < 0) continue;
      if (s0 < 0)
        s0 = s;
      else if (s != s0)
        same = false;
    }
    gsrc[g] = same ? (s0 < 0 ? 0 : s0) : -1;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncol; c += blockDim.x)
    if (csrc[c] < 0) csrc[c] = 0;   // padding: r is 0 there
  __syncthreads();
}

}  // namespace slt
