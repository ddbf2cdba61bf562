// A CPU emulation of the CUDA subset that the port's hand-written kernels
// use, so that their indexing, fragment layouts, masks and cp.async
// pipelines can be checked with g++ where there is no GPU
// (tests/test_torch_kernels_emulated.py translates a .cu source onto it).
//
// Each block runs as one std::thread per CUDA thread; __syncthreads is a
// block-wide std::barrier and the warp collectives (__shfl_xor_sync,
// __shfl_up_sync, ldmatrix, mma.sync) exchange through a per-warp scratch
// area between two warp-wide barriers.  Blocks run one after another.
// Shared memory starts as 0xFF bytes (NaN in bf16 and f32), so a read of
// a byte never written shows.  cp.async copies land only when
// cp.async.wait_group retires their group, the latest a GPU may land them,
// so a read before its wait sees stale data.  mma.sync multiplies bf16
// operands exactly in f32 and sums in another order than the tensor cores.
// Fragment layouts follow the PTX ISA ("Matrix fragments for
// mma.m16n8k16", "ldmatrix").
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
// A static __shared__ array is one object for all the threads of the
// block (blocks run one after another); unlike the dynamic smem() it is
// not filled with NaN bytes.
#define __shared__ static

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {   // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}

namespace emu {
inline thread_local dim3 tIdx, bIdx;
inline dim3 gDim, bDim;
struct Warp {
  std::barrier<> bar{32};
  float f[32];
  uint32_t a[32][4], b[32][2];
  float c[32][4];
  const unsigned char* addr[32];
};
inline std::vector<std::unique_ptr<Warp>> warps;
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<unsigned char> smem_buf;
inline unsigned char* smem() { return smem_buf.data(); }
struct Copy { void* dst; const void* src; int n, src_n; };
inline thread_local std::vector<Copy> cur;
inline thread_local std::vector<std::vector<Copy>> pending;
inline Warp& my_warp() { return *warps[tIdx.x / 32]; }

// kernel<<<grid, block, smem_bytes, stream>>>(...) becomes
// launch(grid, block, smem_bytes, stream, [=] { kernel(...); }).
inline void launch(dim3 grid, dim3 block, int smem_bytes, void*,
                   std::function<void()> fn) {
  gDim = grid;
  bDim = block;
  const int nt = block.x;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        smem_buf.assign(smem_bytes + 16, 0xFF);
        warps.clear();
        for (int w = 0; w < (nt + 31) / 32; ++w) warps.emplace_back(new Warp);
        block_bar.reset(new std::barrier<>(nt));
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t)
          ts.emplace_back([&, t, bx, by, bz] {
            tIdx = dim3(t, 0, 0);
            bIdx = dim3(bx, by, bz);
            cur.clear();
            pending.clear();
            fn();
            if (!pending.empty() || !cur.empty()) {
              std::fprintf(stderr, "a thread left cp.async groups pending\n");
              std::abort();
            }
          });
        for (auto& th : ts) th.join();
      }
}
inline void syncthreads() { block_bar->arrive_and_wait(); }
inline float shfl_xor(float v, int off) {
  Warp& w = my_warp();
  const int l = tIdx.x % 32;
  w.f[l] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[l ^ off];
  w.bar.arrive_and_wait();
  return r;
}
// Lane l gets lane l - off's value, or its own where l < off.
inline float shfl_up(float v, int off) {
  Warp& w = my_warp();
  const int l = tIdx.x % 32;
  w.f[l] = v;
  w.bar.arrive_and_wait();
  const float r = l >= off ? w.f[l - off] : v;
  w.bar.arrive_and_wait();
  return r;
}
}  // namespace emu

#define threadIdx emu::tIdx
#define blockIdx emu::bIdx
#define gridDim emu::gDim
#define blockDim emu::bDim
#define __syncthreads() emu::syncthreads()
#define __shfl_xor_sync(mask, v, off) emu::shfl_xor((v), (off))
#define __shfl_up_sync(mask, v, off) emu::shfl_up((v), (off))

// The tc:: primitives that mma_bf16.cuh writes in inline PTX (the
// translation drops those definitions).
namespace tc {
inline void cp_async16(void* dst, const void* src, int n) {
  emu::cur.push_back({dst, src, 16, n});
}
inline void cp_async4(void* dst, const void* src, int n) {
  emu::cur.push_back({dst, src, 4, n});
}
inline void cp_async_commit() {
  emu::pending.push_back(emu::cur);
  emu::cur.clear();
}
template <int N>
inline void cp_async_wait() {
  while ((int)emu::pending.size() > N) {
    for (auto& c : emu::pending.front()) {
      std::memset(c.dst, 0, c.n);
      std::memcpy(c.dst, c.src, c.src_n);
    }
    emu::pending.erase(emu::pending.begin());
  }
}
inline uint16_t ld16(const unsigned char* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
// Lane l holds the address of row l % 8 of tile l / 8; register j gets
// tile j's (row g, columns 2t, 2t + 1), or transposed (rows 2t, 2t + 1,
// column g).
inline void ldm(uint32_t (&r)[4], const void* p, bool trans) {
  emu::Warp& w = emu::my_warp();
  const int l = emu::tIdx.x % 32, g = l / 4, t = l % 4;
  w.addr[l] = static_cast<const unsigned char*>(p);
  w.bar.arrive_and_wait();
  for (int j = 0; j < 4; ++j) {
    uint16_t e[2];
    for (int i = 0; i < 2; ++i)
      e[i] = trans ? ld16(w.addr[j * 8 + 2 * t + i] + 2 * g)
                   : ld16(w.addr[j * 8 + g] + 2 * (2 * t + i));
    r[j] = (uint32_t)e[0] | ((uint32_t)e[1] << 16);
  }
  w.bar.arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { ldm(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  ldm(r, p, true);
}
inline float half_of(uint32_t reg, int hi) {
  return __bfloat162float({(uint16_t)(hi ? reg >> 16 : reg & 0xffffu)});
}
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  emu::Warp& w = emu::my_warp();
  const int l = emu::tIdx.x % 32, g = l / 4, t = l % 4;
  for (int i = 0; i < 4; ++i) {
    w.a[l][i] = a[i];
    w.c[l][i] = d[i];
  }
  w.b[l][0] = b0;
  w.b[l][1] = b1;
  w.bar.arrive_and_wait();
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >> 1) * 8, col = 2 * t + (e & 1);
    float acc = w.c[l][e];
    for (int k = 0; k < 16; ++k) {
      // A[row][k] sits in lane (row % 8) * 4 + (k % 8) / 2, register
      // row / 8 + 2 (k / 8); B[k][col] in lane col * 4 + (k % 8) / 2,
      // register k / 8; the low half holds the even k.
      const float av = half_of(
          w.a[(row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)], k % 2);
      const float bv = half_of(w.b[col * 4 + (k % 8) / 2][k / 8], k % 2);
      acc += av * bv;
    }
    out[e] = acc;
  }
  w.bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
}  // namespace tc
