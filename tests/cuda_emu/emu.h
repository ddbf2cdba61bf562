// A CPU emulation of the CUDA subset that the port's hand-written kernels
// use, so that their indexing, fragment layouts, masks and cp.async
// pipelines can be checked with g++ where there is no GPU
// (tests/test_torch_kernels_emulated.py translates a .cu source onto it).
//
// Each block runs as one std::thread per CUDA thread; __syncthreads is a
// block-wide std::barrier and the warp collectives (__shfl_xor_sync,
// __shfl_up_sync, ldmatrix, mma.sync) exchange through a per-warp scratch
// area between two warp-wide barriers.  Blocks run one after another,
// but under a cooperative launch (cudaLaunchCooperativeKernel), where all
// of them exist at once and meet at cooperative_groups' grid barrier,
// between two barriers one at a time in order of their index.
// Shared memory starts as 0xFF bytes (NaN in bf16 and f32), so a read of
// a byte never written shows.  cp.async copies land only when
// cp.async.wait_group retires their group, the latest a GPU may land them,
// so a read before its wait sees stale data.  mma.sync multiplies bf16
// operands exactly in f32 and sums in another order than the tensor cores.
// Fragment layouts follow the PTX ISA ("Matrix fragments for
// mma.m16n8k16", "ldmatrix").
//
// Hopper (wgmma_bf16.cuh): a warpgroup's wgmma exchanges its descriptors
// across its 128 threads (they must agree) and is computed only when
// wgmma.wait_group retires its group, reading shared memory then through
// the descriptor and the 128-byte swizzle of the PTX ISA's shared-memory
// matrix layouts, so an accumulator read before its wait sees the old
// value.  An mbarrier keeps its phase, pending arrivals and transaction
// count.  A TMA load is held on its barrier and lands (its box swizzled,
// what lies outside the tensor 0) only when a wait on that barrier
// observes it, so a read of a stage before its wait sees stale bytes; a
// TMA store reads shared memory only when cp.async.bulk.wait_group.read
// retires its group, so a box rewritten before that wait shows.  The
// dynamic shared memory starts on 1024 bytes; tc::smem_u32 is the offset
// from its start.
#pragma once
#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __grid_constant__
#define __trap() emu_trap()
// A static __shared__ array is one object for all the threads of the
// block (blocks run one after another; under a cooperative launch it
// would be all the blocks', so those kernels take dynamic shared memory
// only); unlike the dynamic smem() it is not filled with NaN bytes.
#define __shared__ static

using std::max;
using std::min;

// __trap(): the kernel stops with an error, reported on stderr (a test
// that traps runs the kernel in a process of its own).
[[noreturn]] inline void emu_trap() {
  std::fprintf(stderr, "__trap: the kernel stopped\n");
  std::fflush(stderr);
  std::abort();
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __expf(float x) { return std::exp(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorCooperativeLaunchTooLarge = 82
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
// What a kernel's compilation reports (no registers or spills here).
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes;
};
template <typename F>
int cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  *a = cudaFuncAttributes{};
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}

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
constexpr int SMS = 3;              // multiprocessors (persistent grids)
// A warpgroup's exchange area (its wgmma's descriptors).
struct WarpGroup {
  std::barrier<> bar{128};
  uint64_t a[128], b[128];
};
// One block's own state: its dynamic shared memory (NaN bytes, starting
// on 1024 bytes), its warps' and warpgroups' exchange areas and its
// __syncthreads barrier.
struct Block {
  std::vector<unsigned char> smem_buf;
  unsigned char* smem_base = nullptr;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<std::unique_ptr<WarpGroup>> warpgroups;
  std::unique_ptr<std::barrier<>> bar;
  void init(int nt, int smem_bytes) {
    smem_buf.assign(smem_bytes + 1024 + 16, 0xFF);
    smem_base = smem_buf.data() +
                (1024 - reinterpret_cast<uintptr_t>(smem_buf.data()) % 1024) %
                    1024;
    warps.clear();
    for (int w = 0; w < (nt + 31) / 32; ++w) warps.emplace_back(new Warp);
    warpgroups.clear();
    for (int w = 0; nt % 128 == 0 && w < nt / 128; ++w)
      warpgroups.emplace_back(new WarpGroup);
    bar.reset(new std::barrier<>(nt));
  }
};
inline thread_local Block* blk;            // the calling thread's block
inline thread_local unsigned char* smem_base;   // blk's smem_base
inline unsigned char* smem() { return smem_base; }
struct WgOp { float* d; int n, ta, tb; uint64_t a, b; };
inline thread_local std::vector<WgOp> wg_cur;
inline thread_local std::vector<std::vector<WgOp>> wg_groups;
struct TmaStore;
inline thread_local std::vector<TmaStore> bulk_cur;
inline thread_local std::vector<std::vector<TmaStore>> bulk_groups;
inline void reset_mbarriers();
struct Copy { void* dst; const void* src; int n, src_n; };
inline thread_local std::vector<Copy> cur;
inline thread_local std::vector<std::vector<Copy>> pending;
inline Warp& my_warp() { return *blk->warps[tIdx.x / 32]; }

// One CUDA thread of block b: its indices and block, the kernel, and the
// check that it left no asynchronous copy or product pending.
inline void run_thread(Block* b, int t, dim3 bi,
                       const std::function<void()>& fn) {
  tIdx = dim3(t, 0, 0);
  bIdx = bi;
  blk = b;
  smem_base = b->smem_base;
  cur.clear();
  pending.clear();
  wg_cur.clear();
  wg_groups.clear();
  bulk_cur.clear();
  bulk_groups.clear();
  fn();
  if (!pending.empty() || !cur.empty()) {
    std::fprintf(stderr, "a thread left cp.async groups pending\n");
    std::abort();
  }
  if (!wg_groups.empty() || !wg_cur.empty()) {
    std::fprintf(stderr, "a thread left wgmma groups pending\n");
    std::abort();
  }
  if (!bulk_groups.empty() || !bulk_cur.empty()) {
    std::fprintf(stderr, "a thread left TMA stores unread\n");
    std::abort();
  }
}

// kernel<<<grid, block, smem_bytes, stream>>>(...) becomes
// launch(grid, block, smem_bytes, stream, [=] { kernel(...); }).
inline void launch(dim3 grid, dim3 block, int smem_bytes, void*,
                   std::function<void()> fn) {
  gDim = grid;
  bDim = block;
  const int nt = block.x;
  Block b;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        b.init(nt, smem_bytes);
        reset_mbarriers();
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t)
          ts.emplace_back(
              [&, t, bx, by, bz] { run_thread(&b, t, dim3(bx, by, bz), fn); });
        for (auto& th : ts) th.join();
      }
}

// A cooperative launch (cudaLaunchCooperativeKernel): every block of the
// grid exists at once, each with its own shared memory, and
// cooperative_groups::this_grid().sync() is a grid-wide barrier.  Between
// two barriers the blocks run one at a time, in order of their index
// (block 0 first), a schedule a GPU may take: a block that reads what
// another writes in the same phase (a read not ordered by the barrier)
// sees block 0's writes from block 1 on, deterministically.  A barrier
// after a block has returned is a deadlock on a GPU and fails here.  A
// static __shared__ array would be one object for all blocks: kernels
// launched so use dynamic shared memory only.
struct Coop {
  std::mutex mu;
  std::vector<std::condition_variable> cvs;   // one a block: its turn came
  int nblocks = 0, turn = 0, arrived = 0;
  std::vector<char> done;
  std::vector<int> threads_left;
  int nt = 0;
  // the next block in order that has not returned, from block b
  int next(int b) {
    for (int i = 1; i <= nblocks; ++i) {
      const int c = (b + i) % nblocks;
      if (!done[c]) return c;
    }
    return -1;
  }
  // the turn to block b, waking its waiting threads (mu held)
  void pass(int b) {
    turn = b;
    if (b >= 0) cvs[b].notify_all();
  }
};
inline Coop* coop;
inline thread_local int coop_block = -1;

inline void coop_wait_turn(std::unique_lock<std::mutex>& lock) {
  coop->cvs[coop_block].wait(lock,
                             [] { return coop->turn == coop_block; });
}

inline void grid_sync() {
  if (coop == nullptr) {
    std::fprintf(stderr, "a grid sync outside a cooperative launch\n");
    std::abort();
  }
  blk->bar->arrive_and_wait();           // the whole block is here
  std::unique_lock<std::mutex> lock(coop->mu);
  for (char d : coop->done)
    if (d) {
      std::fprintf(stderr, "a grid sync after a block returned\n");
      std::abort();
    }
  if (++coop->arrived == coop->nt) {     // the block's last thread
    coop->arrived = 0;
    coop->pass(coop->next(coop_block));
  }
  coop->cvs[coop_block].wait(lock, [] {
    return coop->arrived == 0 && coop->turn == coop_block;
  });
}

inline void launch_cooperative(dim3 grid, dim3 block, int smem_bytes,
                               std::function<void()> fn) {
  gDim = grid;
  bDim = block;
  const int nt = block.x;
  const int nb = grid.x * grid.y * grid.z;
  reset_mbarriers();
  std::vector<std::unique_ptr<Block>> blocks;
  for (int i = 0; i < nb; ++i) {
    blocks.emplace_back(new Block);
    blocks.back()->init(nt, smem_bytes);
  }
  Coop state;
  state.cvs = std::vector<std::condition_variable>(nb);
  state.nblocks = nb;
  state.nt = nt;
  state.done.assign(nb, 0);
  state.threads_left.assign(nb, nt);
  coop = &state;
  std::vector<std::thread> ts;
  for (int i = 0; i < nb; ++i) {
    const dim3 bi(i % grid.x, i / grid.x % grid.y, i / (grid.x * grid.y));
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, i, t, bi] {
        coop_block = i;
        {
          std::unique_lock<std::mutex> lock(coop->mu);
          coop_wait_turn(lock);
        }
        run_thread(blocks[i].get(), t, bi, fn);
        std::unique_lock<std::mutex> lock(coop->mu);
        if (--coop->threads_left[i] == 0) {   // the block has returned
          coop->done[i] = 1;
          coop->pass(coop->next(i));
        }
      });
  }
  for (auto& th : ts) th.join();
  coop = nullptr;
}
// A poll that found a word not yet written.  Under a cooperative launch
// the turn passes to the next block that has not returned, and the thread
// waits until the turn is its block's again: blocks that wait on each
// other's words (slstm's tagged ring) then run one at a time, each until
// it waits, a schedule a GPU may take, so a read that does not wait for
// its word reads it before it is written.  Elsewhere the thread yields.
inline void poll_miss() {
  if (coop == nullptr) {
    std::this_thread::yield();
    return;
  }
  std::unique_lock<std::mutex> lock(coop->mu);
  if (coop->turn == coop_block) coop->pass(coop->next(coop_block));
  coop->cvs[coop_block].wait(lock,
                             [] { return coop->turn == coop_block; });
}
inline void syncthreads() { blk->bar->arrive_and_wait(); }
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

inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu::SMS;
  return 0;
}

// Cooperative launches (a persistent grid with a grid-wide barrier; see
// emu::launch_cooperative): one block a multiprocessor is co-resident, so
// a grid of more than SMS blocks is refused, as the driver refuses one
// larger than the card holds.
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, ...) {
  *n = 1;
  return 0;
}
template <typename... P, size_t... I>
void emu_call(void (*k)(P...), void** args, std::index_sequence<I...>) {
  k(*static_cast<std::remove_reference_t<P>*>(args[I])...);
}
template <typename... P>
int cudaLaunchCooperativeKernel(void (*k)(P...), dim3 grid, dim3 block,
                                void** args, size_t smem_bytes,
                                cudaStream_t) {
  if (grid.x * grid.y * grid.z > (unsigned)emu::SMS)
    return cudaErrorCooperativeLaunchTooLarge;
  emu::launch_cooperative(grid, block, (int)smem_bytes, [=] {
    emu_call(k, args, std::index_sequence_for<P...>{});
  });
  return cudaSuccess;
}
namespace cooperative_groups {
struct grid_group {
  void sync() { emu::grid_sync(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
template <typename T>
inline T __ldcg(const T* p) {
  return *p;
}

// The ring:: and slt:: primitives that scan_ring.cuh writes in inline PTX
// (the translation drops those definitions): gpu-scope relaxed, acquire
// and release accesses as C++ atomics of the same order, a poll's pause,
// the identity that hides a value from the compiler, an FMA of a bf16
// pair's half.
#include <atomic>
namespace ring {
typedef unsigned long long u64;
inline u64 ld_relaxed_u64(const u64* p) {
  return std::atomic_ref<u64>(*const_cast<u64*>(p))
      .load(std::memory_order_relaxed);
}
inline void st_relaxed_u64(u64* p, u64 v) {
  std::atomic_ref<u64>(*p).store(v, std::memory_order_relaxed);
}
inline unsigned ld_acquire_u32(const unsigned* p) {
  return std::atomic_ref<unsigned>(*const_cast<unsigned*>(p))
      .load(std::memory_order_acquire);
}
inline void st_release_u32(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned>(*p).store(v, std::memory_order_release);
}
inline void poll_pause() { emu::poll_miss(); }
inline unsigned opaque32(unsigned x) { return x; }
inline u64 opaque64(u64 x) { return x; }
}  // namespace ring
namespace slt {
inline void fma_lo(float& acc, float h, uint32_t w) {
  acc = std::fma(h, __uint_as_float(w << 16), acc);
}
inline void fma_hi(float& acc, float h, uint32_t w) {
  acc = std::fma(h, __uint_as_float(w & 0xFFFF0000u), acc);
}
}  // namespace slt

// The tc:: primitives that mma_bf16.cuh writes in inline PTX (the
// translation drops those definitions).
namespace tc {
// A shared address: the offset from the dynamic shared memory's start.
inline uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - emu::smem_base);
}
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

// ---------------------------------------------------------------------------
// Hopper: the driver's tensor maps and the wg:: primitives that
// wgmma_bf16.cuh writes in inline PTX (the translation drops those
// definitions).
// ---------------------------------------------------------------------------
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
// What an encoding keeps (the driver's is 128 opaque bytes).
struct CUtensorMap {
  const unsigned char* base;
  uint32_t rank, box[5];
  uint64_t dims[5], strides[5];   // strides[i]: bytes of a step of dim i + 1
};
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
#define CUDART_VERSION 12000

// cuTensorMapEncodeTiled for bf16 with the 128-byte swizzle, under TMA's
// rules: a 16-byte aligned base, strides multiples of 16 bytes, box sides
// of 1 to 256 and an inner side of 16 to 128 bytes.
inline CUresult emu_encode_tiled(CUtensorMap* m, CUtensorMapDataType type,
                                 cuuint32_t rank, void* base,
                                 const cuuint64_t* dims,
                                 const cuuint64_t* strides,
                                 const cuuint32_t* box,
                                 const cuuint32_t* step,
                                 CUtensorMapInterleave, CUtensorMapSwizzle sw,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill) {
  if (type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ||
      sw != CU_TENSOR_MAP_SWIZZLE_128B || rank < 1 || rank > 5 ||
      reinterpret_cast<uintptr_t>(base) % 16 || box[0] * 2 > 128 ||
      box[0] * 2 % 16)
    return 1;
  m->base = static_cast<const unsigned char*>(base);
  m->rank = rank;
  for (uint32_t i = 0; i < rank; ++i) {
    if (box[i] < 1 || box[i] > 256 || step[i] != 1 || dims[i] < 1) return 1;
    if (i + 1 < rank && strides[i] % 16) return 1;
    m->box[i] = box[i];
    m->dims[i] = dims[i];
    if (i + 1 < rank) m->strides[i] = strides[i];
  }
  return CUDA_SUCCESS;
}

inline int cudaGetDriverEntryPoint(const char* symbol, void** fn,
                                   unsigned long long,
                                   cudaDriverEntryPointQueryResult* found) {
  if (std::strcmp(symbol, "cuTensorMapEncodeTiled") != 0) return 1;
  *fn = reinterpret_cast<void*>(&emu_encode_tiled);
  *found = cudaDriverEntryPointSuccess;
  return 0;
}

namespace emu {
struct Tma {
  unsigned char* dst;
  CUtensorMap map;
  long long c[3];
};
struct TmaStore {
  const unsigned char* src;
  CUtensorMap map;
  long long c[3];
};
struct Mbar {
  int count = 0, pending = 0;    // arrivals a phase needs, and still owes
  long long tx = 0;              // transaction bytes still owed
  unsigned phases = 0;           // phases completed
  std::vector<Tma> loads;        // issued, not landed
};
inline std::mutex mbar_mu;
inline std::condition_variable mbar_cv;
inline std::map<const void*, Mbar> mbars;
inline void reset_mbarriers() {
  std::lock_guard<std::mutex> lock(mbar_mu);
  mbars.clear();
}
[[noreturn]] inline void fail(const char* what) {
  std::fprintf(stderr, "%s\n", what);
  std::abort();
}
inline Mbar& mbar(const void* p) {
  auto it = mbars.find(p);
  if (it == mbars.end()) fail("an mbarrier used before its init");
  return it->second;
}
inline uint64_t box_bytes(const CUtensorMap& m) {
  uint64_t n = 2;
  for (uint32_t i = 0; i < m.rank; ++i) n *= m.box[i];
  return n;
}
// Land a TMA box: its element (x, y, z) is the tensor's at c + (x, y, z),
// or 0 outside it, at byte b = 2 ((z Y + y) X + x) of the box, with the
// 128-byte swizzle's chunk b bits 4-6 XOR b bits 7-9.
inline void land(const Tma& t) {
  const CUtensorMap& m = t.map;
  if (tc::smem_u32(t.dst) % 1024)
    fail("a 128-byte-swizzled TMA box not on 1024 bytes");
  const uint32_t X = m.box[0], Y = m.rank > 1 ? m.box[1] : 1,
                 Z = m.rank > 2 ? m.box[2] : 1;
  uint64_t b = 0;
  for (uint32_t z = 0; z < Z; ++z)
    for (uint32_t y = 0; y < Y; ++y)
      for (uint32_t x = 0; x < X; ++x, b += 2) {
        const long long g[3] = {t.c[0] + x, t.c[1] + y, t.c[2] + z};
        bool in = true;
        uint64_t off = 0;
        for (uint32_t i = 0; i < m.rank; ++i) {
          in = in && g[i] >= 0 && g[i] < (long long)m.dims[i];
          if (in) off += (i == 0 ? 2 : m.strides[i - 1]) * (uint64_t)g[i];
        }
        unsigned char* dst = t.dst + (b ^ (((b >> 7) & 7) << 4));
        if (in)
          std::memcpy(dst, m.base + off, 2);
        else
          std::memset(dst, 0, 2);
      }
}
// Store a TMA box from shared memory: the inverse of land, writing nothing
// outside the tensor.
inline void store(const TmaStore& t) {
  const CUtensorMap& m = t.map;
  if (tc::smem_u32(t.src) % 1024)
    fail("a 128-byte-swizzled TMA box not on 1024 bytes");
  const uint32_t X = m.box[0], Y = m.rank > 1 ? m.box[1] : 1,
                 Z = m.rank > 2 ? m.box[2] : 1;
  uint64_t b = 0;
  for (uint32_t z = 0; z < Z; ++z)
    for (uint32_t y = 0; y < Y; ++y)
      for (uint32_t x = 0; x < X; ++x, b += 2) {
        const long long g[3] = {t.c[0] + x, t.c[1] + y, t.c[2] + z};
        bool in = true;
        uint64_t off = 0;
        for (uint32_t i = 0; i < m.rank; ++i) {
          in = in && g[i] >= 0 && g[i] < (long long)m.dims[i];
          if (in) off += (i == 0 ? 2 : m.strides[i - 1]) * (uint64_t)g[i];
        }
        if (in)
          std::memcpy(const_cast<unsigned char*>(m.base) + off,
                      t.src + (b ^ (((b >> 7) & 7) << 4)), 2);
      }
}
inline void try_complete(Mbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.phases;
    b.pending = b.count;
    mbar_cv.notify_all();
  }
}
// A wait's view of the barrier: its loads land, then whether the phase of
// parity `parity` has completed (mbar_mu held).
inline bool observe(Mbar& b, uint32_t parity) {
  for (const Tma& t : b.loads) {
    land(t);
    b.tx -= (long long)box_bytes(t.map);
  }
  b.loads.clear();
  try_complete(b);
  return (b.phases & 1) != parity;
}
inline void arrive(Mbar& b) {
  if (--b.pending < 0) fail("more mbarrier arrivals than its count");
  try_complete(b);
}

inline WarpGroup& my_warpgroup() {
  const size_t i = tIdx.x / 128;
  if (i >= blk->warpgroups.size()) fail("a wgmma outside a whole warpgroup");
  return *blk->warpgroups[i];
}
// Element (mn, k) of a wgmma operand through its descriptor: start, LBO
// and SBO in 16-byte units; K-major at start + (mn / 8) SBO + (mn % 8) 128
// + 2 k, MN-major at start + (mn / 64) LBO + (k / 8) SBO + (k % 8) 128 +
// 2 (mn % 64); then the 128-byte swizzle of the shared address.
inline float wg_elem(uint64_t desc, bool mn_major, int mn, int k) {
  if (desc >> 62 != 1 || (desc >> 49 & 7) != 0)
    fail("a wgmma descriptor without the 128-byte swizzle at offset 0");
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)(desc >> 16 & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)(desc >> 32 & 0x3FFF) << 4;
  uint32_t a = mn_major ? start + (mn / 64) * lbo + (k / 8) * sbo +
                              (k % 8) * 128 + (mn % 64) * 2
                        : start + (mn / 8) * sbo + (mn % 8) * 128 + k * 2;
  a ^= ((a >> 7) & 7) << 4;
  return tc::half_of(tc::ld16(smem_base + a), 0);
}
// This thread's part of a retired wgmma: its accumulator registers
// 4 j + 2 i + q, (row 16 w + g + 8 i, column 8 j + 2 t + q).
inline void wg_run(const WgOp& op) {
  const int l = tIdx.x % 128, w = l / 32, g = (l % 32) / 4, t = l % 4;
  for (int j = 0; j < op.n / 8; ++j)
    for (int i = 0; i < 2; ++i)
      for (int q = 0; q < 2; ++q) {
        const int row = 16 * w + g + 8 * i, col = 8 * j + 2 * t + q;
        float acc = op.d[4 * j + 2 * i + q];
        for (int k = 0; k < 16; ++k)
          acc += wg_elem(op.a, op.ta, row, k) * wg_elem(op.b, op.tb, col, k);
        op.d[4 * j + 2 * i + q] = acc;
      }
}
inline void wg_issue(float* d, int n, int ta, int tb, uint64_t a,
                     uint64_t b) {
  WarpGroup& g = my_warpgroup();
  const int l = tIdx.x % 128;
  g.a[l] = a;
  g.b[l] = b;
  g.bar.arrive_and_wait();
  bool same = true;
  for (int i = 0; i < 128; ++i) same = same && g.a[i] == a && g.b[i] == b;
  g.bar.arrive_and_wait();
  if (!same) fail("a wgmma's descriptors differ across its warpgroup");
  wg_cur.push_back({d, n, ta, tb, a, b});
}
}  // namespace emu

namespace wg {
inline void fence() {}
inline void commit_group() {
  emu::wg_groups.push_back(std::move(emu::wg_cur));
  emu::wg_cur.clear();
}
// Retire groups until N remain, then wait for the whole warpgroup: a
// group is the warpgroup's, complete for all its threads at once.
template <int N>
inline void wait_group() {
  while ((int)emu::wg_groups.size() > N) {
    for (const emu::WgOp& op : emu::wg_groups.front()) emu::wg_run(op);
    emu::wg_groups.erase(emu::wg_groups.begin());
  }
  emu::my_warpgroup().bar.arrive_and_wait();
}
template <int TA, int TB>
inline void mma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  emu::wg_issue(d, 64, TA, TB, a, b);
}
template <int TA, int TB>
inline void mma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  emu::wg_issue(d, 128, TA, TB, a, b);
}
template <int TA, int TB>
inline void mma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  emu::wg_issue(d, 256, TA, TB, a, b);
}
inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> lock(emu::mbar_mu);
  emu::Mbar& b = emu::mbars[bar];
  b = emu::Mbar();
  b.count = b.pending = (int)count;
}
inline void fence_barrier_init() {}
inline void fence_proxy_async() {}
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(emu::mbar_mu);
  emu::Mbar& b = emu::mbar(bar);
  b.tx += bytes;
  emu::arrive(b);
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(emu::mbar_mu);
  emu::arrive(emu::mbar(bar));
}
// try_wait until the phase completes (each try lands the barrier's loads);
// blocks between tries, and a minute without the phase is a deadlock.
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(emu::mbar_mu);
  const auto until =
      std::chrono::steady_clock::now() + std::chrono::seconds(60);
  while (!emu::observe(emu::mbar(bar), parity))
    if (emu::mbar_cv.wait_until(lock, until) == std::cv_status::timeout)
      emu::fail("an mbarrier wait never ended");
}
inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2) {
  std::lock_guard<std::mutex> lock(emu::mbar_mu);
  emu::mbar(bar).loads.push_back(
      {static_cast<unsigned char*>(dst), *map, {c0, c1, c2}});
  emu::mbar_cv.notify_all();
}
inline void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                         int c1, int c2) {
  emu::bulk_cur.push_back(
      {static_cast<const unsigned char*>(src), *map, {c0, c1, c2}});
}
inline void bulk_commit() {
  emu::bulk_groups.push_back(std::move(emu::bulk_cur));
  emu::bulk_cur.clear();
}
template <int N>
inline void bulk_wait_read() {
  while ((int)emu::bulk_groups.size() > N) {
    for (const emu::TmaStore& t : emu::bulk_groups.front()) emu::store(t);
    emu::bulk_groups.erase(emu::bulk_groups.begin());
  }
}
inline void warpgroup_sync(int) { emu::my_warpgroup().bar.arrive_and_wait(); }
template <int R>
inline void setmaxnreg_dec() {}
template <int R>
inline void setmaxnreg_inc() {}
}  // namespace wg
