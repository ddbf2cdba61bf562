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
// Three launches on the caller's stream: 1. gate-up recomputes g and u
// (x w1, x w3 over d) and forms dh (dy w2^T over d) for a tile, then
// writes h, dg and du to a workspace; 2. dx = dg w1^T + du w3^T over ff;
// 3. the weight gradients, x^T dg and x^T du for a (d, ff) tile or h^T dy
// for an (ff, d) tile, each over the whole of M in one block: no float
// atomics and a fixed order of every sum, so two runs are bit-equal.  The
// workspace is (planes, E, M, ldh) with ldh = ff rounded up to 64 and the
// columns in [ff, ldh) written as 0: bf16 planes h_hi, h_lo, dg, du, f32
// planes h, dg, du.  Three designs, chosen by the shape, the dtype and the
// pointers' alignment alone (design_of; ops.bwd_design is the same rule):
//
// wgmma (bf16, d and ff multiples of 8, every pointer 16-byte aligned:
// what TMA can describe).  What bounds it: eight products of 2 E M d ff
// operations each (five with gelu), at granite's training shape (E 32,
// M 1280, d 1024, ff 512) 344 GFLOP, 0.35 ms at 989 TFLOP/s; the bytes
// that must move (x, dy, the weights, their gradients, dx) about 0.11 ms
// at 3.35 TB/s, but the workspace adds about 0.4 GB of writes and reads.
// So the kernels must keep the tensor cores fed, which only warpgroup
// wgmma can (mma.sync peaks far below the card's rate), from operands
// staged without spending the consumers' issue slots.  Each launch is a
// persistent grid (a block per SM walking the tiles in a fixed order) of
// warp-specialised blocks of three warpgroups: one thread of the first
// (the producer, its registers given back by setmaxnreg) keeps a ring of
// shared-memory stages full through TMA loads that complete on each
// stage's full mbarrier; two consumer warpgroups each own 64 rows of a
// 128-row tile and run m64nNk16 wgmma on the landed stages, both operands
// read from shared memory through descriptors, keeping one group in flight
// and releasing a stage through its empty mbarrier once its group is
// done.  The producer runs ahead into the block's next tile while the
// consumers store this one.  Stages are 64 deep in k, one 128-byte row of
// the 128-byte swizzle (wgmma_bf16.cuh), and an operand is read as it lies
// in device memory, K-major or MN-major by the instruction's transpose
// bit, so x^T, h^T, w1^T, w3^T and w2^T need no copies; an MN-major
// operand wider than 64 is boxes side by side (the descriptor's LBO).
// TMA's 3-D boxes (inner, M or d, expert) fill what lies past M, d or ff
// with 0, and its stores write nothing past them: each consumer writes
// its outputs to shared memory in the boxes' layout and TMA stores them
// (element stores from the fragments took longer than the products: the
// epilogue runs on 8 warps an SM).
//   1. gate-up: tiles (128 of M, 64 of ff), 4 stages of x, dy (128 x 64),
//      w1 | w3 (MN-major, one m64n128 product) and w2 (K-major, w2^T's
//      tile, m64n64); 96 accumulator registers a thread; the output
//      staged in the tile's last stage.
//   2. dx: tiles (128 of M, 256 of d), 4 stages of dg and w1 (K-major
//      w1^T's tile), then of du and w3: m64n256k16.
//   3. dw: tiles (128, 128), 4 stages of three (64 of M x 128) slots, all
//      MN-major: x, dg, du for dw1 and dw3 (two m64n128 products on one
//      x); h_hi, dy, h_lo for dw2 (two on one dy).
// Where the time goes at granite's shape (NVIDIA H100, 700 W; PERF.md,
// chip_smoke.py's launch_ms): the three launches take about 0.27, 0.13
// and 0.28 ms, 480, 660 and 610 TFLOP/s of their products; the gate-up
// launch, whose epilogue forms and stores four planes, is the slowest.

// mma.sync (bf16, any other shape): the three launches as grids of 64 x 64
// output tiles, 4 warps each a 32 x 32 patch on mma.sync m16n8k16, operands
// loaded element by element into a ring of 3 k-tiles 32 deep (rows padded
// for conflict-free ldmatrix); a tile whose k runs along the rows of its
// matrix is loaded k-major and given to mma.sync through ldmatrix.trans.
//
// fma (f32): the same three launches as f32 FMAs on the CUDA cores.
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
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the workspace is the caller's), does not synchronise,
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int HCOLS = 64;           // workspace rows: ff rounded up to this
constexpr int MAX_GRID_YZ = 65535;  // gridDim.y and gridDim.z limit

__host__ __device__ __forceinline__ int h_cols(int ff) {
  return (ff + HCOLS - 1) / HCOLS * HCOLS;
}

// h and the gradients dg, du of the loss through h = act(g, u), given dh:
// act 0 is silu(g) u (jax.nn.silu), act 1 the tanh-approximated gelu(g)
// (jax.nn.gelu's default), for which du is 0.  In f32, the sigmoid and
// tanh from the fast exponential and reciprocal (a relative error near
// 2^-21 where |g| is near 10, so h keeps the 16 bits its bf16 pair
// carries): the epilogue runs on 8 warps an SM and is latency-bound.
template <int ACT>
__device__ __forceinline__ void act_grad(float g, float u, float dh,
                                         float* h, float* dg, float* du) {
  if (ACT == 0) {
    const float s = __fdividef(1.f, 1.f + __expf(-g));
    const float sg = g * s;
    *h = sg * u;
    *dg = dh * u * s * (1.f + g * (1.f - s));
    *du = dh * sg;
  } else {
    const float k = 0.7978845608028654f;      // sqrt(2 / pi)
    const float c = 0.044715f;
    // tanh(z) = 1 - 2 / (e^2z + 1)
    const float t = 1.f - 2.f * __fdividef(
        1.f, 1.f + __expf(2.f * k * (g + c * g * g * g)));
    *h = 0.5f * g * (1.f + t);
    *dg = dh * (0.5f * (1.f + t) +
                0.5f * g * (1.f - t * t) * k * (1.f + 3.f * c * g * g));
    *du = 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16, the wgmma design: three persistent warp-specialised kernels.
// ---------------------------------------------------------------------------
namespace hop {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // a tile's rows: two consumers of 64
constexpr int BK = 64;           // k of a stage: one 128-byte row of bf16
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int BOX = 64 * 64 * 2;  // bytes of a 64 x 64 box
// Descriptor strides (wgmma_bf16.cuh).  K-major: 8-row groups 1024 bytes
// apart (SBO), LBO unused.  MN-major: groups of 8 k-rows 1024 bytes apart
// (SBO), 64-wide atoms along MN a box apart (LBO: two boxes side by side
// make one operand 128 wide).
constexpr uint32_t LBO_KM = 16, SBO_KM = 1024;
constexpr uint32_t LBO_MN = BOX, SBO_MN = 1024;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// The descriptor of k16 slice kk of the operand tile at p: K-major, the
// next slice 32 bytes on; MN-major, 16 rows (2048 bytes) on.
__device__ __forceinline__ uint64_t km(const unsigned char* p, int kk) {
  return wg::desc(p + 32 * kk, LBO_KM, SBO_KM);
}
__device__ __forceinline__ uint64_t mn(const unsigned char* p, int kk) {
  return wg::desc(p + 2048 * kk, LBO_MN, SBO_MN);
}

// Each launch's stage (byte offsets of its boxes) and ring depth.
// gate-up: x, dy (128 M x 64 d each), w1, w3 (64 d x 64 ff), w2 (64 ff x
// 64 d).
constexpr int GU_X = 0, GU_DY = 2 * BOX, GU_W1 = 4 * BOX, GU_W3 = 5 * BOX,
              GU_W2 = 6 * BOX, GU_STAGE = 7 * BOX, GU_STAGES = 4;
// dx: dg (128 M x 64 ff) and w1 (256 d x 64 ff), or du and w3.
constexpr int DX_A = 0, DX_B = 2 * BOX, DX_STAGE = 6 * BOX, DX_STAGES = 4;
// dw: three slots of two (64 M x 64) boxes: x, dg, du for a tile of dw1
// and dw3; h_hi, dy, h_lo for a tile of dw2.
constexpr int DW_SLOT = 2 * BOX, DW_STAGE = 3 * DW_SLOT, DW_STAGES = 4;

// Each consumer's two staging boxes of output (Out), where a launch has
// them apart from its ring.
constexpr int OUT_BYTES = CONSUMERS * 2 * BOX;

// Dynamic shared memory of a block: the ring's stages, `out` bytes of
// output staging boxes, a full and an empty barrier per stage, and room
// to align it all to 1024 bytes.
constexpr int smem_bytes(int stage, int stages, int out) {
  return stage * stages + out + 16 * stages + 1024;
}

// A stage and the parity of its barriers' current phase, advanced in the
// same order by the producer and the consumers.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The ring's base (the block's dynamic shared memory aligned to 1024
// bytes; OUT bytes of staging boxes follow the stages) and its barriers,
// initialised: full (one arrival, the producer's, and the stage's TMA
// bytes), empty (one arrival per consumer).
template <int STAGES, int STAGE, int OUT>
__device__ __forceinline__ unsigned char* init_ring(unsigned char* raw,
                                                    uint64_t** full,
                                                    uint64_t** empty) {
  unsigned char* sm = raw + ((1024 - (tc::smem_u32(raw) & 1023)) & 1023);
  *full = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE + OUT);
  *empty = *full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(*full + s, 1);
      wg::mbar_init(*empty + s, CONSUMERS);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();
  return sm;
}

// The producer: for each of the block's tiles, KT stages, each loaded by
// load(stage, k, tile) which issues its TMA boxes on the stage's full
// barrier and returns their bytes; a stage is refilled once both
// consumers have released it.
template <int STAGES, int STAGE, class Load>
__device__ __forceinline__ void produce(unsigned char* sm, uint64_t* full,
                                        uint64_t* empty, int tiles, int KT,
                                        Load load) {
  Ring ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int k = 0; k < KT; ++k, ring.next(STAGES)) {
      wg::mbar_wait(empty + ring.stage, ring.phase ^ 1);
      unsigned char* st = sm + ring.stage * STAGE;
      load(st, full + ring.stage, k, t);
    }
}

// A consumer's k-loop over one tile: step(stage) issues the warpgroup's
// wgmma on a landed stage; one group stays in flight, and a stage is
// released once its group has completed.  Returns with the accumulators
// complete and the tile's last stage, which it keeps (unreleased) with
// HOLD_LAST.
template <int STAGES, int STAGE, bool HOLD_LAST = false, class Step>
__device__ __forceinline__ int consume(const unsigned char* sm,
                                       uint64_t* full, uint64_t* empty,
                                       Ring& ring, int KT, Step step) {
  const bool leader = threadIdx.x % 128 == 0;
  int prev = 0;
  for (int k = 0; k < KT; ++k) {
    wg::mbar_wait(full + ring.stage, ring.phase);
    wg::fence();
    step(sm + ring.stage * STAGE);
    wg::commit_group();
    wg::wait_group<1>();
    if (k > 0 && leader) wg::mbar_arrive(empty + prev);
    prev = ring.stage;
    ring.next(STAGES);
  }
  wg::wait_group<0>();
  if (leader && !HOLD_LAST) wg::mbar_arrive(empty + prev);
  return prev;
}

template <int R>
__device__ __forceinline__ void zero(float (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = 0.f;
}

// A thread's place in its consumer's 64 rows: accumulator register
// 4 j + 2 i + q is (row(i), col(j) + q).
struct Frag {
  int r, c;
  __device__ __forceinline__ Frag() {
    const int l = threadIdx.x % 128;
    r = 16 * (l / 32) + (l % 32) / 4;
    c = 2 * (l % 4);
  }
  __device__ __forceinline__ int row(int i) const { return r + 8 * i; }
  __device__ __forceinline__ int col(int j) const { return c + 8 * j; }
};

// A consumer's output: 64 x 64 boxes written to shared memory as a TMA
// load of the same map would land them (128-byte rows, 128-byte swizzle)
// and stored by TMA, which writes nothing outside the tensor.  Two staging
// boxes in turn: one is written while the other's store reads it.
struct Out {
  unsigned char *buf0, *buf1;   // the consumer's two staging boxes
  int c, n = 0;                 // the consumer, and its boxes stored so far
  __device__ __forceinline__ Out(unsigned char* b0, unsigned char* b1,
                                 int consumer)
      : buf0(b0), buf1(b1), c(consumer) {}
  // The consumer's own pair of the launch's staging boxes.
  __device__ __forceinline__ Out(unsigned char* sm_out, int consumer)
      : Out(sm_out + 2 * BOX * consumer, sm_out + (2 * consumer + 1) * BOX,
            consumer) {}
  // The next staging box, once the store that last read it is done.
  __device__ __forceinline__ unsigned char* next() {
    if (threadIdx.x % 128 == 0) wg::bulk_wait_read<1>();
    wg::warpgroup_sync(c);
    return n & 1 ? buf1 : buf0;
  }
  // Store the box written since next() at (c0, c1, c2) of map.
  __device__ __forceinline__ void store(const CUtensorMap* map, int c0,
                                        int c1, int c2) {
    wg::fence_proxy_async();
    wg::warpgroup_sync(c);
    if (threadIdx.x % 128 == 0) {
      wg::tma_store_3d(map, n & 1 ? buf1 : buf0, c0, c1, c2);
      wg::bulk_commit();
    }
    ++n;
  }
  // Every store has read its box (before the consumer exits, or its boxes
  // are reused).
  __device__ __forceinline__ void drain() {
    if (threadIdx.x % 128 == 0) wg::bulk_wait_read<0>();
  }
};

// A bf16 pair at (row r, column col) of a staging box.
__device__ __forceinline__ void put(unsigned char* box, int r, int col,
                                    uint32_t v) {
  *reinterpret_cast<uint32_t*>(box + r * 128 + (((col >> 3) ^ (r & 7)) << 4) +
                               (col & 7) * 2) = v;
}

// Columns [64 h, 64 h + 64) of a consumer's (64, N) accumulator, rounded
// once, into a staging box.
template <int N>
__device__ __forceinline__ void put_acc(unsigned char* box,
                                        const float (&acc)[N / 2], int h) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 4 * (8 * h + j) + 2 * i;
      put(box, f.row(i), f.col(j), tc::pack_bf16(acc[k], acc[k + 1]));
    }
}

// 1. gate-up: tiles (E, M / 128, ldh / 64), f fastest.  g = x w1, u = x w3
// (one m64n128 product: w1's and w3's boxes side by side) and dh = dy w2^T
// of a (128, 64) tile over d, then h as a bf16 pair, dg and du into the
// workspace's planes.  The output is staged in the tile's last stage,
// which each consumer keeps until its stores have read it: in its own x
// and dy boxes, which the other consumer does not read (so the ring has
// a fourth stage where apart staging boxes would not fit).
template <int ACT>
__global__ void __launch_bounds__(THREADS, 1)
mg_bwd_gate_up_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tdy,
                      const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap tw3,
                      const __grid_constant__ CUtensorMap tw2,
                      const __grid_constant__ CUtensorMap tws, int E, int M,
                      int d, int ff) {
  extern __shared__ __align__(1024) unsigned char hop_smem[];
  uint64_t *full, *empty;
  unsigned char* sm =
      init_ring<GU_STAGES, GU_STAGE, 0>(hop_smem, &full, &empty);
  const int ldh = h_cols(ff);
  const int m_tiles = (M + BM - 1) / BM, f_tiles = ldh / 64;
  const int tiles = E * m_tiles * f_tiles, KT = (d + BK - 1) / BK;
  if (threadIdx.x < 128) {
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce<GU_STAGES, GU_STAGE>(
          sm, full, empty, tiles, KT,
          [&](unsigned char* st, uint64_t* bar, int k, int t) {
            const int e = t / (m_tiles * f_tiles);
            const int m0 = t / f_tiles % m_tiles * BM, f0 = t % f_tiles * 64;
            wg::mbar_expect_tx(bar, (ACT == 0 ? 7 : 6) * BOX);
            wg::tma_load_3d(st + GU_X, &tx, bar, k * BK, m0, e);
            wg::tma_load_3d(st + GU_DY, &tdy, bar, k * BK, m0, e);
            wg::tma_load_3d(st + GU_W1, &tw1, bar, f0, k * BK, e);
            if (ACT == 0)
              wg::tma_load_3d(st + GU_W3, &tw3, bar, f0, k * BK, e);
            wg::tma_load_3d(st + GU_W2, &tw2, bar, k * BK, f0, e);
          });
    return;
  }
  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;
  const Frag f;
  Ring ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int e = t / (m_tiles * f_tiles);
    const int m0 = t / f_tiles % m_tiles * BM + 64 * c, f0 = t % f_tiles * 64;
    float agu[ACT == 0 ? 64 : 32], adh[32];     // g | u, and dh
    zero(agu);
    zero(adh);
    const int last = consume<GU_STAGES, GU_STAGE, true>(
        sm, full, empty, ring, KT, [&](const unsigned char* st) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            if constexpr (ACT == 0)
              wg::mma_n128<0, 1>(agu, km(st + GU_X + c * BOX, kk),
                                 mn(st + GU_W1, kk));
            else
              wg::mma_n64<0, 1>(agu, km(st + GU_X + c * BOX, kk),
                                mn(st + GU_W1, kk));
            wg::mma_n64<0, 0>(adh, km(st + GU_DY + c * BOX, kk),
                              km(st + GU_W2, kk));
          }
        });
    unsigned char* st = sm + last * GU_STAGE;
    Out out(st + GU_X + c * BOX, st + GU_DY + c * BOX, c);
    if (m0 >= M) {             // the consumer's rows are all past M
      if (threadIdx.x % 128 == 0) wg::mbar_arrive(empty + last);
      continue;
    }
    // the planes h_hi, h_lo, dg, du of the consumer's (64, 64) as bf16
    // pairs, 0 past ff
    uint32_t pk[4][16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = f0 + f.col(j);
        float h[2], hl[2], dg[2], du[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = 4 * j + 2 * i + q;
          act_grad<ACT>(agu[k], ACT == 0 ? agu[32 + k] : 0.f, adh[k], &h[q],
                        &dg[q], &du[q]);
          if (col + q >= ff) h[q] = dg[q] = du[q] = 0.f;
          hl[q] = h[q] - __bfloat162float(__float2bfloat16(h[q]));
        }
        pk[0][2 * j + i] = tc::pack_bf16(h[0], h[1]);
        pk[1][2 * j + i] = tc::pack_bf16(hl[0], hl[1]);
        pk[2][2 * j + i] = tc::pack_bf16(dg[0], dg[1]);
        pk[3][2 * j + i] = tc::pack_bf16(du[0], du[1]);
      }
#pragma unroll
    for (int p = 0; p < (ACT == 0 ? 4 : 3); ++p) {
      unsigned char* box = out.next();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          put(box, f.row(i), f.col(j), pk[p][2 * j + i]);
      out.store(&tws, f0, m0, p * E + e);
    }
    out.drain();
    if (threadIdx.x % 128 == 0) wg::mbar_arrive(empty + last);
  }
}

// 2. dx: tiles (E, M / 128, d / 256), d fastest.  dg w1^T + du w3^T of a
// (128, 256) tile (m64n256k16): one sum over 2 ldh (dg's k-steps, then
// du's), so a stage holds one pair of operands.
template <int ACT>
__global__ void __launch_bounds__(THREADS, 1)
mg_bwd_dx_kernel(const __grid_constant__ CUtensorMap tws,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw3,
                 const __grid_constant__ CUtensorMap tdx, int E, int M, int d,
                 int ff) {
  extern __shared__ __align__(1024) unsigned char hop_smem[];
  uint64_t *full, *empty;
  unsigned char* sm =
      init_ring<DX_STAGES, DX_STAGE, OUT_BYTES>(hop_smem, &full, &empty);
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (d + 255) / 256;
  const int KF = h_cols(ff) / BK;          // k-steps of one product
  const int tiles = E * m_tiles * n_tiles, KT = (ACT == 0 ? 2 : 1) * KF;
  if (threadIdx.x < 128) {
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce<DX_STAGES, DX_STAGE>(
          sm, full, empty, tiles, KT,
          [&](unsigned char* st, uint64_t* bar, int k, int t) {
            const int e = t / (m_tiles * n_tiles);
            const int m0 = t / n_tiles % m_tiles * BM, n0 = t % n_tiles * 256;
            const bool up = k >= KF;       // du w3^T's k-steps
            const int k0 = (up ? k - KF : k) * BK;
            wg::mbar_expect_tx(bar, DX_STAGE);
            wg::tma_load_3d(st + DX_A, &tws, bar, k0, m0, (up ? 3 : 2) * E + e);
            wg::tma_load_3d(st + DX_B, up ? &tw3 : &tw1, bar, k0, n0, e);
          });
    return;
  }
  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;
  Out out(sm + DX_STAGES * DX_STAGE, c);
  Ring ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int e = t / (m_tiles * n_tiles);
    const int m0 = t / n_tiles % m_tiles * BM + 64 * c, n0 = t % n_tiles * 256;
    float acc[128];
    zero(acc);
    consume<DX_STAGES, DX_STAGE>(
        sm, full, empty, ring, KT, [&](const unsigned char* st) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wg::mma_n256<0, 0>(acc, km(st + DX_A + c * BOX, kk),
                               km(st + DX_B, kk));
        });
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (m0 < M && n0 + 64 * h < d) {
        put_acc<256>(out.next(), acc, h);
        out.store(&tdx, n0 + 64 * h, m0, e);
      }
  }
  out.drain();
}

// 3. The weight gradients, each (128, 128) tile over the whole of M in one
// block, in order: tiles [0, t13) of dw1 = x^T dg and dw3 = x^T du (E, d /
// 128, ldh / 128), the rest of dw2 = h^T dy (E, ldh / 128, d / 128) with h
// as its bf16 pair.  A box wholly past d or ldh is not loaded: its stale
// contents reach only rows or columns that are not stored.
template <int ACT>
__global__ void __launch_bounds__(THREADS, 1)
mg_bwd_dw_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ CUtensorMap tws,
                 const __grid_constant__ CUtensorMap tdw1,
                 const __grid_constant__ CUtensorMap tdw3,
                 const __grid_constant__ CUtensorMap tdw2, int E, int M,
                 int d, int ff) {
  extern __shared__ __align__(1024) unsigned char hop_smem[];
  uint64_t *full, *empty;
  unsigned char* sm =
      init_ring<DW_STAGES, DW_STAGE, OUT_BYTES>(hop_smem, &full, &empty);
  const int ldh = h_cols(ff);
  const int d_tiles = (d + 127) / 128, h_tiles = (ldh + 127) / 128;
  const int per_e = d_tiles * h_tiles, t13 = E * per_e;
  const int KT = (M + BK - 1) / BK;
  // tile t's expert, its 128 rows of d (dw1, dw3) and of ff (dw2) at d0
  // and f0
  auto where = [&](int t, int* e, int* d0, int* f0) {
    const bool w13 = t < t13;
    const int u = w13 ? t : t - t13;
    *e = u / per_e;
    const int a = u / (w13 ? h_tiles : d_tiles) % (w13 ? d_tiles : h_tiles);
    const int b = u % (w13 ? h_tiles : d_tiles);
    *d0 = (w13 ? a : b) * 128;
    *f0 = (w13 ? b : a) * 128;
    return w13;
  };
  if (threadIdx.x < 128) {
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce<DW_STAGES, DW_STAGE>(
          sm, full, empty, 2 * t13, KT,
          [&](unsigned char* st, uint64_t* bar, int k, int t) {
            int e, d0, f0;
            const bool w13 = where(t, &e, &d0, &f0);
            const int m0 = k * BK;
            uint32_t bytes = 0;
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              bytes += (d0 + 64 * b < d) * BOX;
              bytes += (f0 + 64 * b < ldh) * (w13 && ACT == 1 ? 1 : 2) * BOX;
            }
            wg::mbar_expect_tx(bar, bytes);
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              unsigned char* s = st + b * BOX;
              const int dd = d0 + 64 * b, fb = f0 + 64 * b;
              if (w13) {
                if (dd < d) wg::tma_load_3d(s, &tx, bar, dd, m0, e);
                if (fb < ldh) {
                  wg::tma_load_3d(s + DW_SLOT, &tws, bar, fb, m0, 2 * E + e);
                  if (ACT == 0)
                    wg::tma_load_3d(s + 2 * DW_SLOT, &tws, bar, fb, m0,
                                    3 * E + e);
                }
              } else {
                if (fb < ldh) {
                  wg::tma_load_3d(s, &tws, bar, fb, m0, e);
                  wg::tma_load_3d(s + 2 * DW_SLOT, &tws, bar, fb, m0, E + e);
                }
                if (dd < d) wg::tma_load_3d(s + DW_SLOT, &tdy, bar, dd, m0, e);
              }
            }
          });
    return;
  }
  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;
  Out out(sm + DW_STAGES * DW_STAGE, c);
  Ring ring;
  for (int t = blockIdx.x; t < 2 * t13; t += gridDim.x) {
    int e, d0, f0;
    if (where(t, &e, &d0, &f0)) {
      float a1[64], a3[64];
      zero(a1);
      zero(a3);
      consume<DW_STAGES, DW_STAGE>(
          sm, full, empty, ring, KT, [&](const unsigned char* st) {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
              const uint64_t a = mn(st + c * BOX, kk);
              wg::mma_n128<1, 1>(a1, a, mn(st + DW_SLOT, kk));
              if (ACT == 0) wg::mma_n128<1, 1>(a3, a, mn(st + 2 * DW_SLOT, kk));
            }
          });
      const int r0 = d0 + 64 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 < d && f0 + 64 * h < ff) {
          put_acc<128>(out.next(), a1, h);
          out.store(&tdw1, f0 + 64 * h, r0, e);
          if (ACT == 0) {
            put_acc<128>(out.next(), a3, h);
            out.store(&tdw3, f0 + 64 * h, r0, e);
          }
        }
      continue;
    }
    float acc[64];
    zero(acc);
    consume<DW_STAGES, DW_STAGE>(
        sm, full, empty, ring, KT, [&](const unsigned char* st) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t b = mn(st + DW_SLOT, kk);
            wg::mma_n128<1, 1>(acc, mn(st + c * BOX, kk), b);
            // h_lo's product: h^T dy with h to about 16 bits
            wg::mma_n128<1, 1>(acc, mn(st + 2 * DW_SLOT + c * BOX, kk), b);
          }
        });
    const int r0 = f0 + 64 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 < ff && d0 + 64 * h < d) {
        put_acc<128>(out.next(), acc, h);
        out.store(&tdw2, d0 + 64 * h, r0, e);
      }
  }
  out.drain();
}

constexpr int SMEM_GATE_UP = smem_bytes(GU_STAGE, GU_STAGES, 0);
constexpr int SMEM_DX = smem_bytes(DX_STAGE, DX_STAGES, OUT_BYTES);
constexpr int SMEM_DW = smem_bytes(DW_STAGE, DW_STAGES, OUT_BYTES);
static_assert(SMEM_GATE_UP <= 232448 && SMEM_DX <= 232448 &&
                  SMEM_DW <= 232448,
              "a block's shared memory on Hopper");

// One kernel on a persistent grid: a block per SM, or per tile if fewer.
template <class Kernel, class... Args>
int run(Kernel kernel, int smem, long long tiles, int sms,
        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int ACT>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           const void* dy, void* ws, void* dx, void* dw1, void* dw3,
           void* dw2, int E, int M, int d, int ff, cudaStream_t stream) {
  const int ldh = h_cols(ff);
  const long long m_tiles = (M + BM - 1) / BM;
  const long long gu_tiles = E * m_tiles * (ldh / 64);
  const long long dx_tiles = E * m_tiles * ((d + 255) / 256);
  const long long dw_tiles =
      2LL * E * ((d + 127) / 128) * ((ldh + 127) / 128);
  if (gu_tiles > 0x7fffffffLL || dx_tiles > 0x7fffffffLL ||
      dw_tiles > 0x7fffffffLL || 4LL * E > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // the tensor maps: boxes of 64 columns by 256, 128 or 64 rows
  CUtensorMap x128, dy128, w1_64, w3_64, w2_64, ws64, ws128, w1_256, w3_256,
      dx64, x64, dy64, dw1_64, dw3_64, dw2_64;
  if (!(wg::tma_map(&x128, x, d, M, E, 128) &&
        wg::tma_map(&dy128, dy, d, M, E, 128) &&
        wg::tma_map(&w1_64, w1, ff, d, E, 64) &&
        wg::tma_map(&w3_64, w3, ff, d, E, 64) &&
        wg::tma_map(&w2_64, w2, d, ff, E, 64) &&
        wg::tma_map(&ws64, ws, ldh, M, 4LL * E, 64) &&
        wg::tma_map(&ws128, ws, ldh, M, 4LL * E, 128) &&
        wg::tma_map(&w1_256, w1, ff, d, E, 256) &&
        wg::tma_map(&w3_256, w3, ff, d, E, 256) &&
        wg::tma_map(&dx64, dx, d, M, E, 64) &&
        wg::tma_map(&x64, x, d, M, E, 64) &&
        wg::tma_map(&dy64, dy, d, M, E, 64) &&
        wg::tma_map(&dw1_64, dw1, ff, d, E, 64) &&
        wg::tma_map(&dw3_64, dw3, ff, d, E, 64) &&
        wg::tma_map(&dw2_64, dw2, d, ff, E, 64)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int rc = run(mg_bwd_gate_up_kernel<ACT>, SMEM_GATE_UP, gu_tiles, sms,
               stream, x128, dy128, w1_64, w3_64, w2_64, ws64, E, M, d, ff);
  if (rc != 0) return rc;
  rc = run(mg_bwd_dx_kernel<ACT>, SMEM_DX, dx_tiles, sms, stream, ws128,
           w1_256, w3_256, dx64, E, M, d, ff);
  if (rc != 0) return rc;
  return run(mg_bwd_dw_kernel<ACT>, SMEM_DW, dw_tiles, sms, stream, x64,
             dy64, ws64, dw1_64, dw3_64, dw2_64, E, M, d, ff);
}

}  // namespace hop

// ---------------------------------------------------------------------------
// bf16, the mma.sync design: what TMA cannot describe (d or ff not a
// multiple of 8, or a pointer not 16-byte aligned).  Three kernels of 64 x
// 64 tiles, operands loaded element by element.
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
// row stride ld, into shared memory with row stride COLS + PAD, element by
// element (visible after the next __syncthreads); what lies past R or C
// reads as 0.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          int ld, int R, int C, int r0,
                                          int c0, bf16* dst) {
  constexpr int CH = COLS / 8;
  constexpr int LD = COLS + tc::PAD;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * LD + c;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      d[j] = gr < R && gc + j < C ? src[(size_t)gr * ld + gc + j]
                                  : __float2bfloat16(0.f);
  }
}

// The tile of an operand at e0 (its rows of A or columns of B) and k0,
// from its row-major (R, C) matrix: k runs along the rows if KM.
template <bool KM>
__device__ __forceinline__ void load_op(const bf16* src, int ld, int R,
                                        int C, int e0, int k0, bf16* dst) {
  if (KM)
    load_tile<BK, BM>(src, ld, R, C, k0, e0, dst);
  else
    load_tile<BM, BK>(src, ld, R, C, e0, k0, dst);
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

// A block's k-loop over KT k-tiles through a ring of STAGES: load(stage,
// kt) stages k-tile kt, step(stage) runs the products on a staged one.
template <int STAGE_ELEMS, class Load, class Step>
__device__ __forceinline__ void pipeline(bf16* sm, int KT, Load load,
                                         Step step) {
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < KT) load(sm + s * STAGE_ELEMS, s);
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();     // tile kt stored; tile kt - 1's stage is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(sm + (nk % STAGES) * STAGE_ELEMS, nk);
    step(sm + (kt % STAGES) * STAGE_ELEMS);
  }
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
// bf16 matrix, rounded once.
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
        p[0] = __float2bfloat16(v0);
        if (c + 1 < C) p[1] = __float2bfloat16(v1);
      }
}

// 1. g, u and dh of a (BM, BN) tile over d; h as a bf16 pair, dg and du
// into the workspace.
template <int ACT>
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
        load_op<false>(xb, d, M, d, m0, k0, st);
        load_op<false>(dyb, d, M, d, m0, k0, st + A);
        load_op<true>(w1b, ff, d, ff, f0, k0, st + 2 * A);
        if (ACT == 0)
          load_op<true>(w3b, ff, d, ff, f0, k0, st + 2 * A + B);
        load_op<false>(w2b, d, ff, d, f0, k0, st + 2 * A + 2 * B);
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
template <int ACT>
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
        load_op<false>(dgp, ldh, M, ldh, m0, k0, st);
        load_op<false>(w1b, ff, d, ff, n0, k0, st + 2 * A);
        if (ACT == 0) {
          load_op<false>(dup, ldh, M, ldh, m0, k0, st + A);
          load_op<false>(w3b, ff, d, ff, n0, k0, st + 3 * A);
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
  store_tile(acc, f, dx + (size_t)e * M * d, M, d, m0, n0);
}

// 3. The weight gradients, each tile over the whole of M in one block:
// blocks [0, t13) a (BM, BN) tile of dw1 = x^T dg and dw3 = x^T du (rows
// d, columns ff), the rest a tile of dw2 = h^T dy (rows ff, columns d)
// with h as its bf16 pair.
template <int ACT>
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
          load_op<true>(xb, d, M, d, r0, k0, st);
          load_op<true>(dgp, ldh, M, ldh, c0, k0, st + B);
          if (ACT == 0)
            load_op<true>(dup, ldh, M, ldh, c0, k0, st + 2 * B);
        },
        [&](const bf16* st) {
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            mma_step<true, true>(a1, st, st + B, lane, f.wr, f.wc, ks);
            if (ACT == 0)
              mma_step<true, true>(a3, st, st + 2 * B, lane, f.wr, f.wc, ks);
          }
        });
    store_tile(a1, f, dw1 + (size_t)e * d * ff, d, ff, r0, c0);
    if (ACT == 0)
      store_tile(a3, f, dw3 + (size_t)e * d * ff, d, ff, r0, c0);
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
        load_op<true>(hhi, ldh, M, ldh, r0, k0, st);
        load_op<true>(hlo, ldh, M, ldh, r0, k0, st + B);
        load_op<true>(dyb, d, M, d, c0, k0, st + 2 * B);
      },
      [&](const bf16* st) {
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          mma_step<true, true>(acc, st, st + 2 * B, lane, f.wr, f.wc, ks);
          // h_lo's product: h^T dy with h to about 16 bits
          mma_step<true, true>(acc, st + B, st + 2 * B, lane, f.wr, f.wc, ks);
        }
      });
  store_tile(acc, f, dw2 + (size_t)e * ff * d, ff, d, r0, c0);
}

constexpr int SMEM_GATE_UP =
    STAGES * (3 * Sh<false>::ELEMS + 2 * Sh<true>::ELEMS) * (int)sizeof(bf16);
constexpr int SMEM_DX = STAGES * 4 * Sh<false>::ELEMS * (int)sizeof(bf16);
constexpr int SMEM_DW = STAGES * 3 * Sh<true>::ELEMS * (int)sizeof(bf16);

template <int ACT>
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
      bw_gate_up_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_GATE_UP);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bw_dx_kernel<ACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_DX);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bw_dw_kernel<ACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_DW);
  if (err != cudaSuccess) return (int)err;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* dyp = static_cast<const bf16*>(dy);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* w3p = static_cast<const bf16*>(w3);
  bf16* wsp = static_cast<bf16*>(ws);
  bw_gate_up_kernel<ACT><<<dim3(m_tiles, f_tiles, E), THREADS, SMEM_GATE_UP,
                           stream>>>(xp, w1p, w3p,
                                     static_cast<const bf16*>(w2), dyp, wsp,
                                     M, d, ff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bw_dx_kernel<ACT><<<dim3(m_tiles, d_tiles, E), THREADS, SMEM_DX, stream>>>(
      w1p, w3p, wsp, static_cast<bf16*>(dx), M, d, ff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bw_dw_kernel<ACT><<<dim3((unsigned)dw_tiles, E), THREADS, SMEM_DW, stream>>>(
      xp, dyp, wsp, static_cast<bf16*>(dw1), static_cast<bf16*>(dw3),
      static_cast<bf16*>(dw2), M, d, ff);
  return (int)cudaGetLastError();
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

enum Design { WGMMA = 0, MMA_SYNC = 1, FMA = 2 };

// The design a call takes: a pure function of the dtype (0 = float32, 1 =
// bfloat16), d, ff and whether every pointer is 16-byte aligned.
static int design_of(int dtype, int d, int ff, bool aligned) {
  if (dtype == 0) return FMA;
  return d % 8 == 0 && ff % 8 == 0 && aligned ? WGMMA : MMA_SYNC;
}

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// x, dy, dx: (E, M, d); w1, w3, dw1, dw3: (E, d, ff); w2, dw2: (E, ff, d);
// all contiguous, one dtype (0 = float32, 1 = bfloat16).  act 0 = silu
// (SwiGLU), 1 = tanh-approximated gelu (w3 unread, dw3 not written: the
// caller passes it zeroed).  ws: the workspace, (4, E, M, ldh) bf16 or
// (3, E, M, ldh) f32 with ldh = ff rounded up to a multiple of 64.  design:
// the caller's choice (0 wgmma, 1 mma.sync, 2 fma), refused unless it is
// design_of's.  E at most 65535, and for mma.sync and fma so are the tile
// counts ceil(ff / 64) and ceil(d / 64).
extern "C" int mg_ffn_bwd(const void* x, const void* w1, const void* w3,
                          const void* w2, const void* dy, void* ws, void* dx,
                          void* dw1, void* dw3, void* dw2, int E, int M,
                          int d, int ff, int act, int dtype, int design,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || M <= 0 || d <= 0 || ff <= 0 || E > MAX_GRID_YZ ||
      (act != 0 && act != 1) || (dtype != 0 && dtype != 1) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(x) && aligned16(w1) && aligned16(w3) &&
                       aligned16(w2) && aligned16(dy) && aligned16(ws) &&
                       aligned16(dx) && aligned16(dw1) && aligned16(dw3) &&
                       aligned16(dw2);
  if (design != design_of(dtype, d, ff, aligned))
    return (int)cudaErrorInvalidValue;
  if (design == WGMMA)
    return act == 0 ? hop::launch<0>(x, w1, w3, w2, dy, ws, dx, dw1, dw3,
                                     dw2, E, M, d, ff, st)
                    : hop::launch<1>(x, w1, w3, w2, dy, ws, dx, dw1, dw3,
                                     dw2, E, M, d, ff, st);
  if (design == MMA_SYNC)
    return act == 0 ? tcb::launch<0>(x, w1, w3, w2, dy, ws, dx, dw1, dw3,
                                     dw2, E, M, d, ff, st)
                    : tcb::launch<1>(x, w1, w3, w2, dy, ws, dx, dw1, dw3,
                                     dw2, E, M, d, ff, st);
  return act == 0 ? f32b::launch<0>(x, w1, w3, w2, dy, ws, dx, dw1, dw3,
                                    dw2, E, M, d, ff, st)
                  : f32b::launch<1>(x, w1, w3, w2, dy, ws, dx, dw1, dw3,
                                    dw2, E, M, d, ff, st);
}
