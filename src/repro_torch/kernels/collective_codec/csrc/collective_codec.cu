// Chunk-max threshold select for compressed collectives, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/collective_codec/kernel.py::_select_kernel (reached
// through ops.select_codec from core/collectives.py's compressed schedule
// and optim/compress.py).  It computes the same function, per row of a
// (rows, m) f32 matrix:
//     col[r]   = first lane among the maxima of |x[r, :]|   (int32)
//     vals[r]  = x[r, col[r]]
//     resid[r] = x[r, :] with lane col[r] set to +0
// bit for bit: a NaN in a row makes its maximum NaN, no lane equals it,
// and the row gives col = m, vals = 0 and resid = x, as the plain version
// (ref.py) and the JAX reference do.  vals is written as x + 0 so that a
// picked -0 reads +0, as the reference's masked sum gives.
//
// What bounds it on this card.  It is one streaming pass: x read once,
// resid written once, vals and col written once, 8 * rows * m + 8 * rows
// bytes at 3.35 TB/s (about 1.55 ms for one 617,907,200-element shard at
// m = 20).  Its arithmetic (two compares per element) is negligible.
//
// What this design does about it.  Rows are narrow (m = 20 at frac 0.05,
// m = 1 at frac 1.0), so a thread per row reading global memory directly
// would stride 80 bytes between neighbouring threads.  Instead a block of
// 256 threads stages a contiguous tile of rows through shared memory: the
// load and the residual store walk the tile's elements in order, so
// neighbouring threads touch neighbouring addresses, and each thread then
// scans its own rows in shared memory.  The tile's row stride is m rounded
// up to an odd number of floats, which keeps the per-row scans free of
// bank conflicts; the (row, lane) of each element is advanced
// incrementally, with no integer division per element.  One block per
// tile; blocks run in any order and share nothing.  Very wide rows (m in
// the thousands, frac below about 1e-3) leave few rows per tile and
// serialise their scans: correct, but slow; the port's sync runs m = 20.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = 12288;     // 48 KB of shared memory per tile
constexpr int MAX_TILE_ROWS = 8 * THREADS;

__global__ void __launch_bounds__(THREADS)
cc_select_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ col, float* __restrict__ resid,
                 long long rows, int m, int ms, int tile_rows) {
  extern __shared__ float tile[];      // tile_rows x ms
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int nr = (int)min((long long)tile_rows, rows - r0);
  const size_t base = (size_t)r0 * m;
  const int count = nr * m;
  const int dr = THREADS / m, dc = THREADS % m;

  int r = threadIdx.x / m, c = threadIdx.x % m;
  for (int e = threadIdx.x; e < count; e += THREADS) {
    tile[r * ms + c] = x[base + e];
    c += dc;
    r += dr;
    if (c >= m) { c -= m; ++r; }
  }
  __syncthreads();

  for (int row = threadIdx.x; row < nr; row += THREADS) {
    float* t = tile + row * ms;
    float best = fabsf(t[0]);
    for (int j = 1; j < m; ++j) {
      const float a = fabsf(t[j]);
      if (a > best || a != a) best = a;   // a NaN sticks, as in max()
    }
    int pick = m;
    for (int j = 0; j < m; ++j) {
      if (fabsf(t[j]) == best) { pick = j; break; }
    }
    float v = 0.f;
    if (pick < m) {
      v = t[pick] + 0.f;
      t[pick] = 0.f;
    }
    vals[r0 + row] = v;
    col[r0 + row] = pick;
  }
  __syncthreads();

  r = threadIdx.x / m;
  c = threadIdx.x % m;
  for (int e = threadIdx.x; e < count; e += THREADS) {
    resid[base + e] = tile[r * ms + c];
    c += dc;
    r += dr;
    if (c >= m) { c -= m; ++r; }
  }
}

}  // namespace

// x, resid: (rows, m) f32; vals: (rows,) f32; col: (rows,) int32; all
// contiguous.  resid may not alias x.
extern "C" int cc_select(const void* x, void* vals, void* col, void* resid,
                         long long rows, int m, void* stream) {
  if (rows <= 0 || m <= 0 || m >= SMEM_FLOATS)
    return (int)cudaErrorInvalidValue;
  const int ms = m | 1;
  const int fit = SMEM_FLOATS / ms;
  const int tile_rows = fit < MAX_TILE_ROWS ? fit : MAX_TILE_ROWS;
  const long long blocks = (rows + tile_rows - 1) / tile_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = tile_rows * ms * (int)sizeof(float);
  cc_select_kernel<<<(unsigned)blocks, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int*>(col), static_cast<float*>(resid), rows, m, ms,
      tile_rows);
  return (int)cudaGetLastError();
}
