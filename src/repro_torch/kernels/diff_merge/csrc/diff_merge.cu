// Chunk diff + Table-3 merge of one state leaf, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/diff_merge/kernel.py::_dm_kernel
// (reached through ops.diff_merge_leaf from core/diffsync.py's
// fused_diff_apply).  It computes the same function, per 1024-element chunk
// c of a flat leaf of n elements:
//     dirty[c] = any(b0[c] != b1[c])               (stored values compared)
//     a1[c]    = to_leaf(dirty[c] ? merge(a0, b0, b1) : a0)
// where the merge (sum, subtract, multiply, divide, overwrite) runs in the
// compute type of the reference's compute_dtype: bf16 and f16 in f32, f32
// and f64 in their own precision, integers exactly (wrapping) for sum,
// subtract and overwrite and in f32 for multiply and divide.  Clean chunks
// go through the same conversion to the compute type and back, so an int32
// above 2^24 rounds in a clean chunk under multiply or divide, as in the
// reference.  A NaN in b0 or b1 makes its chunk dirty; -0 against +0 does
// not.  Float to integer truncates and saturates (NaN gives 0), as XLA's
// convert does.  Every f32 and f64 operation is an explicit round-to-
// nearest intrinsic, so no multiply-add is contracted and the results are
// bit-exact to the plain version (ref.py); the build has no fast-math.
//
// The reference zero-pads a ragged tail into a full chunk; here the last
// block masks its loads instead (padding compares equal, so the dirty bit
// and the valid elements are the same) and no copy of the leaf is made.
//
// What bounds it on this card.  Three reads and one write of every
// element plus one byte per chunk: (4 n esize + n / 1024) B at 3.35 TB/s,
// about 0.63 ms for the 262,668,288-element bf16 embedding and 14.8 ms for
// the whole full-width llama3.2-1b train state.  Its arithmetic (a few
// operations per element) is far below the card's rate.
//
// What this design does about it.  One block of 256 threads per chunk,
// four consecutive elements per thread, read as one vector (8 bytes for
// bf16, 16 for f32 and int32, two 16-byte halves for f64 and int64) when
// every pointer is aligned to it, so a warp reads 32 neighbouring vectors.
// A thread loads its a0 together with b0 and b1, before the block-wide
// vote (__syncthreads_or) that decides the chunk's dirty bit, so the three
// streams are in flight at once; a chunk is clean or dirty as a whole, so
// no thread diverges after the vote.  Blocks share nothing and run in any
// order; thread 0 writes the chunk's dirty byte.
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 1024;
constexpr int THREADS = 256;
constexpr int PER = CHUNK / THREADS;       // elements per thread

enum Op { SUM = 0, SUBTRACT = 1, MULTIPLY = 2, DIVIDE = 3, OVERWRITE = 4 };

// Compute type: the reference's compute_dtype.
template <typename T, int OP> struct Compute { using type = float; };
template <int OP> struct Compute<double, OP> { using type = double; };
template <> struct Compute<int32_t, SUM> { using type = int32_t; };
template <> struct Compute<int32_t, SUBTRACT> { using type = int32_t; };
template <> struct Compute<int32_t, OVERWRITE> { using type = int32_t; };
template <> struct Compute<int64_t, SUM> { using type = int64_t; };
template <> struct Compute<int64_t, SUBTRACT> { using type = int64_t; };
template <> struct Compute<int64_t, OVERWRITE> { using type = int64_t; };

// Leaf value -> compute type (round to nearest where it rounds).
template <typename C> __device__ __forceinline__ C up(float x) { return x; }
template <typename C> __device__ __forceinline__ C up(double x) { return x; }
template <typename C> __device__ __forceinline__ C up(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename C> __device__ __forceinline__ C up(__half x) {
  return __half2float(x);
}
template <typename C> __device__ __forceinline__ C up(int32_t x) {
  if constexpr (std::is_floating_point<C>::value) return __int2float_rn(x);
  else return x;
}
template <typename C> __device__ __forceinline__ C up(int64_t x) {
  if constexpr (std::is_floating_point<C>::value) return __ll2float_rn(x);
  else return x;
}

// Compute type -> leaf type, as XLA's convert.
template <typename T> __device__ __forceinline__ T down(float x);
template <> __device__ __forceinline__ float down<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
down<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ __half down<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ int32_t down<int32_t>(float x) {
  return __float2int_rz(x);             // saturates; NaN gives 0
}
template <> __device__ __forceinline__ int64_t down<int64_t>(float x) {
  return __float2ll_rz(x);
}
template <typename T> __device__ __forceinline__ T down(double x) {
  return x;
}
template <typename T> __device__ __forceinline__ T down(int32_t x) {
  return x;
}
template <typename T> __device__ __forceinline__ T down(int64_t x) {
  return x;
}

// Stored values compared as values (NaN unequal to itself, -0 == +0).
template <typename T> __device__ __forceinline__ bool differ(T a, T b) {
  return a != b;
}
template <> __device__ __forceinline__ bool differ(__nv_bfloat16 a,
                                                   __nv_bfloat16 b) {
  return __bfloat162float(a) != __bfloat162float(b);
}
template <> __device__ __forceinline__ bool differ(__half a, __half b) {
  return __half2float(a) != __half2float(b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}
// Integers wrap in two's complement, as XLA's and PyTorch's do.
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t sub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

template <typename C, int OP>
__device__ __forceinline__ C merge(C a0, C b0, C b1) {
  if constexpr (OP == SUM) {
    return add(a0, sub(b1, b0));
  } else if constexpr (OP == SUBTRACT) {
    return sub(a0, sub(b0, b1));
  } else if constexpr (OP == MULTIPLY) {
    return mul(a0, b0 == C(0) ? C(1) : dvd(b1, b0));
  } else if constexpr (OP == DIVIDE) {
    return dvd(a0, b1 == C(0) ? C(1) : (b0 == C(0) ? C(1) : dvd(b0, b1)));
  } else {
    return b1;
  }
}

template <typename T> struct alignas(PER * sizeof(T)) Vec { T v[PER]; };

template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
dm_kernel(const T* __restrict__ a0, const T* __restrict__ b0,
          const T* __restrict__ b1, T* __restrict__ a1,
          bool* __restrict__ dirty, long long n, bool vec) {
  using C = typename Compute<T, OP>::type;
  const long long first = (long long)blockIdx.x * CHUNK + threadIdx.x * PER;
  const long long left = n - first;     // valid elements from `first`
  const bool whole = vec && left >= PER;
  Vec<T> va, vb0, vb1;
  if (whole) {
    va = *reinterpret_cast<const Vec<T>*>(a0 + first);
    vb0 = *reinterpret_cast<const Vec<T>*>(b0 + first);
    vb1 = *reinterpret_cast<const Vec<T>*>(b1 + first);
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (j < left) {
        va.v[j] = a0[first + j];
        vb0.v[j] = b0[first + j];
        vb1.v[j] = b1[first + j];
      }
    }
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (j < left && differ(vb0.v[j], vb1.v[j])) mine = 1;
  const bool d = __syncthreads_or(mine) != 0;

  Vec<T> out;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const C a = up<C>(va.v[j]);
    out.v[j] = down<T>(d ? merge<C, OP>(a, up<C>(vb0.v[j]), up<C>(vb1.v[j]))
                         : a);
  }
  if (whole) {
    *reinterpret_cast<Vec<T>*>(a1 + first) = out;
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (j < left) a1[first + j] = out.v[j];
  }
  if (threadIdx.x == 0) dirty[blockIdx.x] = d;
}

template <typename T>
int launch(const void* a0, const void* b0, const void* b1, void* a1,
           void* dirty, long long n, int op, cudaStream_t stream) {
  const uintptr_t align = PER * sizeof(T);
  const bool vec = ((uintptr_t)a0 | (uintptr_t)b0 | (uintptr_t)b1 |
                    (uintptr_t)a1) % align == 0;
  const long long blocks = (n + CHUNK - 1) / CHUNK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(a0);
  const T* y = static_cast<const T*>(b0);
  const T* z = static_cast<const T*>(b1);
  T* o = static_cast<T*>(a1);
  bool* m = static_cast<bool*>(dirty);
  const dim3 grid((unsigned)blocks);
  switch (op) {
    case SUM:
      dm_kernel<T, SUM><<<grid, THREADS, 0, stream>>>(x, y, z, o, m, n, vec);
      break;
    case SUBTRACT:
      dm_kernel<T, SUBTRACT><<<grid, THREADS, 0, stream>>>(x, y, z, o, m, n,
                                                           vec);
      break;
    case MULTIPLY:
      dm_kernel<T, MULTIPLY><<<grid, THREADS, 0, stream>>>(x, y, z, o, m, n,
                                                           vec);
      break;
    case DIVIDE:
      dm_kernel<T, DIVIDE><<<grid, THREADS, 0, stream>>>(x, y, z, o, m, n,
                                                         vec);
      break;
    case OVERWRITE:
      dm_kernel<T, OVERWRITE><<<grid, THREADS, 0, stream>>>(x, y, z, o, m, n,
                                                            vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a0, b0, b1, a1: n contiguous elements of one dtype (0 f32, 1 f64, 2 bf16,
// 3 f16, 4 int32, 5 int64); dirty: ceil(n / 1024) bytes.  op: 0 sum,
// 1 subtract, 2 multiply, 3 divide, 4 overwrite.  a1 may not alias an input.
extern "C" int dm_launch(const void* a0, const void* b0, const void* b1,
                         void* a1, void* dirty, long long n, int dtype,
                         int op, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a0, b0, b1, a1, dirty, n, op, s);
    case 1: return launch<double>(a0, b0, b1, a1, dirty, n, op, s);
    case 2: return launch<__nv_bfloat16>(a0, b0, b1, a1, dirty, n, op, s);
    case 3: return launch<__half>(a0, b0, b1, a1, dirty, n, op, s);
    case 4: return launch<int32_t>(a0, b0, b1, a1, dirty, n, op, s);
    case 5: return launch<int64_t>(a0, b0, b1, a1, dirty, n, op, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
