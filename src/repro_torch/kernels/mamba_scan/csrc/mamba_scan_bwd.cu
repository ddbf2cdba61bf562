// The backward of the Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/mamba_scan/kernel.py::ssd_scan has no
// backward: the JAX package trains through jax.grad of the jnp path
// (models/ssm.py::ssd_chunked).  This kernel is the gradient of the
// forward that csrc/mamba_scan.cu computes, per (batch b, head h) over the
// chunks of q tokens (cum = the chunk's inclusive prefix sum of dt * a,
// total = cum_{q-1}, L_ij = exp(cum_i - cum_j) for j <= i, else 0):
//   y_i   = sum_j (C_i . B_j) L_ij dt_j x_j + exp(cum_i) S_in C_i
//   S_out = exp(total) S_in + sum_j w_j x_j B_j^T,
// w_j = exp(total - cum_j) dt_j.  Given dy and the final state's gradient
// (or 0), with dS the gradient of the state leaving a chunk, walked from
// the last chunk to the first, M1_ij = (C_i . B_j) L_ij dt_j and M2_ij =
// (dy_i . x_j) L_ij dt_j:
//   dx_j   = sum_i M1_ij dy_i + w_j dS B_j
//   dB_j   = sum_i M2_ij C_i + w_j dS^T x_j
//   dC_i   = sum_j M2_ij B_j + exp(cum_i) S_in^T dy_i
//   dS_in  = exp(total) dS + sum_i exp(cum_i) dy_i C_i^T
//   dcum_i = sum_j G_ij - sum_j G_ji + C_i . (exp(cum_i) S_in^T dy_i)
//            - w_i (x_i . dS B_i),  G_ij = M1_ij (dy_i . x_j),
//            and d total = sum_j w_j (x_j . dS B_j) + exp(total) <dS, S_in>
//            joins dcum_{q-1}
//   d dt_k = sum_i (C_i . B_k) L_ik (dy_i . x_k) + exp(total - cum_k)
//            (x_k . dS B_k) + a r_k,   r_k = sum_{i >= k} dcum_i
//   d a    = sum over (b, chunk, k) of dt_k r_k
// and dB, dC and d a summed over the heads (b and c are shared by them).
//
// Design (simple and right first; f32 arithmetic on the CUDA cores, bf16
// inputs read and widened once):
//   1. msb_walk (grid (H, B), 256 threads): first a forward walk over the
//      chunks that rebuilds the state entering each chunk (the forward
//      does not keep it: serving must not pay for it) into f32 scratch;
//      then the reverse walk with dS in shared memory, every product of
//      the chunk a 64 x 64 tile product from shared memory, a 4 x 4
//      register block a thread.  cum is rebuilt in order, one product and
//      one sum a token, as mamba_scan.cu's chunk_cumsum (ms_cb) does.
//      dx and d dt are written directly; each head's dB, dC and d a go to
//      f32 scratch.
//   2. msb_heads: dB and dC summed over the heads in head order, d a over
//      the batch rows in order: no atomics, so a rerun is bit-equal.
//
// What bounds it on this card.  Operations: at zamba2's training shape
// (rank batch 2 x 1024 tokens, H 80, P = N = q = 64) the walk does about
// nine 64^3 products a chunk and (b, h), ~13 GFLOP in f32 (0.2 ms at the
// 67 TFLOP/s CUDA-core peak) against ~52 MB of traffic.  The reverse
// walk is sequential over the chunks, and the grid has B H = 160 blocks
// for 132 SMs.
//
// Edges: q <= 64, P <= 64, N <= 64; q divides L (the wrapper checks).
//
// Interface: plain C, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing (the wrapper passes the scratch), does not
// synchronise, returns the first CUDA error of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int T = 64;              // tile side: chunk, P and N at most T
constexpr int LD = T + 1;          // row stride of an f32 tile
constexpr int THREADS = 256;       // 16 x 16 threads, a 4 x 4 block each
constexpr int TILE = T * LD;
constexpr int NTILE = 8;           // X, dY, B, C, S_in, dS, M1, M2
constexpr int NVEC = 4;            // dt, cum, w, exp(cum)
constexpr int NRED = 5;            // partial sums: rowG, colG, colH, dw, dci
constexpr int SMEM_FLOATS =
    NTILE * TILE + NVEC * T + NRED * 16 * T + THREADS;

__device__ __forceinline__ float ldf(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ldf(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stf(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// acc[r][c] += sum_{k < K} A(ti + 16 r, k) B(tj + 16 c, k) (times ks[k]
// where ks is given), with A(m, k) = A[m * ars + k * aks] and B(n, k) =
// B[n * bcs + k * bks]: every product of the walk, in either orientation.
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* A,
                                   int ars, int aks, const float* B, int bcs,
                                   int bks, int K, int ti, int tj,
                                   const float* ks = nullptr) {
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[(ti + 16 * r) * ars + k * aks];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = B[(tj + 16 * c) * bcs + k * bks];
    if (ks != nullptr) {
      const float s = ks[k];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] *= s;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// A T x T tile of f32 from rows of src (row stride rs): rows at or past nr
// and columns at or past nc read as 0.
template <typename E>
__device__ __forceinline__ void load_tile(float* dst, const E* src, size_t rs,
                                          int nr, int nc) {
  for (int i = threadIdx.x; i < T * T; i += THREADS) {
    const int r = i / T, c = i % T;
    dst[r * LD + c] = (r < nr && c < nc) ? ldf(src, (size_t)r * rs + c) : 0.f;
  }
}

// The chunk's cum (in order, as mamba_scan.cu's chunk_cumsum rounds it;
// past q: the total) from dts, by thread 0.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float ah, int q,
                                             float* cum) {
  float run = 0.f;
  for (int i = 0; i < T; ++i) {
    if (i < q) run = __fadd_rn(run, __fmul_rn(dts[i], ah));
    cum[i] = run;
  }
}

// The factor that carries the state (and its gradient) across a chunk.
__device__ __forceinline__ float state_carry(float total) {
  return expf(total);
}

// Sum over the 16 partials red[k * T + i], k = 0..15, in order.
__device__ __forceinline__ float sum16(const float* red, int i) {
  float s = 0.f;
  for (int k = 0; k < 16; ++k) s += red[k * T + i];
  return s;
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
msb_walk_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const E* __restrict__ b,
                const E* __restrict__ c, const E* __restrict__ dy,
                const float* __restrict__ ds_fin, float* __restrict__ s_in,
                E* __restrict__ dx, float* __restrict__ ddt,
                float* __restrict__ dbp, float* __restrict__ dcp,
                float* __restrict__ dap, int L, int H, int P, int N, int q) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                // [j][p]
  float* dYs = Xs + TILE;          // [i][p]
  float* Bs = dYs + TILE;          // [j][n]
  float* Cs = Bs + TILE;           // [i][n]
  float* Ss = Cs + TILE;           // [p][n]: the state entering the chunk
  float* dS = Ss + TILE;           // [p][n]: the gradient of the state
                                   // leaving it
  float* M1 = dS + TILE;           // [i][j]
  float* M2 = M1 + TILE;           // [i][j]
  float* dts = M2 + TILE;
  float* cum = dts + T;
  float* wv = cum + T;
  float* ec = wv + T;
  float* red = ec + T;             // NRED x 16 x T partial sums
  float* red_row = red, *red_col = red + 16 * T, *red_colh = red + 32 * T,
       *red_dw = red + 48 * T, *red_dci = red + 64 * T;
  float* red_blk = red + NRED * 16 * T;     // THREADS

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int h = blockIdx.x, bb = blockIdx.y, nc = L / q;
  const float ah = a[h];
  const size_t HP = (size_t)H * P;
  float* sbh = s_in + ((size_t)bb * H + h) * nc * P * N;

  // ---- 1. the state entering each chunk ----
  float s[4][4];
  zero(s);
  for (int ci = 0; ci < nc; ++ci) {
    const size_t row0 = (size_t)bb * L + (size_t)ci * q;
    load_tile(Xs, x + row0 * HP + (size_t)h * P, HP, q, P);
    load_tile(Bs, b + row0 * N, N, q, N);
    if (tid < T) dts[tid] = tid < q ? dt[(row0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) chunk_cumsum(dts, ah, q, cum);
    __syncthreads();
    const float total = cum[q - 1];
    if (tid < T) wv[tid] = tid < q ? expf(total - cum[tid]) * dts[tid] : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = ti + 16 * r, n = tj + 16 * cc;
        if (p < P && n < N) sbh[((size_t)ci * P + p) * N + n] = s[r][cc];
      }
    __syncthreads();
    const float g = state_carry(total);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[r][cc] *= g;
    mm(s, Xs, 1, LD, Bs, 1, LD, q, ti, tj, wv);  // (w o X)^T B
    __syncthreads();
  }

  // ---- 2. the reverse walk ----
  for (int i = tid; i < T * T; i += THREADS) {
    const int p = i / T, n = i % T;
    dS[p * LD + n] = (ds_fin != nullptr && p < P && n < N)
                         ? ds_fin[(((size_t)bb * H + h) * P + p) * N + n]
                         : 0.f;
  }
  float da_run = 0.f;                       // thread 0's, in chunk order
  for (int ci = nc - 1; ci >= 0; --ci) {
    const size_t row0 = (size_t)bb * L + (size_t)ci * q;
    load_tile(Xs, x + row0 * HP + (size_t)h * P, HP, q, P);
    load_tile(dYs, dy + row0 * HP + (size_t)h * P, HP, q, P);
    load_tile(Bs, b + row0 * N, N, q, N);
    load_tile(Cs, c + row0 * N, N, q, N);
    load_tile(Ss, sbh + (size_t)ci * P * N, N, P, N);
    if (tid < T) dts[tid] = tid < q ? dt[(row0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) chunk_cumsum(dts, ah, q, cum);
    __syncthreads();
    const float total = cum[q - 1];
    if (tid < T) {
      wv[tid] = tid < q ? expf(total - cum[tid]) * dts[tid] : 0.f;
      ec[tid] = tid < q ? expf(cum[tid]) : 0.f;
    }

    // C B^T and dY X^T, then M1, M2 and the sums of G and H = G / dt
    float cb[4][4], dx4[4][4];
    zero(cb);
    zero(dx4);
    mm(cb, Cs, LD, 1, Bs, LD, 1, N, ti, tj);
    mm(dx4, dYs, LD, 1, Xs, LD, 1, P, ti, tj);
    float grow[4] = {0.f, 0.f, 0.f, 0.f}, gcol[4] = {0.f, 0.f, 0.f, 0.f},
          hcol[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = ti + 16 * r, j = tj + 16 * cc;
        const float lij = (j <= i && i < q) ? expf(cum[i] - cum[j]) : 0.f;
        const float hv = cb[r][cc] * lij * dx4[r][cc];
        const float gv = hv * dts[j];
        M1[i * LD + j] = cb[r][cc] * lij * dts[j];
        M2[i * LD + j] = dx4[r][cc] * lij * dts[j];
        grow[r] += gv;
        gcol[cc] += gv;
        hcol[cc] += hv;
      }
#pragma unroll
    for (int r = 0; r < 4; ++r) red_row[tj * T + ti + 16 * r] = grow[r];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      red_col[ti * T + tj + 16 * cc] = gcol[cc];
      red_colh[ti * T + tj + 16 * cc] = hcol[cc];
    }
    __syncthreads();

    // dx = M1^T dY + w o (B dS^T), and dw_j = x_j . (dS B_j)
    float acc[4][4], v[4][4];
    zero(acc);
    zero(v);
    mm(acc, M1, 1, LD, dYs, 1, LD, q, ti, tj);
    mm(v, Bs, LD, 1, dS, LD, 1, N, ti, tj);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ti + 16 * r;
      float dwp = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tj + 16 * cc;
        dwp += Xs[j * LD + p] * v[r][cc];
        if (j < q && p < P)
          stf(dx, (row0 + j) * HP + (size_t)h * P + p,
              acc[r][cc] + wv[j] * v[r][cc]);
      }
      red_dw[tj * T + j] = dwp;
    }

    // this head's dB = M2^T C + w o (X dS)
    float* dbh = dbp + ((size_t)bb * H + h) * L * N;
    float* dch = dcp + ((size_t)bb * H + h) * L * N;
    zero(acc);
    zero(v);
    mm(acc, M2, 1, LD, Cs, 1, LD, q, ti, tj);
    mm(v, Xs, LD, 1, dS, 1, LD, P, ti, tj);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = ti + 16 * r, n = tj + 16 * cc;
        if (j < q && n < N)
          dbh[((size_t)ci * q + j) * N + n] = acc[r][cc] + wv[j] * v[r][cc];
      }

    // this head's dC = M2 B + exp(cum) o (dY S_in), and C_i . its second
    // term (d cum through y's inter-chunk term)
    zero(acc);
    zero(v);
    mm(acc, M2, LD, 1, Bs, 1, LD, q, ti, tj);
    mm(v, dYs, LD, 1, Ss, 1, LD, P, ti, tj);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti + 16 * r;
      float dcip = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = tj + 16 * cc;
        const float u = ec[i] * v[r][cc];
        dcip += Cs[i * LD + n] * u;
        if (i < q && n < N)
          dch[((size_t)ci * q + i) * N + n] = acc[r][cc] + u;
      }
      red_dci[tj * T + i] = dcip;
    }

    // <dS, S_in>, then dS_in = exp(total) dS + (exp(cum) o dY)^T C
    float cd = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int o = (ti + 16 * r) * LD + tj + 16 * cc;
        cd += dS[o] * Ss[o];
      }
    red_blk[tid] = cd;
    zero(acc);
    mm(acc, dYs, 1, LD, Cs, 1, LD, q, ti, tj, ec);
    const float g = state_carry(total);
    __syncthreads();               // every read of dS and the partials done
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int o = (ti + 16 * r) * LD + tj + 16 * cc;
        dS[o] = g * dS[o] + acc[r][cc];
      }

    // the gates: d cum, its reverse prefix sum, d dt and d a (thread 0,
    // in order)
    if (tid == 0) {
      float carry_dot = 0.f;
      for (int k = 0; k < THREADS; ++k) carry_dot += red_blk[k];
      float dtotal = g * carry_dot;
      for (int j = 0; j < q; ++j) dtotal += wv[j] * sum16(red_dw, j);
      float run = 0.f;
      for (int k = q - 1; k >= 0; --k) {
        const float dwk = sum16(red_dw, k);
        float dcum = sum16(red_row, k) - sum16(red_col, k) +
                     sum16(red_dci, k) - wv[k] * dwk;
        if (k == q - 1) dcum += dtotal;
        run += dcum;
        ddt[(row0 + k) * H + h] =
            sum16(red_colh, k) + expf(total - cum[k]) * dwk + ah * run;
        da_run += dts[k] * run;
      }
    }
    __syncthreads();               // the chunk's tiles are free again
  }
  if (tid == 0) dap[(size_t)bb * H + h] = da_run;
}

// dB and dC: the heads' partials summed in head order, rounded once; d a:
// the batch rows' partials summed in order.
template <typename E>
__global__ void msb_heads_kernel(const float* __restrict__ dbp,
                                 const float* __restrict__ dcp,
                                 const float* __restrict__ dap,
                                 E* __restrict__ db, E* __restrict__ dc,
                                 float* __restrict__ da, int B, int L, int H,
                                 int N) {
  const size_t total = (size_t)B * L * N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (size_t)H) {
    float s = 0.f;
    for (int bb = 0; bb < B; ++bb) s += dap[(size_t)bb * H + idx];
    da[idx] = s;
  }
  if (idx >= total) return;
  const size_t bb = idx / ((size_t)L * N), ln = idx % ((size_t)L * N);
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    const size_t o = ((size_t)bb * H + h) * L * N + ln;
    sb += dbp[o];
    sc += dcp[o];
  }
  stf(db, idx, sb);
  stf(dc, idx, sc);
}

template <typename E>
int launch(const E* x, const float* dt, const float* a, const E* b,
           const E* c, const E* dy, const float* ds_fin, E* dx, float* ddt,
           float* da, E* db, E* dc, float* scratch, int B, int L, int H,
           int P, int N, int q, cudaStream_t stream) {
  const int nc = L / q;
  float* s_in = scratch;
  float* dbp = s_in + (size_t)B * H * nc * P * N;
  float* dcp = dbp + (size_t)B * H * L * N;
  float* dap = dcp + (size_t)B * H * L * N;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      msb_walk_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  msb_walk_kernel<E><<<dim3(H, B), THREADS, smem, stream>>>(
      x, dt, a, b, c, dy, ds_fin, s_in, dx, ddt, dbp, dcp, dap, L, H, P, N,
      q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * L * N > (size_t)H ? (size_t)B * L * N
                                                 : (size_t)H;
  msb_heads_kernel<E><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dbp, dcp, dap, db, dc, da, B, L, H, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: (B, L, H, P); dt, ddt: (B, L, H) f32; a, da: (H,) f32; b, c,
// db, dc: (B, L, N); ds_fin: (B, H, P, N) f32 or null (a zero gradient of
// the final state); scratch: f32, B H (L / q) P N + 2 B H L N + B H
// floats (ops.bwd_scratch_floats); all contiguous.  x, b, c, dy, dx, db
// and dc share one dtype (0 = float32, 1 = bfloat16).  q = the chunk,
// 1 <= q <= 64, dividing L; P, N <= 64.
extern "C" int msb_ssd_bwd(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, const void* dy,
                           const void* ds_fin, void* dx, void* ddt, void* da,
                           void* db, void* dc, void* scratch, int B, int L,
                           int H, int P, int N, int q, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || P > T || N <= 0 || N > T ||
      q <= 0 || q > T || L % q != 0 || H > 65535 || B > 65535 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* dsf = static_cast<const float*>(ds_fin);
  float* ddtf = static_cast<float*>(ddt);
  float* daf = static_cast<float*>(da);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch(static_cast<const float*>(x), dtf, af,
                  static_cast<const float*>(b), static_cast<const float*>(c),
                  static_cast<const float*>(dy), dsf, static_cast<float*>(dx),
                  ddtf, daf, static_cast<float*>(db), static_cast<float*>(dc),
                  sc, B, L, H, P, N, q, st);
  if (dtype == 1)
    return launch(static_cast<const bf16*>(x), dtf, af,
                  static_cast<const bf16*>(b), static_cast<const bf16*>(c),
                  static_cast<const bf16*>(dy), dsf, static_cast<bf16*>(dx),
                  ddtf, daf, static_cast<bf16*>(db), static_cast<bf16*>(dc),
                  sc, B, L, H, P, N, q, st);
  return (int)cudaErrorInvalidValue;
}
