// Device helpers shared by the hand-written Hopper kernels of the port.
//
// Every kernel here runs 256 threads as a 16 x 16 grid (tx = tid & 15,
// ty = tid >> 4) over 64-row tiles. A thread owns rows ty + 16*i (i < 4)
// and columns tx + 16*j of an output tile: with that strided ownership a
// warp reads two distinct rows of the A operand (broadcast) and sixteen
// consecutive columns of the B operand, so shared-memory reads do not
// conflict once row-major tiles carry one column of padding.
//
// Arithmetic runs in fp32. Values are rounded to the storage type T at the
// points where the JAX kernels cast to their compute dtype, so bf16 results
// follow the same rounding chain as the oracle.
//
// Besides the tile helpers, two whole kernels live here because more than
// one source launches them: gemm_kernel (a row-major product with a fused
// epilogue functor) and layer_norm_kernel (torch's LayerNorm, one warp per
// row).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mtp {

constexpr int kThreads = 256;  // 16 x 16 threads per block
constexpr int kTile = 64;      // rows per tile
constexpr int kBlockR = 256;   // rows per row-skip flag (rowmm, wgrad)
static_assert(kBlockR % kTile == 0, "a skip flag covers whole tiles");
constexpr int kKChunk = 32;    // weight rows staged in shared memory per step
constexpr float kMaskFill = -65504.0f;  // valid-but-masked key score
constexpr float kStdLnEps = 1e-6f;       // StdLayerNorm: std + eps
constexpr float kVarFloor = 1e-24f;      // StdLayerNorm variance floor

template <typename T> struct Num;
// load2 / store2: the neighbours p[0], p[1] (p 4-byte aligned), in one
// access for bf16
template <> struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return make_float2(p[0], p[1]);
  }
  static __device__ __forceinline__ void store2(float* p, float v0,
                                                float v1) {
    p[0] = v0;
    p[1] = v1;
  }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                                float v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  }
};

// round an fp32 value to T's precision (identity for float)
template <typename T>
static __device__ __forceinline__ float rnd(float v) {
  return Num<T>::load(Num<T>::store(v));
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// reductions over the 16 threads that share a ty (one half-warp)
static __device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

static __device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator of the
// port's dropout: one call maps a 128-bit counter and a 64-bit key to four
// 32-bit words.
constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kPhiloxW0;
    k.y += kPhiloxW1;
  }
  return c;
}

// The keep bit of element (row, col) of dropout mask m (0: the FFN's hidden
// [R, F], 1: its output [R, C]): word col % 4 of Philox at counter
// (col / 4, row, m, 0), kept when below thr = floor(q * 2^32). Keyed by the
// element's place in the whole array, so it does not depend on the tiling
// and a backward regenerates it exactly. kernels/ffn.py plain_dropout_masks
// is the same function on int64 tensors.
static __device__ __forceinline__ bool dropout_keep(uint2 key, uint32_t thr,
                                                    int m, int row, int col) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)col >> 2, (uint32_t)row, (uint32_t)m, 0u), key);
  const int w = col & 3;
  const uint32_t u = w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
  return u < thr;
}

// Rows [row0, row0 + kTile) of a row-major [nrows, C] matrix through the
// reference's StdLayerNorm (Bessel std, eps added to the std, variance
// floor), rounded to T, into dst[kTile][lda] fp32. Rows past nrows are
// zero-filled (their results are never stored). With ``stats`` non-null,
// row r's mean, 1 / (std + eps), std and variance go to stats[r],
// stats[kTile + r], stats[2 kTile + r], stats[3 kTile + r] (the LN
// backward reads them). Ends with __syncthreads.
template <typename T>
static __device__ __forceinline__ void ln_tile(
    const T* __restrict__ x, int row0, int nrows, int C,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* dst, int lda, int tid, float* stats = nullptr) {
  for (int e = tid; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    dst[r * lda + c] = (row0 + r < nrows)
        ? Num<T>::load(x[(size_t)(row0 + r) * C + c]) : 0.0f;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float* row = dst + r * lda;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mu = warp_sum(s) / (float)C;
    float v = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mu;
      v += d * d;
    }
    const float var = warp_sum(v) / (float)(C - 1);
    const float sd = sqrtf(fmaxf(var, kVarFloor));
    const float inv = 1.0f / (sd + kStdLnEps);
    for (int c = lane; c < C; c += 32)
      row[c] = rnd<T>(((row[c] - mu) * inv) * gamma[c] + beta[c]);
    if (stats != nullptr && lane == 0) {
      stats[r] = mu;
      stats[kTile + r] = inv;
      stats[2 * kTile + r] = sd;
      stats[3 * kTile + r] = var;
    }
  }
  __syncthreads();
}

// torch's LayerNorm of one row held in fp32 at row[0, C) (shared memory),
// by one warp: biased variance, eps inside the square root, rounded to T
// in place. Lane l reads and writes only columns l, l + 32, ...
template <typename T>
static __device__ __forceinline__ void layer_norm_row(
    float* row, int C, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, int lane) {
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += row[c];
  const float mu = warp_sum(s) / (float)C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = row[c] - mu;
    v += d * d;
  }
  const float inv = 1.0f / sqrtf(warp_sum(v) / (float)C + eps);
  for (int c = lane; c < C; c += 32)
    row[c] = rnd<T>((row[c] - mu) * inv * gamma[c] + beta[c]);
}

// acc[i][j] += sum_k A[ty + 16i][k] * W[k][n0 + tx + 16j] for k < K.
// A: kTile x K fp32 in shared memory (leading dimension lda).
// W: row-major with leading dimension ldw in device memory, staged
// kKChunk rows at a time into Bs (kKChunk x 16*NJ floats). K must be a
// multiple of kKChunk. Ends with __syncthreads, so Bs is free afterwards.
template <typename T, int NJ>
static __device__ __forceinline__ void gemm_tile(
    const float* As, int lda, int K, const T* __restrict__ W, int ldw,
    int n0, float* Bs, float (&acc)[4][NJ], int tx, int ty, int tid) {
  constexpr int BN = 16 * NJ;
  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    for (int e = tid; e < kKChunk * BN; e += kThreads) {
      const int kk = e / BN, nn = e - kk * BN;
      Bs[e] = Num<T>::load(W[(size_t)(k0 + kk) * ldw + n0 + nn]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKChunk; ++kk) {
      float a[4], b[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// acc[i][j] += sum_k A[ty + 16i][k] * W[n0 + tx + 16j][k] for k < K: the
// product with the transpose of a row-major W [N, K] (leading dimension
// ldw), staged kKChunk columns at a time into Bs (kKChunk x 16*NJ floats).
// K must be a multiple of kKChunk. Ends with __syncthreads.
template <typename T, int NJ>
static __device__ __forceinline__ void gemm_tile_t(
    const float* As, int lda, int K, const T* __restrict__ W, int ldw,
    int n0, float* Bs, float (&acc)[4][NJ], int tx, int ty, int tid) {
  constexpr int BN = 16 * NJ;
  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    for (int e = tid; e < kKChunk * BN; e += kThreads) {
      const int nn = e / kKChunk, kk = e - nn * kKChunk;
      Bs[kk * BN + nn] = Num<T>::load(W[(size_t)(n0 + nn) * ldw + k0 + kk]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKChunk; ++kk) {
      float a[4], b[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// StdLayerNorm backward of one 64-row tile (kernels/ffn.py:203-214 and
// attn_block.py:481-499 of the JAX package). dln[i][j] is dL/d(LN out) at
// row ty + 16i, column tx + 16j (C = 16 * NJC) of rows [r0, r0 + rows) of
// x [*, C]; stats as ln_tile writes them. Writes
//   dx = c (dxhat - mean(dxhat)) - c^2 A xmu [var > floor] / ((C-1) sd)
// plus the residual cotangent dy: as (dy + dx) rounded once
// (ROUND_TWICE false, the FFN) or as round(round(dx) + dy) (true, the
// attention block); dy NULL: no residual, dx rounded once (the LN-fused
// projection). The tile's column sums of dln * xhat and dln go to
// gpart[0, C) and gpart[C, 2C) through red (16 * C floats of shared
// memory). Starts and ends with __syncthreads.
template <typename T, int NJC, bool ROUND_TWICE>
static __device__ __forceinline__ void stdln_backward_tile(
    const float (&dln)[4][NJC], const T* __restrict__ x,
    const T* __restrict__ dy, T* __restrict__ dx, int r0, int rows,
    const float* __restrict__ gamma, const float* stats, float* red,
    float* __restrict__ gpart, int tx, int ty, int tid) {
  constexpr int C = 16 * NJC;
  float gsum[NJC], bsum[NJC];
#pragma unroll
  for (int j = 0; j < NJC; ++j) gsum[j] = bsum[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool live = r < rows;
    const float mu = stats[r], c = stats[kTile + r];
    const float sd = stats[2 * kTile + r], var = stats[3 * kTile + r];
    float xhat[NJC];
    float A = 0.0f, S = 0.0f;
#pragma unroll
    for (int j = 0; j < NJC; ++j) {
      const int col = tx + 16 * j;
      const float xf = live ? Num<T>::load(x[(size_t)(r0 + r) * C + col])
                            : 0.0f;
      xhat[j] = (xf - mu) * c;
      gsum[j] += dln[i][j] * xhat[j];
      bsum[j] += dln[i][j];
      const float dxhat = dln[i][j] * gamma[col];
      A += dxhat * (xhat[j] / c);
      S += dxhat;
    }
    A = half_warp_sum(A);
    S = half_warp_sum(S);
    if (!live) continue;
    const float mean = S / (float)C;
    const float flag = var > kVarFloor ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < NJC; ++j) {
      const int col = tx + 16 * j;
      const size_t off = (size_t)(r0 + r) * C + col;
      const float dxhat = dln[i][j] * gamma[col];
      const float xmu = xhat[j] / c;
      const float d = c * (dxhat - mean) -
                      (c * c) * A * xmu * flag / ((float)(C - 1) * sd);
      const float g = dy != nullptr ? Num<T>::load(dy[off]) : 0.0f;
      dx[off] = Num<T>::store(ROUND_TWICE ? rnd<T>(d) + g : g + d);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJC; ++j) red[ty * C + tx + 16 * j] = gsum[j];
  __syncthreads();
  for (int col = tid; col < C; col += kThreads) {
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += red[t * C + col];
    gpart[col] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJC; ++j) red[ty * C + tx + 16 * j] = bsum[j];
  __syncthreads();
  for (int col = tid; col < C; col += kThreads) {
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += red[t * C + col];
    gpart[C + col] = s;
  }
  __syncthreads();
}

// dln[i][j] += sum_n cot[ty + 16i][n] w[tx + 16j][n] over n < N: cot the
// tile's rows (row stride ldc; rows past `rows` read as zero), w [C, N]
// row-major (C = 16 NJC), staged kKChunk columns at a time through As
// [kTile][kKChunk + 1] and Bs [kKChunk][C] (fp32, shared memory). N %
// kKChunk == 0. Ends with __syncthreads.
template <typename T, int NJC>
static __device__ __forceinline__ void dln_tile(
    const T* __restrict__ cot, int ldc, int N, int rows,
    const T* __restrict__ w, float* As, float* Bs, float (&dln)[4][NJC],
    int tx, int ty, int tid) {
  constexpr int C = 16 * NJC, LDK = kKChunk + 1;
  for (int k0 = 0; k0 < N; k0 += kKChunk) {
    for (int e = tid; e < kTile * kKChunk; e += kThreads) {
      const int r = e / kKChunk, kk = e - r * kKChunk;
      As[r * LDK + kk] = r < rows
          ? Num<T>::load(cot[(size_t)r * ldc + k0 + kk]) : 0.0f;
    }
    for (int e = tid; e < kKChunk * C; e += kThreads) {
      const int c = e / kKChunk, kk = e - c * kKChunk;
      Bs[kk * C + c] = Num<T>::load(w[(size_t)c * N + k0 + kk]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKChunk; ++kk) {
      float a[4], bb[NJC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * LDK + kk];
#pragma unroll
      for (int j = 0; j < NJC; ++j) bb[j] = Bs[kk * C + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJC; ++j) dln[i][j] = fmaf(a[i], bb[j], dln[i][j]);
    }
    __syncthreads();
  }
}

// rows [row0, row0 + rows) of a row-major [*, C] matrix set to zero
template <typename T>
static __device__ __forceinline__ void zero_rows(T* __restrict__ dst,
                                                 int row0, int rows, int C,
                                                 int tid) {
  const size_t base = (size_t)row0 * C;
  for (int e = tid; e < rows * C; e += kThreads)
    dst[base + e] = Num<T>::store(0.0f);
}

template <int NI, int NJ>
static __device__ __forceinline__ void zero(float (&a)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) a[i][j] = 0.0f;
}

// copy rows [row0, row0 + rows) of a row-major [*, C] matrix (the pure
// residual of a skipped tile)
template <typename T>
static __device__ __forceinline__ void copy_rows(
    const T* __restrict__ src, T* __restrict__ dst, int row0, int rows,
    int C, int tid) {
  const size_t base = (size_t)row0 * C;
  for (int e = tid; e < rows * C; e += kThreads) dst[base + e] = src[base + e];
}

static __device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Epilogues of gemm_kernel and gemm_bf16_kernel (mma.cuh): operator()
// stores element (row, col) from its fp32 sum, pair() the neighbours
// (row, col) and (row, col + 1) (col even; the tensor-core kernel's
// fragments), dead() runs in place of the product of a row tile whose
// flag is 0 (rows [r0, r0 + rows), columns [n0, n0 + 64), by nthreads
// threads). out and res [R, N] row-major in T.

// out = T(T(acc) + bias[n]), a bias of T
template <typename T>
struct EpiBiasT {
  const T* __restrict__ bias;
  T* __restrict__ out;
  int N;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    out[(size_t)row * N + col] =
        Num<T>::store(rnd<T>(acc) + Num<T>::load(bias[col]));
  }
  __device__ __forceinline__ void pair(int row, int col, float a0,
                                       float a1) const {
    Num<T>::store2(out + (size_t)row * N + col,
                   rnd<T>(a0) + Num<T>::load(bias[col]),
                   rnd<T>(a1) + Num<T>::load(bias[col + 1]));
  }
  __device__ __forceinline__ void dead(int, int, int, int, int) const {}
};

// out = T(gelu(acc + bias[n])), an fp32 bias
template <typename T>
struct EpiBiasGelu {
  const float* __restrict__ bias;
  T* __restrict__ out;
  int N;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    out[(size_t)row * N + col] = Num<T>::store(gelu_exact(acc + bias[col]));
  }
  __device__ __forceinline__ void dead(int, int, int, int, int) const {}
};

// out = T(res[r, n] + (acc + bias[n])), an fp32 bias
template <typename T>
struct EpiBiasResidual {
  const float* __restrict__ bias;
  const T* __restrict__ res;
  T* __restrict__ out;
  int N;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    const size_t off = (size_t)row * N + col;
    out[off] = Num<T>::store(Num<T>::load(res[off]) + (acc + bias[col]));
  }
  __device__ __forceinline__ void pair(int row, int col, float a0,
                                       float a1) const {
    const size_t off = (size_t)row * N + col;
    const float2 r = Num<T>::load2(res + off);
    Num<T>::store2(out + off, r.x + (a0 + bias[col]),
                   r.y + (a1 + bias[col + 1]));
  }
  __device__ __forceinline__ void dead(int, int, int, int, int) const {}
};

// epi(sum_k a[r, k] w(k, n)) for a [R, K] and w [K, N] (BT false) or
// [N, K] (BT true), row-major in T; K % kKChunk == 0. 64 x 64 output
// tiles, a and w staged kKChunk deep in shared memory, 4 x 4 register
// tiles a thread. valid: a flag per 64-row tile, or NULL (every tile
// live); a dead tile runs epi.dead. grid (ceil(R/64), ceil(N/64)).
template <typename T, class Epi, bool BT = false>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const T* __restrict__ a, const T* __restrict__ w,
    const int8_t* __restrict__ valid, Epi epi, int R, int K, int N) {
  __shared__ float As[kTile][kKChunk + 1];
  __shared__ float Bs[kKChunk][kTile + 1];
  const int r0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (valid != nullptr && valid[blockIdx.x] == 0) {
    epi.dead(r0, min(kTile, R - r0), n0, tid, kThreads);
    return;
  }
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    for (int e = tid; e < kTile * kKChunk; e += kThreads) {
      const int r = e / kKChunk, k = e - r * kKChunk;
      As[r][k] = (r0 + r < R)
          ? Num<T>::load(a[(size_t)(r0 + r) * K + k0 + k]) : 0.0f;
    }
    for (int e = tid; e < kKChunk * kTile; e += kThreads) {
      if constexpr (BT) {
        const int n = e / kKChunk, kk = e - n * kKChunk;
        Bs[kk][n] = (n0 + n < N)
            ? Num<T>::load(w[(size_t)(n0 + n) * K + k0 + kk]) : 0.0f;
      } else {
        const int kk = e / kTile, n = e - kk * kTile;
        Bs[kk][n] = (n0 + n < N)
            ? Num<T>::load(w[(size_t)(k0 + kk) * N + n0 + n]) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKChunk; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) epi(row, col, acc[i][j]);
    }
  }
}

// out = LayerNorm(x) rounded to T, one warp per row of [R, C], through
// layer_norm_row on the row staged in shared memory (8 * C floats of
// dynamic shared memory per block). grid (ceil(R/8)).
template <typename T>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, T* __restrict__ out, int R,
    int C) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + warp;
  if (r >= R) return;
  float* row = rows + warp * C;
  const size_t base = (size_t)r * C;
  // each lane touches only its own columns, so the warp needs no barrier
  for (int c = lane; c < C; c += 32) row[c] = Num<T>::load(x[base + c]);
  layer_norm_row<T>(row, C, gamma, beta, eps, lane);
  for (int c = lane; c < C; c += 32) out[base + c] = Num<T>::store(row[c]);
}

}  // namespace mtp
