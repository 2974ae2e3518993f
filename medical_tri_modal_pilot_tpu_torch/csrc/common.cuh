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
// epilogue) and layer_norm_kernel (torch's LayerNorm, one warp per row).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mtp {

constexpr int kThreads = 256;  // 16 x 16 threads per block
constexpr int kTile = 64;      // rows per tile
constexpr int kKChunk = 32;    // weight rows staged in shared memory per step
constexpr float kMaskFill = -65504.0f;  // valid-but-masked key score
constexpr float kStdLnEps = 1e-6f;       // StdLayerNorm: std + eps
constexpr float kVarFloor = 1e-24f;      // StdLayerNorm variance floor

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
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

// Rows [row0, row0 + kTile) of a row-major [nrows, C] matrix through the
// reference's StdLayerNorm (Bessel std, eps added to the std, variance
// floor), rounded to T, into dst[kTile][lda] fp32. Rows past nrows are
// zero-filled (their results are never stored). Ends with __syncthreads.
template <typename T>
static __device__ __forceinline__ void ln_tile(
    const T* __restrict__ x, int row0, int nrows, int C,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* dst, int lda, int tid) {
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
    const float inv = 1.0f / (sqrtf(fmaxf(var, kVarFloor)) + kStdLnEps);
    for (int c = lane; c < C; c += 32)
      row[c] = rnd<T>(((row[c] - mu) * inv) * gamma[c] + beta[c]);
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

// Epilogues of gemm_kernel (bias of T for kEpiBiasT, else fp32):
constexpr int kEpiBiasT = 0;         // out = T(T(acc) + bias[n])
constexpr int kEpiBiasGelu = 1;      // out = T(gelu(acc + bias[n]))
constexpr int kEpiBiasResidual = 2;  // out = T(res[r, n] + (acc + bias[n]))

// out[r, n] = epilogue(sum_k a[r, k] w[k, n]); a [R, K], w [K, N], res and
// out [R, N] row-major in T; K % kKChunk == 0. 64 x 64 output tiles, a and
// w staged kKChunk deep in shared memory, 4 x 4 register tiles per thread.
// grid (ceil(R/64), ceil(N/64)).
template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const T* __restrict__ a, const T* __restrict__ w,
    const void* __restrict__ bias, const T* __restrict__ res,
    T* __restrict__ out, int R, int K, int N) {
  __shared__ float As[kTile][kKChunk + 1];
  __shared__ float Bs[kKChunk][kTile];
  const int r0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    for (int e = tid; e < kTile * kKChunk; e += kThreads) {
      const int r = e / kKChunk, k = e - r * kKChunk;
      As[r][k] = (r0 + r < R)
          ? Num<T>::load(a[(size_t)(r0 + r) * K + k0 + k]) : 0.0f;
    }
    for (int e = tid; e < kKChunk * kTile; e += kThreads) {
      const int kk = e / kTile, n = e - kk * kTile;
      Bs[kk][n] = (n0 + n < N)
          ? Num<T>::load(w[(size_t)(k0 + kk) * N + n0 + n]) : 0.0f;
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
      if (col >= N) continue;
      const size_t off = (size_t)row * N + col;
      float v;
      if (EPI == kEpiBiasT) {
        v = rnd<T>(acc[i][j]) + Num<T>::load(((const T*)bias)[col]);
      } else if (EPI == kEpiBiasGelu) {
        v = gelu_exact(acc[i][j] + ((const float*)bias)[col]);
      } else {
        v = Num<T>::load(res[off]) + (acc[i][j] + ((const float*)bias)[col]);
      }
      out[off] = Num<T>::store(v);
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
