// The backward of the Swin blocks' LN -> MLP -> residual,
// y = x + fc2(gelu(fc1(LN(x)))): dx and the parameters' gradients from
// the saved inputs and dy.
//
// Replaces medical_tri_modal_pilot_tpu/kernels/swin_mlp.py::_fused_bwd,
// the custom VJP of the Pallas MLP, which takes jax.vjp of xla_swin_mlp
// (no pallas_call of its own).
//
// The steps, rounded where autograd of the plain version
// (kernels/swin_mlp.py torch_swin_mlp) rounds; T is the compute dtype:
//   ln  = T(LN(x))                      layer_norm_kernel (common.cuh)
//   dg  = T(dy . w2^T)                  gemm, EpiRound
//   h   = ln . w1 + b1 (fp32);  g = T(gelu(h));
//   dh  = T(dg * gelu'(h))              gemm, EpiGeluBwd (h never stored)
//   dln = T(dh . w1^T)                  gemm, EpiRound
//   dx  = T(dy + T(LN backward of dln)) and the per-block sums of dln * n
//       and dln (dscale, dbias)         swin_ln_bwd_kernel
// and, by the wrapper (kernels/swin_mlp.py::_launch_bwd), the weight sums
// dw1 = ln^T dh, db1 = sum dh, dw2 = g^T dy, db2 = sum dy on wgrad.cu, and
// the fixed-order sum of the per-block partials (col_sum_kernel). dg is
// written into dh's buffer and replaced in place by dh, so the backward
// keeps no [R, 4C] tensor beyond g and dh, the weight sums' operands. dh
// leaves the products rounded to T (the plain version keeps it in fp32
// for dln and the weight sums: a bf16 rounding more there, the one the
// wgrad operands need).
//
// The gemms are common.cuh's gemm_kernel (fp32, FMAs, the checking dtype)
// and mma.cuh's gemm_bf16_kernel (bf16, tensor cores) with the epilogues
// below. What bounds it on an H100: five products of 2 R C 4C operations
// (three here, two in wgrad.cu), against R * C elements in and out and
// the two [R, 4C] operands of the weight sums written and read: the
// operations in fp32; in bf16 the bytes at Swin-T's widths (R 200704, C
// 96 at stage 1: 74 GFLOP against 0.8 GB).
#include "common.cuh"
#include "mma.cuh"

namespace mtp {

namespace swin_mlp_bwd {
constexpr float kLnEps = 1e-5f;
}  // namespace swin_mlp_bwd

// out = T(acc)
template <typename T>
struct EpiRound {
  T* __restrict__ out;
  int N;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    out[(size_t)row * N + col] = Num<T>::store(acc);
  }
  __device__ __forceinline__ void pair(int row, int col, float a0,
                                       float a1) const {
    Num<T>::store2(out + (size_t)row * N + col, a0, a1);
  }
  __device__ __forceinline__ void dead(int, int, int, int, int) const {}
};

// GELU's derivative at h (torch's GeluBackward, approximate "none"):
// Phi(h) + h phi(h)
static __device__ __forceinline__ float gelu_grad(float h) {
  constexpr float kAlpha = 0.3989422804014327f;  // 1 / sqrt(2 pi)
  const float cdf = 0.5f * (1.0f + erff(h * 0.70710678118654752f));
  const float pdf = expf(-0.5f * h * h) * kAlpha;
  return cdf + h * pdf;
}

// h = acc + b1[n] in fp32: g = T(gelu(h)); dh holds T(dg) and takes
// T(dg * gelu'(h)) in place. b1 fp32.
template <typename T>
struct EpiGeluBwd {
  const float* __restrict__ b1;
  T* __restrict__ g;
  T* __restrict__ dh;
  int N;
  __device__ __forceinline__ void one(size_t off, float h) const {
    g[off] = Num<T>::store(gelu_exact(h));
    dh[off] = Num<T>::store(Num<T>::load(dh[off]) * gelu_grad(h));
  }
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    one((size_t)row * N + col, acc + b1[col]);
  }
  __device__ __forceinline__ void pair(int row, int col, float a0,
                                       float a1) const {
    const size_t off = (size_t)row * N + col;
    const float h0 = a0 + b1[col], h1 = a1 + b1[col + 1];
    const float2 d = Num<T>::load2(dh + off);
    Num<T>::store2(g + off, gelu_exact(h0), gelu_exact(h1));
    Num<T>::store2(dh + off, d.x * gelu_grad(h0), d.y * gelu_grad(h1));
  }
  __device__ __forceinline__ void dead(int, int, int, int, int) const {}
};

// The LayerNorm backward (torch's: biased variance, eps inside the square
// root) a warp a row, rows [rows b, rows b + rows) of block b: the row's mean
// and 1 / std recomputed from x as layer_norm_row computes them, n =
// (x - mean) / std, dn = dln * scale,
//   dx = T(dy + T(inv (dn - mean(dn) - n mean(dn n))));
// the block's column sums of dln * n and dln (its rows, warp by warp in
// order) to gpart[b, 0:C) and gpart[b, C:2C). x, dln, dy, dx [R, C] in
// T; scale fp32. Dynamic shared memory: 8 warps x (2 rows + 2 sums) x C
// floats. grid (ceil(R / rows)).
template <typename T>
__global__ void __launch_bounds__(kThreads) swin_ln_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dln,
    const T* __restrict__ dy, const float* __restrict__ scale,
    T* __restrict__ dx, float* __restrict__ gpart, int R, int C, int rows) {
  using namespace swin_mlp_bwd;
  extern __shared__ float swin_ln_smem[];
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xr = swin_ln_smem + (size_t)warp * 4 * C;  // x, then n
  float* dr = xr + C;                               // dln
  float* gs = dr + C;                               // sum dln * n
  float* bs = gs + C;                               // sum dln
  // each lane touches only its own columns, so the warp needs no barrier
  for (int c = lane; c < C; c += 32) gs[c] = bs[c] = 0.0f;
  const int r0 = blockIdx.x * rows;
  for (int r = r0 + warp; r < min(R, r0 + rows); r += kWarps) {
    const size_t base = (size_t)r * C;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) {
      xr[c] = Num<T>::load(x[base + c]);
      dr[c] = Num<T>::load(dln[base + c]);
      s += xr[c];
    }
    const float mu = warp_sum(s) / (float)C;
    float v = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mu;
      v += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(v) / (float)C + kLnEps);
    float a = 0.0f, b = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float n = (xr[c] - mu) * inv;
      const float dn = dr[c] * scale[c];
      xr[c] = n;
      a += dn;
      b += dn * n;
      gs[c] += dr[c] * n;
      bs[c] += dr[c];
    }
    a = warp_sum(a) / (float)C;
    b = warp_sum(b) / (float)C;
    for (int c = lane; c < C; c += 32) {
      const float dn = dr[c] * scale[c];
      const float d = rnd<T>(inv * (dn - a - xr[c] * b));
      dx[base + c] = Num<T>::store(Num<T>::load(dy[base + c]) + d);
    }
  }
  __syncthreads();
  float* gp = gpart + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float g = 0.0f, bb = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      g += swin_ln_smem[(size_t)w * 4 * C + 2 * C + c];
      bb += swin_ln_smem[(size_t)w * 4 * C + 3 * C + c];
    }
    gp[c] = g;
    gp[C + c] = bb;
  }
}

template <typename T>
static cudaError_t launch_ln(const void* x, const float* scale,
                             const float* bias, void* ln, int R, int C,
                             cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / 32;
  const size_t smem = sizeof(float) * kRowsPerBlock * C;
  cudaError_t err = cudaFuncSetAttribute(
      layer_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  layer_norm_kernel<T><<<(R + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                         smem, stream>>>((const T*)x, scale, bias,
                                         swin_mlp_bwd::kLnEps, (T*)ln, R, C);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_ln_bwd(const void* x, const void* dln,
                                 const void* dy, const float* scale, void* dx,
                                 float* gpart, int R, int C, int rows,
                                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kThreads / 32) * 4 * C;
  cudaError_t err = cudaFuncSetAttribute(
      swin_ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  swin_ln_bwd_kernel<T><<<(R + rows - 1) / rows, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dln, (const T*)dy, scale, (T*)dx, gpart, R, C,
      rows);
  return cudaGetLastError();
}

// epi(a . w) over [R, K] x [K, N] (BT: w [N, K]) on the dtype's gemm
template <typename T, class Epi, bool BT>
static cudaError_t gemm(const void* a, const void* w, Epi epi, int R, int K,
                        int N, cudaStream_t stream) {
  const dim3 grid((R + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  if constexpr (sizeof(T) == sizeof(float))
    gemm_kernel<float, Epi, BT><<<grid, kThreads, 0, stream>>>(
        (const float*)a, (const float*)w, nullptr, epi, R, K, N);
  else
    gemm_bf16_kernel<Epi, BT><<<grid, kGemmThreads, 0, stream>>>(
        (const bf16*)a, (const bf16*)w, nullptr, epi, R, K, N);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_mlp_bwd(const void* x, const float* scale,
                                  const float* bias, const void* w1,
                                  const float* b1, const void* w2,
                                  const void* dy, void* ln, void* g, void* dh,
                                  void* dln, void* dx, float* gpart, int R,
                                  int C, int F, int rows,
                                  cudaStream_t stream) {
  cudaError_t err = launch_ln<T>(x, scale, bias, ln, R, C, stream);
  if (err != cudaSuccess) return err;
  // dg = dy . w2^T into dh's buffer
  err = gemm<T, EpiRound<T>, true>(dy, w2, EpiRound<T>{(T*)dh, F}, R, C, F,
                                   stream);
  if (err != cudaSuccess) return err;
  err = gemm<T, EpiGeluBwd<T>, false>(ln, w1,
                                      EpiGeluBwd<T>{b1, (T*)g, (T*)dh, F}, R,
                                      C, F, stream);
  if (err != cudaSuccess) return err;
  // dln = dh . w1^T (w1 [C, F] is the [N, K] operand)
  err = gemm<T, EpiRound<T>, true>(dh, w1, EpiRound<T>{(T*)dln, C}, R, F, C,
                                   stream);
  if (err != cudaSuccess) return err;
  return launch_ln_bwd<T>(x, dln, dy, scale, dx, gpart, R, C, rows, stream);
}

}  // namespace mtp

// The backward's row passes: x, dy, dx and the scratches ln, dln [R, C],
// g, dh [R, F] in the dtype (0 = fp32, 1 = bf16); w1 [C, F], w2 [F, C] in
// the dtype; scale, bias (LN), b1 fp32. Writes ln, g, dh (the weight
// sums' operands), dln, dx and gpart fp32 [ceil(R / rows), 2C] (each
// block of `rows` rows: its sums of dln * n, then of dln). C % 32 == 0,
// F % 64 == 0. Returns cudaGetLastError().
extern "C" int swin_mlp_bwd(const void* x, const void* scale,
                            const void* bias, const void* w1, const void* b1,
                            const void* w2, const void* dy, void* ln, void* g,
                            void* dh, void* dln, void* dx, void* gpart, int R,
                            int C, int F, int rows, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0 || C <= 0 || C % kKChunk != 0 || F <= 0 || F % kTile != 0 ||
      rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_mlp_bwd<float>(
        x, (const float*)scale, (const float*)bias, w1, (const float*)b1, w2,
        dy, ln, g, dh, dln, dx, (float*)gpart, R, C, F, rows, s);
  if (dtype == 1)
    return (int)launch_mlp_bwd<__nv_bfloat16>(
        x, (const float*)scale, (const float*)bias, w1, (const float*)b1, w2,
        dy, ln, g, dh, dln, dx, (float*)gpart, R, C, F, rows, s);
  return (int)cudaErrorInvalidValue;
}
