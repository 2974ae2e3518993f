// Swin window attention over pre-windowed tokens [I, 49, C], 32-wide
// heads: qkv projection, per-head scores / sqrt(32) + relative-position
// bias, shifted-window mask (-65504), softmax, @v, output projection.
// Forward only (the trunk is frozen).
//
// Replaces medical_tri_modal_pilot_tpu/kernels/swin_attention.py::
// _pallas_window_attention (body _kernel), reached through
// pallas_window_attention.
//
// What bounds it on an H100: the two projections (8*T*C^2 operations for T
// tokens) outweigh the window products (4*T*49*C) at every stage. Against
// the bytes (x and out, T*C elements each, the weights and the bias) the
// operations are the limit at Swin-T's stages 2-4 and in fp32; at stage 1
// (C = 96) in bf16 the bytes are, narrowly. The TPU kernel keeps a group of windows, q|k|v and both weight
// matrices in VMEM. At C = 768 one window's x is 150 KB in fp32, its q|k|v
// three times that, and w_qkv 7 MB: none of it fits beside the rest in the
// 227 KB of shared memory an SM offers. So here the block splits in three
// launches, each tiled to fit:
//   1. gemm_kernel (common.cuh): q|k|v = x.w_qkv + b_qkv over all I*49
//      rows, into a [I, 49, 3C] scratch in T, 64 x 64 output tiles with the
//      operands staged 32 deep in shared memory;
//   2. window_attn_kernel: one block per (window, head), 49 tokens padded
//      to 64: its q, k and v (32 wide) in shared memory, scores, bias, the
//      window's shift mask (window i of an image takes mask i % M), softmax
//      over the 49 real keys (padded keys are left out), @v, into a
//      [I, 49, C] scratch in T;
//   3. gemm_kernel again: out = heads.w_proj + b_proj.
// The scratches make one round trip through device memory (4x the stream),
// which the TPU kernel avoids; the products are fp32 FMAs on register
// tiles. Tensor cores, and fusing the projections around the window loop,
// are later work.
//
// Rounding follows the plain version (kernels/swin_attention.py), which
// follows the XLA oracle: q|k|v and the projection rounded to T after the
// fp32 sum, then the bias added in T; scores in fp32; probabilities
// rounded to T; @v rounded to T. (The Pallas kernel adds the qkv bias in
// fp32 before rounding; bf16 results may differ from it by one unit.)
#include "common.cuh"

namespace mtp {

constexpr int kWin = 49;     // tokens per 7x7 window
constexpr int kHeadDim = 32;

// heads[i, :, h*32:(h+1)*32] = softmax(q k^T / scale + bias[h], mask) v for
// window i, head h; qkv [I, 49, 3C]; bias [nh, 49, 49] fp32; smask
// [M, 49, 49] int8 (1 = masked) or NULL. grid (I, nh).
template <typename T>
__global__ void __launch_bounds__(kThreads) window_attn_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const int8_t* __restrict__ smask, int M, T* __restrict__ heads, int C,
    float scale) {
  constexpr int LDQ = kHeadDim + 1;
  constexpr int LDP = kTile + 1;
  __shared__ float qs[kTile][LDQ];
  __shared__ float ks[kTile][LDQ];
  __shared__ float vs[kTile][kHeadDim];
  __shared__ float ps[kTile][LDP];
  const int win = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* base = qkv + (size_t)win * kWin * 3 * C + h * kHeadDim;
  for (int e = tid; e < kTile * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, d = e - r * kHeadDim;
    float q = 0.0f, k = 0.0f, v = 0.0f;
    if (r < kWin) {
      const T* row = base + (size_t)r * 3 * C + d;
      q = Num<T>::load(row[0]);
      k = Num<T>::load(row[C]);
      v = Num<T>::load(row[2 * C]);
    }
    qs[r][d] = q;
    ks[r][d] = k;
    vs[r][d] = v;
  }
  __syncthreads();
  float s[4][4];
  zero(s);
#pragma unroll 8
  for (int d = 0; d < kHeadDim; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = qs[ty + 16 * i][d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kb[j] = ks[tx + 16 * j][d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
  }
  const float* bh = bias + (size_t)h * kWin * kWin;
  const int8_t* mw =
      smask == nullptr ? nullptr : smask + (size_t)(win % M) * kWin * kWin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c >= kWin) {
        s[i][j] = -INFINITY;  // padded key: out of the softmax
      } else if (r >= kWin) {
        s[i][j] = 0.0f;       // padded query row: never stored
      } else {
        const int rc = r * kWin + c;
        s[i][j] = (mw != nullptr && mw[rc] != 0)
            ? kMaskFill : s[i][j] / scale + bh[rc];
      }
    }
    float m = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
    m = half_warp_max(m);
    float l = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = expf(s[i][j] - m);
      l += s[i][j];
    }
    l = half_warp_sum(l);
#pragma unroll
    for (int j = 0; j < 4; ++j) ps[r][tx + 16 * j] = rnd<T>(s[i][j] / l);
  }
  __syncthreads();
  float o[4][2];
  zero(o);
#pragma unroll 8
  for (int k = 0; k < kWin; ++k) {
    float pa[4], vb[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = ps[ty + 16 * i][k];
#pragma unroll
    for (int j = 0; j < 2; ++j) vb[j] = vs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) o[i][j] = fmaf(pa[i], vb[j], o[i][j]);
  }
  T* ob = heads + (size_t)win * kWin * C + h * kHeadDim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= kWin) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ob[(size_t)r * C + tx + 16 * j] = Num<T>::store(o[i][j]);
  }
}

template <typename T>
static cudaError_t launch(const void* xw, const void* wqkv, const void* bqkv,
                          const void* wproj, const void* bproj,
                          const float* bias, const int8_t* smask, void* qkv,
                          void* heads, void* out, int I, int C, int M,
                          float scale, cudaStream_t stream) {
  const int R = I * kWin;
  const dim3 g1((R + kTile - 1) / kTile, (3 * C + kTile - 1) / kTile);
  gemm_kernel<T, kEpiBiasT><<<g1, kThreads, 0, stream>>>(
      (const T*)xw, (const T*)wqkv, bqkv, nullptr, (T*)qkv, R, C, 3 * C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  window_attn_kernel<T><<<dim3(I, C / kHeadDim), kThreads, 0, stream>>>(
      (const T*)qkv, bias, smask, M, (T*)heads, C, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g3((R + kTile - 1) / kTile, (C + kTile - 1) / kTile);
  gemm_kernel<T, kEpiBiasT><<<g3, kThreads, 0, stream>>>(
      (const T*)heads, (const T*)wproj, bproj, nullptr, (T*)out, R, C, C);
  return cudaGetLastError();
}

}  // namespace mtp

// dtype: 0 = fp32, 1 = bf16 for xw [I, 49, C], wqkv [C, 3C], bqkv [3C],
// wproj [C, C], bproj [C], the scratches qkv [I, 49, 3C] and heads
// [I, 49, C], and out [I, 49, C]; bias [C/32, 49, 49] fp32; smask int8
// [M, 49, 49] with M dividing I, or NULL (then M is ignored). C % 32 == 0;
// scale = sqrt(32), the score divisor. Returns cudaGetLastError().
extern "C" int swin_attention_fwd(const void* xw, const void* wqkv,
                                  const void* bqkv, const void* wproj,
                                  const void* bproj, const void* bias,
                                  const void* smask, void* qkv, void* heads,
                                  void* out, int I, int C, int M, float scale,
                                  int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bi = (const float*)bias;
  const int8_t* sm = (const int8_t*)smask;
  if (I <= 0 || C <= 0 || C % kHeadDim != 0 || C % kKChunk != 0 ||
      (sm != nullptr && (M <= 0 || I % M != 0)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(xw, wqkv, bqkv, wproj, bproj, bi, sm, qkv,
                              heads, out, I, C, M, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(xw, wqkv, bqkv, wproj, bproj, bi, sm,
                                      qkv, heads, out, I, C, M, scale, s);
  return (int)cudaErrorInvalidValue;
}
