// Second half of a Swin block: y = x + fc2(gelu(fc1(LN(x)))), LN eps 1e-5,
// forward only (the trunk is frozen).
//
// Replaces medical_tri_modal_pilot_tpu/kernels/swin_mlp.py::_pallas (body
// _kernel -> _block), reached through pallas_swin_mlp.
//
// What bounds it on an H100: two products of 8*R*C^2 operations each
// (hidden width 4C) against R*C elements in and out, so the operations, not
// the bytes, are the limit. Unfused, the [R, 4C] hidden layer would make a
// round trip through device memory (4x the stream); the TPU kernel keeps it
// in VMEM with both weight matrices.
//
// At C = 96 (Swin-T stage 1, which holds 3/4 of the rows) this kernel
// keeps it in shared memory too: a block owns a 64-row tile, keeps its LN
// rows in shared memory, and walks the hidden width in 64-wide chunks,
// h = gelu(LN.W1[:, c] + b1) into shared memory, acc += h.W2[c, :] in
// registers, the weights streamed from L2 in 32-row slices. Only x is read
// and y written.
//
// Every other width runs as three launches: LN into a [R, C] scratch,
// h = gelu(LN.W1 + b1) into a [R, 4C] scratch, then y = x + h.W2 + b2,
// both products 64 x 64-tiled (gemm_kernel). At C = 384 and 768 the fused
// tile cannot hold: the 64 LN rows alone would take 98 and 196 KB of the
// 227 KB an SM offers, and the 64 x C accumulator 96 or 192 registers a
// thread. At C = 192 it fits, but on an H100 it was no faster than the
// three launches (chip_smoke.py phase 3, bf16, 33 images: 0.900 ms fused,
// 0.873 split), while at C = 96 it is (0.727 against 1.043: a K of 96
// gives fc1's tiles three 32-deep slices, and the 79 MB hidden layer
// outgrows the 50 MB L2). The products are fp32 FMAs on register tiles
// (tensor cores are later work).
//
// Rounding follows the plain version (kernels/swin_mlp.py): LN to T; fc1
// summed in fp32 plus b1 in fp32; GELU (exact, erf) in fp32, then to T;
// fc2 summed in fp32 plus b2; x added in fp32, then rounded to T. The two
// paths round at the same points.
#include "common.cuh"

namespace mtp {

constexpr float kLnEps = 1e-5f;
constexpr int kHidden = 64;  // hidden columns per chunk

// grid (ceil(R/64)); C = 16 * NJC; F % kHidden == 0.
template <typename T, int NJC>
__global__ void __launch_bounds__(kThreads) swin_mlp_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ y, int R, int F) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1;
  constexpr int LDH = kHidden + 1;
  extern __shared__ float smem[];
  float* lns = smem;               // kTile x LDA: LN of the tile
  float* hs = lns + kTile * LDA;   // kTile x LDH: hidden chunk
  float* Bs = hs + kTile * LDH;    // kKChunk x max(C, kHidden): weights
  const int r0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, R - r0);
  for (int e = tid; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    lns[r * LDA + c] = (r < rows)
        ? Num<T>::load(x[(size_t)(r0 + r) * C + c]) : 0.0f;
  }
  __syncthreads();
  for (int r = tid >> 5; r < kTile; r += kThreads / 32)
    layer_norm_row<T>(lns + r * LDA, C, scale, bias, kLnEps, tid & 31);
  __syncthreads();
  float acc[4][NJC];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += kHidden) {
    float hacc[4][4];
    zero(hacc);
    gemm_tile<T, 4>(lns, LDA, C, w1, F, f0, Bs, hacc, tx, ty, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        hs[(ty + 16 * i) * LDH + col] =
            rnd<T>(gelu_exact(hacc[i][j] + b1[f0 + col]));
      }
    // gemm_tile's first barrier orders the hidden-chunk writes before
    // its reads
    gemm_tile<T, NJC>(hs, LDH, kHidden, w2 + (size_t)f0 * C, C, 0, Bs, acc,
                      tx, ty, tid);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJC; ++j) {
      const int col = tx + 16 * j;
      const size_t off = (size_t)(r0 + row) * C + col;
      y[off] = Num<T>::store(Num<T>::load(x[off]) + (acc[i][j] + b2[col]));
    }
  }
}

template <typename T, int NJC>
static cudaError_t launch_fused(const void* x, const float* scale,
                                const float* bias, const void* w1,
                                const float* b1, const void* w2,
                                const float* b2, void* y, int R, int F,
                                cudaStream_t stream) {
  constexpr int C = 16 * NJC;
  constexpr int BN = C > kHidden ? C : kHidden;
  const size_t smem = sizeof(float) *
      (kTile * (C + 1) + kTile * (kHidden + 1) + kKChunk * BN);
  cudaError_t err = cudaFuncSetAttribute(
      swin_mlp_kernel<T, NJC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  swin_mlp_kernel<T, NJC><<<(R + kTile - 1) / kTile, kThreads, smem,
                            stream>>>(
      (const T*)x, scale, bias, (const T*)w1, b1, (const T*)w2, b2, (T*)y,
      R, F);
  return cudaGetLastError();
}

// LN, then fc1 + GELU, then fc2 + residual, through the two scratches
template <typename T>
static cudaError_t launch_split(const void* x, const float* scale,
                                const float* bias, const void* w1,
                                const float* b1, const void* w2,
                                const float* b2, void* ln, void* hidden,
                                void* y, int R, int C, int F,
                                cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / 32;
  const size_t smem = sizeof(float) * kRowsPerBlock * C;
  cudaError_t err = cudaFuncSetAttribute(
      layer_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  layer_norm_kernel<T><<<(R + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                         smem, stream>>>((const T*)x, scale, bias, kLnEps,
                                         (T*)ln, R, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int row_tiles = (R + kTile - 1) / kTile;
  gemm_kernel<T, kEpiBiasGelu>
      <<<dim3(row_tiles, (F + kTile - 1) / kTile), kThreads, 0, stream>>>(
          (const T*)ln, (const T*)w1, b1, nullptr, (T*)hidden, R, C, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_kernel<T, kEpiBiasResidual>
      <<<dim3(row_tiles, (C + kTile - 1) / kTile), kThreads, 0, stream>>>(
          (const T*)hidden, (const T*)w2, b2, (const T*)x, (T*)y, R, F, C);
  return cudaGetLastError();
}

// the one width the fused kernel is instantiated for (see the header)
constexpr int kFusedWidth = 96;

template <typename T>
static cudaError_t dispatch(const void* x, const float* s, const float* b,
                            const void* w1, const float* b1, const void* w2,
                            const float* b2, void* ln, void* hidden, void* y,
                            int R, int C, int F, cudaStream_t st) {
  if (ln != nullptr && hidden != nullptr)
    return launch_split<T>(x, s, b, w1, b1, w2, b2, ln, hidden, y, R, C, F,
                           st);
  if (C != kFusedWidth) return cudaErrorInvalidValue;
  return launch_fused<T, kFusedWidth / 16>(x, s, b, w1, b1, w2, b2, y, R, F,
                                           st);
}

}  // namespace mtp

// 1 where swin_mlp_fwd runs width C fused (and takes NULL scratches).
extern "C" int swin_mlp_fuses(int C) { return C == mtp::kFusedWidth; }

// dtype: 0 = fp32, 1 = bf16 for x [R, C], w1 [C, F], w2 [F, C], the
// scratches ln [R, C] and hidden [R, F], and y; scale, bias (LN), b1 and b2
// fp32. C % 32 == 0 and F % 64 == 0. Given both scratches it runs the
// three launches; given NULL ones, the fused kernel, at a width
// swin_mlp_fuses accepts. Returns cudaGetLastError().
extern "C" int swin_mlp_fwd(const void* x, const void* scale,
                            const void* bias, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* ln,
                            void* hidden, void* y, int R, int C, int F,
                            int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  const float* c1 = (const float*)b1;
  const float* c2 = (const float*)b2;
  if (R <= 0 || C <= 0 || C % kKChunk != 0 || F <= 0 || F % kHidden != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(x, sc, bi, w1, c1, w2, c2, ln, hidden, y, R,
                                C, F, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, sc, bi, w1, c1, w2, c2, ln,
                                        hidden, y, R, C, F, s);
  return (int)cudaErrorInvalidValue;
}
