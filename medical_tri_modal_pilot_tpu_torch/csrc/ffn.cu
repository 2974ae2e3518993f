// Fused pre-norm feed-forward block,
//   y = x + drop(W2.drop(relu(W1.StdLN(x) + b1)) + b2),
// forward with in-kernel dropout and per-tile row skipping, its backward,
// and the dropout masks alone.
//
// Replaces medical_tri_modal_pilot_tpu/kernels/ffn.py::_call_fwd (body
// _fwd_kernel), ::_call_bwd (body _bwd_kernel / _bwd_block) and
// ::dropout_masks (body _masks_kernel), reached through pallas_ffn.
//
// What bounds it on an H100: two products of 2*R*C*F operations each
// (R = 64*1024 rows, C = 256, F = 1024 on the TIE stream) against R*C
// elements in and out, so the operations, not the bytes, are the limit.
// Unfused, the [R, F] hidden layer would make a round trip through device
// memory (4x the stream); the TPU kernel keeps it in VMEM and so does this
// one: a block owns a 64-row tile, keeps its StdLN rows in shared memory,
// and walks d_ff in 64-wide chunks, h = relu(LN.W1[:, c] + b1[c]) into
// shared memory, acc += h.W2[c, :] in registers. Only x is read and y
// written. The products are fp32 FMAs on register tiles (tensor cores are
// later work). A tile whose valid flag is 0 (every row past its sample's
// valid length) copies the residual and does no arithmetic.
//
// Dropout: the TPU kernel draws from the TPU's hardware generator per
// 256-row block; its bits cannot be reproduced here. This kernel keeps an
// element with the Philox4x32-10 draw keyed by (seed, row, column) of the
// flattened [R, F] hidden and [R, C] output (dropout_keep, common.cuh), so
// the masks do not depend on the tile size and the backward regenerates
// them without storing them. Kept values are divided by q = 1 - p rounded
// to T, as the TPU kernel divides by q in its compute dtype.
//
// Backward (ffn_bwd_kernel): per 64-row tile it recomputes StdLN and the
// hidden chunks, regenerates both masks and writes dx. The weight
// gradients sum over all R rows; the TPU accumulates them in its
// sequential grid, which blocks running in parallel cannot do. So the tile
// kernel writes the operands of those sums once, in T (LN, the dropped
// hidden h_d, dz and dh, the values the TPU kernel feeds its products),
// and wgrad.cu reduces them: dW1 = LN^T dh, dW2 = h_d^T dz, in split-K
// slices summed in a fixed order. dgamma and dbeta leave as per-tile
// partial sums, reduced the same way. Deterministic; no atomics.
#include "common.cuh"

namespace mtp {

struct Dropout {
  uint2 key;      // the seed's low and high words
  uint32_t thr;   // keep when the draw is below floor(q * 2^32)
  float q_t;      // q rounded to T (the forward's divisor)
  float q_f;      // q in fp32 (the backward's divisor)
  int on;
};

// grid (ceil(R/64)); C = 16 * NJC.
template <typename T, int NJC>
__global__ void __launch_bounds__(kThreads) ffn_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, const int8_t* __restrict__ valid,
    T* __restrict__ y, int R, int F, Dropout drop) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1;
  constexpr int LDH = kTile + 1;
  extern __shared__ float smem[];
  float* lns = smem;              // kTile x LDA: StdLN of the tile
  float* hs = lns + kTile * LDA;  // kTile x LDH: hidden chunk
  float* Bs = hs + kTile * LDH;   // kKChunk x C: weight chunk
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, R - r0);
  if (valid != nullptr && valid[tile] == 0) {
    copy_rows<T>(x, y, r0, rows, C, tid);
    return;
  }
  ln_tile<T>(x, r0, R, C, gamma, beta, lns, LDA, tid);
  float acc[4][NJC];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += kTile) {
    float hacc[4][4];
    zero(hacc);
    gemm_tile<T, 4>(lns, LDA, C, w1, F, f0, Bs, hacc, tx, ty, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        float h = fmaxf(
            rnd<T>(rnd<T>(hacc[i][j]) + Num<T>::load(b1[f0 + col])), 0.0f);
        if (drop.on)
          h = dropout_keep(drop.key, drop.thr, 0, r0 + row, f0 + col)
                  ? rnd<T>(h / drop.q_t) : 0.0f;
        hs[row * LDH + col] = h;
      }
    // gemm_tile's first barrier orders the hidden-chunk writes before
    // its reads
    gemm_tile<T, NJC>(hs, LDH, kTile, w2 + (size_t)f0 * C, C, 0, Bs, acc,
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
      float z = rnd<T>(rnd<T>(acc[i][j]) + Num<T>::load(b2[col]));
      if (drop.on)
        z = dropout_keep(drop.key, drop.thr, 1, r0 + row, col)
                ? rnd<T>(z / drop.q_t) : 0.0f;
      y[off] = Num<T>::store(Num<T>::load(x[off]) + z);
    }
  }
}

// grid (ceil(R/64)). Writes dx [R, C] and, for the weight gradients, ln_o
// and dz_o [R, C], hd_o and dh_o [R, F] (zeros in skipped tiles) and
// gpart [tiles, 2C] (the tile's dgamma | dbeta sums).
template <typename T, int NJC>
__global__ void __launch_bounds__(kThreads) ffn_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const int8_t* __restrict__ valid, const T* __restrict__ dy,
    T* __restrict__ dx, T* __restrict__ ln_o, T* __restrict__ dz_o,
    T* __restrict__ hd_o, T* __restrict__ dh_o, float* __restrict__ gpart,
    int R, int F, Dropout drop) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1;
  constexpr int LDH = kTile + 1;
  extern __shared__ float smem[];
  float* lns = smem;               // kTile x LDA: StdLN of the tile
  float* dzs = lns + kTile * LDA;  // kTile x LDA: dz, rounded to T
  float* hs = dzs + kTile * LDA;   // kTile x LDH: dh chunk
  float* Bs = hs + kTile * LDH;    // kKChunk x max(C, 64): weight chunk
  float* stats = Bs + kKChunk * (C > kTile ? C : kTile);  // 4 x kTile
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, R - r0);
  float* gp = gpart + (size_t)tile * 2 * C;
  if (valid != nullptr && valid[tile] == 0) {
    // the forward passed x through: dx = dy, nothing reaches the weights
    copy_rows<T>(dy, dx, r0, rows, C, tid);
    zero_rows<T>(ln_o, r0, rows, C, tid);
    zero_rows<T>(dz_o, r0, rows, C, tid);
    zero_rows<T>(hd_o, r0, rows, F, tid);
    zero_rows<T>(dh_o, r0, rows, F, tid);
    for (int c = tid; c < 2 * C; c += kThreads) gp[c] = 0.0f;
    return;
  }
  ln_tile<T>(x, r0, R, C, gamma, beta, lns, LDA, tid, stats);
  for (int e = tid; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    float dz = 0.0f;
    if (r < rows) {
      const size_t off = (size_t)(r0 + r) * C + c;
      dz = Num<T>::load(dy[off]);
      if (drop.on)
        dz = dropout_keep(drop.key, drop.thr, 1, r0 + r, c) ? dz / drop.q_f
                                                            : 0.0f;
      dz = rnd<T>(dz);
      dz_o[off] = Num<T>::store(dz);
      ln_o[off] = Num<T>::store(lns[r * LDA + c]);
    }
    dzs[r * LDA + c] = dz;
  }
  __syncthreads();
  float dln[4][NJC];
  zero(dln);
  for (int f0 = 0; f0 < F; f0 += kTile) {
    float hacc[4][4], dacc[4][4];
    zero(hacc);
    zero(dacc);
    gemm_tile<T, 4>(lns, LDA, C, w1, F, f0, Bs, hacc, tx, ty, tid);
    // dh_d = dz . W2[f0:f0+64, :]^T
    gemm_tile_t<T, 4>(dzs, LDA, C, w2 + (size_t)f0 * C, C, 0, Bs, dacc, tx,
                      ty, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j, f = f0 + col;
        const float hpre = rnd<T>(rnd<T>(hacc[i][j]) + Num<T>::load(b1[f]));
        float hd = fmaxf(hpre, 0.0f);
        float dh = dacc[i][j];
        if (drop.on) {
          const bool keep = dropout_keep(drop.key, drop.thr, 0, r0 + row, f);
          hd = keep ? rnd<T>(hd / drop.q_t) : 0.0f;
          dh = keep ? dh / drop.q_f : 0.0f;
        }
        dh = rnd<T>(hpre > 0.0f ? dh : 0.0f);
        hs[row * LDH + col] = dh;
        if (row < rows) {
          const size_t off = (size_t)(r0 + row) * F + f;
          hd_o[off] = Num<T>::store(hd);
          dh_o[off] = Num<T>::store(dh);
        }
      }
    // dln += dh . W1[:, f0:f0+64]^T (the first barrier orders hs)
    gemm_tile_t<T, NJC>(hs, LDH, kTile, w1 + f0, F, 0, Bs, dln, tx, ty, tid);
  }
  stdln_backward_tile<T, NJC, false>(dln, x, dy, dx, r0, rows, gamma, stats,
                                     Bs, gp, tx, ty, tid);
}

// keep masks as int8: k1 [R, F] (hidden columns col0 .. col0 + F of the
// whole [R, *] mask: one rank's share of d_ff under tensor parallelism)
// and k2 [R, C] (output)
__global__ void __launch_bounds__(kThreads) dropout_masks_kernel(
    int8_t* __restrict__ k1, int8_t* __restrict__ k2, int R, int F, int C,
    int col0, uint2 key, uint32_t thr) {
  const size_t n1 = (size_t)R * F, n = n1 + (size_t)R * C;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    if (e < n1) {
      k1[e] = dropout_keep(key, thr, 0, (int)(e / F), col0 + (int)(e % F));
    } else {
      const size_t e2 = e - n1;
      k2[e2] = dropout_keep(key, thr, 1, (int)(e2 / C), (int)(e2 % C));
    }
  }
}

static Dropout make_dropout(unsigned long long seed, unsigned int thr,
                            float q_t, float q_f, int on) {
  Dropout d;
  d.key = make_uint2((uint32_t)(seed & 0xffffffffull),
                     (uint32_t)(seed >> 32));
  d.thr = thr;
  d.q_t = q_t;
  d.q_f = q_f;
  d.on = on;
  return d;
}

template <typename T, int NJC>
static cudaError_t launch(const void* x, const float* gamma,
                          const float* beta, const void* w1, const void* b1,
                          const void* w2, const void* b2,
                          const int8_t* valid, void* y, int R, int F,
                          Dropout drop, cudaStream_t stream) {
  constexpr int C = 16 * NJC;
  const size_t smem = sizeof(float) *
      (kTile * (C + 1) + kTile * (kTile + 1) + kKChunk * C);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T, NJC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kTile - 1) / kTile;
  ffn_kernel<T, NJC><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, valid, (T*)y, R, F, drop);
  return cudaGetLastError();
}

template <typename T, int NJC>
static cudaError_t launch_bwd(const void* x, const float* gamma,
                              const float* beta, const void* w1,
                              const void* b1, const void* w2,
                              const int8_t* valid, const void* dy, void* dx,
                              void* ln_o, void* dz_o, void* hd_o, void* dh_o,
                              float* gpart, int R, int F, Dropout drop,
                              cudaStream_t stream) {
  constexpr int C = 16 * NJC;
  const size_t smem = sizeof(float) *
      (2 * kTile * (C + 1) + kTile * (kTile + 1) +
       kKChunk * (C > kTile ? C : kTile) + 4 * kTile);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_kernel<T, NJC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kTile - 1) / kTile;
  ffn_bwd_kernel<T, NJC><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, (const T*)w1, (const T*)b1, (const T*)w2,
      valid, (const T*)dy, (T*)dx, (T*)ln_o, (T*)dz_o, (T*)hd_o, (T*)dh_o,
      gpart, R, F, drop);
  return cudaGetLastError();
}

}  // namespace mtp

// dtype: 0 = fp32, 1 = bf16 for x, w1 [C, F], b1, w2 [F, C], b2 and y;
// gamma and beta fp32; valid: int8 [ceil(R/64)] tile flags or NULL (every
// tile live). C in {64, 256}, F % 64 == 0. Dropout when drop != 0: keep
// below thr, kept values divided by q_t. Returns cudaGetLastError().
extern "C" int ffn_fwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* valid, void* y, int R,
                       int C, int F, unsigned long long seed,
                       unsigned int thr, float q_t, int drop, int dtype,
                       void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* v = (const int8_t*)valid;
  const Dropout d = make_dropout(seed, thr, q_t, 1.0f, drop);
  if (F <= 0 || F % kTile != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && C == 256)
    return (int)launch<float, 16>(x, g, be, w1, b1, w2, b2, v, y, R, F, d, s);
  if (dtype == 0 && C == 64)
    return (int)launch<float, 4>(x, g, be, w1, b1, w2, b2, v, y, R, F, d, s);
  if (dtype == 1 && C == 256)
    return (int)launch<__nv_bfloat16, 16>(x, g, be, w1, b1, w2, b2, v, y, R, F, d, s);
  if (dtype == 1 && C == 64)
    return (int)launch<__nv_bfloat16, 4>(x, g, be, w1, b1, w2, b2, v, y, R, F, d, s);
  return (int)cudaErrorInvalidValue;
}

// The backward tile pass. dy, dx, ln_o, dz_o [R, C] and hd_o, dh_o [R, F]
// in the dtype; gpart fp32 [ceil(R/64), 2C]. Dropout as ffn_fwd, with
// q_f = q in fp32 dividing the cotangents.
extern "C" int ffn_bwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* valid, const void* dy, void* dx,
                       void* ln_o, void* dz_o, void* hd_o, void* dh_o,
                       void* gpart, int R, int C, int F,
                       unsigned long long seed, unsigned int thr, float q_t,
                       float q_f, int drop, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* v = (const int8_t*)valid;
  float* gp = (float*)gpart;
  const Dropout d = make_dropout(seed, thr, q_t, q_f, drop);
  if (F <= 0 || F % kTile != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && C == 256)
    return (int)launch_bwd<float, 16>(x, g, be, w1, b1, w2, v, dy, dx, ln_o, dz_o, hd_o, dh_o, gp, R, F, d, s);
  if (dtype == 0 && C == 64)
    return (int)launch_bwd<float, 4>(x, g, be, w1, b1, w2, v, dy, dx, ln_o, dz_o, hd_o, dh_o, gp, R, F, d, s);
  if (dtype == 1 && C == 256)
    return (int)launch_bwd<__nv_bfloat16, 16>(x, g, be, w1, b1, w2, v, dy, dx, ln_o, dz_o, hd_o, dh_o, gp, R, F, d, s);
  if (dtype == 1 && C == 64)
    return (int)launch_bwd<__nv_bfloat16, 4>(x, g, be, w1, b1, w2, v, dy, dx, ln_o, dz_o, hd_o, dh_o, gp, R, F, d, s);
  return (int)cudaErrorInvalidValue;
}

// The keep masks the two kernels above draw for (seed, thr): int8 k1
// [R, F] and k2 [R, C], 1 = kept; k1 holds hidden columns col0 .. col0 + F
// (col0 = 0: the kernels' own mask).
extern "C" int ffn_dropout_masks(void* k1, void* k2, int R, int F, int C,
                                 int col0, unsigned long long seed,
                                 unsigned int thr, void* stream) {
  using namespace mtp;
  const Dropout d = make_dropout(seed, thr, 1.0f, 1.0f, 1);
  const size_t n = (size_t)R * (F + C);
  const int blocks = (int)((n + kThreads - 1) / kThreads < 4096
                               ? (n + kThreads - 1) / kThreads : 4096);
  if (blocks <= 0) return 0;
  dropout_masks_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int8_t*)k1, (int8_t*)k2, R, F, C, col0, d.key, d.thr);
  return (int)cudaGetLastError();
}
