// The pre-norm FFN block at the width the fused tile loops cannot hold,
//   y = x + drop(W2.drop(relu(W1.StdLN(x) + b1)) + b2),
// C = 512 (d_ff = 2048): the split route, forward and backward, in both
// dtypes.
//
// Replaces, at C = 512, medical_tri_modal_pilot_tpu/kernels/ffn.py::
// _call_fwd (body _fwd_kernel) and ::_call_bwd (body _bwd_kernel),
// reached through pallas_ffn, as ffn.cu does up to C = 256: the TPU kernel
// takes any width.
//
// Why split: ffn.cu's fused forward keeps 128 normalised rows and a
// two-stage W1/W2 chunk ring in shared memory (MlpTc<512>: 410 KB), its
// fused backward 433 KB (FfnBwdTc<512>), past a block's 227 KB, and the
// tile pass's dln accumulators would be 16 x 256 fp32 a warp group (128
// registers a thread). So the route writes its intermediates to device
// memory, as swin_mlp.cu's split route does at Swin-T's stages 3 and 4:
//   forward   ffn_ln_kernel: ln = StdLN(x) rounded to T, [R, C];
//             fc1: hd = drop(relu(round(round(ln . W1) + b1))), [R, F]
//             (Fc1Epi: the hidden mask, 0);
//             fc2: y = x + drop(round(round(hd . W2) + b2)) (Fc2Out: the
//             output mask, 1).
//   backward  ln and hd again, by the forward's kernels (so the values the
//             forward used); ffn_dz_kernel: dz = round(drop(dy) / q);
//             dh = round(dz . W2^T / q) where hd > 0, else 0 (DhEpi: hd > 0
//             exactly where the element was kept and its pre-activation
//             positive); then the StdLN backward of dln = dh . W1^T with
//             the residual cotangent: dx and each tile's dgamma | dbeta
//             partials (bf16: proj_tc.cuh::proj_bwd_tile, the attention
//             block's loop; fp32: ln_tile, dln_tile, stdln_backward_tile);
//             the weight sums are wgrad.cu's over ln, dh, hd and dz
//             (kernels/ffn.py::ffn_weight_sums), as on the fused route.
// Products: bf16 on the tensor cores (mma.cuh gemm_bf16_kernel: 64 x 64
// tiles of mma.sync m16n8k16 over a three-stage cp.async ring, W read
// [K][N] or, for dz . W2^T, [N][K]); fp32, the checking dtype, on FMAs
// (common.cuh gemm_kernel); each with this file's epilogues. The masks are dropout_keep's Philox words keyed by
// (seed, row, column), so they are the fused route's and dropout_masks'
// bit for bit; the roundings and divisions are the fused route's of the
// same dtype (ffn.cu). A dead 64-row tile (flag 0): the forward copies x,
// the backward writes dx = dy and zero partials and nothing else (wgrad
// gets the same flags).
//
// What bounds it on an H100: the operations, 4 R C F forward and 2.5
// times that backward (at R = 65536 rows, 0.27 TFLOP forward: 0.28 ms on
// the tensor cores at 989 TFLOP/s); the bytes of x, y and the weights
// are a few percent of that. A simple first form: the LN is not fused into fc1,
// the [R, F] hidden makes a round trip through device memory (0.5 GB in
// bf16 at that R, about 0.16 ms), and each element draws its own Philox
// word.
#include <algorithm>
#include <type_traits>

#include "mlp_tc.cuh"
#include "proj_tc.cuh"

namespace mtp {

// the width the route is built for (kernels/ffn.py SPLIT_WIDTH)
constexpr int kSplitWidth = 512;

// v / q in the arithmetic of T's fused kernels: bf16 the reciprocal
// product with one FMA correction (div_q), fp32 an IEEE division
template <typename T>
static __device__ __forceinline__ float drop_div(float v, float q,
                                                 float iq) {
  if constexpr (std::is_same<T, bf16>::value)
    return div_q(v, q, iq);
  else
    return v / q;
}

static __device__ __forceinline__ bool tile_live(
    const int8_t* __restrict__ valid, int row) {
  return valid == nullptr || valid[row / kTile] != 0;
}

// ln = StdLN(x) rounded to T (ln_tile's arithmetic: Bessel std, eps added
// to the std, variance floor), for the rows of live tiles; a warp a row,
// C / 32 columns a lane. grid (ceil(R / 8)), kThreads threads.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) ffn_ln_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const int8_t* __restrict__ valid,
    T* __restrict__ ln, int R) {
  constexpr int V = C / 32;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R || !tile_live(valid, r)) return;  // the whole warp
  const T* xr = x + (size_t)r * C;
  float v[V];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = Num<T>::load(xr[lane + 32 * j]);
    s += v[j];
  }
  const float mu = warp_sum(s) / (float)C;
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = v[j] - mu;
    q += d * d;
  }
  const float var = warp_sum(q) / (float)(C - 1);
  const float inv = 1.0f / (sqrtf(fmaxf(var, kVarFloor)) + kStdLnEps);
  T* o = ln + (size_t)r * C;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = lane + 32 * j;
    o[c] = Num<T>::store(((v[j] - mu) * inv) * gamma[c] + beta[c]);
  }
}

// The GEMMs' epilogues, in the form of gemm_kernel's (common.cuh):
// operator() takes element (row, col) of the product's fp32 sum, pair()
// two neighbours, dead() runs in place of a dead tile's product (rows
// [r0, r0 + rows), columns [n0, n0 + 64)).

// the hidden layer: relu(round(round(acc) + b1)), then mask 0
template <typename T>
struct Fc1Epi {
  const T* __restrict__ b1;
  T* __restrict__ h;  // [R, F]
  int F;
  Dropout drop;
  float iq;  // 1 / q_t
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    float v = fmaxf(rnd<T>(rnd<T>(acc) + Num<T>::load(b1[col])), 0.0f);
    if (drop.on)
      v = dropout_keep(drop.key, drop.thr, 0, row, col)
              ? rnd<T>(drop_div<T>(v, drop.q_t, iq)) : 0.0f;
    h[(size_t)row * F + col] = Num<T>::store(v);
  }
  __device__ __forceinline__ void pair(int row, int col, float a0,
                                       float a1) const {
    (*this)(row, col, a0);
    (*this)(row, col + 1, a1);
  }
  __device__ __forceinline__ void dead(int, int, int, int, int) const {}
};

// the output: z = round(round(acc) + b2), mask 1, y = round(x + z); a dead
// tile's rows keep x
template <typename T>
struct Fc2Out {
  const T* __restrict__ b2;
  const T* __restrict__ x;
  T* __restrict__ y;  // [R, C]
  int C;
  Dropout drop;
  float iq;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    float z = rnd<T>(rnd<T>(acc) + Num<T>::load(b2[col]));
    if (drop.on)
      z = dropout_keep(drop.key, drop.thr, 1, row, col)
              ? rnd<T>(drop_div<T>(z, drop.q_t, iq)) : 0.0f;
    const size_t off = (size_t)row * C + col;
    y[off] = Num<T>::store(Num<T>::load(x[off]) + z);
  }
  __device__ __forceinline__ void pair(int row, int col, float a0,
                                       float a1) const {
    (*this)(row, col, a0);
    (*this)(row, col + 1, a1);
  }
  __device__ __forceinline__ void dead(int r0, int rows, int n0, int tid,
                                       int nthreads) const {
    for (int e = tid; e < rows * kTile; e += nthreads) {
      const int r = e / kTile, c = n0 + e % kTile;
      if (c < C) y[(size_t)(r0 + r) * C + c] = x[(size_t)(r0 + r) * C + c];
    }
  }
};

// the hidden cotangent: dh = round(acc / q_f) where hd > 0, else 0
template <typename T>
struct DhEpi {
  const T* __restrict__ hd;
  T* __restrict__ dh;  // [R, F]
  int F;
  float q_f, iq_f;
  int on;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float acc) const {
    const size_t off = (size_t)row * F + col;
    float v = 0.0f;
    if (Num<T>::load(hd[off]) > 0.0f)
      v = on ? drop_div<T>(acc, q_f, iq_f) : acc;
    dh[off] = Num<T>::store(v);
  }
  __device__ __forceinline__ void pair(int row, int col, float a0,
                                       float a1) const {
    (*this)(row, col, a0);
    (*this)(row, col + 1, a1);
  }
  __device__ __forceinline__ void dead(int, int, int, int, int) const {}
};

// dz = round(drop(dy) / q_f) (mask 1; dy itself without dropout) on the
// rows of live tiles, an element a thread. grid-stride.
template <typename T>
__global__ void __launch_bounds__(kThreads) ffn_dz_kernel(
    const T* __restrict__ dy, const int8_t* __restrict__ valid,
    T* __restrict__ dz, int R, int C, Dropout drop) {
  const size_t n = (size_t)R * C;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    const int r = (int)(e / C), c = (int)(e - (size_t)r * C);
    if (!tile_live(valid, r)) continue;
    float d = Num<T>::load(dy[e]);
    if (drop.on)
      d = dropout_keep(drop.key, drop.thr, 1, r, c) ? d / drop.q_f : 0.0f;
    dz[e] = Num<T>::store(d);
  }
}

// The StdLN backward of one 64-row tile on the tensor cores
// (proj_bwd_tile with the residual, dy added once as ffn.cu rounds):
// dln = dh . W1^T over k = F, dx and the tile's dgamma | dbeta sums to
// gpart. Dead tiles write dx = dy and zero partials. grid (ceil(R/64)),
// kThreads threads; C = 16 * NJC.
template <int NJC>
__global__ void __launch_bounds__(kThreads, proj_bwd_min_blocks(16 * NJC))
    ffn_ln_bwd_tc_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const bf16* __restrict__ w1,
                         const int8_t* __restrict__ valid,
                         const bf16* __restrict__ dh,
                         const bf16* __restrict__ dy, bf16* __restrict__ dx,
                         float* __restrict__ gpart, int R, int F) {
  constexpr int C = 16 * NJC;
  extern __shared__ __align__(16) unsigned char ffn_lnb_smem[];
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int rows = min(kTile, R - r0);
  float* gp = gpart + (size_t)tile * 2 * C;
  if (!tile_live(valid, r0)) {
    copy_rows<bf16>(dy, dx, r0, rows, C, threadIdx.x);
    for (int c = threadIdx.x; c < 2 * C; c += kThreads) gp[c] = 0.0f;
    return;
  }
  proj_bwd_tile<NJC, true, true, false>(
      ffn_lnb_smem, x + (size_t)r0 * C, rows, gamma, beta, w1, F,
      Packed<const bf16>{dh + (size_t)r0 * F, F}, dy + (size_t)r0 * C,
      dx + (size_t)r0 * C, nullptr, gp);
}

// The same on fp32 FMAs: the tile's StdLN statistics (ln_tile), dln =
// dh . W1^T (dln_tile), stdln_backward_tile with the residual. Shared
// memory: the tile's StdLN rows [64][C + 1], a dh slice [64][33], a W1
// slice [32][C] (also the column sums' scratch) and the stats [4][64],
// fp32. grid (ceil(R/64)), kThreads threads; C = 16 * NJC.
template <int NJC>
__global__ void __launch_bounds__(kThreads) ffn_ln_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ w1,
    const int8_t* __restrict__ valid, const float* __restrict__ dh,
    const float* __restrict__ dy, float* __restrict__ dx,
    float* __restrict__ gpart, int R, int F) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1, LDK = kKChunk + 1;
  extern __shared__ float ffn_lnb_f32[];
  float* lns = ffn_lnb_f32;
  float* As = lns + kTile * LDA;
  float* Bs = As + kTile * LDK;
  float* stats = Bs + kKChunk * C;
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, R - r0);
  float* gp = gpart + (size_t)tile * 2 * C;
  if (!tile_live(valid, r0)) {
    copy_rows<float>(dy, dx, r0, rows, C, tid);
    for (int c = tid; c < 2 * C; c += kThreads) gp[c] = 0.0f;
    return;
  }
  ln_tile<float>(x, r0, R, C, gamma, beta, lns, LDA, tid, stats);
  float dln[4][NJC];
  zero(dln);
  dln_tile<float, NJC>(dh + (size_t)r0 * F, F, F, rows, w1, As, Bs, dln, tx,
                       ty, tid);
  stdln_backward_tile<float, NJC, false>(dln, x, dy, dx, r0, rows, gamma,
                                         stats, Bs, gp, tx, ty, tid);
}

// shared-memory bytes of the LN backward kernels at width C
__host__ __device__ constexpr int ffn_ln_bwd_f32_smem(int C) {
  return (int)sizeof(float) *
         (kTile * (C + 1) + kTile * (kKChunk + 1) + kKChunk * C + 4 * kTile);
}

// the product a . w (BT: a . w^T) with epi: bf16 on the tensor cores
// (mma.cuh gemm_bf16_kernel), fp32 on FMAs (common.cuh gemm_kernel)
template <bool BT, typename T, class Epi>
static cudaError_t launch_gemm(const T* a, const T* w, const int8_t* valid,
                               const Epi& epi, int R, int K, int N,
                               cudaStream_t stream) {
  const dim3 grid((R + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  if constexpr (std::is_same<T, bf16>::value)
    gemm_bf16_kernel<Epi, BT><<<grid, kGemmThreads, 0, stream>>>(
        a, w, valid, epi, R, K, N);
  else
    gemm_kernel<T, Epi, BT><<<grid, kThreads, 0, stream>>>(a, w, valid, epi,
                                                           R, K, N);
  return cudaGetLastError();
}

// ln, then fc1 into the hidden [R, F] (hd)
template <typename T>
static cudaError_t launch_ln_fc1(const T* x, const float* gamma,
                                 const float* beta, const T* w1, const T* b1,
                                 const int8_t* valid, T* ln, T* hd, int R,
                                 int F, const Dropout& d,
                                 cudaStream_t stream) {
  constexpr int C = kSplitWidth;
  ffn_ln_kernel<T, C><<<(R + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                        0, stream>>>(x, gamma, beta, valid, ln, R);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm<false>(ln, w1, valid,
                            Fc1Epi<T>{b1, hd, F, d, 1.0f / d.q_t}, R, C, F,
                            stream);
}

template <typename T>
static cudaError_t split_fwd(const void* x, const float* gamma,
                             const float* beta, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const int8_t* valid, void* ln, void* hidden,
                             void* y, int R, int F, const Dropout& d,
                             cudaStream_t stream) {
  constexpr int C = kSplitWidth;
  cudaError_t err = launch_ln_fc1<T>((const T*)x, gamma, beta, (const T*)w1,
                                     (const T*)b1, valid, (T*)ln,
                                     (T*)hidden, R, F, d, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<false>(
      (const T*)hidden, (const T*)w2, valid,
      Fc2Out<T>{(const T*)b2, (const T*)x, (T*)y, C, d, 1.0f / d.q_t}, R, F,
      C, stream);
}

template <typename T>
static cudaError_t split_bwd(const void* x, const float* gamma,
                             const float* beta, const void* w1,
                             const void* b1, const void* w2,
                             const int8_t* valid, const void* dy, void* dx,
                             void* ln_o, void* dz_o, void* hd_o, void* dh_o,
                             float* gpart, int R, int F, const Dropout& d,
                             cudaStream_t stream) {
  constexpr int C = kSplitWidth;
  cudaError_t err = launch_ln_fc1<T>((const T*)x, gamma, beta, (const T*)w1,
                                     (const T*)b1, valid, (T*)ln_o,
                                     (T*)hd_o, R, F, d, stream);
  if (err != cudaSuccess) return err;
  const int blocks = (int)std::min<size_t>(
      ((size_t)R * C + kThreads - 1) / kThreads, 4096);
  ffn_dz_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)dy, valid, (T*)dz_o, R, C, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_gemm<true>(
      (const T*)dz_o, (const T*)w2, valid,
      DhEpi<T>{(const T*)hd_o, (T*)dh_o, F, d.q_f, 1.0f / d.q_f, d.on}, R, C,
      F, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (R + kTile - 1) / kTile;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = ln_bwd_tc_smem(C);
    err = cudaFuncSetAttribute(ffn_ln_bwd_tc_kernel<C / 16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ffn_ln_bwd_tc_kernel<C / 16><<<tiles, kThreads, smem, stream>>>(
        (const bf16*)x, gamma, beta, (const bf16*)w1, valid,
        (const bf16*)dh_o, (const bf16*)dy, (bf16*)dx, gpart, R, F);
  } else {
    constexpr int smem = ffn_ln_bwd_f32_smem(C);
    err = cudaFuncSetAttribute(ffn_ln_bwd_kernel<C / 16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ffn_ln_bwd_kernel<C / 16><<<tiles, kThreads, smem, stream>>>(
        (const float*)x, gamma, beta, (const float*)w1, valid,
        (const float*)dh_o, (const float*)dy, (float*)dx, gpart, R, F);
  }
  return cudaGetLastError();
}

}  // namespace mtp

// The forward of the split route: dtype 0 = fp32 (FMAs), 1 = bf16 (the
// tensor cores) for x [R, C], w1 [C, F], b1, w2 [F, C], b2, y and the
// scratches ln [R, C] and hidden [R, F]; gamma and beta fp32; valid: int8
// [ceil(R/64)] tile flags or NULL (every tile live). C = 512, F % 64 ==
// 0. Dropout as ffn_fwd (ffn.cu). Returns cudaGetLastError().
extern "C" int ffn_split_fwd(const void* x, const void* gamma,
                             const void* beta, const void* w1, const void* b1,
                             const void* w2, const void* b2,
                             const void* valid, void* ln, void* hidden,
                             void* y, int R, int C, int F,
                             unsigned long long seed, unsigned int thr,
                             float q_t, int drop, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const Dropout d = make_dropout(seed, thr, q_t, 1.0f, drop);
  if (R < 0 || C != kSplitWidth || F <= 0 || F % kTile != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* v = (const int8_t*)valid;
  if (dtype == 0)
    return (int)split_fwd<float>(x, g, be, w1, b1, w2, b2, v, ln, hidden, y,
                                 R, F, d, s);
  if (dtype == 1)
    return (int)split_fwd<bf16>(x, g, be, w1, b1, w2, b2, v, ln, hidden, y,
                                R, F, d, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of the split route, ffn_bwd's (ffn.cu) arguments and
// outputs: dx, and ln_o, dz_o [R, C], hd_o, dh_o [R, F] (the weight sums'
// operands, written on the rows of live tiles) in the dtype; gpart fp32
// [ceil(R/64), 2C]. C = 512. Returns cudaGetLastError().
extern "C" int ffn_split_bwd(const void* x, const void* gamma,
                             const void* beta, const void* w1, const void* b1,
                             const void* w2, const void* valid,
                             const void* dy, void* dx, void* ln_o,
                             void* dz_o, void* hd_o, void* dh_o, void* gpart,
                             int R, int C, int F, unsigned long long seed,
                             unsigned int thr, float q_t, float q_f, int drop,
                             int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const Dropout d = make_dropout(seed, thr, q_t, q_f, drop);
  if (R <= 0 || C != kSplitWidth || F <= 0 || F % kTile != 0)
    return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* v = (const int8_t*)valid;
  float* gp = (float*)gpart;
  if (dtype == 0)
    return (int)split_bwd<float>(x, g, be, w1, b1, w2, v, dy, dx, ln_o, dz_o,
                                 hd_o, dh_o, gp, R, F, d, s);
  if (dtype == 1)
    return (int)split_bwd<bf16>(x, g, be, w1, b1, w2, v, dy, dx, ln_o, dz_o,
                                hd_o, dh_o, gp, R, F, d, s);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of the split route's LN backward at C = 512 (0 the
// tensor cores' ffn_ln_bwd_tc_kernel, 1 the FMAs' ffn_ln_bwd_kernel):
// kernels/ffn.py::split_smem_bytes mirrors this.
extern "C" int ffn_split_smem(int kernel) {
  using namespace mtp;
  switch (kernel) {
    case 0: return ln_bwd_tc_smem(kSplitWidth);
    case 1: return ffn_ln_bwd_f32_smem(kSplitWidth);
  }
  return -1;
}

// Blocks an SM that the split route's bf16 kernels ask for in their launch
// bounds (0 gemm_bf16_kernel: none, 1; 1 ffn_ln_bwd_tc_kernel):
// kernels/ffn.py::tc_min_blocks mirrors this.
extern "C" int ffn_split_min_blocks(int kernel) {
  using namespace mtp;
  switch (kernel) {
    case 0: return 1;
    case 1: return proj_bwd_min_blocks(kSplitWidth);
  }
  return -1;
}
