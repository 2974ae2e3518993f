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
// Four routes (kernels/swin_mlp.py::swin_mlp_route), two per dtype:
//   tc_fused (bf16, C <= 256: Swin-T's stages 1 and 2): swin_mlp_tc_kernel,
//     the tile loop of mlp_tc.cuh with LayerNorm, GeluErf and ResidualOut
//     over 128-row tiles: the LN rows in shared memory, W1/W2 chunks of 64
//     hidden columns through a cp.async ring, the hidden chunk kept in
//     registers from the GELU to the second product. Only x is read and y
//     written.
//   tc_split (bf16, C > 256: stages 3 and 4, where the fused tile's
//     accumulator, 16 x C fp32 a warp, outgrows the registers): two
//     tensor-core launches, swin_fc1_tc_kernel (LN-fused fc1: the tile's
//     LN rows in shared memory as the A operand, computed once for a group
//     of 128-column chunks, W1 streamed 32 rows deep through a three-stage
//     ring, bias + GELU on the fragments) into a
//     [R, 4C] bf16 scratch, then gemm_bf16_kernel (mma.cuh) with the bias +
//     residual epilogue. At stages 3 and 4 the scratch (20 and 10 MB for
//     the 33 trunk rows) stays in the 50 MB L2.
//   fma_fused (fp32, C = 96): swin_mlp_kernel, the fused tile on fp32 FMAs
//     (64-row tile, LN rows in shared memory, hidden chunks through shared
//     memory).
//   fma_split (fp32, other widths): layer_norm_kernel, then gemm_kernel
//     with the bias + GELU and the bias + residual epilogues (common.cuh),
//     through [R, C] and [R, 4C] scratches.
// fp32 is the checking dtype: its products stay in full fp32.
//
// Rounding follows the plain version (kernels/swin_mlp.py): LN to T; fc1
// summed in fp32 plus b1 in fp32; GELU (exact, erf) in fp32, then to T;
// fc2 summed in fp32 plus b2; x added in fp32, then rounded to T. Every
// route rounds at the same points.
#include "mlp_tc.cuh"

namespace mtp {

constexpr float kLnEps = 1e-5f;

// grid (ceil(R/64)); C = 16 * NJC; F % kFch == 0.
template <typename T, int NJC>
__global__ void __launch_bounds__(kThreads) swin_mlp_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ y, int R, int F) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1;
  constexpr int LDH = kFch + 1;
  extern __shared__ float smem[];
  float* lns = smem;               // kTile x LDA: LN of the tile
  float* hs = lns + kTile * LDA;   // kTile x LDH: hidden chunk
  float* Bs = hs + kTile * LDH;    // kKChunk x max(C, kFch): weights
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
  for (int f0 = 0; f0 < F; f0 += kFch) {
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
    gemm_tile<T, NJC>(hs, LDH, kFch, w2 + (size_t)f0 * C, C, 0, Bs, acc,
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
  constexpr int BN = C > kFch ? C : kFch;
  const size_t smem = sizeof(float) *
      (kTile * (C + 1) + kTile * (kFch + 1) + kKChunk * BN);
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
  gemm_kernel<<<dim3(row_tiles, (F + kTile - 1) / kTile), kThreads, 0,
                stream>>>((const T*)ln, (const T*)w1, nullptr,
                          EpiBiasGelu<T>{b1, (T*)hidden, F}, R, C, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_kernel<<<dim3(row_tiles, (C + kTile - 1) / kTile), kThreads, 0,
                stream>>>((const T*)hidden, (const T*)w2, nullptr,
                          EpiBiasResidual<T>{b2, (const T*)x, (T*)y, C}, R,
                          F, C);
  return cudaGetLastError();
}

// the fp32 fused kernel's one width: Swin-T's stage 1
constexpr int kFusedWidth = 96;

// ----------------------------------------------------------------------
// bf16 on the tensor cores

// grid (ceil(R / kMlpRows)); F % 64 == 0. Built for C = 32, 64, ..., 256.
template <int C>
__global__ void __launch_bounds__(kMlpThreads, C <= 96 ? 2 : 1)
    swin_mlp_tc_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const bf16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const bf16* __restrict__ w2,
                       const float* __restrict__ b2, bf16* __restrict__ y,
                       int R, int F) {
  extern __shared__ __align__(16) unsigned char swin_mlp_smem[];
  mlp_tile<C>(x, y, w1, w2, R, F, blockIdx.x * kMlpRows,
              LayerNorm{scale, bias, kLnEps}, GeluErf{b1}, ResidualOut{b2},
              swin_mlp_smem);
}

// the LN-fused fc1 of the split route: hidden columns per block, W1 rows
// per cp.async stage, stages in the ring
constexpr int kFc1Cols = 128;
constexpr int kFc1Depth = 32;
constexpr int kFc1Stages = 3;

// shared-memory bytes of swin_fc1_tc_kernel at width C: the tile's LN
// rows [64][C] and the W1 ring [3][32][128], bf16 of pitch width + 8
__host__ __device__ constexpr int fc1_tc_smem(int C) {
  return 2 * (kTile * pitch(C) + kFc1Stages * kFc1Depth * pitch(kFc1Cols));
}

// LayerNorm::row's arithmetic at a width known at run time
static __device__ __forceinline__ void layer_norm_row_bf16(
    bf16* xr, int C, const float* __restrict__ gamma,
    const float* __restrict__ beta, int lane) {
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += bf(xr[c]);
  const float mu = warp_sum(s) / (float)C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = bf(xr[c]) - mu;
    v += d * d;
  }
  const float inv = 1.0f / sqrtf(warp_sum(v) / (float)C + kLnEps);
  for (int c = lane; c < C; c += 32)
    xr[c] = __float2bfloat16_rn((bf(xr[c]) - mu) * inv * gamma[c] + beta[c]);
}

// h[r, n] = bf16(gelu(LN(x)[r] . w1[:, n] + b1[n])) for the 64 rows of a
// tile and a group of 128-column chunks (chunks cpb * blockIdx.y .. + cpb,
// those below F): x staged by cp.async and normalised in place once (the
// A operand), W1 streamed 32 rows deep through a three-stage ring over
// every (chunk, slice) of the group in turn; 8 warps, 4 row slabs x 2
// halves of 64 columns; GeluErf on the fragments after each chunk's last
// slice. C % 32 == 0, F % 64 == 0 (columns past F zero-filled and not
// stored). grid (ceil(R/64), ceil(ceil(F/128) / cpb)).
__global__ void __launch_bounds__(kMlpThreads) swin_fc1_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, const bf16* __restrict__ w1,
    const float* __restrict__ b1, bf16* __restrict__ h, int R, int C, int F,
    int cpb) {
  extern __shared__ __align__(16) unsigned char fc1_smem[];
  constexpr int LDW = pitch(kFc1Cols), WSTAGE = kFc1Depth * LDW;
  constexpr int kPerRow = kFc1Cols / 8;
  const int LDX = pitch(C);
  bf16* xs = reinterpret_cast<bf16*>(fc1_smem);  // [64][LDX]: x, then LN
  bf16* ws = xs + kTile * LDX;                   // [stages][32][LDW]
  const int r0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * cpb;  // the group's first chunk
  const int nc = min(cpb, (F + kFc1Cols - 1) / kFc1Cols - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rs = warp & 3, ch = warp >> 2;
  const int rows = min(kTile, R - r0);
  const int per_row = C / 8;
  for (int e = tid; e < kTile * per_row; e += kMlpThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    const bool in = r < rows;
    cp_async16(xs + r * LDX + c, in ? x + (size_t)(r0 + r) * C + c : x, in);
  }
  const int nk = C / kFc1Depth, total = nc * nk;
  // step s of the walk: slice s % nk of chunk c0 + s / nk
  auto load_w = [&](int s) {
    const int n0 = (c0 + s / nk) * kFc1Cols, ks = s % nk;
    bf16* dst = ws + (s % kFc1Stages) * WSTAGE;
    const bf16* src = w1 + (size_t)ks * kFc1Depth * F + n0;
    for (int e = tid; e < kFc1Depth * kPerRow; e += kMlpThreads) {
      const int r = e / kPerRow, c = (e - r * kPerRow) * 8;
      const bool in = n0 + c < F;
      cp_async16(dst + r * LDW + c, in ? src + (size_t)r * F + c : w1, in);
    }
  };
  load_w(0);
  cp_async_commit();  // x and the first slice
  if (total > 1) load_w(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int r = warp; r < kTile; r += kMlpThreads / 32)
    layer_norm_row_bf16(xs + r * LDX, C, scale, bias, lane);
  const GeluErf gelu{b1};
  float acc[8][4];
  for (int s = 0; s < total; ++s) {
    const int ks = s % nk;
    if (ks == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    // slice s has landed (at s == 0, every row's LN too); every warp is
    // done with slice s - 1, whose stage is refilled next
    cp_async_wait<1>();
    __syncthreads();
    if (s + 2 < total) load_w(s + 2);
    cp_async_commit();
    const bf16* wst = ws + (s % kFc1Stages) * WSTAGE;
#pragma unroll
    for (int kk = 0; kk < kFc1Depth; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, frag_a(xs, LDX, 16 * rs, ks * kFc1Depth + kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, frag_b_kn(wst, LDW, kk, 64 * ch + 16 * np, lane));
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    const int f = (c0 + s / nk) * kFc1Cols + 64 * ch;
    // F % 64 == 0: a warp's 64 columns are all in or all out
    if (ks != nk - 1 || f >= F) continue;
    GeluErf::Pre<8> pre;
#pragma unroll
    for (int q = 0; q < 4; ++q) gelu.pre(pre, q, 0, f, t);
    gelu.apply(acc, pre);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 16 * rs + g + 8 * hh;
        if (r >= R) continue;
        *reinterpret_cast<uint32_t*>(h + (size_t)r * F + f + 8 * j + 2 * t) =
            pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
  }
  cp_async_wait<0>();
}

template <int C>
static cudaError_t launch_fused_tc(const void* x, const float* scale,
                                   const float* bias, const void* w1,
                                   const float* b1, const void* w2,
                                   const float* b2, void* y, int R, int F,
                                   cudaStream_t stream) {
  constexpr int bytes = MlpTc<C>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      swin_mlp_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  swin_mlp_tc_kernel<C><<<(R + kMlpRows - 1) / kMlpRows, kMlpThreads,
                          bytes, stream>>>(
      (const bf16*)x, scale, bias, (const bf16*)w1, b1, (const bf16*)w2, b2,
      (bf16*)y, R, F);
  return cudaGetLastError();
}

// LN-fused fc1 + GELU into the hidden scratch, then fc2 + b2 + x
static cudaError_t launch_split_tc(const void* x, const float* scale,
                                   const float* bias, const void* w1,
                                   const float* b1, const void* w2,
                                   const float* b2, void* hidden, void* y,
                                   int R, int C, int F,
                                   cudaStream_t stream) {
  const int bytes = fc1_tc_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      swin_fc1_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // column groups: each block normalises its rows once for cpb chunks;
  // enough groups for about two blocks an SM
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int row_tiles = (R + kTile - 1) / kTile;
  const int chunks = (F + kFc1Cols - 1) / kFc1Cols;
  const int groups = min(chunks, max(1, (2 * sms + row_tiles - 1) / row_tiles));
  const int cpb = (chunks + groups - 1) / groups;
  swin_fc1_tc_kernel<<<dim3(row_tiles, (chunks + cpb - 1) / cpb),
                       kMlpThreads, bytes, stream>>>(
      (const bf16*)x, scale, bias, (const bf16*)w1, b1, (bf16*)hidden, R, C,
      F, cpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_bf16_kernel<<<dim3(row_tiles, (C + kTile - 1) / kTile),
                     kGemmThreads, 0, stream>>>(
      (const bf16*)hidden, (const bf16*)w2, nullptr,
      EpiBiasResidual<bf16>{b2, (const bf16*)x, (bf16*)y, C}, R, F, C);
  return cudaGetLastError();
}

static cudaError_t dispatch_fused_tc(const void* x, const float* s,
                                     const float* b, const void* w1,
                                     const float* b1, const void* w2,
                                     const float* b2, void* y, int R, int C,
                                     int F, cudaStream_t st) {
  switch (C) {
    case 32: return launch_fused_tc<32>(x, s, b, w1, b1, w2, b2, y, R, F, st);
    case 64: return launch_fused_tc<64>(x, s, b, w1, b1, w2, b2, y, R, F, st);
    case 96: return launch_fused_tc<96>(x, s, b, w1, b1, w2, b2, y, R, F, st);
    case 128: return launch_fused_tc<128>(x, s, b, w1, b1, w2, b2, y, R, F, st);
    case 160: return launch_fused_tc<160>(x, s, b, w1, b1, w2, b2, y, R, F, st);
    case 192: return launch_fused_tc<192>(x, s, b, w1, b1, w2, b2, y, R, F, st);
    case 224: return launch_fused_tc<224>(x, s, b, w1, b1, w2, b2, y, R, F, st);
    case 256: return launch_fused_tc<256>(x, s, b, w1, b1, w2, b2, y, R, F, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mtp

// Routes of swin_mlp_fwd (kernels/swin_mlp.py ROUTES).
enum { kFmaFused = 0, kFmaSplit = 1, kTcFused = 2, kTcSplit = 3 };

// Shared-memory bytes of the bf16 route's LN-fused kernel at width C:
// swin_mlp_tc_kernel at C <= 256, else swin_fc1_tc_kernel; 0 where C %
// 32 != 0.
extern "C" int swin_mlp_tc_smem(int C) {
  using namespace mtp;
  if (C <= 0 || C % kKChunk != 0) return 0;
  switch (C) {
    case 32: return MlpTc<32>::kBytes;
    case 64: return MlpTc<64>::kBytes;
    case 96: return MlpTc<96>::kBytes;
    case 128: return MlpTc<128>::kBytes;
    case 160: return MlpTc<160>::kBytes;
    case 192: return MlpTc<192>::kBytes;
    case 224: return MlpTc<224>::kBytes;
    case 256: return MlpTc<256>::kBytes;
    default: return fc1_tc_smem(C);
  }
}

// x [R, C], w1 [C, F], w2 [F, C], y, and the scratches ln [R, C] and
// hidden [R, F], in fp32 for the fma routes and bf16 for the tc routes;
// scale, bias (LN), b1 and b2 fp32. C % 32 == 0 and F % 64 == 0.
// fma_fused takes C = 96 and no scratch, fma_split both scratches,
// tc_fused C <= 256 and no scratch, tc_split the hidden scratch. Returns
// cudaGetLastError().
extern "C" int swin_mlp_fwd(const void* x, const void* scale,
                            const void* bias, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* ln,
                            void* hidden, void* y, int R, int C, int F,
                            int route, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  const float* c1 = (const float*)b1;
  const float* c2 = (const float*)b2;
  if (R <= 0 || C <= 0 || C % kKChunk != 0 || F <= 0 || F % kFch != 0)
    return (int)cudaErrorInvalidValue;
  switch (route) {
    case kFmaFused:
      if (C != kFusedWidth) return (int)cudaErrorInvalidValue;
      return (int)launch_fused<float, kFusedWidth / 16>(
          x, sc, bi, w1, c1, w2, c2, y, R, F, s);
    case kFmaSplit:
      if (ln == nullptr || hidden == nullptr)
        return (int)cudaErrorInvalidValue;
      return (int)launch_split<float>(x, sc, bi, w1, c1, w2, c2, ln, hidden,
                                      y, R, C, F, s);
    case kTcFused:
      return (int)dispatch_fused_tc(x, sc, bi, w1, c1, w2, c2, y, R, C, F,
                                    s);
    case kTcSplit:
      if (hidden == nullptr || fc1_tc_smem(C) > 232448)
        return (int)cudaErrorInvalidValue;
      return (int)launch_split_tc(x, sc, bi, w1, c1, w2, c2, hidden, y, R, C,
                                  F, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
