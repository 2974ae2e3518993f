// Row-block-skipped projections, forward and backward:
//   y = x.W + b                  (LN false: rowmm)
//   q|k|v = StdLN(x).W + b       (LN true: rowmm_ln, the attention pre-norm
//                                 fused into the q|k|v projection)
// over x [R, Cin], skipping the row blocks whose flag is 0 (every row
// padding).
//
// Replaces medical_tri_modal_pilot_tpu/kernels/rowmm.py::_call_fwd (body
// _fwd_kernel), ::_call_bwd (_bwd_kernel), ::_call_ln_fwd (_fwd_ln_kernel)
// and ::_call_ln_bwd (_bwd_ln_kernel), reached through
// pallas_rowskip_affine and pallas_rowskip_ln_affine. Under tensor
// parallelism the LN form projects one rank's q|k|v columns of the TIE
// stream: x [64 * 1024, 256], W [256, 384] per rank at --mp-size 2.
//
// What bounds it on an H100: 2 Cin Cout operations per live row (16
// GFLOP at [65536, 256] x [256, 768] with 5/8 of the rows live) against x
// read on the live rows and every output row written (100 MB in bf16 at
// that shape, dead blocks' zeros included): in bf16 the bytes bound it
// (0.036 ms against 0.016 ms of operations at 989 TFLOP/s). Two routes,
// picked by dtype (kernels/rowmm.py::rowmm_route):
//
//   tc (bf16), on the tensor cores through the projection tile loops the
//     attention block runs too (proj_tc.cuh; mma.sync m16n8k16, fp32
//     accumulate):
//     rowmm_tc_kernel: one block per 64-row tile, two blocks an SM; a
//       dead tile (its 256-row flag 0) writes zeros in 16-byte pieces and
//       reads nothing; a live one stages x by cp.async, normalises it in
//       place (LN form), and walks the output columns in 128-column
//       chunks against a three-stage ring of 64 x 128 W chunks, each
//       chunk leaving through shared memory in 16-byte pieces
//       (proj_fwd_tile, whose note gives what bounds the loop).
//     rowmm_bwd_tc_kernel: one block per 64-row tile: dA = dy . W^T with
//       dy and W^T in 32-deep chunks through a three-stage ring
//       (proj_bwd_tile); the LN form recomputes StdLN (rows to ln_o) and
//       runs its backward with the variance-floor flag on the fragments,
//       the plain form writes dx = round(dA). Dead tiles write dx = 0 and
//       zero partials.
//   fma (fp32, the checking dtype): fp32 FMAs on 4 x 4 register tiles
//     (gemm_tile, gemm_tile_t), exact to the fp32 oracle: rowmm_kernel
//     and rowmm_bwd_kernel, one block per 64-row tile, the tile's (StdLN)
//     rows in shared memory, 64 output columns at a time.
//
// The TPU kernel's point is what it keeps out of device memory, and so is
// this one's: the StdLN rows of a tile live in shared memory and never
// make a round trip, and a dead tile reads nothing. The product rounds to
// T before the bias is added in T (rowmm.py:59, :111-114). The LN form
// writes q, k and v as three packed [R, Cout / 3] outputs, as the TPU
// kernel does (:115-118).
//
// Backward: the TPU kernel adds each block's dW and db into one output as
// its sequential grid walks the rows; here the tile pass writes the A
// operand of dW (the rounded StdLN rows; x itself for the plain form) and
// the LN form's dgamma | dbeta partials per tile, and wgrad.cu sums A^T dy
// and the column sums of dy over the live rows only, in split-K slices in
// a fixed order. Deterministic; no atomics.
#include "proj_tc.cuh"

namespace mtp {

// Rows [r0, r0 + kTile) of row-major x [R, C] as fp32 into dst[kTile][lda]
// (zeros past R). Ends with __syncthreads.
template <typename T>
static __device__ __forceinline__ void stage_rows(const T* __restrict__ x,
                                                  int r0, int R, int C,
                                                  float* dst, int lda,
                                                  int tid) {
  for (int e = tid; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    dst[r * lda + c] =
        (r0 + r < R) ? Num<T>::load(x[(size_t)(r0 + r) * C + c]) : 0.0f;
  }
  __syncthreads();
}

// grid (ceil(R/64)); Cin = 16 * NJC; Cout and Cs multiples of 64. Output
// column n goes to outs[n / Cs] at column n % Cs (Cs = Cout: one output).
template <typename T, int NJC, bool LN>
__global__ void __launch_bounds__(kThreads) rowmm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w,
    const T* __restrict__ b, const int8_t* __restrict__ valid, T* out0,
    T* out1, T* out2, int R, int Cout, int Cs) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1;
  extern __shared__ float smem[];
  float* as = smem;               // kTile x LDA: the tile's (StdLN) rows
  float* Bs = as + kTile * LDA;   // kKChunk x 64: weight chunk
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, R - r0);
  T* outs[3] = {out0, out1, out2};
  if (valid[r0 / kBlockR] == 0) {
    for (int e = tid; e < rows * Cout; e += kThreads) {
      const int r = e / Cout, n = e - r * Cout, o = n / Cs;
      outs[o][(size_t)(r0 + r) * Cs + n - o * Cs] = Num<T>::store(0.0f);
    }
    return;
  }
  if (LN)
    ln_tile<T>(x, r0, R, C, gamma, beta, as, LDA, tid);
  else
    stage_rows<T>(x, r0, R, C, as, LDA, tid);
  for (int n0 = 0; n0 < Cout; n0 += kTile) {
    float acc[4][4];
    zero(acc);
    gemm_tile<T, 4>(as, LDA, C, w, Cout, n0, Bs, acc, tx, ty, tid);
    const int o = n0 / Cs, c0 = n0 - o * Cs;
    T* out = outs[o];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float v = rnd<T>(acc[i][j]) + Num<T>::load(b[n0 + col]);
        out[(size_t)(r0 + row) * Cs + c0 + col] = Num<T>::store(v);
      }
    }
  }
}

// grid (ceil(R/64)). dy is dy0 | dy1 | dy2 (each [R, Cs]; one [R, Cout]
// when Cs = Cout). Writes dx [R, Cin] (zeros in dead tiles); the LN form
// also writes ln_o [R, Cin] in live tiles (the rounded StdLN rows, the A
// operand of dW) and gpart [tiles, 2 Cin] (the tile's dgamma | dbeta sums,
// zeros in dead tiles).
template <typename T, int NJC, bool LN>
__global__ void __launch_bounds__(kThreads) rowmm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w,
    const int8_t* __restrict__ valid, const T* dy0, const T* dy1,
    const T* dy2, T* __restrict__ dx, T* __restrict__ ln_o,
    float* __restrict__ gpart, int R, int Cout, int Cs) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1;
  constexpr int LDD = kTile + 1;
  extern __shared__ float smem[];
  float* dys = smem;                  // kTile x LDD: 64 columns of dy
  float* Bs = dys + kTile * LDD;      // kKChunk x C: weight chunk; also
                                      // the 16 x C reduction scratch
  float* stats = Bs + kKChunk * C;    // 4 x kTile (LN form)
  float* lns = stats + 4 * kTile;     // kTile x LDA (LN form)
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, R - r0);
  const T* dys_in[3] = {dy0, dy1, dy2};
  if (valid[r0 / kBlockR] == 0) {
    zero_rows<T>(dx, r0, rows, C, tid);
    if (LN)
      for (int c = tid; c < 2 * C; c += kThreads)
        gpart[(size_t)tile * 2 * C + c] = 0.0f;
    return;
  }
  if (LN) {
    ln_tile<T>(x, r0, R, C, gamma, beta, lns, LDA, tid, stats);
    for (int e = tid; e < rows * C; e += kThreads) {
      const int r = e / C, c = e - r * C;
      ln_o[(size_t)(r0 + r) * C + c] = Num<T>::store(lns[r * LDA + c]);
    }
  }
  float dln[4][NJC];
  zero(dln);
  for (int k0 = 0; k0 < Cout; k0 += kTile) {
    const int o = k0 / Cs, c0 = k0 - o * Cs;
    const T* d = dys_in[o];
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e - r * kTile;
      dys[r * LDD + c] =
          r < rows ? Num<T>::load(d[(size_t)(r0 + r) * Cs + c0 + c]) : 0.0f;
    }
    // dln += dy[:, k0:k0+64] . W[:, k0:k0+64]^T (gemm_tile_t's first
    // barrier orders the dy writes before its reads; it ends with one)
    gemm_tile_t<T, NJC>(dys, LDD, kTile, w + k0, Cout, 0, Bs, dln, tx, ty,
                        tid);
  }
  if (LN) {
    stdln_backward_tile<T, NJC, false>(dln, x, nullptr, dx, r0, rows, gamma,
                                       stats, Bs,
                                       gpart + (size_t)tile * 2 * C, tx, ty,
                                       tid);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < NJC; ++j)
        dx[(size_t)(r0 + row) * C + tx + 16 * j] = Num<T>::store(dln[i][j]);
    }
  }
}

// ---- the bf16 route on the tensor cores ----

// rows [r0, r0 + rows) of a row-major bf16 [*, C] array set to zero in
// 16-byte pieces, by kThreads threads (C % 8 == 0)
static __device__ __forceinline__ void zero_rows16(bf16* p, int r0, int rows,
                                                   int C, int tid) {
  uint4* d = reinterpret_cast<uint4*>(p + (size_t)r0 * C);
  for (int e = tid; e < rows * (C / 8); e += kThreads)
    d[e] = make_uint4(0, 0, 0, 0);
}

// out0 | out1 | out2 (each [R, Cs]; out0 alone [R, Cout] when Cs = Cout)
// for the 64-row tile at blockIdx.x. Cin % 64 == 0, Cout and Cs multiples
// of 64. grid (ceil(R/64)), kProjThreads threads; MINB blocks an SM
// (proj_fwd_min_blocks: two up to Cin = 256, one at 512).
template <bool LN, int MINB>
__global__ void __launch_bounds__(kProjThreads, MINB)
    rowmm_tc_kernel(const bf16* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const bf16* __restrict__ w, const bf16* __restrict__ b,
                    const int8_t* __restrict__ valid, bf16* out0, bf16* out1,
                    bf16* out2, int R, int Cin, int Cout, int Cs) {
  extern __shared__ __align__(16) unsigned char rowmm_smem[];
  const int r0 = blockIdx.x * kTile, rows = min(kTile, R - r0);
  if (valid[r0 / kBlockR] == 0) {
    bf16* outs[3] = {out0, out1, out2};
    for (int o = 0; o < Cout / Cs; ++o)
      zero_rows16(outs[o], r0, rows, Cs, threadIdx.x);
    return;
  }
  proj_fwd_tile<LN>(
      rowmm_smem, x + (size_t)r0 * Cin, rows, Cin, gamma, beta, w, b, Cout,
      Split<bf16>{out0, out1, out2, Cs, r0});
}

// The backward tile pass of one 64-row tile: dx [R, Cin] (zeros in dead
// tiles); the LN form also ln_o [R, Cin] on live tiles and gpart
// [ceil(R/64), 2 Cin] (zeros in dead tiles). dy0 | dy1 | dy2 as the
// forward's outputs. grid (ceil(R/64)), kThreads; Cin = 16 * NJC. Two
// blocks an SM up to Cin = 256; at 512 the 128 fp32 dA accumulators a
// thread and the 201 KB ring take one (proj_bwd_min_blocks).
template <int NJC, bool LN>
__global__ void __launch_bounds__(kThreads, proj_bwd_min_blocks(16 * NJC))
    rowmm_bwd_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w,
    const int8_t* __restrict__ valid, const bf16* dy0, const bf16* dy1,
    const bf16* dy2, bf16* __restrict__ dx, bf16* __restrict__ ln_o,
    float* __restrict__ gpart, int R, int Cout, int Cs) {
  constexpr int C = 16 * NJC;
  extern __shared__ __align__(16) unsigned char rowmm_bwd_smem[];
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int rows = min(kTile, R - r0);
  float* gp = LN ? gpart + (size_t)tile * 2 * C : nullptr;
  if (valid[r0 / kBlockR] == 0) {
    zero_rows16(dx, r0, rows, C, threadIdx.x);
    if (LN)
      for (int c = threadIdx.x; c < 2 * C; c += kThreads) gp[c] = 0.0f;
    return;
  }
  proj_bwd_tile<NJC, LN, false>(
      rowmm_bwd_smem, x + (size_t)r0 * C, rows, gamma, beta, w, Cout,
      Split<const bf16>{dy0, dy1, dy2, Cs, r0}, nullptr, dx + (size_t)r0 * C,
      LN ? ln_o + (size_t)r0 * C : nullptr, gp);
}

template <bool LN, int MINB>
static cudaError_t launch_fwd_tc_at(const void* x, const float* gamma,
                                    const float* beta, const void* w,
                                    const void* b, const int8_t* valid,
                                    void* out0, void* out1, void* out2,
                                    int R, int Cin, int Cout, int Cs,
                                    cudaStream_t stream) {
  const int smem = proj_fwd_smem(Cin);
  cudaError_t err = cudaFuncSetAttribute(
      rowmm_tc_kernel<LN, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  rowmm_tc_kernel<LN, MINB><<<(R + kTile - 1) / kTile, kProjThreads, smem,
                              stream>>>(
      (const bf16*)x, gamma, beta, (const bf16*)w, (const bf16*)b, valid,
      (bf16*)out0, (bf16*)out1, (bf16*)out2, R, Cin, Cout, Cs);
  return cudaGetLastError();
}

template <bool LN>
static cudaError_t launch_fwd_tc(const void* x, const float* gamma,
                                 const float* beta, const void* w,
                                 const void* b, const int8_t* valid,
                                 void* out0, void* out1, void* out2, int R,
                                 int Cin, int Cout, int Cs,
                                 cudaStream_t stream) {
  if (proj_fwd_min_blocks(Cin) == 1)
    return launch_fwd_tc_at<LN, 1>(x, gamma, beta, w, b, valid, out0, out1,
                                   out2, R, Cin, Cout, Cs, stream);
  return launch_fwd_tc_at<LN, 2>(x, gamma, beta, w, b, valid, out0, out1,
                                 out2, R, Cin, Cout, Cs, stream);
}

template <int NJC, bool LN>
static cudaError_t launch_bwd_tc(const void* x, const float* gamma,
                                 const float* beta, const void* w,
                                 const int8_t* valid, const void* dy0,
                                 const void* dy1, const void* dy2, void* dx,
                                 void* ln_o, float* gpart, int R, int Cout,
                                 int Cs, cudaStream_t stream) {
  constexpr int smem = proj_bwd_smem(16 * NJC, LN);
  cudaError_t err = cudaFuncSetAttribute(
      rowmm_bwd_tc_kernel<NJC, LN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rowmm_bwd_tc_kernel<NJC, LN><<<(R + kTile - 1) / kTile, kThreads, smem,
                                 stream>>>(
      (const bf16*)x, gamma, beta, (const bf16*)w, valid, (const bf16*)dy0,
      (const bf16*)dy1, (const bf16*)dy2, (bf16*)dx, (bf16*)ln_o, gpart, R,
      Cout, Cs);
  return cudaGetLastError();
}

template <int NJC>
static cudaError_t bwd_tc(int ln, const void* x, const float* g,
                          const float* be, const void* w, const int8_t* v,
                          const void* d0, const void* d1, const void* d2,
                          void* dx, void* ln_o, float* gp, int R, int Cout,
                          int Cs, cudaStream_t s) {
  return ln ? launch_bwd_tc<NJC, true>(x, g, be, w, v, d0, d1, d2, dx, ln_o,
                                        gp, R, Cout, Cs, s)
            : launch_bwd_tc<NJC, false>(x, g, be, w, v, d0, d1, d2, dx,
                                         ln_o, gp, R, Cout, Cs, s);
}

// ---- the fp32 route (FMA) ----

template <typename T, int NJC, bool LN>
static cudaError_t launch_fwd(const void* x, const float* gamma,
                              const float* beta, const void* w, const void* b,
                              const int8_t* valid, void* out0, void* out1,
                              void* out2, int R, int Cout, int Cs,
                              cudaStream_t stream) {
  constexpr int C = 16 * NJC;
  const size_t smem = sizeof(float) * (kTile * (C + 1) + kKChunk * kTile);
  cudaError_t err = cudaFuncSetAttribute(
      rowmm_kernel<T, NJC, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kTile - 1) / kTile;
  rowmm_kernel<T, NJC, LN><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, (const T*)w, (const T*)b, valid, (T*)out0,
      (T*)out1, (T*)out2, R, Cout, Cs);
  return cudaGetLastError();
}

template <typename T, int NJC, bool LN>
static cudaError_t launch_bwd(const void* x, const float* gamma,
                              const float* beta, const void* w,
                              const int8_t* valid, const void* dy0,
                              const void* dy1, const void* dy2, void* dx,
                              void* ln_o, float* gpart, int R, int Cout,
                              int Cs, cudaStream_t stream) {
  constexpr int C = 16 * NJC;
  const size_t smem = sizeof(float) *
      (kTile * (kTile + 1) + kKChunk * C + 4 * kTile +
       (LN ? kTile * (C + 1) : 0));
  cudaError_t err = cudaFuncSetAttribute(
      rowmm_bwd_kernel<T, NJC, LN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kTile - 1) / kTile;
  rowmm_bwd_kernel<T, NJC, LN><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, (const T*)w, valid,
      (const T*)dy0, (const T*)dy1, (const T*)dy2, (T*)dx, (T*)ln_o, gpart,
      R, Cout, Cs);
  return cudaGetLastError();
}

template <typename T, int NJC>
static cudaError_t fwd_ln(int ln, const void* x, const float* g,
                          const float* be, const void* w, const void* b,
                          const int8_t* v, void* o0, void* o1, void* o2,
                          int R, int Cout, int Cs, cudaStream_t s) {
  return ln ? launch_fwd<T, NJC, true>(x, g, be, w, b, v, o0, o1, o2, R,
                                        Cout, Cs, s)
            : launch_fwd<T, NJC, false>(x, g, be, w, b, v, o0, o1, o2, R,
                                         Cout, Cs, s);
}

template <typename T, int NJC>
static cudaError_t bwd_ln(int ln, const void* x, const float* g,
                          const float* be, const void* w, const int8_t* v,
                          const void* d0, const void* d1, const void* d2,
                          void* dx, void* ln_o, float* gp, int R, int Cout,
                          int Cs, cudaStream_t s) {
  return ln ? launch_bwd<T, NJC, true>(x, g, be, w, v, d0, d1, d2, dx,
                                        ln_o, gp, R, Cout, Cs, s)
            : launch_bwd<T, NJC, false>(x, g, be, w, v, d0, d1, d2, dx,
                                         ln_o, gp, R, Cout, Cs, s);
}

static bool shapes_ok(int R, int Cout, int Cs) {
  return R > 0 && Cout > 0 && Cout % kTile == 0 && Cs > 0 &&
         Cs % kTile == 0 && Cout % Cs == 0 && Cout / Cs <= 3;
}

}  // namespace mtp

// dtype: 0 = fp32 (the FMA kernels), 1 = bf16 (the tensor cores) for x
// [R, Cin], w [Cin, Cout], b [Cout] and the outputs; gamma and beta fp32
// [Cin] (LN form only, else NULL). valid: int8 flags, one per kBlockR
// (256) consecutive rows. ln != 0: the LN form,
// outputs out0 | out1 | out2 each [R, Cs] with Cs = Cout / 3; else one
// output out0 [R, Cout] (Cs = Cout). Cin in {64, 128, 256, 512}; Cout and
// Cs multiples of 64. Returns cudaGetLastError().
extern "C" int rowmm_fwd(const void* x, const void* gamma, const void* beta,
                         const void* w, const void* b, const void* valid,
                         void* out0, void* out1, void* out2, int R, int Cin,
                         int Cout, int Cs, int ln, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* v = (const int8_t*)valid;
  if (!shapes_ok(R, Cout, Cs) || (ln && Cs * 3 != Cout))
    return (int)cudaErrorInvalidValue;
#define MTP_FWD(CIN) \
  if (dtype == 0 && Cin == CIN) \
    return (int)fwd_ln<float, CIN / 16>(ln, x, g, be, w, b, v, out0, out1, out2, R, Cout, Cs, s);
  MTP_FWD(64) MTP_FWD(128) MTP_FWD(256) MTP_FWD(512)
#undef MTP_FWD
  if (dtype == 1 && model_width(Cin))
    return (int)(ln ? launch_fwd_tc<true>(x, g, be, w, b, v, out0, out1, out2, R, Cin, Cout, Cs, s)
                    : launch_fwd_tc<false>(x, g, be, w, b, v, out0, out1, out2, R, Cin, Cout, Cs, s));
  return (int)cudaErrorInvalidValue;
}

// The backward tile pass. dy0 | dy1 | dy2 as the forward's outputs (dy0
// alone for the plain form), dx [R, Cin] and ln_o [R, Cin] in the dtype
// (ln_o and gpart, fp32 [ceil(R/64), 2 Cin], for the LN form only, else
// NULL). The weight gradients are wgrad_partials' work.
extern "C" int rowmm_bwd(const void* x, const void* gamma, const void* beta,
                         const void* w, const void* valid, const void* dy0,
                         const void* dy1, const void* dy2, void* dx,
                         void* ln_o, void* gpart, int R, int Cin, int Cout,
                         int Cs, int ln, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* v = (const int8_t*)valid;
  float* gp = (float*)gpart;
  if (!shapes_ok(R, Cout, Cs) || (ln && Cs * 3 != Cout))
    return (int)cudaErrorInvalidValue;
#define MTP_BWD(CIN) \
  if (dtype == 0 && Cin == CIN) \
    return (int)bwd_ln<float, CIN / 16>(ln, x, g, be, w, v, dy0, dy1, dy2, dx, ln_o, gp, R, Cout, Cs, s); \
  if (dtype == 1 && Cin == CIN) \
    return (int)bwd_tc<CIN / 16>(ln, x, g, be, w, v, dy0, dy1, dy2, dx, ln_o, gp, R, Cout, Cs, s);
  MTP_BWD(64) MTP_BWD(128) MTP_BWD(256) MTP_BWD(512)
#undef MTP_BWD
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of a tensor-core kernel at width Cin, as the
// launchers ask for them (0 rowmm_tc_kernel, 1 rowmm_bwd_tc_kernel in the
// LN form, 2 in the plain form): kernels/rowmm.py::rowmm_tc_smem mirrors
// this.
extern "C" int rowmm_tc_smem(int kernel, int Cin) {
  using namespace mtp;
  switch (kernel) {
    case 0: return proj_fwd_smem(Cin);
    case 1: return proj_bwd_smem(Cin, true);
    case 2: return proj_bwd_smem(Cin, false);
  }
  return -1;
}

// Blocks an SM that a tensor-core kernel's launch bounds ask for at width
// Cin (kernels as rowmm_tc_smem's): kernels/rowmm.py::tc_min_blocks
// mirrors this.
extern "C" int rowmm_tc_min_blocks(int kernel, int Cin) {
  using namespace mtp;
  switch (kernel) {
    case 0: return proj_fwd_min_blocks(Cin);
    case 1:
    case 2: return proj_bwd_min_blocks(Cin);
  }
  return -1;
}
