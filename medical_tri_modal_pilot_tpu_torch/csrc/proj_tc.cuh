// The projection tile loops of the bf16 routes on the tensor cores, shared
// by the attention block (attn_block.cu::block_qkv_tc_kernel, the LN-fused
// q|k|v projection; attn_block_bwd.cu::block_ln_bwd_tc_kernel, its
// backward) and the row-skipping projections (rowmm.cu::rowmm_tc_kernel,
// rowmm_bwd_tc_kernel, LN-fused and plain):
//
//   forward   out = round(round(A . W) + b), W [C, N], A = StdLN(x)
//             rounded to bf16 (LN) or x as it is
//   backward  dA = dy . W^T in fp32; then the StdLN backward with the
//             variance-floor flag and the tile's dgamma | dbeta partials
//             (LN), with the residual dx = round(round(dx_ln) + dy) or
//             without it; or dx = round(dA) (plain)
//
// Forward (proj_fwd_tile): a block of 8 warps owns 64 rows. It stages
// them by cp.async, normalises them in place (LN: four rows a warp at a
// time, fp32, rounded to bf16) as the A operand, and walks the N output
// columns in 128-column chunks, W streamed kProjDepth rows deep through a
// kProjStages-stage cp.async ring. Warp w computes rows 16 (w & 3) .. + 16
// and columns 64 (w >> 2) .. + 64 of each chunk on mma.sync m16n8k16
// (ldmatrix fragments). The epilogue rounds, adds the bias and rounds
// again into the ring stage the chunk has just consumed; the chunk leaves
// from there in 16-byte pieces of whole rows. Measured on an H100
// (PERF.md): 128-row tiles (one block an SM) lost to these by 5-15 %,
// the staged output beat 4-byte fragment stores by 8-15 %, and a deeper
// ring or pipelined fragment loads changed nothing. The loop is bound by
// the SM's memory-instruction pipe (cp.async of W, ldmatrix, the stores),
// not by latency: clock64() timers per phase put a third of a block's
// time in issuing the W copies.
//
// Backward (proj_bwd_tile): a block of 8 warps owns 64 rows. The
// cotangent's 32-column chunks and W's matching [C][32] slices (W^T's
// rows) stream through a kLnBwdStages-stage ring; warp w accumulates rows
// 16 (w & 3) .. + 16 and columns (C / 2)(w >> 2) .. + C / 2 of dA. The LN
// form stages x first, recomputes the StdLN (its rounded rows to ln_o, the
// A operand of dW) and keeps the row statistics; its epilogue runs the
// StdLN backward on the fragments and sums the tile's dgamma | dbeta
// through a free stage of the ring. With the residual, the tile's dy is
// staged into the first two stages during the last chunk.
//
// Providers: where the output columns go and where the cotangent chunks
// come from (Packed: one row-major [rows, N] array; Split: N = k Cs
// columns over k <= 3 row-major [rows, Cs] arrays. A warp's 64 output
// columns, a 16-byte piece and a 32-column chunk always fall in one of
// them, since Cs % 64 == 0). Which tiles are live is the caller's: the
// attention block tests a tile's start against its sample's last valid
// key, rowmm reads its 256-row flag.
#pragma once

#include "mma.cuh"

namespace mtp {

// the forward: 8 warps (4 row slabs x 2 column halves), output columns per
// chunk, W rows per cp.async stage, stages in the ring
constexpr int kProjThreads = 256;
constexpr int kProjCols = 128;
constexpr int kProjDepth = 64;
constexpr int kProjStages = 3;
// the backward: cotangent columns (W^T rows) per stage, stages in the ring
constexpr int kLnBwdDepth = 32;
constexpr int kLnBwdStages = 3;

// Shared-memory bytes (bf16 tiles of pitch width + 8). The forward at
// width C: x / StdLN(x) [64][C] and the W ring [stages][64][128].
__host__ __device__ constexpr int proj_fwd_smem(int C) {
  return 2 * (kTile * pitch(C) +
              kProjStages * kProjDepth * pitch(kProjCols));
}
// a stage of the backward's ring at width C: a cotangent chunk [64][32]
// and a W chunk [C][32]
__host__ __device__ constexpr int ln_bwd_tc_stage(int C) {
  return (kTile + C) * pitch(kLnBwdDepth);
}
// the backward at width C: x [64][C] (LN), the ring, the StdLN stats fp32
// [4][64] (LN)
__host__ __device__ constexpr int proj_bwd_smem(int C, bool ln) {
  return 2 * ((ln ? kTile * pitch(C) : 0) +
              kLnBwdStages * ln_bwd_tc_stage(C)) +
         (ln ? 4 * 4 * kTile : 0);
}
// the attention block's (LN)
__host__ __device__ constexpr int qkv_tc_smem(int C) {
  return proj_fwd_smem(C);
}
__host__ __device__ constexpr int ln_bwd_tc_smem(int C) {
  return proj_bwd_smem(C, true);
}
// the model widths (d_model) the attention block's and the row-skipping
// projections' kernels are built for (kernels/attn_block.py and
// kernels/rowmm.py WIDTHS)
__host__ __device__ constexpr bool model_width(int C) {
  return C == 64 || C == 128 || C == 256 || C == 512;
}
// blocks an SM that the forward's launch bounds ask for at width C: two
// up to C = 256; at 512 x and the W ring take 116 KB, room for one block
// (a thread's registers do not depend on C)
__host__ __device__ constexpr int proj_fwd_min_blocks(int C) {
  return C > 256 ? 1 : 2;
}
// blocks an SM that the backward's launch bounds ask for at width C: two
// up to C = 256; at 512 a thread's dA accumulators are 128 fp32 registers
// (NJC 32 n8 tiles), which two blocks' 128-register budget cannot hold,
// and the LN form's 201 KB leave room for one block only
__host__ __device__ constexpr int proj_bwd_min_blocks(int C) {
  return C > 256 ? 1 : 2;
}

// rows a warp normalises at a time (stdln_rows_bf16)
constexpr int kLnRows = 4;

// StdLayerNorm (ln_tile's arithmetic: Bessel std, eps added to the std,
// variance floor) of kLnRows bf16 rows of width C in shared memory (rows
// r, r + rstride, ... of xs, pitch ld), by one warp, the rows' reduction
// chains interleaved; each row's sums run in the one-row order (a lane's
// columns l, l + 32, ..., then the warp's butterfly), so the values do not
// depend on kLnRows. Rounded to bf16 into dst (pitch ldd; dst may be xs: in
// place) for the rows below nrows; dst NULL: not written. With stats
// non-null, row q's mean, 1 / (std + eps), std and variance go to
// stats[q], stats[kTile + q], stats[2 kTile + q], stats[3 kTile + q].
static __device__ __forceinline__ void stdln_rows_bf16(
    const bf16* xs, int ld, int r, int rstride, bf16* dst, int ldd,
    int nrows, int C, const float* __restrict__ gamma,
    const float* __restrict__ beta, int lane, float* stats) {
  float s[kLnRows], v[kLnRows], mu[kLnRows], inv[kLnRows];
#pragma unroll
  for (int k = 0; k < kLnRows; ++k) s[k] = v[k] = 0.0f;
  for (int c = lane; c < C; c += 32)
#pragma unroll
    for (int k = 0; k < kLnRows; ++k)
      s[k] += bf(xs[(r + k * rstride) * ld + c]);
#pragma unroll
  for (int k = 0; k < kLnRows; ++k) mu[k] = warp_sum(s[k]) / (float)C;
  for (int c = lane; c < C; c += 32)
#pragma unroll
    for (int k = 0; k < kLnRows; ++k) {
      const float d = bf(xs[(r + k * rstride) * ld + c]) - mu[k];
      v[k] += d * d;
    }
#pragma unroll
  for (int k = 0; k < kLnRows; ++k) {
    const float var = warp_sum(v[k]) / (float)(C - 1);
    const float sd = sqrtf(fmaxf(var, kVarFloor));
    inv[k] = 1.0f / (sd + kStdLnEps);
    const int q = r + k * rstride;
    if (stats != nullptr && lane == 0) {
      stats[q] = mu[k];
      stats[kTile + q] = inv[k];
      stats[2 * kTile + q] = sd;
      stats[3 * kTile + q] = var;
    }
  }
  if (dst == nullptr) return;
  for (int c = lane; c < C; c += 32) {
    const float gc = gamma[c], bc = beta[c];
#pragma unroll
    for (int k = 0; k < kLnRows; ++k) {
      const int q = r + k * rstride;
      if (q < nrows)
        dst[q * ldd + c] = __float2bfloat16_rn(
            ((bf(xs[q * ld + c]) - mu[k]) * inv[k]) * gc + bc);
    }
  }
}

// one row-major [rows, ld] array from the tile's first row
template <typename P>
struct Packed {
  P* base;
  int ld;
  __device__ __forceinline__ P* at(int r, int col) const {
    return base + (size_t)r * ld + col;
  }
  __device__ __forceinline__ int stride() const { return ld; }
};

// columns [0, k cs) over k <= 3 row-major [*, cs] arrays (unused ones
// NULL), rows counted from row r0
template <typename P>
struct Split {
  P* p0;
  P* p1;
  P* p2;
  int cs, r0;
  __device__ __forceinline__ P* at(int r, int col) const {
    const int o = col >= cs ? (col >= 2 * cs ? 2 : 1) : 0;
    P* p = o == 0 ? p0 : (o == 1 ? p1 : p2);
    return p + (size_t)(r0 + r) * cs + col - o * cs;
  }
  __device__ __forceinline__ int stride() const { return cs; }
};

// The forward of one 64-row tile: rows [0, rows) of xt (row stride C)
// projected through w [C, N] and bias [N]; out.at(r, col) takes tile row
// r's columns col .. col + 7. Rows past `rows` are zero-filled and not
// stored. C % 64 == 0, N % 8 == 0 (columns past N of the last chunk are
// zero-filled and not stored). Every thread of the block (kProjThreads)
// calls it.
template <bool LN, typename Out>
static __device__ __forceinline__ void proj_fwd_tile(
    unsigned char* smem, const bf16* __restrict__ xt, int rows, int C,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ w, const bf16* __restrict__ bias, int N,
    const Out& out) {
  constexpr int STAGES = kProjStages;
  static_assert(STAGES >= 2, "a stage in use and one in flight");
  constexpr int LDW = pitch(kProjCols), WSTAGE = kProjDepth * LDW;
  constexpr int kPerRow = kProjCols / 8;
  const int LDX = pitch(C);
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [64][LDX]: x, then A
  bf16* ws = xs + kTile * LDX;               // [stages][64][LDW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rs = warp & 3, ch = warp >> 2;
  // the tile's x, a warp per row
  for (int r = warp; r < kTile; r += kProjThreads / 32)
    for (int c = lane * 8; c < C; c += 256)
      cp_async16(xs + r * LDX + c, r < rows ? xt + (size_t)r * C + c : xt,
                 r < rows);
  const int ksteps = C / kProjDepth;
  const int total = (N + kProjCols - 1) / kProjCols * ksteps;
  // stage s of the walk over (128-column chunk, 64-row depth step)
  auto load_w = [&](int s) {
    const int nc = s / ksteps, kc = s - nc * ksteps;
    bf16* dst = ws + (s % STAGES) * WSTAGE;
    const bf16* src = w + (size_t)kc * kProjDepth * N + nc * kProjCols;
    for (int e = tid; e < kProjDepth * kPerRow; e += kProjThreads) {
      const int r = e / kPerRow, c = (e % kPerRow) * 8;
      const bool in = nc * kProjCols + c < N;
      cp_async16(dst + r * LDW + c, in ? src + (size_t)r * N + c : w, in);
    }
  };
  // stages 0 .. STAGES - 2 in flight (x with the first)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_w(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  constexpr int kWarps = kProjThreads / 32;
  static_assert(kTile % (kWarps * kLnRows) == 0, "whole row groups");
  if (LN)  // StdLN in place, kLnRows rows a warp at a time
    for (int r = warp; r < kTile; r += kWarps * kLnRows)
      stdln_rows_bf16(xs, LDX, r, kWarps, xs, LDX, kTile, C, gamma, beta,
                      lane, nullptr);
  float acc[8][4];
  for (int s = 0; s < total; ++s) {
    const int nc = s / ksteps, kc = s - nc * ksteps;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    cp_async_wait<STAGES - 2>();
    // stage s has landed (and, at s = 0, every row's A operand); every
    // warp is done with stage s - 1, whose buffer is refilled next
    __syncthreads();
    if (s + STAGES - 1 < total) load_w(s + STAGES - 1);
    cp_async_commit();
    bf16* wsb = ws + (s % STAGES) * WSTAGE;
#pragma unroll
    for (int kk = 0; kk < kProjDepth; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, frag_a(xs, LDX, 16 * rs, kc * kProjDepth + kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ldsm_x4_t(bq, frag_b_kn(wsb, LDW, kk, 64 * ch + 16 * np, lane));
        mma16816(acc[2 * np], a, bq[0], bq[1]);
        mma16816(acc[2 * np + 1], a, bq[2], bq[3]);
      }
    }
    if (kc != ksteps - 1) continue;
    // the chunk through the stage just consumed, then out in 16-byte
    // pieces; the next step's barrier orders the last reads before the
    // stage is refilled
    __syncthreads();  // every warp is done with the stage
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * ch + 8 * j + 2 * t, col = nc * kProjCols + c;
      const float b0 = col < N ? bf(bias[col]) : 0.0f;
      const float b1 = col < N ? bf(bias[col + 1]) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(wsb + (16 * rs + g + 8 * h) * LDW + c) =
            pack_bf16(rnd<bf16>(acc[j][2 * h]) + b0,
                      rnd<bf16>(acc[j][2 * h + 1]) + b1);
    }
    __syncthreads();
    for (int e = tid; e < kTile * kPerRow; e += kProjThreads) {
      const int r = e / kPerRow, c = (e % kPerRow) * 8;
      const int col = nc * kProjCols + c;
      if (r < rows && col < N)
        *reinterpret_cast<uint4*>(out.at(r, col)) =
            *reinterpret_cast<const uint4*>(wsb + r * LDW + c);
    }
  }
  cp_async_wait<0>();
}

// The backward of one 64-row tile: dA = cot . W^T, cot [rows, N] through
// cot.at(r, col) and cot.stride(), w [C, N]; then
//   plain (!LN):  dx = round(dA) into dxt [rows, C];
//   LN:           StdLN of xt's rows recomputed (rounded rows to lnt), the
//                 StdLN backward dx = round(dx_ln) (RES: round(round(dx_ln)
//                 + dy), dy from dyt) and the tile's column sums of
//                 dA * xhat | dA into gp[0, 2C).
// xt, dyt, dxt, lnt: the tile's first row (row stride C); rows past
// `rows` are zero-filled and not stored. N % 32 == 0; with RES, (N / 32)
// % kLnBwdStages == 0 (the attention block's N = 3C): the last chunk runs
// in the ring's last stage and dy is staged into the first two during
// it. Every thread of the block (kThreads) calls it.
template <int NJC, bool LN, bool RES, typename Cot>
static __device__ __forceinline__ void proj_bwd_tile(
    unsigned char* smem, const bf16* __restrict__ xt, int rows,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ w, int N, const Cot& cot,
    const bf16* __restrict__ dyt, bf16* __restrict__ dxt,
    bf16* __restrict__ lnt, float* __restrict__ gp) {
  constexpr int C = 16 * NJC, KC = kLnBwdDepth;
  constexpr int LDC = pitch(C), LDK = pitch(KC);
  constexpr int AT = kTile * LDK, STAGE = ln_bwd_tc_stage(C);
  static_assert(LN || !RES, "the residual comes with the LN backward");
  static_assert(!RES || kTile * LDC <= 2 * STAGE, "dy fits in two stages");
  static_assert(!LN || (4 * kTile + 8 * C) * sizeof(float) <=
                           STAGE * sizeof(bf16),
                "the epilogue's sums fit in a stage of the ring");
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [64][LDC] (LN)
  bf16* ring = xs + (LN ? kTile * LDC : 0);  // [stage][cot chunk | W chunk]
  float* stats = reinterpret_cast<float*>(ring + kLnBwdStages * STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nch = N / KC;
  auto load = [&](int it) {
    bf16* a = ring + (it % kLnBwdStages) * STAGE;
    stage_rows<KC, kThreads>(a, LDK, cot.at(0, it * KC), cot.stride(),
                             kTile, rows, tid);
    stage_rows<KC, kThreads>(a + AT, LDK, w + it * KC, N, C, C, tid);
  };
  if (LN) stage_rows<C, kThreads>(xs, LDC, xt, C, kTile, rows, tid);
  load(0);
  cp_async_commit();
  if (nch > 1) load(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // StdLN of the tile, one warp per row: its stats, and its live rows
  // to lnt for dW (the forward's values bit for bit)
  constexpr int kWarps = kThreads / 32;
  static_assert(kTile % (kWarps * kLnRows) == 0, "whole row groups");
  if (LN)
    for (int r = warp; r < kTile; r += kWarps * kLnRows)
      stdln_rows_bf16(xs, LDC, r, kWarps, lnt, C, rows, C, gamma, beta,
                      lane, stats);
  const int rs = warp & 3, ch = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  float dln[NJC][4];
#pragma unroll
  for (int j = 0; j < NJC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dln[j][e] = 0.0f;
  for (int it = 0; it < nch; ++it) {
    cp_async_wait<1>();
    // chunk it has landed; every warp is done with chunk it - 1, whose
    // stage is refilled next
    __syncthreads();
    if (it + 2 < nch)
      load(it + 2);
    else if (RES && it == nch - 1)
      stage_rows<C, kThreads>(ring, LDC, dyt, C, kTile, rows, tid);
    cp_async_commit();
    const bf16* as = ring + (it % kLnBwdStages) * STAGE;
    const bf16* ws = as + AT;
    // dA += chunk . W[:, chunk]^T (W's rows are the B operand stored
    // [n][k])
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, frag_a(as, LDK, 16 * rs, kk, lane));
#pragma unroll
      for (int np = 0; np < NJC / 2; ++np) {
        uint32_t bw[4];
        ldsm_x4(bw, frag_b_nk(ws, LDK, (C / 2) * ch + 16 * np, kk, lane));
        mma16816(dln[2 * np], a, bw[0], bw[1]);
        mma16816(dln[2 * np + 1], a, bw[2], bw[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!LN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rs + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < NJC; ++j)
        *reinterpret_cast<uint32_t*>(dxt + (size_t)r * C + (C / 2) * ch +
                                     8 * j + 2 * t) =
            pack_bf16(dln[j][2 * h], dln[j][2 * h + 1]);
    }
    return;
  }
  // The StdLN backward on the fragments (stdln_backward_tile's
  // arithmetic, its sums in another order); the cross-warp sums through
  // the ring's last stage
  const bf16* dys = ring;
  float* rrow = reinterpret_cast<float*>(ring + 2 * STAGE);  // [2][64][2]
  float* rcol = rrow + 2 * 2 * kTile;                         // [4][2C]
  float A[2] = {0.0f, 0.0f}, S[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NJC; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = (C / 2) * ch + 8 * j + 2 * t + e;
      const float gam = gamma[col];
      float gs = 0.0f, bs = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rs + g + 8 * h;
        const float c = stats[kTile + r];
        const float xhat = (bf(xs[r * LDC + col]) - stats[r]) * c;
        const float d = dln[j][2 * h + e];
        gs += d * xhat;
        bs += d;
        const float dxhat = d * gam;
        A[h] += dxhat * (xhat / c);
        S[h] += dxhat;
      }
      // column sums over the warp's 16 rows: the 8 lanes that share t
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        gs += __shfl_xor_sync(0xffffffffu, gs, off);
        bs += __shfl_xor_sync(0xffffffffu, bs, off);
      }
      if (g == 0) {
        rcol[rs * 2 * C + col] = gs;
        rcol[rs * 2 * C + C + col] = bs;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      A[h] += __shfl_xor_sync(0xffffffffu, A[h], off);
      S[h] += __shfl_xor_sync(0xffffffffu, S[h], off);
    }
    if (t == 0) {
      const int r = 16 * rs + g + 8 * h;
      rrow[(ch * kTile + r) * 2] = A[h];
      rrow[(ch * kTile + r) * 2 + 1] = S[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * rs + g + 8 * h;
    if (r >= rows) continue;
    const float a = rrow[r * 2] + rrow[(kTile + r) * 2];
    const float mean = (rrow[r * 2 + 1] + rrow[(kTile + r) * 2 + 1]) /
                       (float)C;
    const float mu = stats[r], c = stats[kTile + r];
    const float sd = stats[2 * kTile + r], var = stats[3 * kTile + r];
    const float k2 = (c * c) * a * (var > kVarFloor ? 1.0f : 0.0f) /
                     ((float)(C - 1) * sd);
#pragma unroll
    for (int j = 0; j < NJC; ++j) {
      const int col = (C / 2) * ch + 8 * j + 2 * t;
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xhat = (bf(xs[r * LDC + col + e]) - mu) * c;
        const float dxhat = dln[j][2 * h + e] * gamma[col + e];
        const float d0 = c * (dxhat - mean) - k2 * (xhat / c);
        const float d = rnd<bf16>(d0);
        o[e] = RES ? bf(dys[r * LDC + col + e]) + d : d;
      }
      *reinterpret_cast<uint32_t*>(dxt + (size_t)r * C + col) =
          pack_bf16(o[0], o[1]);
    }
  }
  for (int col = tid; col < 2 * C; col += kThreads)
    gp[col] = rcol[col] + rcol[2 * C + col] + rcol[4 * C + col] +
              rcol[6 * C + col];
}

}  // namespace mtp
