// Shared pieces of the attention block's bf16 route on the tensor cores
// (attn_block.cu: the LN-fused q|k|v projection and the flash forward;
// attn_block_bwd.cu: the delta pre-pass, dK/dV, dQ and the projection
// backward): the block geometry, the shared-memory reckoning of each
// kernel (kernels/attn_block.py::tc_smem_bytes mirrors it), the key-mask
// bits of a 64-key tile and the StdLN of a bf16 row staged in shared
// memory.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace mtp {

// the attention kernels: 4 warps, warp w owns rows 16 w .. 16 w + 15 of a
// 64-row tile
constexpr int kTcThreads = 128;
// the projection: 8 warps (4 row slabs x 2 column halves), output columns
// per chunk, W rows per cp.async stage, stages in the ring
constexpr int kProjThreads = 256;
constexpr int kProjCols = 128;
constexpr int kProjDepth = 64;
constexpr int kProjStages = 3;
// the projection backward: dq|dk|dv columns (W^T rows) per stage, stages
// in the ring
constexpr int kLnBwdDepth = 32;
constexpr int kLnBwdStages = 3;

// shared-memory bytes of each kernel of the route (bf16 tiles of pitch
// width + 8): block_qkv_tc_kernel at width C, x / StdLN(x) [64][C] and a
// three-stage W ring [64][128]
__host__ __device__ constexpr int qkv_tc_smem(int C) {
  return 2 * (kTile * pitch(C) +
              kProjStages * kProjDepth * pitch(kProjCols));
}
// block_attn_tc_kernel: q [64][DH], a two-stage ring of k and v [64][DH]
__host__ __device__ constexpr int attn_tc_smem(int dh) {
  return 2 * 5 * kTile * pitch(dh);
}
// block_dkv_tc_kernel: k and v [64][DH], a two-stage ring of q and dO
// [64][DH] with the rows' m, 1 / l and delta (fp32 [2][3][64])
__host__ __device__ constexpr int dkv_tc_smem(int dh) {
  return 2 * 6 * kTile * pitch(dh) + 4 * 2 * 3 * kTile;
}
// block_dq_tc_kernel: q and dO [64][DH], a two-stage ring of k and v
__host__ __device__ constexpr int dq_tc_smem(int dh) {
  return 2 * 6 * kTile * pitch(dh);
}
// block_ln_bwd_tc_kernel at width C: x [64][C], a three-stage ring of a
// dq|dk|dv chunk [64][32] and a W chunk [C][32] (dy [64][C] in its first
// two stages once the chunks are done), the StdLN stats fp32 [4][64]
__host__ __device__ constexpr int ln_bwd_tc_stage(int C) {
  return (kTile + C) * pitch(kLnBwdDepth);
}
__host__ __device__ constexpr int ln_bwd_tc_smem(int C) {
  return 2 * (kTile * pitch(C) + kLnBwdStages * ln_bwd_tc_stage(C)) +
         4 * 4 * kTile;
}

// The key mask of keys k0 .. k0 + 63 of one sample as 64-bit rows, by
// ballot: bit j of masked set when key k0 + j < L is masked (mb: the
// sample's int8 mask row), bit j of pad when k0 + j >= L. Every lane of
// the warp gets both.
static __device__ __forceinline__ void key_bits(const int8_t* __restrict__ mb,
                                                int k0, int L, int lane,
                                                uint64_t& masked,
                                                uint64_t& pad) {
  const int lo = k0 + lane, hi = lo + 32;
  const bool m_lo = lo < L && mb[lo] != 0;
  const bool m_hi = hi < L && mb[hi] != 0;
  masked = ((uint64_t)__ballot_sync(0xffffffffu, m_hi) << 32) |
           __ballot_sync(0xffffffffu, m_lo);
  const int live = L - k0;
  pad = live >= 64 ? 0ull : ~0ull << live;
}

// StdLayerNorm (ln_tile's arithmetic: Bessel std, eps added to the std,
// variance floor) of one bf16 row xr of width C in shared memory, by one
// warp, rounded to bf16 into dst (which may be xr itself, a row in device
// memory, or NULL: not written). With stats non-null, row r's mean,
// 1 / (std + eps), std and variance go to stats[r], stats[kTile + r],
// stats[2 kTile + r], stats[3 kTile + r]. Lane l reads and writes columns
// l, l + 32, ...
static __device__ __forceinline__ void stdln_row_bf16(
    const bf16* xr, bf16* dst, int C, const float* __restrict__ gamma,
    const float* __restrict__ beta, int lane, float* stats, int r) {
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += bf(xr[c]);
  const float mu = warp_sum(s) / (float)C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = bf(xr[c]) - mu;
    v += d * d;
  }
  const float var = warp_sum(v) / (float)(C - 1);
  const float sd = sqrtf(fmaxf(var, kVarFloor));
  const float inv = 1.0f / (sd + kStdLnEps);
  if (dst != nullptr)
    for (int c = lane; c < C; c += 32)
      dst[c] = __float2bfloat16_rn(((bf(xr[c]) - mu) * inv) * gamma[c] +
                                   beta[c]);
  if (stats != nullptr && lane == 0) {
    stats[r] = mu;
    stats[kTile + r] = inv;
    stats[2 * kTile + r] = sd;
    stats[3 * kTile + r] = var;
  }
}

// rows [row0, row0 + 64) x DH columns from column col of a row-major bf16
// matrix with nrows rows and leading dimension ld into a shared tile of
// pitch pitch(DH), by kTcThreads threads; rows past nrows are zero-filled
// and not read
template <int DH>
static __device__ __forceinline__ void stage_head(bf16* dst,
                                                  const bf16* __restrict__ src,
                                                  int row0, int nrows, int ld,
                                                  int col, int tid) {
  constexpr int per_row = DH / 8, LD = pitch(DH);
  for (int e = tid; e < kTile * per_row; e += kTcThreads) {
    const int r = e / per_row, c = (e % per_row) * 8;
    const bool in = row0 + r < nrows;
    cp_async16(dst + r * LD + c,
               in ? src + (size_t)(row0 + r) * ld + col + c : src, in);
  }
}

}  // namespace mtp
