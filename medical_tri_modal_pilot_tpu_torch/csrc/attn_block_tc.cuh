// Shared pieces of the attention block's bf16 route on the tensor cores
// (attn_block.cu: the LN-fused q|k|v projection and the flash forward;
// attn_block_bwd.cu: the delta pre-pass, dK/dV, dQ and the projection
// backward): the projections' block geometry, the shared-memory reckoning
// of the projection kernels (kernels/attn_block.py::tc_smem_bytes mirrors
// it with the flash loops' of flash_tc.cuh) and the StdLN of a bf16 row
// staged in shared memory. The flash loops themselves are flash_tc.cuh's,
// shared with the masked attention (attention.cu).
#pragma once

#include "flash_tc.cuh"

namespace mtp {

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

// shared-memory bytes of the projection kernels (bf16 tiles of pitch
// width + 8): block_qkv_tc_kernel at width C, x / StdLN(x) [64][C] and a
// three-stage W ring [64][128]
__host__ __device__ constexpr int qkv_tc_smem(int C) {
  return 2 * (kTile * pitch(C) +
              kProjStages * kProjDepth * pitch(kProjCols));
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

}  // namespace mtp
