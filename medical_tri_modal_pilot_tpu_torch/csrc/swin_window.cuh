// The window geometry of the Swin kernels (7 x 7 windows, 32-wide heads)
// and the shift mask's bits as the tensor-core window cores read them,
// shared by the forward (swin_attention.cu) and the backward
// (swin_attention_bwd.cu).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace mtp {

constexpr int kWin = 49;     // tokens per 7x7 window
constexpr int kHeadDim = 32;

// The shift-mask bits of rows g and g + 8 (g = lane >> 2) of the 16 rows
// 16 w .. 16 w + 15 of a window: bit c set when key c is masked. mw: the
// window's mask [49, 49] int8, or NULL (no bits). The 16 rows' bytes are
// all loaded before the first ballot, so their latencies overlap.
static __device__ __forceinline__ void mask_bits(const int8_t* __restrict__ mw,
                                                 int w, int lane,
                                                 uint64_t& m0, uint64_t& m1) {
  m0 = m1 = 0;
  if (mw == nullptr) return;
  const int g = lane >> 2;
  int8_t lo[16], hi[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * w + rr;
    lo[rr] = r < kWin ? mw[r * kWin + lane] : 0;
    hi[rr] = r < kWin && lane + 32 < kWin ? mw[r * kWin + lane + 32] : 0;
  }
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const uint64_t bits =
        ((uint64_t)__ballot_sync(0xffffffffu, hi[rr] != 0) << 32) |
        __ballot_sync(0xffffffffu, lo[rr] != 0);
    if (rr == g) m0 = bits;
    if (rr == g + 8) m1 = bits;
  }
}

}  // namespace mtp
