// The FFN kernels' dropout keep masks drawn alone, straight into bool
// tensors (one byte, 0 or 1, per element): k1 [R, F], hidden columns
// col0 .. col0 + F of the whole [R, *] mask (one rank's share of d_ff under
// tensor parallelism), and k2 [R, C], the output mask, both rows
// row0 .. row0 + R of the whole [*, *] masks (one rank's share of the batch
// under data parallelism). The MBT input dropout draws k2 alone (F = 0).
//
// Replaces medical_tri_modal_pilot_tpu/kernels/ffn.py::dropout_masks (body
// _masks_kernel). Element (r, c) of mask m is word c % 4 of Philox4x32-10
// at counter (c / 4, r, m, 0) (dropout_keep, common.cuh), so one draw
// gives four neighbouring mask bytes.
//
// What bounds it on an H100: the integer multiplies of Philox, then the
// bytes. A draw is ten rounds of two 32 x 32 -> 64-bit products (IMAD.WIDE,
// two 32-bit multiply results each) and two three-input xors (LOP3), so
// 40 multiply results per four mask bytes; at 64 a clock per SM (compute
// capability 9.0) 84 MB of masks ([65536, 1024] + [65536, 256]) take 0.050
// ms on the multiply pipe against 0.025 ms of stores. The xors, compares
// and stores run on other pipes beside it.
//
// Design: a thread takes one row and a run of units, each unit four
// draws = 16 mask bytes, which it packs into four words and writes with
// one 16-byte store where the destination is 16-byte aligned (F % 16 == 0
// and col0 % 4 == 0 for k1, C % 16 == 0 for k2: every shape of the main
// path), else a 4-byte store per draw where that is aligned and bytes at
// the ragged edges (col0 % 4 != 0, a width not a multiple of 16). The
// grid is two-dimensional: 16 rows per block, 16 threads walking a row's
// units of both masks, so row and column come without a division; the
// ten round keys are computed once per thread. One launch writes both
// masks.
#include "common.cuh"

namespace mtp {

constexpr int kMaskUnitCols = 16;  // mask bytes per unit: four draws
constexpr int kMaskThreadsX = 16;  // threads walking one row's units
constexpr int kMaskRows = 16;      // rows per block

// Philox4x32-10 with the round keys precomputed (philox4x32_10's rounds)
static __device__ __forceinline__ uint4 philox_keyed(uint4 c,
                                                     const uint2 (&ks)[10]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ ks[i].x, lo1, hi0 ^ c.w ^ ks[i].y, lo0);
  }
  return c;
}

// the four keep bytes of one draw, byte j = word j < thr
static __device__ __forceinline__ uint32_t keep_word(uint4 d, uint32_t thr) {
  return (uint32_t)(d.x < thr) | ((uint32_t)(d.y < thr) << 8) |
         ((uint32_t)(d.z < thr) << 16) | ((uint32_t)(d.w < thr) << 24);
}

// grid (ceil(R / kMaskRows)), block (kMaskThreadsX, kMaskRows)
__global__ void __launch_bounds__(kMaskThreadsX * kMaskRows)
    dropout_masks_kernel(uint8_t* __restrict__ k1, uint8_t* __restrict__ k2,
                         int R, int F, int C, int col0, uint32_t row0,
                         uint2 key, uint32_t thr) {
  const int r = blockIdx.x * kMaskRows + threadIdx.y;
  if (r >= R) return;
  const uint32_t rg = row0 + (uint32_t)r;  // the row's counter word
  uint2 ks[10];
  ks[0] = key;
#pragma unroll
  for (int i = 1; i < 10; ++i)
    ks[i] = make_uint2(ks[i - 1].x + kPhiloxW0, ks[i - 1].y + kPhiloxW1);
  // k1: draws g0 .. g_end - 1 cover its global columns col0 .. col0 + F
  const int g0 = col0 >> 2;
  const int g_end = F > 0 ? (col0 + F + 3) >> 2 : g0;
  const int u0 = (g_end - g0 + 3) >> 2;
  const int units = u0 + (C + kMaskUnitCols - 1) / kMaskUnitCols;
  for (int u = threadIdx.x; u < units; u += kMaskThreadsX) {
    const bool hid = u < u0;
    const int g = hid ? g0 + 4 * u : 4 * (u - u0);  // the unit's first draw
    const int gl = hid ? g_end : (C + 3) >> 2;      // past the mask's last
    const int width = hid ? F : C;
    const int l0 = 4 * g - (hid ? col0 : 0);  // its first byte's column
    uint8_t* row = hid ? k1 + (size_t)r * F : k2 + (size_t)r * C;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = g + i < gl
          ? keep_word(philox_keyed(make_uint4((uint32_t)(g + i), rg,
                                              hid ? 0u : 1u, 0u), ks), thr)
          : 0u;
    uint8_t* dst = row + l0;
    if (l0 >= 0 && l0 + kMaskUnitCols <= width &&
        ((uintptr_t)dst & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + 4 * i;
      if (l >= 0 && l + 4 <= width && ((uintptr_t)(row + l) & 3) == 0) {
        *reinterpret_cast<uint32_t*>(row + l) = w[i];
      } else {
        for (int j = 0; j < 4; ++j)
          if (l + j >= 0 && l + j < width)
            row[l + j] = (uint8_t)((w[i] >> (8 * j)) & 1u);
      }
    }
  }
}

}  // namespace mtp

// The keep masks the FFN kernels draw for (seed, thr), as bool tensors
// (bytes 0 or 1): k1 [R, F], hidden columns col0 .. col0 + F of the whole
// mask (col0 = 0: the kernels' own), and k2 [R, C], both rows row0 ..
// row0 + R of the whole masks. One launch. Returns cudaGetLastError().
extern "C" int dropout_masks(void* k1, void* k2, int R, int F, int C,
                             int col0, int row0, unsigned long long seed,
                             unsigned int thr, void* stream) {
  using namespace mtp;
  if (R < 0 || F < 0 || C < 0 || col0 < 0 || row0 < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || F + C == 0) return 0;
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull),
                               (uint32_t)(seed >> 32));
  const dim3 block(kMaskThreadsX, kMaskRows);
  dropout_masks_kernel<<<(R + kMaskRows - 1) / kMaskRows, block, 0,
                         (cudaStream_t)stream>>>(
      (uint8_t*)k1, (uint8_t*)k2, R, F, C, col0, (uint32_t)row0, key, thr);
  return (int)cudaGetLastError();
}
