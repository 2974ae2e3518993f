// Weight gradients of the fusion layers' backward: dW = A^T B over all R
// rows with fp32 accumulation, and db = the column sums of B; plus the
// fixed-order reduction of per-tile partial sums (dgamma, dbeta).
//
// Replaces the parameter-gradient accumulation inside
// medical_tri_modal_pilot_tpu/kernels/ffn.py::_bwd_block (:182-198) and
// attn_block.py::_bwd_fused_kernel (:484-492): the TPU adds each row
// block's A^T B into one output as its sequential grid walks the rows. On
// Hopper the row blocks run in parallel, so the sum over R = 64 * 1024
// rows is split: each block computes one 64 x 64 tile of A^T B over one
// slice of the rows (split-K, S slices, fp32 partials of S * Ka * Nb
// floats), and col_sum_kernel adds the S partials in slice order. B's
// columns may come from up to three arrays of Bcs columns each (the q, k
// and v cotangents of rowmm's LN form: one launch for the three).
// Ka and Bcs are multiples of 32 (Swin-T's C 96 and 192): a tile past Ka
// or Nb reads zeros there and leaves those rows and columns of the
// partials unwritten; B in parts takes whole 64-column tiles.
// Deterministic, no atomics. Two forms, picked by dtype: wgrad_kernel,
// fp32 FMAs from shared memory (fp32, the checking dtype); and
// wgrad_tc_kernel, bf16 on
// the tensor cores (mma.sync m16n8k16, fp32 accumulation; A^T through
// ldmatrix.trans), which stages 64-row chunks by cp.async in a two-stage
// ring and skips a chunk under a 0 row flag without reading it. Bound on
// an H100: operations, 2 R Ka Nb (34 GFLOP for the FFN's dW1 at R =
// 65536, counting every row).
#include "common.cuh"
#include "mma.cuh"

namespace mtp {

// B's columns n0 .. n0 + 63 (Bcs % 64 == 0): a pointer to them in row 0
// of the array that holds them, whose row stride is Bcs
template <typename T>
static __device__ __forceinline__ const T* b_cols(const T* B0, const T* B1,
                                                  const T* B2, int Bcs,
                                                  int n0) {
  const int o = n0 / Bcs;
  return (o == 0 ? B0 : (o == 1 ? B1 : B2)) + n0 - o * Bcs;
}

// part[s, k, n] = sum_{r in slice s} A[r, k] B[r, n]; colpart[s, n] =
// sum_{r in slice s} B[r, n] (blocks with blockIdx.x == 0); rows whose
// flag valid[r / flag_rows] is 0 count as zeros and are not read (valid
// NULL: every row counts). fp32 A and B = B0 | B1 | B2 (each [R, Bcs]).
// grid (ceil(Ka/64), ceil(Nb/64), S).
__global__ void __launch_bounds__(kThreads) wgrad_kernel(
    const float* __restrict__ A, const float* B0, const float* B1,
    const float* B2, int R, int Ka, int Nb, int Bcs, int rows_per_slice,
    float* __restrict__ part, float* __restrict__ colpart,
    const int8_t* __restrict__ valid, int flag_rows) {
  __shared__ float As[kKChunk][kTile];
  __shared__ float Bs[kKChunk][kTile];
  const int k0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int s = blockIdx.z;
  const int rs = s * rows_per_slice, re = min(R, rs + rows_per_slice);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* Bm = b_cols(B0, B1, B2, Bcs, n0);
  const bool sums = blockIdx.x == 0 && ty == 0;
  float acc[4][4], csum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  zero(acc);
  for (int r0 = rs; r0 < re; r0 += kKChunk) {
    for (int e = tid; e < kKChunk * kTile; e += kThreads) {
      const int kk = e / kTile, c = e - kk * kTile;
      const bool in = r0 + kk < re &&
                      (valid == nullptr || valid[(r0 + kk) / flag_rows]);
      As[kk][c] = in && k0 + c < Ka ? A[(size_t)(r0 + kk) * Ka + k0 + c]
                                    : 0.0f;
      Bs[kk][c] = in && n0 + c < Nb ? Bm[(size_t)(r0 + kk) * Bcs + c]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKChunk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (sums)
#pragma unroll
        for (int j = 0; j < 4; ++j) csum[j] += b[j];
    }
    __syncthreads();
  }
  float* p = part + (size_t)s * Ka * Nb;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (k < Ka && n < Nb) p[(size_t)k * Nb + n] = acc[i][j];
    }
  if (sums)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + tx + 16 * j < Nb)
        colpart[(size_t)s * Nb + n0 + tx + 16 * j] = csum[j];
}

// The same sums in bf16 on the tensor cores: warp w computes rows
// 32 (w & 1) .. + 32 of the 64-row Ka tile and columns 32 (w >> 1) .. + 32
// of the Nb tile; the rows of the slice are the product's depth, in
// chunks of kWgRows that start on multiples of kWgRows. rows_per_slice and
// flag_rows are multiples of kWgRows, so a chunk lies under one flag and
// is either read whole or skipped whole. colpart by threads 0..63 of the
// blockIdx.x == 0 blocks, each summing one column of each chunk in row
// order. grid (ceil(Ka/64), ceil(Nb/64), S), 128 threads.
constexpr int kWgRows = 64;
constexpr int kWgThreads = 128;

// rows [0, kWgRows) x cols [0, 64) of a row-major bf16 matrix (leading
// dimension lds) into a shared tile (pitch ld) by cp.async; rows from
// `rows` and columns from `cols` (a multiple of 8) on are zero-filled and
// not read
static __device__ __forceinline__ void stage_chunk64(bf16* dst, int ld,
                                                     const bf16* src, int lds,
                                                     int rows, int cols,
                                                     int tid) {
  for (int e = tid; e < kWgRows * 8; e += kWgThreads) {
    const int r = e >> 3, c = (e & 7) << 3;
    const bool in = r < rows && c < cols;
    cp_async16(dst + r * ld + c, in ? src + (size_t)r * lds + c : src, in);
  }
}

__global__ void __launch_bounds__(kWgThreads) wgrad_tc_kernel(
    const bf16* __restrict__ A, const bf16* B0, const bf16* B1,
    const bf16* B2, int R, int Ka, int Nb, int Bcs, int rows_per_slice,
    float* __restrict__ part, float* __restrict__ colpart,
    const int8_t* __restrict__ valid, int flag_rows) {
  constexpr int LD = pitch(kTile);
  __shared__ __align__(16) bf16 As[2][kWgRows * LD];
  __shared__ __align__(16) bf16 Bs[2][kWgRows * LD];
  const int k0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int s = blockIdx.z;
  const int rs = s * rows_per_slice, re = min(R, rs + rows_per_slice);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const bool sums = blockIdx.x == 0 && tid < kTile;
  const bf16* Bm = b_cols(B0, B1, B2, Bcs, n0);
  // the first chunk start at or after r under a live flag (re if none)
  auto live_from = [&](int r) {
    if (valid != nullptr)
      while (r < re && valid[r / flag_rows] == 0)
        r = (r / flag_rows + 1) * flag_rows;
    return min(r, re);
  };
  const int acols = min(kTile, Ka - k0), bcols = min(kTile, Nb - n0);
  auto load = [&](int r, int st) {
    const int n = min(kWgRows, re - r);
    stage_chunk64(As[st], LD, A + (size_t)r * Ka + k0, Ka, n, acols, tid);
    stage_chunk64(Bs[st], LD, Bm + (size_t)r * Bcs, Bcs, n, bcols, tid);
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  float csum = 0.0f;
  int cur = live_from(rs), st = 0;
  if (cur < re) load(cur, 0);
  cp_async_commit();
  while (cur < re) {
    const int nxt = live_from(cur + kWgRows);
    // the stage refilled here was read for the last chunk, before the
    // barrier that ended its iteration
    if (nxt < re) load(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* as = As[st];
    const bf16* bs = Bs[st];
#pragma unroll
    for (int kk = 0; kk < kWgRows; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(af[i], frag_a_t(as, LD, kk, wm + 16 * i, lane));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_t(bfr[j], frag_b_kn(bs, LD, kk, wn + 16 * j, lane));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma16816(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          mma16816(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
    if (sums)
      for (int r = 0; r < kWgRows; ++r) csum += bf(bs[r * LD + tid]);
    __syncthreads();
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();
  float* p = part + (size_t)s * Ka * Nb;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + wm + 16 * i + g + 8 * h;
        const int col = n0 + wn + 8 * j + 2 * t;
        if (row < Ka && col < Nb)
          *reinterpret_cast<float2*>(p + (size_t)row * Nb + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  if (sums && n0 + tid < Nb) colpart[(size_t)s * Nb + n0 + tid] = csum;
}

// out[n] = sum_{s < S} part[s, n], in order of s. grid (ceil(N/256)).
__global__ void __launch_bounds__(kThreads) col_sum_kernel(
    const float* __restrict__ part, int S, int N, float* __restrict__ out) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * N + n];
  out[n] = acc;
}

}  // namespace mtp

// A [R, Ka] and B [R, Nb] row-major in the dtype (0 = fp32, 1 = bf16), B
// as Nb / Bcs <= 3 arrays B0 | B1 | B2 of [R, Bcs] (B1, B2 NULL when
// unused; Bcs = Nb: one array); Ka % 32 == Bcs % 32 == 0, Bcs % 64 == 0
// when B comes in parts; slices of
// rows_per_slice rows (the last may be shorter), S = ceil(R /
// rows_per_slice). valid: int8 flags, one per
// flag_rows consecutive rows, 0 leaving those rows out of both sums (and
// unread), or NULL. fp32 sums by FMAs, bf16 on the tensor cores (then
// rows_per_slice and flag_rows multiples of 64). Writes part fp32
// [S, Ka, Nb] and colpart fp32 [S, Nb]. Returns cudaGetLastError().
extern "C" int wgrad_partials(const void* A, const void* B0, const void* B1,
                              const void* B2, int R, int Ka, int Nb, int Bcs,
                              int rows_per_slice, int S, void* part,
                              void* colpart, const void* valid, int flag_rows,
                              int dtype, void* stream) {
  using namespace mtp;
  if (Ka <= 0 || Ka % kKChunk != 0 || Bcs <= 0 || Bcs % kKChunk != 0 ||
      Nb % Bcs != 0 || Nb / Bcs > 3 || (Nb / Bcs > 1 && Bcs % kTile != 0) ||
      (Nb / Bcs > 1 && B1 == nullptr) ||
      (Nb / Bcs > 2 && B2 == nullptr) || rows_per_slice <= 0 || S <= 0 ||
      flag_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* v = (const int8_t*)valid;
  const dim3 grid((Ka + kTile - 1) / kTile, (Nb + kTile - 1) / kTile, S);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (rows_per_slice % kWgRows != 0 || flag_rows % kWgRows != 0)
      return (int)cudaErrorInvalidValue;
    wgrad_tc_kernel<<<grid, kWgThreads, 0, s>>>(
        (const bf16*)A, (const bf16*)B0, (const bf16*)B1, (const bf16*)B2, R,
        Ka, Nb, Bcs, rows_per_slice, (float*)part, (float*)colpart, v,
        flag_rows);
  } else if (dtype == 0) {
    wgrad_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)A, (const float*)B0, (const float*)B1, (const float*)B2,
        R, Ka, Nb, Bcs, rows_per_slice, (float*)part, (float*)colpart, v,
        flag_rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out fp32 [N] = the sum over s of part fp32 [S, N], in order of s.
extern "C" int col_sum(const void* part, int S, int N, void* out,
                       void* stream) {
  using namespace mtp;
  if (S <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  mtp::col_sum_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>((const float*)part, S, N,
                                                (float*)out);
  return (int)cudaGetLastError();
}
