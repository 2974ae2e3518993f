// Weight gradients of the fusion layers' backward: dW = A^T B over all R
// rows with fp32 accumulation, and db = the column sums of B; plus the
// fixed-order reduction of per-tile partial sums (dgamma, dbeta).
//
// Replaces the parameter-gradient accumulation inside
// medical_tri_modal_pilot_tpu/kernels/ffn.py::_bwd_block (:182-198) and
// attn_block.py::_bwd_fused_kernel (:484-492): the TPU adds each row
// block's A^T B into one output as its sequential grid walks the rows. On
// Hopper the row blocks run in parallel, so the sum over R = 64 * 1024
// rows is split: wgrad_kernel computes one 64 x 64 tile of A^T B over one
// slice of the rows per block (split-K, S slices, fp32 partials of S * Ka
// * Nb floats), and col_sum_kernel adds the S partials in slice order.
// Deterministic, no atomics. fp32 FMAs from shared memory; tensor cores
// are later work. Bound on an H100: operations, 2 R Ka Nb (34 GFLOP for
// the FFN's dW1 at R = 65536).
#include "common.cuh"

namespace mtp {

// part[s, k, n] = sum_{r in slice s} A[r, k] B[r, n]; colpart[s, n] =
// sum_{r in slice s} B[r, n] (blocks with blockIdx.x == 0); rows whose
// flag valid[r / kBlockR] is 0 count as zeros and are not read (valid
// NULL: every row counts). grid (Ka/64, Nb/64, S).
template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm, int R, int Ka, int Nb,
    int rows_per_slice, float* __restrict__ part,
    float* __restrict__ colpart, const int8_t* __restrict__ valid) {
  __shared__ float As[kKChunk][kTile];
  __shared__ float Bs[kKChunk][kTile];
  const int k0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int s = blockIdx.z;
  const int rs = s * rows_per_slice, re = min(R, rs + rows_per_slice);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool sums = blockIdx.x == 0 && ty == 0;
  float acc[4][4], csum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  zero(acc);
  for (int r0 = rs; r0 < re; r0 += kKChunk) {
    for (int e = tid; e < kKChunk * kTile; e += kThreads) {
      const int kk = e / kTile, c = e - kk * kTile;
      const bool in = r0 + kk < re &&
                      (valid == nullptr || valid[(r0 + kk) / kBlockR]);
      As[kk][c] = in ? Num<T>::load(A[(size_t)(r0 + kk) * Ka + k0 + c]) : 0.0f;
      Bs[kk][c] = in ? Num<T>::load(Bm[(size_t)(r0 + kk) * Nb + n0 + c])
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
    for (int j = 0; j < 4; ++j)
      p[(size_t)(k0 + ty + 16 * i) * Nb + n0 + tx + 16 * j] = acc[i][j];
  if (sums)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      colpart[(size_t)s * Nb + n0 + tx + 16 * j] = csum[j];
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

// A [R, Ka] and B [R, Nb] row-major in the dtype (0 = fp32, 1 = bf16);
// Ka % 64 == Nb % 64 == 0; slices of rows_per_slice rows (the last may be
// shorter), S = ceil(R / rows_per_slice). valid: int8 flags, one per
// kBlockR (256) consecutive rows, 0 leaving those rows out of both sums (the
// row-block skip of the LN-fused projection), or NULL. Writes part fp32
// [S, Ka, Nb] and colpart fp32 [S, Nb]. Returns cudaGetLastError().
extern "C" int wgrad_partials(const void* A, const void* B, int R, int Ka,
                              int Nb, int rows_per_slice, int S, void* part,
                              void* colpart, const void* valid, int dtype,
                              void* stream) {
  using namespace mtp;
  if (Ka % kTile != 0 || Nb % kTile != 0 || rows_per_slice <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* v = (const int8_t*)valid;
  const dim3 grid(Ka / kTile, Nb / kTile, S);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    wgrad_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)A, (const float*)B, R, Ka, Nb, rows_per_slice,
        (float*)part, (float*)colpart, v);
  else if (dtype == 1)
    wgrad_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)A, (const __nv_bfloat16*)B, R, Ka, Nb,
        rows_per_slice, (float*)part, (float*)colpart, v);
  else
    return (int)cudaErrorInvalidValue;
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
