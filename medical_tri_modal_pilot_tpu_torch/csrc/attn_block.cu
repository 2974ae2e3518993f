// Fused pre-norm attention block: out = x + MHA(StdLN(x)), 2-D key mask.
// The lean form (eval) and the training form, which also writes the
// pre-residual attention output and the per-row, per-head softmax stats
// (m, l) that the backward (attn_block_bwd.cu) needs.
//
// Replaces medical_tri_modal_pilot_tpu/kernels/attn_block.py::_fwd (body
// _fwd_kernel, lean and training forms), reached through
// pallas_attn_block.
//
// What bounds it on an H100: the two attention products (q.k^T and p.v)
// are O(L^2) per sample and dominate at L = 1024; the projections and the
// StdLN are O(L). The TPU kernel keeps a whole sample's k and v in VMEM
// (_build_kv). At [1024, 256] x 2 that is 2 MB in fp32, far beyond the
// 227 KB of shared memory an SM offers, so here k and v round-trip through
// device memory, unlike on the TPU:
//   launch 1 (proj_kernel): StdLN + the k|v projection of every row up
//     to the sample's last valid key, into a [B, L, 2C] scratch in T;
//   launch 2 (attn_kernel): one block per (sample, 64-row q tile): StdLN +
//     the q projection of the tile, a flash (online-softmax) loop over
//     64-key tiles up to the sample's last valid key, per head, with the
//     residual added in the epilogue.
// The scratch is read from L2 by every q tile of its sample. The products
// run as fp32 FMAs on 4 x 4 register tiles staged through shared memory:
// simple and exact to the fp32 oracle; tensor cores (wgmma) are later work.
// The backward recomputes q|k|v with proj_kernel over all 3C columns
// (attn_block_qkv).
//
// Mask contract (kernels/attn_block.py:27-38, kernels/attention.py:186-196):
// a valid-but-masked key scores -65504; keys past the array end are left
// out; a sample whose keys are all masked has kend = L and so attends
// uniformly over its L keys; q tiles that start past the sample's last
// valid key emit the pure residual.
#include "common.cuh"

namespace mtp {

// out[b, r, :] = round(round(StdLN(x[b, r]) . w[:, c0:c0+N]) + bias[c0:c0+N])
// for the rows of tiles that start before kend[b]; out is [B, L, N].
// grid (ceil(L/64), N/64, B).
template <typename T>
__global__ void __launch_bounds__(kThreads) proj_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w,
    const T* __restrict__ bias, const int* __restrict__ kend,
    T* __restrict__ out, int L, int C, int c0, int N) {
  extern __shared__ float smem[];
  const int lda = C + 1;
  float* lns = smem;               // kTile x (C + 1)
  float* Bs = lns + kTile * lda;   // kKChunk x 64
  const int b = blockIdx.z, r0 = blockIdx.x * kTile, n0 = blockIdx.y * 64;
  if (r0 >= kend[b]) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  ln_tile<T>(x + (size_t)b * L * C, r0, L, C, gamma, beta, lns, lda, tid);
  float acc[4][4];
  zero(acc);
  gemm_tile<T, 4>(lns, lda, C, w, 3 * C, c0 + n0, Bs, acc, tx, ty, tid);
  T* ob = out + (size_t)b * L * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      ob[(size_t)row * N + col] = Num<T>::store(
          rnd<T>(acc[i][j]) + Num<T>::load(bias[c0 + col]));
    }
  }
}

// grid (ceil(L/64), B); DH = head width. TRAIN: also attn [B, L, C] (the
// pre-residual output in T) and stats [B, H, L, 2] fp32 (the row max m
// and the sum l of exp(s - m), floored at 1e-30) of the live q tiles.
template <typename T, int DH, bool TRAIN>
__global__ void __launch_bounds__(kThreads) attn_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w,
    const T* __restrict__ bias, const int8_t* __restrict__ mask,
    const int* __restrict__ kend, const T* __restrict__ kv,
    T* __restrict__ out, T* __restrict__ attn, float* __restrict__ stats,
    int L, int C, float mult) {
  constexpr int NJ = DH / 16;
  constexpr int LDQ = DH + 1;
  constexpr int LDP = kTile + 1;
  extern __shared__ float smem[];
  const int lda = C + 1;
  float* lns = smem;                // kTile x (C + 1): StdLN of the q tile
  float* qs = lns + kTile * lda;    // kTile x LDQ: q of the current head
  float* ks = qs + kTile * LDQ;     // kTile x LDQ: k tile; weight chunk
  float* vs = ks + kTile * LDQ;     // kTile x DH: v tile
  float* ps = vs + kTile * DH;      // kTile x LDP: probabilities
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ke = kend[b];
  const int rows = min(kTile, L - q0);
  const T* xb = x + (size_t)b * L * C;
  T* ob = out + (size_t)b * L * C;
  if (q0 >= ke) {  // dead q tile: pure residual
    copy_rows<T>(xb, ob, q0, rows, C, tid);
    return;
  }
  ln_tile<T>(xb, q0, L, C, gamma, beta, lns, lda, tid);
  const T* kvb = kv + (size_t)b * L * 2 * C;
  const int8_t* mb = mask + (size_t)b * L;
  const int H = C / DH;
  for (int h = 0; h < H; ++h) {
    {
      float acc[4][NJ];
      zero(acc);
      gemm_tile<T, NJ>(lns, lda, C, w, 3 * C, h * DH, ks, acc, tx, ty, tid);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          qs[(ty + 16 * i) * LDQ + col] = rnd<T>(
              rnd<T>(acc[i][j]) + Num<T>::load(bias[h * DH + col]));
        }
    }
    float m[4], l[4], o[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.0f;
    }
    zero(o);
    for (int k0 = 0; k0 < ke; k0 += kTile) {
      for (int e = tid; e < kTile * DH; e += kThreads) {
        const int j = e / DH, d = e - j * DH;
        const int key = k0 + j;
        float kval = 0.0f, vval = 0.0f;
        if (key < L) {
          const T* row = kvb + (size_t)key * 2 * C + h * DH + d;
          kval = Num<T>::load(row[0]);
          vval = Num<T>::load(row[C]);
        }
        ks[j * LDQ + d] = kval;
        vs[j * DH + d] = vval;
      }
      __syncthreads();  // q (first tile) and the k/v tile are in place
      float s[4][4];
      zero(s);
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        float qa[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool pad = key >= L;
        const bool masked = !pad && mb[key] != 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][j] = pad ? -INFINITY : (masked ? kMaskFill : s[i][j] * mult);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        const float mn = fmaxf(m[i], half_warp_max(mt));
        const float alpha = expf(m[i] - mn);
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - mn);
          rs += s[i][j];
        }
        l[i] = l[i] * alpha + half_warp_sum(rs);
        m[i] = mn;
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[i][j] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
      }
      __syncthreads();  // p complete
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) {
        float pa[4], vb[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * LDP + k];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vb[j] = vs[k * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(pa[i], vb[j], o[i][j]);
      }
      __syncthreads();  // k/v/p tiles free for the next step
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      if (row >= rows) continue;
      const float l_safe = fmaxf(l[i], 1e-30f);
      const float inv_l = 1.0f / l_safe;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const size_t off = (size_t)(q0 + row) * C + h * DH + tx + 16 * j;
        const float att = rnd<T>(o[i][j] * inv_l);
        ob[off] = Num<T>::store(Num<T>::load(xb[off]) + att);
        if (TRAIN) attn[(size_t)b * L * C + off] = Num<T>::store(att);
      }
      if (TRAIN && tx == 0) {
        float* st = stats + (((size_t)b * H + h) * L + q0 + row) * 2;
        st[0] = m[i];
        st[1] = l_safe;
      }
    }
  }
}

template <typename T>
static cudaError_t launch_proj(const void* x, const float* gamma,
                               const float* beta, const void* w,
                               const void* bias, const int* kend, void* out,
                               int B, int L, int C, int c0, int N,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kTile * (C + 1) + kKChunk * 64);
  cudaError_t err = cudaFuncSetAttribute(
      proj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, N / 64, B);
  proj_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, (const T*)w, (const T*)bias, kend, (T*)out,
      L, C, c0, N);
  return cudaGetLastError();
}

template <typename T, int DH, bool TRAIN>
static cudaError_t launch(const void* x, const float* gamma,
                          const float* beta, const void* w, const void* bias,
                          const int8_t* mask, const int* kend, void* kv,
                          void* out, void* attn, float* stats, int B, int L,
                          int C, float mult, cudaStream_t stream) {
  cudaError_t err = launch_proj<T>(x, gamma, beta, w, bias, kend, kv, B, L,
                                   C, C, 2 * C, stream);
  if (err != cudaSuccess) return err;
  const size_t smem_at = sizeof(float) *
      (kTile * (C + 1) + 2 * kTile * (DH + 1) + kTile * DH +
       kTile * (kTile + 1));
  err = cudaFuncSetAttribute(attn_kernel<T, DH, TRAIN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_at);
  if (err != cudaSuccess) return err;
  const dim3 g2((L + kTile - 1) / kTile, B);
  attn_kernel<T, DH, TRAIN><<<g2, kThreads, smem_at, stream>>>(
      (const T*)x, gamma, beta, (const T*)w, (const T*)bias, mask, kend,
      (const T*)kv, (T*)out, (T*)attn, stats, L, C, mult);
  return cudaGetLastError();
}

}  // namespace mtp

// dtype: 0 = fp32, 1 = bf16. x, w, bias, kv, out and attn are in that
// type; gamma and beta fp32; mask int8 [B, L] (1 = masked); kend int32
// [B]. attn [B, L, C] and stats fp32 [B, H, L, 2] are written when attn is
// not NULL (the training form). C % 64 == 0 and C / H in {32, 64}.
// Returns cudaGetLastError().
extern "C" int attn_block_fwd(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* bias, const void* mask,
                              const void* kend, void* kv, void* out,
                              void* attn, void* stats, int B, int L, int C,
                              int H, float mult, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* mk = (const int8_t*)mask;
  const int* ke = (const int*)kend;
  float* st = (float*)stats;
  if (H <= 0 || C % 64 != 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  const int dh = C / H;
  const bool train = attn != nullptr;
#define MTP_ATTN(T, DH, TR) \
  return (int)launch<T, DH, TR>(x, g, be, w, bias, mk, ke, kv, out, attn, st, B, L, C, mult, s)
  if (dtype == 0 && dh == 64) { if (train) MTP_ATTN(float, 64, true); MTP_ATTN(float, 64, false); }
  if (dtype == 0 && dh == 32) { if (train) MTP_ATTN(float, 32, true); MTP_ATTN(float, 32, false); }
  if (dtype == 1 && dh == 64) { if (train) MTP_ATTN(__nv_bfloat16, 64, true); MTP_ATTN(__nv_bfloat16, 64, false); }
  if (dtype == 1 && dh == 32) { if (train) MTP_ATTN(__nv_bfloat16, 32, true); MTP_ATTN(__nv_bfloat16, 32, false); }
#undef MTP_ATTN
  return (int)cudaErrorInvalidValue;
}

// q|k|v of the rows of tiles that start before kend[b], recomputed for the
// backward: qkv [B, L, 3C] in the dtype (other rows are left unwritten).
extern "C" int attn_block_qkv(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* bias, const void* kend, void* qkv,
                              int B, int L, int C, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C % 64 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_proj<float>(x, (const float*)gamma, (const float*)beta, w, bias, (const int*)kend, qkv, B, L, C, 0, 3 * C, s);
  if (dtype == 1)
    return (int)launch_proj<__nv_bfloat16>(x, (const float*)gamma, (const float*)beta, w, bias, (const int*)kend, qkv, B, L, C, 0, 3 * C, s);
  return (int)cudaErrorInvalidValue;
}
