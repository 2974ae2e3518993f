// Fused pre-norm attention block: out = x + MHA(StdLN(x)), under a 2-D key
// mask [B, L] or a 3-D block mask [B, L, L] (the multitoken MBT streams).
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
// (_build_kv). At [1024, 256] x 2 that is 1 MB in bf16, far beyond the
// 227 KB of shared memory an SM offers, so here q|k|v round-trip through
// device memory (read from L2 by every q tile of the sample), in two
// launches. Two routes, picked by dtype (kernels/attn_block.py route):
//
//   tc (bf16): on the tensor cores (mma.sync m16n8k16, fp32 accumulate;
//     helpers in mma.cuh, flash_tc.cuh, proj_tc.cuh):
//     1. block_qkv_tc_kernel: one block per 64-row tile that starts
//        before the sample's last valid key, through the projection tile
//        loop it shares with rowmm.cu (proj_tc.cuh::proj_fwd_tile): x
//        staged by cp.async, StdLN in fp32 rounded to bf16 in place as the
//        A operand, W streamed in 64 x 128 chunks through a three-stage
//        cp.async ring; q|k|v = round(round(acc) + bias) into a [B, L, 3C]
//        scratch, through shared memory in 16-byte pieces. The
//        backward's recompute launches it too.
//     2. block_attn_tc_kernel: one block per (64-row q tile, head,
//        sample), warp w owning q rows 16 w .. + 15, through the flash
//        loop it shares with attention.cu (flash_tc.cuh::flash_fwd_tile
//        at row stride 3C): q staged once, k and v tiles in a two-stage
//        cp.async ring up to the last valid key; S = Q K^T on the tensor
//        cores, the key mask as 64-bit rows by ballot, the online softmax
//        on the accumulator fragments in fp32, P rounded to bf16 (as the
//        TPU kernel casts p to v's dtype) straight from the C fragments
//        into the A fragments of P V (V through ldmatrix.trans); the
//        epilogue divides by l, rounds and adds the residual.
//   fma (fp32, the checking dtype): fp32 FMAs on 4 x 4 register tiles,
//     exact to the fp32 oracle:
//     1. proj_kernel: StdLN + the q|k|v projection into a [B, L, 3C]
//        scratch (the backward's recompute launches it too);
//     2. attn_kernel: one block per (64-row q tile, sample): the flash
//        loop per head over the scratch's q, k and v, the residual. (Its
//        shared memory no longer holds the tile's StdLN rows, [64][C + 1]
//        fp32, which at C = 512 with d_head 128 outgrew a block's
//        227 KB.)
//
// Mask contract (kernels/attn_block.py:27-38, kernels/attention.py:186-196):
// a valid-but-masked key scores -65504; keys past the array end are left
// out; a sample whose keys are all masked has kend = L and so attends
// uniformly over its L keys; q tiles that start past the sample's last
// valid key emit the pure residual. A block mask ([B, L, L], the BLOCK
// template flag of the FMA kernels, BlockMask on the tensor cores) masks
// (query, key) pairs; the caller passes kend = L for every sample, as the
// TPU kernel does no per-sample skipping there (attn_block.py:219-227): a
// query whose every key is masked attends uniformly over all L keys, so
// its output depends on every real key.
#include "flash_tc.cuh"
#include "proj_tc.cuh"

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
// BLOCK: mask is [B, L, L], read per (query, key) pair; else [B, L].
template <typename T, int DH, bool TRAIN, bool BLOCK>
__global__ void __launch_bounds__(kThreads) attn_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ mask,
    const int* __restrict__ kend, const T* __restrict__ qkv,
    T* __restrict__ out, T* __restrict__ attn, float* __restrict__ stats,
    int L, int C, float mult) {
  constexpr int NJ = DH / 16;
  constexpr int LDQ = DH + 1;
  constexpr int LDP = kTile + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // kTile x LDQ: q of the current head
  float* ks = qs + kTile * LDQ;     // kTile x LDQ: k tile
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
  const T* qkvb = qkv + (size_t)b * L * 3 * C;
  const T* kvb = qkvb + C;  // k at column 0 of a row, v at C
  const int8_t* mb = mask + (size_t)b * L * (BLOCK ? L : 1);
  const int H = C / DH;
  for (int h = 0; h < H; ++h) {
    // q of the tile's rows (zeros past L); the previous head's last
    // barrier ordered every read of qs before these writes
    for (int e = tid; e < kTile * DH; e += kThreads) {
      const int r = e / DH, d = e - r * DH;
      qs[r * LDQ + d] = q0 + r < L
          ? Num<T>::load(qkvb[(size_t)(q0 + r) * 3 * C + h * DH + d])
          : 0.0f;
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
          const T* row = kvb + (size_t)key * 3 * C + h * DH + d;
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
        const bool kmasked = !BLOCK && !pad && mb[key] != 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty + 16 * i;
          const bool masked =
              BLOCK ? !pad && q < L && mb[(size_t)q * L + key] != 0 : kmasked;
          s[i][j] = pad ? -INFINITY : (masked ? kMaskFill : s[i][j] * mult);
        }
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

template <typename T, int DH, bool TRAIN, bool BLOCK>
static cudaError_t launch(const void* x, const float* gamma,
                          const float* beta, const void* w, const void* bias,
                          const int8_t* mask, const int* kend, void* kv,
                          void* out, void* attn, float* stats, int B, int L,
                          int C, float mult, cudaStream_t stream) {
  cudaError_t err = launch_proj<T>(x, gamma, beta, w, bias, kend, kv, B, L,
                                   C, 0, 3 * C, stream);
  if (err != cudaSuccess) return err;
  const size_t smem_at = sizeof(float) *
      (2 * kTile * (DH + 1) + kTile * DH + kTile * (kTile + 1));
  err = cudaFuncSetAttribute(attn_kernel<T, DH, TRAIN, BLOCK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_at);
  if (err != cudaSuccess) return err;
  const dim3 g2((L + kTile - 1) / kTile, B);
  attn_kernel<T, DH, TRAIN, BLOCK><<<g2, kThreads, smem_at, stream>>>(
      (const T*)x, mask, kend, (const T*)kv, (T*)out, (T*)attn, stats, L,
      C, mult);
  return cudaGetLastError();
}

// ---- the bf16 route on the tensor cores ----

// qkv[b, r, :] = round(round(StdLN(x[b, r]) . w) + bias), [B, L, 3C], for
// the rows of tiles that start before kend[b] (other rows are left
// unwritten). grid (ceil(L/64), B), kProjThreads threads; C % 64 == 0;
// MINB blocks an SM (proj_fwd_min_blocks).
template <int MINB>
__global__ void __launch_bounds__(kProjThreads, MINB) block_qkv_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const int* __restrict__ kend,
    bf16* __restrict__ qkv, int L, int C) {
  extern __shared__ __align__(16) unsigned char qkv_smem[];
  const int b = blockIdx.y, r0 = blockIdx.x * kTile;
  if (r0 >= kend[b]) return;
  const int N = 3 * C;
  const size_t row0 = (size_t)b * L + r0;
  proj_fwd_tile<true>(
      qkv_smem, x + row0 * C, min(kTile, L - r0), C, gamma, beta, w, bias,
      N, Packed<bf16>{qkv + row0 * N, N});
}

// out = x + MHA for head h's columns of one 64-row q tile, from qkv
// [B, L, 3C] (flash_tc.cuh's forward loop at row stride 3C). TRAIN: also
// attn [B, L, C] (the pre-residual output) and stats [B, H, L, 2] (the row
// max m of the scaled scores and l of exp(s - m), floored at 1e-30) of the
// tile's rows. Dead q tiles copy the residual. Mask: KeyMask over a
// [B, L] mask or BlockMask over a [B, L, L] one (flash_tc.cuh). grid
// (ceil(L/64), H, B), kTcThreads threads.
template <int DH, bool TRAIN, class Mask>
__global__ void __launch_bounds__(kTcThreads) block_attn_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ qkv,
    const int8_t* __restrict__ mask, const int* __restrict__ kend,
    bf16* __restrict__ out, bf16* __restrict__ attn,
    float* __restrict__ stats, int L, int C, float mult) {
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ke = kend[b], rows = min(kTile, L - q0), col0 = h * DH;
  const size_t row0 = (size_t)b * L + q0;
  if (q0 >= ke) {  // dead q tile: the residual in this head's columns
    for (int e = tid; e < rows * ND; e += kTcThreads) {
      const int r = e / ND, c = (e % ND) * 8;
      const size_t off = (row0 + r) * C + col0 + c;
      *reinterpret_cast<uint4*>(out + off) =
          *reinterpret_cast<const uint4*>(x + off);
    }
    return;
  }
  const int N = 3 * C;
  const bf16* qb = qkv + (size_t)b * L * N + col0;
  float o[ND][4], m[2], l[2];
  flash_fwd_tile<DH>(attn_smem, qb, N, qb + C, qb + 2 * C, N, q0, L, L, ke,
                     Mask::at(mask, b, L, L), mult, o, m, l);
  const int H = gridDim.y;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    if (r >= rows) continue;
    const float l_safe = fmaxf(l[hh], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t off = (row0 + r) * C + col0 + 8 * j + 2 * t;
      const float a0 = rnd<bf16>(o[j][2 * hh] / l_safe);
      const float a1 = rnd<bf16>(o[j][2 * hh + 1] / l_safe);
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
          x + off);
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(bf(xv.x) + a0, bf(xv.y) + a1);
      if (TRAIN)
        *reinterpret_cast<uint32_t*>(attn + off) = pack_bf16(a0, a1);
    }
    if (TRAIN && t == 0) {
      float* st = stats + (((size_t)b * H + h) * L + q0 + r) * 2;
      st[0] = m[hh];
      st[1] = l_safe;
    }
  }
}

template <int MINB>
static cudaError_t launch_qkv_tc_at(const void* x, const float* gamma,
                                    const float* beta, const void* w,
                                    const void* bias, const int* kend,
                                    void* qkv, int B, int L, int C,
                                    cudaStream_t stream) {
  const int smem = qkv_tc_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      block_qkv_tc_kernel<MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, B);
  block_qkv_tc_kernel<MINB><<<grid, kProjThreads, smem, stream>>>(
      (const bf16*)x, gamma, beta, (const bf16*)w, (const bf16*)bias, kend,
      (bf16*)qkv, L, C);
  return cudaGetLastError();
}

static cudaError_t launch_qkv_tc(const void* x, const float* gamma,
                                 const float* beta, const void* w,
                                 const void* bias, const int* kend,
                                 void* qkv, int B, int L, int C,
                                 cudaStream_t stream) {
  if (proj_fwd_min_blocks(C) == 1)
    return launch_qkv_tc_at<1>(x, gamma, beta, w, bias, kend, qkv, B, L, C,
                               stream);
  return launch_qkv_tc_at<2>(x, gamma, beta, w, bias, kend, qkv, B, L, C,
                             stream);
}

template <int DH, bool TRAIN, class Mask>
static cudaError_t launch_tc(const void* x, const float* gamma,
                             const float* beta, const void* w,
                             const void* bias, const int8_t* mask,
                             const int* kend, void* qkv, void* out,
                             void* attn, float* stats, int B, int L, int C,
                             float mult, cudaStream_t stream) {
  cudaError_t err = launch_qkv_tc(x, gamma, beta, w, bias, kend, qkv, B, L,
                                  C, stream);
  if (err != cudaSuccess) return err;
  constexpr int smem = attn_tc_smem(DH);
  err = cudaFuncSetAttribute(block_attn_tc_kernel<DH, TRAIN, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, C / DH, B);
  block_attn_tc_kernel<DH, TRAIN, Mask><<<grid, kTcThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)qkv, mask, kend, (bf16*)out, (bf16*)attn,
      stats, L, C, mult);
  return cudaGetLastError();
}

}  // namespace mtp

// dtype: 0 = fp32 (the FMA kernels), 1 = bf16 (the tensor cores). x, w,
// bias, qkv, out and attn are in that type; gamma and beta fp32; mask int8
// (1 = masked), [B, L] or, when block != 0, [B, L, L]; kend int32 [B] (L
// for every sample under a block mask); qkv a scratch of [B, L, 3C]
// (q|k|v). attn [B, L, C] and stats fp32 [B, H, L, 2] are written when
// attn is not NULL (the training form). C in {64, 128, 256, 512} and
// C / H in {32, 64, 128}. Returns cudaGetLastError().
extern "C" int attn_block_fwd(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* bias, const void* mask,
                              const void* kend, void* qkv, void* out,
                              void* attn, void* stats, int B, int L, int C,
                              int H, int block, float mult, int dtype,
                              void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* mk = (const int8_t*)mask;
  const int* ke = (const int*)kend;
  float* st = (float*)stats;
  if (H <= 0 || !model_width(C) || C % H != 0)
    return (int)cudaErrorInvalidValue;
  const int dh = C / H;
  const bool train = attn != nullptr;
#define MTP_ATTN(DH, TR, BL) \
  return (int)launch<float, DH, TR, BL>(x, g, be, w, bias, mk, ke, qkv, out, attn, st, B, L, C, mult, s)
#define MTP_ATTN_TC(DH, TR, MK) \
  return (int)launch_tc<DH, TR, MK>(x, g, be, w, bias, mk, ke, qkv, out, attn, st, B, L, C, mult, s)
#define MTP_FORMS(DH)                                                    \
  if (dtype == 0 && dh == DH) {                                          \
    if (block) { if (train) MTP_ATTN(DH, true, true); MTP_ATTN(DH, false, true); } \
    if (train) MTP_ATTN(DH, true, false);                                \
    MTP_ATTN(DH, false, false);                                          \
  }                                                                      \
  if (dtype == 1 && dh == DH) {                                          \
    if (block) { if (train) MTP_ATTN_TC(DH, true, BlockMask); MTP_ATTN_TC(DH, false, BlockMask); } \
    if (train) MTP_ATTN_TC(DH, true, KeyMask);                           \
    MTP_ATTN_TC(DH, false, KeyMask);                                     \
  }
  MTP_FORMS(128)
  MTP_FORMS(64)
  MTP_FORMS(32)
#undef MTP_FORMS
#undef MTP_ATTN
#undef MTP_ATTN_TC
  return (int)cudaErrorInvalidValue;
}

// q|k|v of the rows of tiles that start before kend[b], recomputed for the
// backward: qkv [B, L, 3C] in the dtype (other rows are left unwritten);
// bf16 through block_qkv_tc_kernel, so the values are the forward's bit
// for bit.
extern "C" int attn_block_qkv(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* bias, const void* kend, void* qkv,
                              int B, int L, int C, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!model_width(C)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_proj<float>(x, (const float*)gamma, (const float*)beta, w, bias, (const int*)kend, qkv, B, L, C, 0, 3 * C, s);
  if (dtype == 1)
    return (int)launch_qkv_tc(x, (const float*)gamma, (const float*)beta, w, bias, (const int*)kend, qkv, B, L, C, s);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of a kernel of the tensor-core route (0 the
// projection at width C, 1 the attention forward, 2 dK/dV, 3 dQ at head
// width dh, 4 the projection backward at width C), as the launchers ask
// for them: kernels/attn_block.py::tc_smem_bytes mirrors this.
extern "C" int attn_block_tc_smem(int kernel, int C, int dh) {
  using namespace mtp;
  switch (kernel) {
    case 0: return qkv_tc_smem(C);
    case 1: return attn_tc_smem(dh);
    case 2: return dkv_tc_smem(dh);
    case 3: return dq_tc_smem(dh);
    case 4: return ln_bwd_tc_smem(C);
  }
  return -1;
}

// Blocks an SM that a kernel of the tensor-core route asks for in its
// launch bounds (kernels as attn_block_tc_smem's; the attention forward
// asks for none, 1): kernels/attn_block.py::tc_min_blocks mirrors this.
extern "C" int attn_block_tc_min_blocks(int kernel, int C, int dh) {
  using namespace mtp;
  switch (kernel) {
    case 0: return proj_fwd_min_blocks(C);
    case 1: return 1;
    case 2: return flash_min_blocks(dh, kFlashDkvBlocks);
    case 3: return flash_min_blocks(dh, kFlashDqBlocks);
    case 4: return proj_bwd_min_blocks(C);
  }
  return -1;
}
