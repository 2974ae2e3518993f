// Backward of the fused pre-norm attention block out = x + MHA(StdLN(x)):
// dx, and the tile partials of dgamma and dbeta; dW and db come from
// wgrad.cu over the operands this pass writes.
//
// Replaces medical_tri_modal_pilot_tpu/kernels/attn_block.py::
// _fused_block_bwd (body _bwd_fused_kernel), reached through
// pallas_attn_block's custom VJP.
//
// What bounds it on an H100: as in the forward, the O(L^2) attention
// products (here five: s, dp, dv, dk and dq, of which s and dp are
// computed twice). The TPU kernel keeps one sample's q, k, v and three
// fp32 gradient scratches in VMEM, about 5 MB at [1024, 256]; a Hopper SM
// has 227 KB of shared memory. So the backward is several launches, as the
// forward is, with the per-sample state in device memory (read from L2),
// after attn_block_qkv (attn_block.cu) has recomputed q|k|v of the live
// rows into [B, L, 3C]. Two routes, picked by dtype:
//
//   tc (bf16), every product on the tensor cores (mma.sync m16n8k16, fp32
//   accumulate; the dK/dV and dQ loops are flash_tc.cuh's, shared with
//   attention.cu; the projection backward's is proj_tc.cuh's, shared with
//   rowmm.cu):
//     block_delta_kernel: delta = rowsum(dO * O) per row and head, once,
//       into fp32 [B, H, L] (FlashAttention-2's backward preprocess);
//     block_dkv_tc_kernel: one block per (64-key tile, head, sample),
//       warp w owning keys 16 w .. + 15, k and v as A fragments in
//       registers; it walks the live q tiles (q and dO in a two-stage
//       cp.async ring): S^T = K Q^T and dP^T = V dO^T, P^T and dS^T on
//       the fragments, rounded to bf16 into the A fragments of
//       dV += P^T dO and dK += dS^T Q (dS^T in two bf16 parts under a
//       block mask, kSplitDs);
//     block_dq_tc_kernel: one block per (64-row q tile, head, sample): it
//       walks the live key tiles (k and v in the ring): S, dP, dS and
//       dQ += dS K. Two passes instead of float atomics on dq keep the
//       result deterministic;
//     block_ln_bwd_tc_kernel: one block per (64-row tile, sample), 8
//       warps: x staged by cp.async, StdLN recomputed (its rows written
//       for dW), dln = [dq|dk|dv] . W^T over k = 3C with dq|dk|dv and W
//       chunks in a three-stage ring, dy staged during the last; then
//       the StdLN backward, the residual fold into dx and the tile's
//       dgamma | dbeta sums on the fragments, their cross-warp sums
//       through shared memory (ffn.cu's ffn_bwd_tc_kernel epilogue).
//   fma (fp32, the checking dtype), fp32 FMAs on 4 x 4 register tiles:
//     dkv_kernel and dq_kernel (the same two passes, delta recomputed per
//     q tile from dy and O) and ln_bwd_kernel.
// The probabilities come from the forward's saved (m, l) per row and head,
// p = exp(s - m) / l, and delta from the saved pre-residual output O, as
// in the TPU kernel. Roundings follow it: p and ds are rounded to T before
// their products (on the tensor cores under a block mask ds enters dK
// and dQ in two bf16 parts, kSplitDs), dq, dk and dv to T before the
// projection backward, dx to T before the residual is added.
//
// Rows of q tiles that start past a sample's last valid key (kend) carry
// no cotangent in the model (they are masked keys everywhere downstream
// and the FFN passes them through): their dx is dy and they add nothing.
// Under a block mask ([B, L, L]: the BLOCK flag of the FMA kernels,
// BlockMask on the tensor cores) the caller passes kend = L, so every row
// is live, as in the TPU kernel's full coverage (attn_block.py:558-566); a
// masked pair keeps its probability (dV takes it) and has no score
// gradient, also in a row whose every key is masked.
#include <type_traits>

#include "flash_tc.cuh"
#include "proj_tc.cuh"

namespace mtp {

// dS enters dK and dQ in two bf16 parts (flash_tc.cuh's SPLIT) under a
// block mask, rounded once under a key mask as in the TPU kernel: the
// multitoken models' bf16 train step needs the former (PERF.md §6)
template <class Mask>
constexpr bool kSplitDs = std::is_same_v<Mask, BlockMask>;

template <int DH>
struct AttnBwdSmem {
  static constexpr int LD = DH + 1;
  static constexpr int LDP = kTile + 1;
  // k, v, q, dO tiles; p and ds tiles; m, l, delta per row; key flags
  static constexpr size_t floats =
      4 * kTile * LD + 2 * kTile * LDP + 3 * kTile + kTile;
};

// Load the q rows [q0, q0 + 64) of head h (q from qkv, dO from dy) with
// their stats and delta = rowsum(dO * O). Rows past L are zero, with l = 1.
template <typename T, int DH>
static __device__ __forceinline__ void load_q_side(
    const T* __restrict__ qkvb, const T* __restrict__ dyb,
    const T* __restrict__ attnb, const float* __restrict__ stb, int q0,
    int L, int C, int h, float* qs, float* dos, float* mrow, float* lrow,
    float* delta, int tid) {
  constexpr int LD = DH + 1;
  for (int e = tid; e < kTile * DH; e += kThreads) {
    const int r = e / DH, d = e - r * DH;
    const int q = q0 + r;
    float qv = 0.0f, dov = 0.0f;
    if (q < L) {
      qv = Num<T>::load(qkvb[(size_t)q * 3 * C + h * DH + d]);
      dov = Num<T>::load(dyb[(size_t)q * C + h * DH + d]);
    }
    qs[r * LD + d] = qv;
    dos[r * LD + d] = dov;
  }
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int q = q0 + r;
    float s = 0.0f;
    if (q < L)
      for (int d = lane; d < DH; d += 32) {
        const size_t off = (size_t)q * C + h * DH + d;
        s += Num<T>::load(dyb[off]) * Num<T>::load(attnb[off]);
      }
    s = warp_sum(s);
    if (lane == 0) {
      delta[r] = s;
      mrow[r] = q < L ? stb[(size_t)q * 2] : 0.0f;
      lrow[r] = q < L ? stb[(size_t)q * 2 + 1] : 1.0f;
    }
  }
}

// Load key rows [k0, k0 + 64) of head h (k, v) and their flags: 0 live,
// 1 valid but masked, 2 past the array end. BLOCK: the flags say only
// whether a key lies past the end (pair_flag reads the pair's mask).
template <typename T, int DH, bool BLOCK>
static __device__ __forceinline__ void load_k_side(
    const T* __restrict__ qkvb, const int8_t* __restrict__ mb, int k0,
    int L, int C, int h, float* ks, float* vs, int* kflag, int tid) {
  constexpr int LD = DH + 1;
  for (int e = tid; e < kTile * DH; e += kThreads) {
    const int j = e / DH, d = e - j * DH;
    const int key = k0 + j;
    float kv = 0.0f, vv = 0.0f;
    if (key < L) {
      const T* row = qkvb + (size_t)key * 3 * C + h * DH + d;
      kv = Num<T>::load(row[C]);
      vv = Num<T>::load(row[2 * C]);
    }
    ks[j * LD + d] = kv;
    vs[j * LD + d] = vv;
  }
  for (int j = tid; j < kTile; j += kThreads) {
    const int key = k0 + j;
    kflag[j] = key >= L ? 2 : (!BLOCK && mb[key] != 0 ? 1 : 0);
  }
}

// The flag of the pair (q, key) from the key's flag: under a block mask
// (BLOCK, mb the sample's [L][L]) a key within the array is masked for
// query q where mb[q][key] is set; rows past L read no mask.
template <bool BLOCK>
static __device__ __forceinline__ int pair_flag(int kflag,
                                                const int8_t* __restrict__ mb,
                                                int q, int key, int L) {
  if (!BLOCK || kflag != 0 || q >= L) return kflag;
  return mb[(size_t)q * L + key] != 0 ? 1 : 0;
}

// p and ds of one (q row, key) pair (attn_block.py:428-447)
static __device__ __forceinline__ void prob_and_ds(
    float s, float dp, int flag, bool qvalid, float m, float l, float delta,
    float mult, float& p, float& ds) {
  p = 0.0f;
  ds = 0.0f;
  if (flag == 2 || !qvalid) return;
  const float sc = flag == 1 ? kMaskFill : s * mult;
  p = expf(sc - m) / l;
  if (flag == 0) ds = p * (dp - delta) * mult;
}

// grid (ceil(L/64), H, B); BLOCK: mask [B, L, L], else [B, L]
template <typename T, int DH, bool BLOCK>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dy,
    const T* __restrict__ attn, const float* __restrict__ stats,
    const int8_t* __restrict__ mask, const int* __restrict__ kend,
    T* __restrict__ dqkv, int L, int C, float mult) {
  constexpr int NJ = DH / 16;
  constexpr int LD = DH + 1, LDP = kTile + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;      // [key][q], p rounded to T
  float* dss = ps + kTile * LDP;     // [key][q], ds rounded to T
  float* mrow = dss + kTile * LDP;
  float* lrow = mrow + kTile;
  float* delta = lrow + kTile;
  int* kflag = (int*)(delta + kTile);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int H = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ke = kend[b];
  const int nk = min(kTile, L - k0);
  T* db = dqkv + (size_t)b * L * 3 * C;
  if (k0 >= ke) {  // keys past the last valid one get no gradient
    for (int e = tid; e < nk * DH; e += kThreads) {
      const int j = e / DH, d = e - j * DH;
      const size_t off = (size_t)(k0 + j) * 3 * C + h * DH + d;
      db[off + C] = Num<T>::store(0.0f);
      db[off + 2 * C] = Num<T>::store(0.0f);
    }
    return;
  }
  const T* qkvb = qkv + (size_t)b * L * 3 * C;
  const T* dyb = dy + (size_t)b * L * C;
  const T* attnb = attn + (size_t)b * L * C;
  const float* stb = stats + ((size_t)b * H + h) * L * 2;
  const int8_t* mb = mask + (size_t)b * L * (BLOCK ? L : 1);
  load_k_side<T, DH, BLOCK>(qkvb, mb, k0, L, C, h, ks, vs, kflag, tid);
  float dk[4][NJ], dv[4][NJ];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < ke; q0 += kTile) {
    load_q_side<T, DH>(qkvb, dyb, attnb, stb, q0, L, C, h, qs, dos, mrow,
                       lrow, delta, tid);
    __syncthreads();
    // transposed scores: key ty + 16i, q row tx + 16j
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float ka[4], va[4], qb[4], ob[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = ks[(ty + 16 * i) * LD + d];
        va[i] = vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = qs[(tx + 16 * j) * LD + d];
        ob[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
          dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = ty + 16 * i, q = tx + 16 * j;
        float p, ds;
        prob_and_ds(s[i][j], dp[i][j],
                    pair_flag<BLOCK>(kflag[key], mb, q0 + q, k0 + key, L),
                    q0 + q < L, mrow[q], lrow[q], delta[q], mult, p, ds);
        ps[key * LDP + q] = rnd<T>(p);
        dss[key * LDP + q] = rnd<T>(ds);
      }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < kTile; ++q) {
      float pa[4], da[4], ob[NJ], qb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[(ty + 16 * i) * LDP + q];
        da[i] = dss[(ty + 16 * i) * LDP + q];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ob[j] = dos[q * LD + tx + 16 * j];
        qb[j] = qs[q * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
          dk[i][j] = fmaf(da[i], qb[j], dk[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= L) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t off = (size_t)key * 3 * C + h * DH + tx + 16 * j;
      db[off + C] = Num<T>::store(dk[i][j]);
      db[off + 2 * C] = Num<T>::store(dv[i][j]);
    }
  }
}

// grid (ceil(L/64), H, B); BLOCK: mask [B, L, L], else [B, L]
template <typename T, int DH, bool BLOCK>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dy,
    const T* __restrict__ attn, const float* __restrict__ stats,
    const int8_t* __restrict__ mask, const int* __restrict__ kend,
    T* __restrict__ dqkv, int L, int C, float mult) {
  constexpr int NJ = DH / 16;
  constexpr int LD = DH + 1, LDP = kTile + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* dss = dos + kTile * LD;     // [q][key], ds rounded to T
  float* mrow = dss + 2 * kTile * LDP;
  float* lrow = mrow + kTile;
  float* delta = lrow + kTile;
  int* kflag = (int*)(delta + kTile);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int H = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ke = kend[b];
  const int nq = min(kTile, L - q0);
  T* db = dqkv + (size_t)b * L * 3 * C;
  if (q0 >= ke) {  // dead q tile: no cotangent reaches q
    for (int e = tid; e < nq * DH; e += kThreads) {
      const int r = e / DH, d = e - r * DH;
      db[(size_t)(q0 + r) * 3 * C + h * DH + d] = Num<T>::store(0.0f);
    }
    return;
  }
  const T* qkvb = qkv + (size_t)b * L * 3 * C;
  const int8_t* mb = mask + (size_t)b * L * (BLOCK ? L : 1);
  load_q_side<T, DH>(qkvb, dy + (size_t)b * L * C, attn + (size_t)b * L * C,
                     stats + ((size_t)b * H + h) * L * 2, q0, L, C, h, qs,
                     dos, mrow, lrow, delta, tid);
  float dq[4][NJ];
  zero(dq);
  for (int k0 = 0; k0 < ke; k0 += kTile) {
    load_k_side<T, DH, BLOCK>(qkvb, mb, k0, L, C, h, ks, vs, kflag, tid);
    __syncthreads();
    // q row ty + 16i, key tx + 16j
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty + 16 * i) * LD + d];
        oa[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ks[(tx + 16 * j) * LD + d];
        vb[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = ty + 16 * i, key = tx + 16 * j;
        float p, ds;
        prob_and_ds(s[i][j], dp[i][j],
                    pair_flag<BLOCK>(kflag[key], mb, q0 + q, k0 + key, L),
                    q0 + q < L, mrow[q], lrow[q], delta[q], mult, p, ds);
        dss[q * LDP + key] = rnd<T>(ds);
      }
    __syncthreads();
#pragma unroll 8
    for (int key = 0; key < kTile; ++key) {
      float da[4], kb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dss[(ty + 16 * i) * LDP + key];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kb[j] = ks[key * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq[i][j] = fmaf(da[i], kb[j], dq[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= L) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      db[(size_t)q * 3 * C + h * DH + tx + 16 * j] = Num<T>::store(dq[i][j]);
  }
}

// grid (ceil(L/64), B); C = 16 * NJC. gpart [B * ceil(L/64), 2C].
template <typename T, int NJC>
__global__ void __launch_bounds__(kThreads) ln_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w,
    const int* __restrict__ kend, const T* __restrict__ dqkv,
    const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ ln_o,
    float* __restrict__ gpart, int L) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1, LDK = kKChunk + 1;
  extern __shared__ float smem[];
  float* lns = smem;                 // kTile x LDA
  float* As = lns + kTile * LDA;     // kTile x LDK: a slice of dq|dk|dv
  float* Bs = As + kTile * LDK;      // kKChunk x C: a slice of W^T
  float* stats = Bs + kKChunk * C;   // 4 x kTile
  const int b = blockIdx.y, r0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, L - r0);
  const size_t base = (size_t)b * L;
  float* gp = gpart + ((size_t)b * gridDim.x + blockIdx.x) * 2 * C;
  if (r0 >= kend[b]) {
    copy_rows<T>(dy + base * C, dx + base * C, r0, rows, C, tid);
    zero_rows<T>(ln_o + base * C, r0, rows, C, tid);
    for (int c = tid; c < 2 * C; c += kThreads) gp[c] = 0.0f;
    return;
  }
  ln_tile<T>(x + base * C, r0, L, C, gamma, beta, lns, LDA, tid, stats);
  for (int e = tid; e < rows * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    ln_o[(base + r0 + r) * C + c] = Num<T>::store(lns[r * LDA + c]);
  }
  // dln[r][c] = sum_n dqkv[r][n] w[c][n], n < 3C
  float dln[4][NJC];
  zero(dln);
  dln_tile<T, NJC>(dqkv + (base + r0) * 3 * C, 3 * C, 3 * C, rows, w, As, Bs,
                   dln, tx, ty, tid);
  stdln_backward_tile<T, NJC, true>(dln, x + base * C, dy + base * C,
                                    dx + base * C, r0, rows, gamma, stats,
                                    Bs, gp, tx, ty, tid);
}

template <typename T, int DH, bool BLOCK>
static cudaError_t launch_attn(const void* qkv, const void* dy,
                               const void* attn, const float* stats,
                               const int8_t* mask, const int* kend,
                               void* dqkv, int B, int L, int C, float mult,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * AttnBwdSmem<DH>::floats;
  const dim3 grid((L + kTile - 1) / kTile, C / DH, B);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, DH, BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<T, DH, BLOCK><<<grid, kThreads, smem, stream>>>(
      (const T*)qkv, (const T*)dy, (const T*)attn, stats, mask, kend,
      (T*)dqkv, L, C, mult);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, DH, BLOCK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dq_kernel<T, DH, BLOCK><<<grid, kThreads, smem, stream>>>(
      (const T*)qkv, (const T*)dy, (const T*)attn, stats, mask, kend,
      (T*)dqkv, L, C, mult);
  return cudaGetLastError();
}

template <typename T, int NJC>
static cudaError_t launch_ln(const void* x, const float* gamma,
                             const float* beta, const void* w,
                             const int* kend, const void* dqkv,
                             const void* dy, void* dx, void* ln_o,
                             float* gpart, int B, int L,
                             cudaStream_t stream) {
  constexpr int C = 16 * NJC;
  const size_t smem = sizeof(float) *
      (kTile * (C + 1) + kTile * (kKChunk + 1) + kKChunk * C + 4 * kTile);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel<T, NJC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, B);
  ln_bwd_kernel<T, NJC><<<grid, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, (const T*)w, kend, (const T*)dqkv,
      (const T*)dy, (T*)dx, (T*)ln_o, gpart, L);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_bwd(const void* x, const float* gamma,
                              const float* beta, const void* w,
                              const int8_t* mask, const int* kend,
                              const void* attn, const float* stats,
                              const void* dy, const void* qkv, void* dqkv,
                              void* ln_o, void* dx, float* gpart, int B,
                              int L, int C, int H, bool block, float mult,
                              cudaStream_t stream) {
  const int dh = C / H;
  cudaError_t err = cudaErrorInvalidValue;
#define MTP_DQKV(DH, BL) \
  err = launch_attn<T, DH, BL>(qkv, dy, attn, stats, mask, kend, dqkv, B, L, C, mult, stream)
  if (dh == 128 && block) MTP_DQKV(128, true);
  else if (dh == 128) MTP_DQKV(128, false);
  else if (dh == 64 && block) MTP_DQKV(64, true);
  else if (dh == 64) MTP_DQKV(64, false);
  else if (dh == 32 && block) MTP_DQKV(32, true);
  else if (dh == 32) MTP_DQKV(32, false);
#undef MTP_DQKV
  if (err != cudaSuccess) return err;
#define MTP_LN(CC) \
  if (C == CC) \
    return launch_ln<T, CC / 16>(x, gamma, beta, w, kend, dqkv, dy, dx, ln_o, gpart, B, L, stream);
  MTP_LN(64) MTP_LN(128) MTP_LN(256) MTP_LN(512)
#undef MTP_LN
  return cudaErrorInvalidValue;
}

// ---- the bf16 route on the tensor cores ----

// delta[b, h, q] = sum_d dy[b, q, h DH + d] attn[b, q, h DH + d] in fp32,
// for the rows of q tiles that start before kend[b] (others are left
// unwritten). grid (ceil(L/64), B), kThreads threads: a warp per row, 8
// columns (16 bytes) per lane.
template <int DH>
__global__ void __launch_bounds__(kThreads) block_delta_kernel(
    const bf16* __restrict__ dy, const bf16* __restrict__ attn,
    const int* __restrict__ kend, float* __restrict__ delta, int L, int C,
    int H) {
  const int b = blockIdx.y, r0 = blockIdx.x * kTile;
  if (r0 >= kend[b]) return;
  const size_t base = (size_t)b * L * C;
  delta_rows<DH, kThreads / 32>(dy + base, attn + base,
                                delta + (size_t)b * H * L, r0,
                                min(kTile, L - r0), L, C, threadIdx.x >> 5,
                                threadIdx.x & 31);
}

// dK and dV of head h for one 64-key tile (flash_tc.cuh's dK/dV loop at
// row stride 3C): dk, dv rounded to bf16 into dqkv[:, :, C:3C] (zeros for
// tiles that start past kend[b]). Mask: KeyMask ([B, L]) or BlockMask
// ([B, L, L]). grid (ceil(L/64), H, B), kTcThreads threads; warp w owns
// keys 16 w .. + 15.
template <int DH, class Mask>
__global__ void __launch_bounds__(kTcThreads, flash_min_blocks(DH, kFlashDkvBlocks))
    block_dkv_tc_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dy,
    const float* __restrict__ stats, const float* __restrict__ delta,
    const int8_t* __restrict__ mask, const int8_t* __restrict__ tmap,
    const int* __restrict__ kend, bf16* __restrict__ dqkv, int L, int C,
    float mult) {
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ke = kend[b], nk = min(kTile, L - k0), col0 = h * DH;
  const int N = 3 * C;
  bf16* db = dqkv + (size_t)b * L * N;
  if (k0 >= ke) {  // keys past the last valid one get no gradient
    for (int e = tid; e < nk * ND; e += kTcThreads) {
      const int r = e / ND, c = (e % ND) * 8;
      const size_t off = (size_t)(k0 + r) * N + col0 + c;
      *reinterpret_cast<uint4*>(db + off + C) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(db + off + 2 * C) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const bf16* qb = qkv + (size_t)b * L * N + col0;
  const size_t bh = (size_t)b * H + h;
  float dk[ND][4], dv[ND][4];
  flash_dkv_tile<DH, kSplitDs<Mask>>(
      dkv_smem, qb, N, qb + C, qb + 2 * C, N, dy + (size_t)b * L * C + col0,
      C, stats + bh * L * 2, delta + bh * L, k0, L, L, ke,
      Mask::at(mask, tmap, b, L, L), mult, dk, dv);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + 16 * warp + g + 8 * hh;
    if (key >= L) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t off = (size_t)key * N + col0 + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(db + off + C) =
          pack_bf16(dk[j][2 * hh], dk[j][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(db + off + 2 * C) =
          pack_bf16(dv[j][2 * hh], dv[j][2 * hh + 1]);
    }
  }
}

// dQ of head h for one 64-row q tile (flash_tc.cuh's dQ loop at row
// stride 3C), rounded to bf16 into dqkv[:, :, 0:C] (zeros for tiles that
// start past kend[b]). Mask: KeyMask ([B, L]) or BlockMask ([B, L, L]).
// grid (ceil(L/64), H, B), kTcThreads threads; warp w owns q rows
// 16 w .. + 15.
template <int DH, class Mask>
__global__ void __launch_bounds__(kTcThreads, flash_min_blocks(DH, kFlashDqBlocks))
    block_dq_tc_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dy,
    const float* __restrict__ stats, const float* __restrict__ delta,
    const int8_t* __restrict__ mask, const int8_t* __restrict__ tmap,
    const int* __restrict__ kend, bf16* __restrict__ dqkv, int L, int C,
    float mult) {
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ke = kend[b], nq = min(kTile, L - q0), col0 = h * DH;
  const int N = 3 * C;
  bf16* db = dqkv + (size_t)b * L * N;
  if (q0 >= ke) {  // dead q tile: no cotangent reaches q
    for (int e = tid; e < nq * ND; e += kTcThreads) {
      const int r = e / ND, c = (e % ND) * 8;
      *reinterpret_cast<uint4*>(db + (size_t)(q0 + r) * N + col0 + c) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const bf16* qb = qkv + (size_t)b * L * N + col0;
  const size_t bh = (size_t)b * H + h;
  float dq[ND][4];
  flash_dq_tile<DH, kSplitDs<Mask>>(
      dq_smem, qb, N, qb + C, qb + 2 * C, N, dy + (size_t)b * L * C + col0,
      C, stats + bh * L * 2, delta + bh * L, q0, L, L, ke,
      Mask::at(mask, tmap, b, L, L), mult, dq);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = q0 + 16 * warp + g + 8 * hh;
    if (q >= L) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(db + (size_t)q * N + col0 + 8 * j + 2 * t) =
          pack_bf16(dq[j][2 * hh], dq[j][2 * hh + 1]);
  }
}

// The projection backward of one 64-row tile on the tensor cores
// (proj_tc.cuh::proj_bwd_tile with the residual): StdLN recomputed (rows to
// ln_o for dW), dln = [dq|dk|dv] . W^T, the StdLN backward with the
// residual cotangent, dx = round(round(dx_ln) + dy), and the tile's
// dgamma | dbeta sums to gpart. 256 threads, two blocks an SM up to C =
// 256, one at 512 (proj_bwd_min_blocks). Dead tiles
// write dx = dy, zero ln_o rows and zero partials. grid (ceil(L/64), B);
// C = 16 * NJC.
template <int NJC>
__global__ void __launch_bounds__(kThreads, proj_bwd_min_blocks(16 * NJC))
    block_ln_bwd_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w,
    const int* __restrict__ kend, const bf16* __restrict__ dqkv,
    const bf16* __restrict__ dy, bf16* __restrict__ dx,
    bf16* __restrict__ ln_o, float* __restrict__ gpart, int L) {
  constexpr int C = 16 * NJC, N = 3 * C;
  static_assert((N / kLnBwdDepth) % kLnBwdStages == 0,
                "the last chunk runs in the ring's last stage");
  extern __shared__ __align__(16) unsigned char lnb_smem[];
  const int b = blockIdx.y, tile = blockIdx.x, r0 = tile * kTile;
  const int rows = min(kTile, L - r0);
  const size_t base = (size_t)b * L, row0 = base + r0;
  float* gp = gpart + ((size_t)b * gridDim.x + tile) * 2 * C;
  if (r0 >= kend[b]) {
    const int tid = threadIdx.x;
    copy_rows<bf16>(dy + base * C, dx + base * C, r0, rows, C, tid);
    zero_rows<bf16>(ln_o + base * C, r0, rows, C, tid);
    for (int c = tid; c < 2 * C; c += kThreads) gp[c] = 0.0f;
    return;
  }
  proj_bwd_tile<NJC, true, true>(
      lnb_smem, x + row0 * C, rows, gamma, beta, w, N,
      Packed<const bf16>{dqkv + row0 * N, N}, dy + row0 * C, dx + row0 * C,
      ln_o + row0 * C, gp);
}

template <int DH, class Mask>
static cudaError_t launch_attn_tc(const void* qkv, const void* dy,
                                  const void* attn, const float* stats,
                                  float* delta, const int8_t* mask,
                                  const int8_t* tmap, const int* kend,
                                  void* dqkv, int B, int L, int C, float mult,
                                  cudaStream_t stream) {
  const int tiles = (L + kTile - 1) / kTile;
  block_delta_kernel<DH><<<dim3(tiles, B), kThreads, 0, stream>>>(
      (const bf16*)dy, (const bf16*)attn, kend, delta, L, C, C / DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, C / DH, B);
  constexpr int smem_kv = dkv_tc_smem(DH), smem_q = dq_tc_smem(DH);
  err = cudaFuncSetAttribute(block_dkv_tc_kernel<DH, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  block_dkv_tc_kernel<DH, Mask><<<grid, kTcThreads, smem_kv, stream>>>(
      (const bf16*)qkv, (const bf16*)dy, stats, delta, mask, tmap, kend,
      (bf16*)dqkv, L, C, mult);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(block_dq_tc_kernel<DH, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  block_dq_tc_kernel<DH, Mask><<<grid, kTcThreads, smem_q, stream>>>(
      (const bf16*)qkv, (const bf16*)dy, stats, delta, mask, tmap, kend,
      (bf16*)dqkv, L, C, mult);
  return cudaGetLastError();
}

template <int NJC>
static cudaError_t launch_ln_tc(const void* x, const float* gamma,
                                const float* beta, const void* w,
                                const int* kend, const void* dqkv,
                                const void* dy, void* dx, void* ln_o,
                                float* gpart, int B, int L,
                                cudaStream_t stream) {
  constexpr int smem = ln_bwd_tc_smem(16 * NJC);
  cudaError_t err = cudaFuncSetAttribute(
      block_ln_bwd_tc_kernel<NJC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, B);
  block_ln_bwd_tc_kernel<NJC><<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, gamma, beta, (const bf16*)w, kend, (const bf16*)dqkv,
      (const bf16*)dy, (bf16*)dx, (bf16*)ln_o, gpart, L);
  return cudaGetLastError();
}

static cudaError_t launch_bwd_tc(const void* x, const float* gamma,
                                 const float* beta, const void* w,
                                 const int8_t* mask, const int8_t* tmap,
                                 const int* kend,
                                 const void* attn, const float* stats,
                                 const void* dy, const void* qkv,
                                 float* delta, void* dqkv, void* ln_o,
                                 void* dx, float* gpart, int B, int L, int C,
                                 int H, bool block, float mult,
                                 cudaStream_t stream) {
  const int dh = C / H;
  cudaError_t err = cudaErrorInvalidValue;
#define MTP_DQKV_TC(DH, MK) \
  err = launch_attn_tc<DH, MK>(qkv, dy, attn, stats, delta, mask, tmap, kend, dqkv, B, L, C, mult, stream)
  if (dh == 128 && block) MTP_DQKV_TC(128, BlockMask);
  else if (dh == 128) MTP_DQKV_TC(128, KeyMask);
  else if (dh == 64 && block) MTP_DQKV_TC(64, BlockMask);
  else if (dh == 64) MTP_DQKV_TC(64, KeyMask);
  else if (dh == 32 && block) MTP_DQKV_TC(32, BlockMask);
  else if (dh == 32) MTP_DQKV_TC(32, KeyMask);
#undef MTP_DQKV_TC
  if (err != cudaSuccess) return err;
#define MTP_LN_TC(CC) \
  if (C == CC) \
    return launch_ln_tc<CC / 16>(x, gamma, beta, w, kend, dqkv, dy, dx, ln_o, gpart, B, L, stream);
  MTP_LN_TC(64) MTP_LN_TC(128) MTP_LN_TC(256) MTP_LN_TC(512)
#undef MTP_LN_TC
  return cudaErrorInvalidValue;
}

}  // namespace mtp

// dtype: 0 = fp32 (the FMA kernels), 1 = bf16 (the tensor cores) for x,
// w [C, 3C], attn, dy, qkv, dqkv, ln_o and dx ([B, L, C] or [B, L, 3C]);
// gamma, beta and stats ([B, H, L, 2]) fp32; mask int8, [B, L] or, when
// block != 0, [B, L, L]; tmap: a block mask's tile map
// (attn_block_tile_map) for the tensor cores' loops, or NULL; kend int32
// [B] (L for every sample under a block mask); qkv from attn_block_qkv;
// delta: fp32 scratch [B, H, L] for bf16
// (unused for fp32, may be NULL). Writes dqkv, ln_o, dx and gpart fp32
// [B * ceil(L/64), 2C]. C in {64, 128, 256, 512}, C / H in {32, 64, 128}.
// Returns cudaGetLastError().
extern "C" int attn_block_bwd(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* mask, const void* tmap,
                              const void* kend,
                              const void* attn, const void* stats,
                              const void* dy, const void* qkv, void* delta,
                              void* dqkv, void* ln_o, void* dx, void* gpart,
                              int B, int L, int C, int H, int block,
                              float mult, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (H <= 0 || !model_width(C) || C % H != 0)
    return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* mk = (const int8_t*)mask;
  const int* ke = (const int*)kend;
  const float* st = (const float*)stats;
  float* gp = (float*)gpart;
  if (dtype == 0)
    return (int)launch_bwd<float>(x, g, be, w, mk, ke, attn, st, dy, qkv, dqkv, ln_o, dx, gp, B, L, C, H, block != 0, mult, s);
  if (dtype == 1 && delta != nullptr)
    return (int)launch_bwd_tc(x, g, be, w, mk, (const int8_t*)tmap, ke, attn, st, dy, qkv, (float*)delta, dqkv, ln_o, dx, gp, B, L, C, H, block != 0, mult, s);
  return (int)cudaErrorInvalidValue;
}
