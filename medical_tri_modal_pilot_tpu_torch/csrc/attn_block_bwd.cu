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
// forward is, with the per-sample state in device memory (read from L2):
//   attn_block_qkv (attn_block.cu): q|k|v of the live rows into [B, L, 3C];
//   dkv_kernel: one block per (sample, 64-key tile, head); it walks the
//     live q tiles and accumulates dk and dv in registers;
//   dq_kernel: one block per (sample, 64-row q tile, head); it walks the
//     live key tiles and accumulates dq. Two passes instead of float
//     atomics on dq keep the result deterministic;
//   ln_bwd_kernel: one block per (sample, 64-row tile): StdLN recomputed,
//     dln = [dq|dk|dv] . W^T, the StdLN backward, the residual cotangent
//     folded into dx, the tile's dgamma | dbeta sums, and the LN rows that
//     dW = LN^T [dq|dk|dv] needs.
// The probabilities come from the forward's saved (m, l) per row and head,
// p = exp(s - m) / l, and delta = rowsum(dO * O) from the saved
// pre-residual output O, as in the TPU kernel. Roundings follow it: p and
// ds are rounded to T before their products, dq, dk and dv to T before the
// projection backward, dx to T before the residual is added.
//
// Rows of q tiles that start past a sample's last valid key (kend) carry
// no cotangent in the model (they are masked keys everywhere downstream
// and the FFN passes them through): their dx is dy and they add nothing.
#include "common.cuh"

namespace mtp {

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
// 1 valid but masked, 2 past the array end.
template <typename T, int DH>
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
    kflag[j] = key >= L ? 2 : (mb[key] != 0 ? 1 : 0);
  }
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

// grid (ceil(L/64), H, B)
template <typename T, int DH>
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
  load_k_side<T, DH>(qkvb, mask + (size_t)b * L, k0, L, C, h, ks, vs, kflag,
                     tid);
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
        prob_and_ds(s[i][j], dp[i][j], kflag[key], q0 + q < L, mrow[q],
                    lrow[q], delta[q], mult, p, ds);
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

// grid (ceil(L/64), H, B)
template <typename T, int DH>
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
  const int8_t* mb = mask + (size_t)b * L;
  load_q_side<T, DH>(qkvb, dy + (size_t)b * L * C, attn + (size_t)b * L * C,
                     stats + ((size_t)b * H + h) * L * 2, q0, L, C, h, qs,
                     dos, mrow, lrow, delta, tid);
  float dq[4][NJ];
  zero(dq);
  for (int k0 = 0; k0 < ke; k0 += kTile) {
    load_k_side<T, DH>(qkvb, mb, k0, L, C, h, ks, vs, kflag, tid);
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
        prob_and_ds(s[i][j], dp[i][j], kflag[key], q0 + q < L, mrow[q],
                    lrow[q], delta[q], mult, p, ds);
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
  const T* g = dqkv + (base + r0) * 3 * C;
  for (int k0 = 0; k0 < 3 * C; k0 += kKChunk) {
    for (int e = tid; e < kTile * kKChunk; e += kThreads) {
      const int r = e / kKChunk, kk = e - r * kKChunk;
      As[r * LDK + kk] = r < rows
          ? Num<T>::load(g[(size_t)r * 3 * C + k0 + kk]) : 0.0f;
    }
    for (int e = tid; e < kKChunk * C; e += kThreads) {
      const int c = e / kKChunk, kk = e - c * kKChunk;
      Bs[kk * C + c] = Num<T>::load(w[(size_t)c * 3 * C + k0 + kk]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKChunk; ++kk) {
      float a[4], bb[NJC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * LDK + kk];
#pragma unroll
      for (int j = 0; j < NJC; ++j) bb[j] = Bs[kk * C + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJC; ++j) dln[i][j] = fmaf(a[i], bb[j], dln[i][j]);
    }
    __syncthreads();
  }
  stdln_backward_tile<T, NJC, true>(dln, x + base * C, dy + base * C,
                                    dx + base * C, r0, rows, gamma, stats,
                                    Bs, gp, tx, ty, tid);
}

template <typename T, int DH>
static cudaError_t launch_attn(const void* qkv, const void* dy,
                               const void* attn, const float* stats,
                               const int8_t* mask, const int* kend,
                               void* dqkv, int B, int L, int C, float mult,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * AttnBwdSmem<DH>::floats;
  const dim3 grid((L + kTile - 1) / kTile, C / DH, B);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      (const T*)qkv, (const T*)dy, (const T*)attn, stats, mask, kend,
      (T*)dqkv, L, C, mult);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dq_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
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
                              int L, int C, int H, float mult,
                              cudaStream_t stream) {
  const int dh = C / H;
  cudaError_t err = cudaErrorInvalidValue;
  if (dh == 64)
    err = launch_attn<T, 64>(qkv, dy, attn, stats, mask, kend, dqkv, B, L, C, mult, stream);
  else if (dh == 32)
    err = launch_attn<T, 32>(qkv, dy, attn, stats, mask, kend, dqkv, B, L, C, mult, stream);
  if (err != cudaSuccess) return err;
  if (C == 256)
    return launch_ln<T, 16>(x, gamma, beta, w, kend, dqkv, dy, dx, ln_o, gpart, B, L, stream);
  if (C == 64)
    return launch_ln<T, 4>(x, gamma, beta, w, kend, dqkv, dy, dx, ln_o, gpart, B, L, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mtp

// dtype: 0 = fp32, 1 = bf16 for x, w [C, 3C], attn, dy, qkv, dqkv, ln_o and
// dx ([B, L, C] or [B, L, 3C]); gamma, beta and stats ([B, H, L, 2]) fp32;
// mask int8 [B, L]; kend int32 [B]; qkv from attn_block_qkv. Writes dqkv,
// ln_o, dx and gpart fp32 [B * ceil(L/64), 2C]. C in {64, 256}, C / H in
// {32, 64}. Returns cudaGetLastError().
extern "C" int attn_block_bwd(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* mask, const void* kend,
                              const void* attn, const void* stats,
                              const void* dy, const void* qkv, void* dqkv,
                              void* ln_o, void* dx, void* gpart, int B,
                              int L, int C, int H, float mult, int dtype,
                              void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (H <= 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* mk = (const int8_t*)mask;
  const int* ke = (const int*)kend;
  const float* st = (const float*)stats;
  float* gp = (float*)gpart;
  if (dtype == 0)
    return (int)launch_bwd<float>(x, g, be, w, mk, ke, attn, st, dy, qkv, dqkv, ln_o, dx, gp, B, L, C, H, mult, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, g, be, w, mk, ke, attn, st, dy, qkv, dqkv, ln_o, dx, gp, B, L, C, H, mult, s);
  return (int)cudaErrorInvalidValue;
}
