// Masked multi-head attention over projected q, k, v (no projections, no
// residual): out = softmax(mask(q k^T / scale)) v per head, the lean form
// (eval), the training form, which also writes the per-row, per-head
// softmax stats (m, l), and the backward (dq, dk, dv).
//
// Replaces medical_tri_modal_pilot_tpu/kernels/attention.py::_fwd (body
// _fwd_kernel, lean and training forms) and ::_bwd (body _bwd_kernel),
// reached through pallas_masked_attention and its custom VJP.
//
// Layout: q [B, Lq, H, DH], k and v [B, Lk, H, DH], all row-major, that is
// the packed [B, L, H * DH] of the projections; a block reads its head's
// DH columns in place, so no head transpose is ever made.
//
// Masks (mode): 0 none; 1 a key mask [B, Lk] int8 (1 = masked), not
// assumed to be tail-contiguous; 2 a block mask [B, Lq, Lk] int8. A masked
// score is replaced by -65504, so a query whose keys are all masked
// attends uniformly over the Lk keys; keys past Lk (tile padding) are left
// out of the softmax. With a key mask the key loop stops at the tile that
// holds the sample's last valid key (kend[b], Lk when every key is
// masked): masked keys past it would take exp(-65504 - m) = 0. is_self
// (key mask, Lq == Lk, q and k from one stream): q tiles that start at or
// past kend[b] are dead rows; they are written as zeros with stats m = 0,
// l = 1, and the backward skips them.
//
// What bounds it on an H100: at the shapes of the cross-modal layers
// ([64, 24] x [64, 128] keys and back, 4 heads of 64) the two products are
// about 0.2 GFLOP against about 10 MB of q, k, v, out and mask, so the
// bound is the bytes (about 3 us) and a launch costs as much. The design
// is the simple one: one block per (64-row q tile, head, sample), 64-key
// tiles staged through shared memory, an fp32 online softmax, fp32 FMAs
// on 4 x 4 register tiles (tensor cores are later work). The backward is
// two passes without atomics, as attn_block_bwd.cu: attention_dkv_kernel
// per (64-key tile, head, sample) walks the live q tiles with dk and dv in
// registers; attention_dq_kernel per (q tile, head, sample) walks the key
// tiles. p = exp(s - m) / l from the saved (m, l), not from a log-sum-exp:
// for an all-masked row s and m are both -65504 and m + log l would lose
// the difference in fp32. Roundings follow the TPU kernel: p and ds are
// rounded to T before their products; outputs are rounded once to T.
#include "common.cuh"

namespace mtp {

constexpr int kMaskKeys = 1, kMaskBlock = 2;  // mode 0: no mask
// pair flags: 0 live, 1 valid but masked, 2 key past the array end
constexpr uint8_t kLive = 0, kMasked = 1, kPad = 2;

// The flags of the (q row, key) pairs of the tile at (q0, k0), fl[q][key]
// (kTile x kTile bytes). Rows past Lq take kMasked (never stored).
static __device__ __forceinline__ void load_pair_flags(
    const int8_t* __restrict__ mask, int mode, int b, int q0, int k0,
    int Lq, int Lk, uint8_t* fl, int tid) {
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, j = e - r * kTile;
    const int q = q0 + r, key = k0 + j;
    uint8_t f = kLive;
    if (key >= Lk) {
      f = kPad;
    } else if (mode == kMaskKeys) {
      f = mask[(size_t)b * Lk + key] != 0 ? kMasked : kLive;
    } else if (mode == kMaskBlock) {
      f = q >= Lq || mask[((size_t)b * Lq + q) * Lk + key] != 0 ? kMasked
                                                                 : kLive;
    }
    fl[e] = f;
  }
}

// rows [r0, r0 + kTile) of head h of a [B, L, H * DH] array into
// dst[kTile][LD] fp32, zero past L
template <typename T, int DH, int LD>
static __device__ __forceinline__ void load_head_rows(
    const T* __restrict__ src, int r0, int L, int C, int h, float* dst,
    int tid) {
  for (int e = tid; e < kTile * DH; e += kThreads) {
    const int r = e / DH, d = e - r * DH;
    dst[r * LD + d] = r0 + r < L
        ? Num<T>::load(src[(size_t)(r0 + r) * C + h * DH + d]) : 0.0f;
  }
}

// rows [r0, r0 + rows) of head h of a [*, H * DH] array set to zero
template <typename T, int DH>
static __device__ __forceinline__ void zero_head_rows(
    T* __restrict__ dst, int r0, int rows, int C, int h, int tid) {
  for (int e = tid; e < rows * DH; e += kThreads) {
    const int r = e / DH, d = e - r * DH;
    dst[(size_t)(r0 + r) * C + h * DH + d] = Num<T>::store(0.0f);
  }
}

// the last key bound of sample b: kend[b] for a key mask, else Lk
static __device__ __forceinline__ int key_end(const int* __restrict__ kend,
                                              int mode, int b, int Lk) {
  return mode == kMaskKeys ? kend[b] : Lk;
}

// grid (ceil(Lq/64), H, B). TRAIN: also stats [B, H, Lq, 2] fp32, the row
// max m and the sum l of exp(s - m) floored at 1e-30.
template <typename T, int DH, bool TRAIN>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int8_t* __restrict__ mask,
    const int* __restrict__ kend, T* __restrict__ out,
    float* __restrict__ stats, int Lq, int Lk, int mode, int is_self,
    float mult) {
  constexpr int NJ = DH / 16;
  constexpr int LD = DH + 1, LDP = kTile + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // kTile x LD
  float* ks = qs + kTile * LD;      // kTile x LD
  float* vs = ks + kTile * LD;      // kTile x DH
  float* ps = vs + kTile * DH;      // kTile x LDP: probabilities
  uint8_t* fl = (uint8_t*)(ps + kTile * LDP);  // kTile x kTile pair flags
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int H = gridDim.y, C = H * DH;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ke = key_end(kend, mode, b, Lk);
  const int rows = min(kTile, Lq - q0);
  T* ob = out + (size_t)b * Lq * C;
  float* st = TRAIN ? stats + ((size_t)b * H + h) * Lq * 2 : nullptr;
  if (is_self && q0 >= ke) {  // dead q tile of a self-attention
    zero_head_rows<T, DH>(ob, q0, rows, C, h, tid);
    if (TRAIN)
      for (int r = tid; r < rows; r += kThreads) {
        st[(size_t)(q0 + r) * 2] = 0.0f;
        st[(size_t)(q0 + r) * 2 + 1] = 1.0f;
      }
    return;
  }
  load_head_rows<T, DH, LD>(q + (size_t)b * Lq * C, q0, Lq, C, h, qs, tid);
  const T* kb = k + (size_t)b * Lk * C;
  const T* vb = v + (size_t)b * Lk * C;
  float m[4], l[4], o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  zero(o);
  for (int k0 = 0; k0 < ke; k0 += kTile) {
    load_head_rows<T, DH, LD>(kb, k0, Lk, C, h, ks, tid);
    load_head_rows<T, DH, DH>(vb, k0, Lk, C, h, vs, tid);
    load_pair_flags(mask, mode, b, q0, k0, Lq, Lk, fl, tid);
    __syncthreads();  // q (first tile), the k/v tile and its flags in place
    float s[4][4];
    zero(s);
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t f = fl[(ty + 16 * i) * kTile + tx + 16 * j];
        s[i][j] = f == kPad ? -INFINITY
                            : (f == kMasked ? kMaskFill : s[i][j] * mult);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
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
    for (int key = 0; key < kTile; ++key) {
      float pa[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * LDP + key];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[key * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(pa[i], vv[j], o[i][j]);
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
    for (int j = 0; j < NJ; ++j)
      ob[(size_t)(q0 + row) * C + h * DH + tx + 16 * j] =
          Num<T>::store(o[i][j] * inv_l);
    if (TRAIN && tx == 0) {
      st[(size_t)(q0 + row) * 2] = m[i];
      st[(size_t)(q0 + row) * 2 + 1] = l_safe;
    }
  }
}

template <int DH>
struct AttentionBwdSmem {
  static constexpr int LD = DH + 1;
  static constexpr int LDP = kTile + 1;
  // k, v, q, dO tiles; p and ds tiles; m, l, delta per row; pair flags
  static constexpr size_t bytes =
      sizeof(float) * (4 * kTile * LD + 2 * kTile * LDP + 3 * kTile) +
      kTile * kTile;
};

// The q side of a tile pair: q and dO rows [q0, q0 + 64) of head h, their
// stats and delta = rowsum(dO * O). Rows past Lq are zero with l = 1.
template <typename T, int DH>
static __device__ __forceinline__ void load_q_rows(
    const T* __restrict__ qb, const T* __restrict__ dob,
    const T* __restrict__ ob, const float* __restrict__ stb, int q0, int Lq,
    int C, int h, float* qs, float* dos, float* mrow, float* lrow,
    float* delta, int tid) {
  constexpr int LD = DH + 1;
  load_head_rows<T, DH, LD>(qb, q0, Lq, C, h, qs, tid);
  load_head_rows<T, DH, LD>(dob, q0, Lq, C, h, dos, tid);
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int q = q0 + r;
    float s = 0.0f;
    if (q < Lq)
      for (int d = lane; d < DH; d += 32) {
        const size_t off = (size_t)q * C + h * DH + d;
        s += Num<T>::load(dob[off]) * Num<T>::load(ob[off]);
      }
    s = warp_sum(s);
    if (lane == 0) {
      delta[r] = s;
      mrow[r] = q < Lq ? stb[(size_t)q * 2] : 0.0f;
      lrow[r] = q < Lq ? stb[(size_t)q * 2 + 1] : 1.0f;
    }
  }
}

// p and ds of one (q row, key) pair (attention.py:350-360): a masked pair
// keeps its probability (which dv takes) and has a zero score gradient
static __device__ __forceinline__ void pair_prob_and_ds(
    float s, float dp, uint8_t flag, bool qvalid, float m, float l,
    float delta, float mult, float& p, float& ds) {
  p = 0.0f;
  ds = 0.0f;
  if (flag == kPad || !qvalid) return;
  const float sc = flag == kMasked ? kMaskFill : s * mult;
  p = expf(sc - m) / l;
  if (flag == kLive) ds = p * (dp - delta) * mult;
}

// grid (ceil(Lk/64), H, B)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) attention_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ out,
    const float* __restrict__ stats, const T* __restrict__ dout,
    const int8_t* __restrict__ mask, const int* __restrict__ kend,
    T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk, int mode,
    int is_self, float mult) {
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
  uint8_t* fl = (uint8_t*)(delta + kTile);  // [q][key]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int H = gridDim.y, C = H * DH;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ke = key_end(kend, mode, b, Lk);
  const int qe = is_self ? ke : Lq;
  const int nk = min(kTile, Lk - k0);
  T* dkb = dk + (size_t)b * Lk * C;
  T* dvb = dv + (size_t)b * Lk * C;
  if (k0 >= ke) {  // keys past the last valid one get no gradient
    zero_head_rows<T, DH>(dkb, k0, nk, C, h, tid);
    zero_head_rows<T, DH>(dvb, k0, nk, C, h, tid);
    return;
  }
  const size_t qoff = (size_t)b * Lq * C;
  const float* stb = stats + ((size_t)b * H + h) * Lq * 2;
  load_head_rows<T, DH, LD>(k + (size_t)b * Lk * C, k0, Lk, C, h, ks, tid);
  load_head_rows<T, DH, LD>(v + (size_t)b * Lk * C, k0, Lk, C, h, vs, tid);
  float dka[4][NJ], dva[4][NJ];
  zero(dka);
  zero(dva);
  for (int q0 = 0; q0 < qe; q0 += kTile) {
    load_q_rows<T, DH>(q + qoff, dout + qoff, out + qoff, stb, q0, Lq, C, h,
                       qs, dos, mrow, lrow, delta, tid);
    load_pair_flags(mask, mode, b, q0, k0, Lq, Lk, fl, tid);
    __syncthreads();
    // transposed scores: key ty + 16i, q row tx + 16j
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float ka[4], va[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = ks[(ty + 16 * i) * LD + d];
        va[i] = vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * LD + d];
        dov[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(va[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = ty + 16 * i, r = tx + 16 * j;
        float p, ds;
        pair_prob_and_ds(s[i][j], dp[i][j], fl[r * kTile + key],
                         q0 + r < Lq, mrow[r], lrow[r], delta[r], mult, p,
                         ds);
        ps[key * LDP + r] = rnd<T>(p);
        dss[key * LDP + r] = rnd<T>(ds);
      }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      float pa[4], da[4], dov[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[(ty + 16 * i) * LDP + r];
        da[i] = dss[(ty + 16 * i) * LDP + r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dov[j] = dos[r * LD + tx + 16 * j];
        qv[j] = qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dva[i][j] = fmaf(pa[i], dov[j], dva[i][j]);
          dka[i][j] = fmaf(da[i], qv[j], dka[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Lk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t off = (size_t)key * C + h * DH + tx + 16 * j;
      dkb[off] = Num<T>::store(dka[i][j]);
      dvb[off] = Num<T>::store(dva[i][j]);
    }
  }
}

// grid (ceil(Lq/64), H, B)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ out,
    const float* __restrict__ stats, const T* __restrict__ dout,
    const int8_t* __restrict__ mask, const int* __restrict__ kend,
    T* __restrict__ dq, int Lq, int Lk, int mode, int is_self, float mult) {
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
  uint8_t* fl = (uint8_t*)(delta + kTile);  // [q][key]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int H = gridDim.y, C = H * DH;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ke = key_end(kend, mode, b, Lk);
  const int nq = min(kTile, Lq - q0);
  const size_t qoff = (size_t)b * Lq * C;
  if (is_self && q0 >= ke) {  // dead q tile: no cotangent reaches q
    zero_head_rows<T, DH>(dq + qoff, q0, nq, C, h, tid);
    return;
  }
  load_q_rows<T, DH>(q + qoff, dout + qoff, out + qoff,
                     stats + ((size_t)b * H + h) * Lq * 2, q0, Lq, C, h, qs,
                     dos, mrow, lrow, delta, tid);
  const T* kb = k + (size_t)b * Lk * C;
  const T* vb = v + (size_t)b * Lk * C;
  float dqa[4][NJ];
  zero(dqa);
  for (int k0 = 0; k0 < ke; k0 += kTile) {
    load_head_rows<T, DH, LD>(kb, k0, Lk, C, h, ks, tid);
    load_head_rows<T, DH, LD>(vb, k0, Lk, C, h, vs, tid);
    load_pair_flags(mask, mode, b, q0, k0, Lq, Lk, fl, tid);
    __syncthreads();
    // q row ty + 16i, key tx + 16j
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], oa[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty + 16 * i) * LD + d];
        oa[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, key = tx + 16 * j;
        float p, ds;
        pair_prob_and_ds(s[i][j], dp[i][j], fl[r * kTile + key], q0 + r < Lq,
                         mrow[r], lrow[r], delta[r], mult, p, ds);
        dss[r * LDP + key] = rnd<T>(ds);
      }
    __syncthreads();
#pragma unroll 8
    for (int key = 0; key < kTile; ++key) {
      float da[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dss[(ty + 16 * i) * LDP + key];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = ks[key * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dqa[i][j] = fmaf(da[i], kk[j], dqa[i][j]);
    }
    __syncthreads();
  }
  T* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqb[(size_t)r * C + h * DH + tx + 16 * j] = Num<T>::store(dqa[i][j]);
  }
}

template <typename T, int DH>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                              const int8_t* mask, const int* kend, void* out,
                              float* stats, int B, int Lq, int Lk, int H,
                              int mode, int is_self, float mult,
                              cudaStream_t stream) {
  constexpr int LD = DH + 1;
  const size_t smem =
      sizeof(float) * (2 * kTile * LD + kTile * DH + kTile * (kTile + 1)) +
      kTile * kTile;
  const dim3 grid((Lq + kTile - 1) / kTile, H, B);
  cudaError_t err;
  if (stats != nullptr) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<T, DH, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attention_fwd_kernel<T, DH, true><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, mask, kend, (T*)out, stats,
        Lq, Lk, mode, is_self, mult);
  } else {
    err = cudaFuncSetAttribute(attention_fwd_kernel<T, DH, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attention_fwd_kernel<T, DH, false><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, mask, kend, (T*)out, nullptr,
        Lq, Lk, mode, is_self, mult);
  }
  return cudaGetLastError();
}

template <typename T, int DH>
static cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                              const void* out, const float* stats,
                              const void* dout, const int8_t* mask,
                              const int* kend, void* dq, void* dk, void* dv,
                              int B, int Lq, int Lk, int H, int mode,
                              int is_self, float mult, cudaStream_t stream) {
  const size_t smem = AttentionBwdSmem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_dkv_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 gk((Lk + kTile - 1) / kTile, H, B);
  attention_dkv_kernel<T, DH><<<gk, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, stats,
      (const T*)dout, mask, kend, (T*)dk, (T*)dv, Lq, Lk, mode, is_self,
      mult);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 gq((Lq + kTile - 1) / kTile, H, B);
  attention_dq_kernel<T, DH><<<gq, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, stats,
      (const T*)dout, mask, kend, (T*)dq, Lq, Lk, mode, is_self, mult);
  return cudaGetLastError();
}

}  // namespace mtp

// dtype: 0 = fp32, 1 = bf16 for q [B, Lq, H, dh], k and v [B, Lk, H, dh]
// and out [B, Lq, H, dh]; mask int8 ([B, Lk] for mode 1, [B, Lq, Lk] for
// mode 2, unused for mode 0); kend int32 [B] (mode 1 only); stats fp32
// [B, H, Lq, 2] written when not NULL (the training form). dh in {32, 64};
// mult = 1 / scale. Returns cudaGetLastError().
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, const void* kend, void* out,
                             void* stats, int B, int Lq, int Lk, int H,
                             int dh, int mode, int is_self, float mult,
                             int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  is_self = is_self && mode == kMaskKeys && Lq == Lk;
  const int8_t* mk = (const int8_t*)mask;
  const int* ke = (const int*)kend;
  float* st = (float*)stats;
#define MTP_FWD(T, DH) \
  return (int)launch_fwd<T, DH>(q, k, v, mk, ke, out, st, B, Lq, Lk, H, mode, is_self, mult, s)
  if (dtype == 0 && dh == 64) MTP_FWD(float, 64);
  if (dtype == 0 && dh == 32) MTP_FWD(float, 32);
  if (dtype == 1 && dh == 64) MTP_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && dh == 32) MTP_FWD(__nv_bfloat16, 32);
#undef MTP_FWD
  return (int)cudaErrorInvalidValue;
}

// The backward: dq [B, Lq, H, dh], dk and dv [B, Lk, H, dh] in the dtype,
// from q, k, v, the forward's out and stats, and dout (the cotangent of
// out); the other arguments as attention_fwd's. Returns
// cudaGetLastError().
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* stats,
                             const void* dout, const void* mask,
                             const void* kend, void* dq, void* dk, void* dv,
                             int B, int Lq, int Lk, int H, int dh, int mode,
                             int is_self, float mult, int dtype,
                             void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  is_self = is_self && mode == kMaskKeys && Lq == Lk;
  const int8_t* mk = (const int8_t*)mask;
  const int* ke = (const int*)kend;
  const float* st = (const float*)stats;
#define MTP_BWD(T, DH) \
  return (int)launch_bwd<T, DH>(q, k, v, out, st, dout, mk, ke, dq, dk, dv, B, Lq, Lk, H, mode, is_self, mult, s)
  if (dtype == 0 && dh == 64) MTP_BWD(float, 64);
  if (dtype == 0 && dh == 32) MTP_BWD(float, 32);
  if (dtype == 1 && dh == 64) MTP_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && dh == 32) MTP_BWD(__nv_bfloat16, 32);
#undef MTP_BWD
  return (int)cudaErrorInvalidValue;
}
