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
// Masks (mode): 0 none; 1 a key mask [B, Lk] (1 byte per key, nonzero =
// masked: a bool or int8 tensor read as it is), not assumed to be
// tail-contiguous; 2 a block mask [B, Lq, Lk]. A masked score is replaced
// by -65504, so a query whose keys are all masked attends uniformly over
// the Lk keys; keys past Lk (tile padding) are left out of the softmax.
// With a key mask the key loop stops at the tile that holds the sample's
// last valid key, which each block finds itself by scanning the mask row
// (flash_tc.cuh::scan_key_end; Lk when every key is masked): masked keys
// past it would take exp(-65504 - m) = 0. is_self (key mask, Lq == Lk, q
// and k from one stream): q tiles that start at or past that key are dead
// rows; they are written as zeros with stats m = 0, l = 1, and the
// backward skips them.
//
// What bounds it on an H100: at the cross-modal layers' shapes ([64, 24]
// x [64, 128] keys and back, 4 heads of 64) the two products are about
// 0.2 GFLOP against about 10 MB of q, k, v, out and mask, so the bound is
// the bytes (about 3 us) and a launch costs as much; at the
// tensor-parallel self shape ([64, 1024], 2 heads of 64, the TIE key mask)
// about 20 us, also the bytes. Two routes, picked by dtype
// (kernels/attention.py::attention_route):
//
//   tc (bf16), on the tensor cores through the flash loops that the
//   attention block's kernels also run (flash_tc.cuh, at row stride
//   H * DH here, 3C there):
//     attention_fwd_tc_kernel: one block per (64-row q tile, head,
//       sample), 4 warps of 16 q rows; q staged once, 64-key k and v tiles
//       in a two-stage cp.async ring; S by mma.sync, the online softmax in
//       fp32 on the fragments, P rounded to bf16 into P V; the mask as
//       64-bit rows per 64-key tile by ballot (a key mask one row per
//       sample, a block mask one per query row); the output rounded once.
//       A warp whose rows all lie past Lq (Lq = 24: two of four) does no
//       products.
//     attention_delta_kernel: delta = rowsum(dO * O) per row and head;
//     attention_dkv_tc_kernel: one block per (64-key tile, head, sample)
//       walking the live q tiles; attention_dq_tc_kernel: one block per
//       (q tile, head, sample) walking the key tiles. No atomics: the
//       backward repeats bit for bit.
//   fma (fp32, the checking dtype): one block per (64-row q tile, head,
//     sample), 64-key tiles staged through shared memory as fp32, pair
//     flags per (query, key), fp32 FMAs on 4 x 4 register tiles, exact to
//     the fp32 oracle; the backward in the same two passes
//     (attention_dkv_kernel, attention_dq_kernel), delta recomputed per
//     q tile.
// Both take p = exp(s - m) / l in the backward from the saved (m, l), not
// from a log-sum-exp: for an all-masked row s and m are both -65504 and
// m + log l would lose the difference in fp32. Roundings follow the TPU
// kernel: p and ds are rounded to bf16 before their products, outputs
// once.
#include "flash_tc.cuh"

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
template <int DH, int LD>
static __device__ __forceinline__ void load_head_rows(
    const float* __restrict__ src, int r0, int L, int C, int h, float* dst,
    int tid) {
  for (int e = tid; e < kTile * DH; e += kThreads) {
    const int r = e / DH, d = e - r * DH;
    dst[r * LD + d] = r0 + r < L ? src[(size_t)(r0 + r) * C + h * DH + d]
                                 : 0.0f;
  }
}

// rows [r0, r0 + rows) of head h of a [*, H * DH] array set to zero
template <int DH>
static __device__ __forceinline__ void zero_head_rows(
    float* __restrict__ dst, int r0, int rows, int C, int h, int tid) {
  for (int e = tid; e < rows * DH; e += kThreads) {
    const int r = e / DH, d = e - r * DH;
    dst[(size_t)(r0 + r) * C + h * DH + d] = 0.0f;
  }
}

// the last key bound of sample b: one past its last unmasked key (Lk
// when every key is masked) for a key mask, else Lk; each warp scans
static __device__ __forceinline__ int key_end(const int8_t* __restrict__ mask,
                                              int mode, int b, int Lk,
                                              int tid) {
  return mode == kMaskKeys ? scan_key_end(mask + (size_t)b * Lk, Lk, tid & 31)
                           : Lk;
}

// grid (ceil(Lq/64), H, B). TRAIN: also stats [B, H, Lq, 2] fp32, the row
// max m and the sum l of exp(s - m) floored at 1e-30.
template <int DH, bool TRAIN>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int8_t* __restrict__ mask,
    float* __restrict__ out,
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
  const int ke = key_end(mask, mode, b, Lk, tid);
  const int rows = min(kTile, Lq - q0);
  float* ob = out + (size_t)b * Lq * C;
  float* st = TRAIN ? stats + ((size_t)b * H + h) * Lq * 2 : nullptr;
  if (is_self && q0 >= ke) {  // dead q tile of a self-attention
    zero_head_rows<DH>(ob, q0, rows, C, h, tid);
    if (TRAIN)
      for (int r = tid; r < rows; r += kThreads) {
        st[(size_t)(q0 + r) * 2] = 0.0f;
        st[(size_t)(q0 + r) * 2 + 1] = 1.0f;
      }
    return;
  }
  load_head_rows<DH, LD>(q + (size_t)b * Lq * C, q0, Lq, C, h, qs, tid);
  const float* kb = k + (size_t)b * Lk * C;
  const float* vb = v + (size_t)b * Lk * C;
  float m[4], l[4], o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  zero(o);
  for (int k0 = 0; k0 < ke; k0 += kTile) {
    load_head_rows<DH, LD>(kb, k0, Lk, C, h, ks, tid);
    load_head_rows<DH, DH>(vb, k0, Lk, C, h, vs, tid);
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
      ob[(size_t)(q0 + row) * C + h * DH + tx + 16 * j] = o[i][j] * inv_l;
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
template <int DH>
static __device__ __forceinline__ void load_q_rows(
    const float* __restrict__ qb, const float* __restrict__ dob,
    const float* __restrict__ ob, const float* __restrict__ stb, int q0,
    int Lq, int C, int h, float* qs, float* dos, float* mrow, float* lrow,
    float* delta, int tid) {
  constexpr int LD = DH + 1;
  load_head_rows<DH, LD>(qb, q0, Lq, C, h, qs, tid);
  load_head_rows<DH, LD>(dob, q0, Lq, C, h, dos, tid);
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int q = q0 + r;
    float s = 0.0f;
    if (q < Lq)
      for (int d = lane; d < DH; d += 32) {
        const size_t off = (size_t)q * C + h * DH + d;
        s += dob[off] * ob[off];
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
template <int DH>
__global__ void __launch_bounds__(kThreads) attention_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ out,
    const float* __restrict__ stats, const float* __restrict__ dout,
    const int8_t* __restrict__ mask, float* __restrict__ dk,
    float* __restrict__ dv, int Lq, int Lk, int mode, int is_self,
    float mult) {
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
  const int ke = key_end(mask, mode, b, Lk, tid);
  const int qe = is_self ? ke : Lq;
  const int nk = min(kTile, Lk - k0);
  float* dkb = dk + (size_t)b * Lk * C;
  float* dvb = dv + (size_t)b * Lk * C;
  if (k0 >= ke) {  // keys past the last valid one get no gradient
    zero_head_rows<DH>(dkb, k0, nk, C, h, tid);
    zero_head_rows<DH>(dvb, k0, nk, C, h, tid);
    return;
  }
  const size_t qoff = (size_t)b * Lq * C;
  const float* stb = stats + ((size_t)b * H + h) * Lq * 2;
  load_head_rows<DH, LD>(k + (size_t)b * Lk * C, k0, Lk, C, h, ks, tid);
  load_head_rows<DH, LD>(v + (size_t)b * Lk * C, k0, Lk, C, h, vs, tid);
  float dka[4][NJ], dva[4][NJ];
  zero(dka);
  zero(dva);
  for (int q0 = 0; q0 < qe; q0 += kTile) {
    load_q_rows<DH>(q + qoff, dout + qoff, out + qoff, stb, q0, Lq, C, h,
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
        ps[key * LDP + r] = p;
        dss[key * LDP + r] = ds;
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
      dkb[off] = dka[i][j];
      dvb[off] = dva[i][j];
    }
  }
}

// grid (ceil(Lq/64), H, B)
template <int DH>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ out,
    const float* __restrict__ stats, const float* __restrict__ dout,
    const int8_t* __restrict__ mask, float* __restrict__ dq, int Lq, int Lk,
    int mode, int is_self, float mult) {
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
  const int ke = key_end(mask, mode, b, Lk, tid);
  const int nq = min(kTile, Lq - q0);
  const size_t qoff = (size_t)b * Lq * C;
  if (is_self && q0 >= ke) {  // dead q tile: no cotangent reaches q
    zero_head_rows<DH>(dq + qoff, q0, nq, C, h, tid);
    return;
  }
  load_q_rows<DH>(q + qoff, dout + qoff, out + qoff,
                     stats + ((size_t)b * H + h) * Lq * 2, q0, Lq, C, h, qs,
                     dos, mrow, lrow, delta, tid);
  const float* kb = k + (size_t)b * Lk * C;
  const float* vb = v + (size_t)b * Lk * C;
  float dqa[4][NJ];
  zero(dqa);
  for (int k0 = 0; k0 < ke; k0 += kTile) {
    load_head_rows<DH, LD>(kb, k0, Lk, C, h, ks, tid);
    load_head_rows<DH, LD>(vb, k0, Lk, C, h, vs, tid);
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
        dss[r * LDP + key] = ds;
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
  float* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqb[(size_t)r * C + h * DH + tx + 16 * j] = dqa[i][j];
  }
}

template <int DH>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                              const int8_t* mask, void* out, float* stats,
                              int B, int Lq, int Lk, int H, int mode,
                              int is_self, float mult, cudaStream_t stream) {
  constexpr int LD = DH + 1;
  const size_t smem =
      sizeof(float) * (2 * kTile * LD + kTile * DH + kTile * (kTile + 1)) +
      kTile * kTile;
  const dim3 grid((Lq + kTile - 1) / kTile, H, B);
  cudaError_t err;
  if (stats != nullptr) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<DH, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attention_fwd_kernel<DH, true><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, mask,
        (float*)out, stats, Lq, Lk, mode, is_self, mult);
  } else {
    err = cudaFuncSetAttribute(attention_fwd_kernel<DH, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attention_fwd_kernel<DH, false><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, mask,
        (float*)out, nullptr, Lq, Lk, mode, is_self, mult);
  }
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                              const void* out, const float* stats,
                              const void* dout, const int8_t* mask, void* dq,
                              void* dk, void* dv, int B, int Lq, int Lk,
                              int H, int mode, int is_self, float mult,
                              cudaStream_t stream) {
  const size_t smem = AttentionBwdSmem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 gk((Lk + kTile - 1) / kTile, H, B);
  attention_dkv_kernel<DH><<<gk, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)out,
      stats, (const float*)dout, mask, (float*)dk, (float*)dv, Lq, Lk, mode,
      is_self, mult);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_dq_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 gq((Lq + kTile - 1) / kTile, H, B);
  attention_dq_kernel<DH><<<gq, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)out,
      stats, (const float*)dout, mask, (float*)dq, Lq, Lk, mode, is_self,
      mult);
  return cudaGetLastError();
}

// ---- the bf16 route on the tensor cores ----

// out = softmax(mask(q k^T * mult)) v for head h of one 64-row q tile
// (flash_tc.cuh's forward loop at row stride H * DH), rounded once to
// bf16. TRAIN: also stats [B, H, Lq, 2] (the row max m of the scaled
// scores, l of exp(s - m) floored at 1e-30). Under is_self, q tiles that
// start at or past the sample's last valid key are zeros with m = 0,
// l = 1. grid (ceil(Lq/64), H, B), kTcThreads threads.
template <int DH, class Mask, bool TRAIN>
__global__ void __launch_bounds__(kTcThreads, flash_min_blocks(DH, kFlashFwdBlocks))
    attention_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int8_t* __restrict__ mask,
    bf16* __restrict__ out, float* __restrict__ stats, int Lq, int Lk,
    int is_self, float mult) {
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int H = gridDim.y, C = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Mask mk = Mask::at(mask, nullptr, b, Lq, Lk);
  const int ke = mk.key_end(lane), rows = min(kTile, Lq - q0);
  const size_t col = (size_t)h * DH;
  bf16* ob = out + ((size_t)b * Lq + q0) * C + col;
  float* st = TRAIN ? stats + (((size_t)b * H + h) * Lq + q0) * 2 : nullptr;
  if (is_self && q0 >= ke) {  // dead q tile of a self-attention
    for (int e = tid; e < rows * ND; e += kTcThreads) {
      const int r = e / ND, c = (e % ND) * 8;
      *reinterpret_cast<uint4*>(ob + (size_t)r * C + c) =
          make_uint4(0, 0, 0, 0);
    }
    if (TRAIN)
      for (int r = tid; r < rows; r += kTcThreads)
        *reinterpret_cast<float2*>(st + 2 * r) = make_float2(0.0f, 1.0f);
    return;
  }
  const bf16* qb = q + (size_t)b * Lq * C + col;
  const bf16* kb = k + (size_t)b * Lk * C + col;
  const bf16* vb = v + (size_t)b * Lk * C + col;
  if (q0 + 16 * warp >= Lq) {  // the warp's rows all lie past Lq
    flash_fwd_idle<DH>(fwd_smem, qb, C, kb, vb, C, q0, Lq, Lk, ke, mk);
    return;
  }
  float o[ND][4], m[2], l[2];
  flash_fwd_tile<DH>(fwd_smem, qb, C, kb, vb, C, q0, Lq, Lk, ke, mk, mult, o,
                     m, l);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    if (r >= rows) continue;
    const float l_safe = fmaxf(l[hh], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r * C + 8 * j + 2 * t) =
          pack_bf16(o[j][2 * hh] / l_safe, o[j][2 * hh + 1] / l_safe);
    if (TRAIN && t == 0)
      *reinterpret_cast<float2*>(st + 2 * r) = make_float2(m[hh], l_safe);
  }
}

// delta[b, h, q] = sum_d dO[b, q, h, d] O[b, q, h, d] in fp32, the
// backward's pre-pass, for every row, or under is_self for the rows of q
// tiles that start before the sample's last valid key (the others are
// left unwritten and never read). grid (ceil(Lq/64), B), kThreads threads.
template <int DH>
__global__ void __launch_bounds__(kThreads) attention_delta_kernel(
    const bf16* __restrict__ dout, const bf16* __restrict__ out,
    const int8_t* __restrict__ mask, float* __restrict__ delta, int Lq,
    int C, int is_self) {
  const int b = blockIdx.y, r0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (is_self && r0 >= scan_key_end(mask + (size_t)b * Lq, Lq, lane))
    return;
  const size_t base = (size_t)b * Lq * C;
  delta_rows<DH, kThreads / 32>(dout + base, out + base,
                                delta + (size_t)b * (C / DH) * Lq, r0,
                                min(kTile, Lq - r0), Lq, C, warp, lane);
}

// dK and dV of head h for one 64-key tile (flash_tc.cuh's dK/dV loop at
// row stride H * DH), rounded to bf16; zeros for a tile that starts past
// the sample's last valid key. grid (ceil(Lk/64), H, B), kTcThreads
// threads; warp w owns keys 16 w .. + 15.
template <int DH, class Mask>
__global__ void __launch_bounds__(kTcThreads, flash_min_blocks(DH, kFlashDkvBlocks))
    attention_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ stats, const float* __restrict__ delta,
    const int8_t* __restrict__ mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Lq, int Lk, int is_self, float mult) {
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int H = gridDim.y, C = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Mask mk = Mask::at(mask, nullptr, b, Lq, Lk);
  const int ke = mk.key_end(lane), nk = min(kTile, Lk - k0);
  const size_t col = (size_t)h * DH;
  bf16* dkb = dk + ((size_t)b * Lk + k0) * C + col;
  bf16* dvb = dv + ((size_t)b * Lk + k0) * C + col;
  if (k0 >= ke) {  // keys past the last valid one get no gradient
    for (int e = tid; e < nk * ND; e += kTcThreads) {
      const int r = e / ND, c = (e % ND) * 8;
      *reinterpret_cast<uint4*>(dkb + (size_t)r * C + c) =
          make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dvb + (size_t)r * C + c) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const size_t bh = (size_t)b * H + h, qoff = (size_t)b * Lq * C + col;
  const size_t koff = (size_t)b * Lk * C + col;
  float dka[ND][4], dva[ND][4];
  flash_dkv_tile<DH, false>(dkv_smem, q + qoff, C, k + koff, v + koff, C,
                            dout + qoff, C, stats + bh * Lq * 2,
                            delta + bh * Lq, k0, Lq, Lk, is_self ? ke : Lq,
                            mk, mult, dka, dva);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    if (r >= nk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t off = (size_t)r * C + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dkb + off) =
          pack_bf16(dka[j][2 * hh], dka[j][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dvb + off) =
          pack_bf16(dva[j][2 * hh], dva[j][2 * hh + 1]);
    }
  }
}

// dQ of head h for one 64-row q tile (flash_tc.cuh's dQ loop at row
// stride H * DH), rounded to bf16; zeros for a dead q tile of a
// self-attention. grid (ceil(Lq/64), H, B), kTcThreads threads; warp w
// owns q rows 16 w .. + 15.
template <int DH, class Mask>
__global__ void __launch_bounds__(kTcThreads, flash_min_blocks(DH, kFlashDqBlocks))
    attention_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ stats, const float* __restrict__ delta,
    const int8_t* __restrict__ mask, bf16* __restrict__ dq, int Lq, int Lk,
    int is_self, float mult) {
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int H = gridDim.y, C = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Mask mk = Mask::at(mask, nullptr, b, Lq, Lk);
  const int ke = mk.key_end(lane), nq = min(kTile, Lq - q0);
  const size_t col = (size_t)h * DH;
  bf16* dqb = dq + ((size_t)b * Lq + q0) * C + col;
  if (is_self && q0 >= ke) {  // dead q tile: no cotangent reaches q
    for (int e = tid; e < nq * ND; e += kTcThreads) {
      const int r = e / ND, c = (e % ND) * 8;
      *reinterpret_cast<uint4*>(dqb + (size_t)r * C + c) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const size_t bh = (size_t)b * H + h, qoff = (size_t)b * Lq * C + col;
  const size_t koff = (size_t)b * Lk * C + col;
  float dqa[ND][4];
  flash_dq_tile<DH, false>(dq_smem, q + qoff, C, k + koff, v + koff, C,
                           dout + qoff, C, stats + bh * Lq * 2,
                           delta + bh * Lq, q0, Lq, Lk, ke, mk, mult, dqa);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r * C + 8 * j + 2 * t) =
          pack_bf16(dqa[j][2 * hh], dqa[j][2 * hh + 1]);
  }
}

template <int DH, class Mask>
static cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                                 const int8_t* mask, void* out, float* stats,
                                 int B, int Lq, int Lk, int H, int is_self,
                                 float mult, cudaStream_t stream) {
  constexpr int smem = attn_tc_smem(DH);
  const dim3 grid((Lq + kTile - 1) / kTile, H, B);
  cudaError_t err;
  if (stats != nullptr) {
    err = cudaFuncSetAttribute(attention_fwd_tc_kernel<DH, Mask, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    attention_fwd_tc_kernel<DH, Mask, true>
        <<<grid, kTcThreads, smem, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, mask,
            (bf16*)out, stats, Lq, Lk, is_self, mult);
  } else {
    err = cudaFuncSetAttribute(attention_fwd_tc_kernel<DH, Mask, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    attention_fwd_tc_kernel<DH, Mask, false>
        <<<grid, kTcThreads, smem, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, mask,
            (bf16*)out, nullptr, Lq, Lk, is_self, mult);
  }
  return cudaGetLastError();
}

template <int DH, class Mask>
static cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                                 const void* out, const float* stats,
                                 const void* dout, const int8_t* mask,
                                 float* delta, void* dq, void* dk, void* dv,
                                 int B, int Lq, int Lk, int H, int is_self,
                                 float mult, cudaStream_t stream) {
  const int tq = (Lq + kTile - 1) / kTile, tk = (Lk + kTile - 1) / kTile;
  attention_delta_kernel<DH><<<dim3(tq, B), kThreads, 0, stream>>>(
      (const bf16*)dout, (const bf16*)out, mask, delta, Lq, H * DH,
      is_self);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem_kv = dkv_tc_smem(DH), smem_q = dq_tc_smem(DH);
  err = cudaFuncSetAttribute(attention_dkv_tc_kernel<DH, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  attention_dkv_tc_kernel<DH, Mask>
      <<<dim3(tk, H, B), kTcThreads, smem_kv, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          stats, delta, mask, (bf16*)dk, (bf16*)dv, Lq, Lk, is_self, mult);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_dq_tc_kernel<DH, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  attention_dq_tc_kernel<DH, Mask>
      <<<dim3(tq, H, B), kTcThreads, smem_q, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          stats, delta, mask, (bf16*)dq, Lq, Lk, is_self, mult);
  return cudaGetLastError();
}

}  // namespace mtp

// dtype: 0 = fp32 (the FMA kernels), 1 = bf16 (the tensor cores) for q
// [B, Lq, H, dh], k and v [B, Lk, H, dh] and out [B, Lq, H, dh] (bf16:
// 16-byte aligned); mask one byte per entry, nonzero = masked ([B, Lk]
// for mode 1, [B, Lq, Lk] for mode 2, unused for mode 0); stats fp32
// [B, H, Lq, 2] written when not NULL (the training form). dh in {32, 64,
// 128}; mult = 1 / scale. Returns cudaGetLastError().
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* stats, int B,
                             int Lq, int Lk, int H, int dh, int mode,
                             int is_self, float mult, int dtype,
                             void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  is_self = is_self && mode == kMaskKeys && Lq == Lk;
  const int8_t* mk = (const int8_t*)mask;
  float* st = (float*)stats;
#define MTP_FWD(DH) \
  return (int)launch_fwd<DH>(q, k, v, mk, out, st, B, Lq, Lk, H, mode, is_self, mult, s)
#define MTP_FWD_TC(DH, M) \
  return (int)launch_fwd_tc<DH, M>(q, k, v, mk, out, st, B, Lq, Lk, H, is_self, mult, s)
#define MTP_FWD_TC_MODES(DH)                          \
  {                                                   \
    if (mode == 0) MTP_FWD_TC(DH, NoMask);            \
    if (mode == kMaskKeys) MTP_FWD_TC(DH, KeyMask);   \
    MTP_FWD_TC(DH, BlockMask);                        \
  }
  if (dtype == 0 && dh == 128) MTP_FWD(128);
  if (dtype == 0 && dh == 64) MTP_FWD(64);
  if (dtype == 0 && dh == 32) MTP_FWD(32);
  if (dtype == 1 && dh == 128) MTP_FWD_TC_MODES(128)
  if (dtype == 1 && dh == 64) MTP_FWD_TC_MODES(64)
  if (dtype == 1 && dh == 32) MTP_FWD_TC_MODES(32)
#undef MTP_FWD
#undef MTP_FWD_TC
#undef MTP_FWD_TC_MODES
  return (int)cudaErrorInvalidValue;
}

// The backward: dq [B, Lq, H, dh], dk and dv [B, Lk, H, dh] in the dtype,
// from q, k, v, the forward's out and stats, and dout (the cotangent of
// out); delta: an fp32 scratch [B, H, Lq] for bf16 (unused for fp32, may
// be NULL); the other arguments as attention_fwd's. Returns
// cudaGetLastError().
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* stats,
                             const void* dout, const void* mask, void* delta,
                             void* dq, void* dk, void* dv, int B, int Lq,
                             int Lk, int H, int dh, int mode, int is_self,
                             float mult, int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  is_self = is_self && mode == kMaskKeys && Lq == Lk;
  const int8_t* mk = (const int8_t*)mask;
  const float* st = (const float*)stats;
  float* dl = (float*)delta;
#define MTP_BWD(DH) \
  return (int)launch_bwd<DH>(q, k, v, out, st, dout, mk, dq, dk, dv, B, Lq, Lk, H, mode, is_self, mult, s)
#define MTP_BWD_TC(DH, M) \
  return (int)launch_bwd_tc<DH, M>(q, k, v, out, st, dout, mk, dl, dq, dk, dv, B, Lq, Lk, H, is_self, mult, s)
#define MTP_BWD_TC_MODES(DH)                          \
  {                                                   \
    if (mode == 0) MTP_BWD_TC(DH, NoMask);            \
    if (mode == kMaskKeys) MTP_BWD_TC(DH, KeyMask);   \
    MTP_BWD_TC(DH, BlockMask);                        \
  }
  if (dtype == 0 && dh == 128) MTP_BWD(128);
  if (dtype == 0 && dh == 64) MTP_BWD(64);
  if (dtype == 0 && dh == 32) MTP_BWD(32);
  if (dtype == 1 && dl == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && dh == 128) MTP_BWD_TC_MODES(128)
  if (dtype == 1 && dh == 64) MTP_BWD_TC_MODES(64)
  if (dtype == 1 && dh == 32) MTP_BWD_TC_MODES(32)
#undef MTP_BWD
#undef MTP_BWD_TC
#undef MTP_BWD_TC_MODES
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of a tensor-core kernel at head width dh (0 the
// forward, 1 dK/dV, 2 dQ), as the launchers ask for them:
// kernels/attention.py::tc_smem_bytes mirrors this.
extern "C" int attention_tc_smem(int kernel, int dh) {
  using namespace mtp;
  switch (kernel) {
    case 0: return attn_tc_smem(dh);
    case 1: return dkv_tc_smem(dh);
    case 2: return dq_tc_smem(dh);
  }
  return -1;
}

// Blocks an SM that a tensor-core kernel's launch bounds ask for at head
// width dh (kernels as attention_tc_smem's): kernels/attention.py::
// tc_min_blocks mirrors this.
extern "C" int attention_tc_min_blocks(int kernel, int dh) {
  using namespace mtp;
  switch (kernel) {
    case 0: return flash_min_blocks(dh, kFlashFwdBlocks);
    case 1: return flash_min_blocks(dh, kFlashDkvBlocks);
    case 2: return flash_min_blocks(dh, kFlashDqBlocks);
  }
  return -1;
}
