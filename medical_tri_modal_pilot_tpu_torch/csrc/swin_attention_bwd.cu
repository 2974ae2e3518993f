// The backward of Swin window attention's core, per (window, head): from
// x.w_qkv (recomputed from the saved input by the wrapper; the kernel adds
// b_qkv as it stages q|k|v) and the heads' cotangent do, the scores and
// probabilities again, the heads' output o (the output projection's
// weight gradient needs it), dq, dk, dv and the relative-position bias's
// cotangent.
//
// Replaces medical_tri_modal_pilot_tpu/kernels/swin_attention.py::
// _fused_bwd, the custom VJP of the Pallas window attention, which takes
// jax.vjp of xla_window_attention (no pallas_call of its own). The four
// dense products around the core (q|k|v = x.w_qkv + b_qkv, do = dout.
// w_proj^T, and the projections' input and weight gradients) are plain
// matrix products, left to torch.matmul by the wrapper
// (kernels/swin_attention.py::_launch_bwd), as JAX leaves them to XLA.
//
// Per window and head, 49 tokens padded to 64, 32-wide heads:
//   S  = q k^T / scale + bias, shift-masked keys -65504   (fp32)
//   P  = softmax(S) in fp32;  Pc = P rounded to T
//   o  = Pc v                                     (rounded to T)
//   dP = do v^T                                   (rounded to T)
//   dS = P (dP - rowsum(dP P)), 0 at masked keys  (fp32)
//   dv = Pc^T do;  dq = (dS / scale) k;  dk = (dS / scale)^T q  (to T)
// rounded where autograd of the plain version (kernels/swin_attention.py
// torch_window_attention) rounds: the bf16 products' results, the fp32
// score and softmax gradients (q.float() @ k.float()^T), each gradient of
// a T tensor cast to T once.
//
// What bounds it on an H100: six products of 49 x 49 x 32 a window and
// head (11.3 GFLOP at Swin-T's stage 1, batch 64) against reading q|k|v
// and do and writing o and dq|dk|dv (308 MB in bf16 there): on the tensor
// cores the bytes (0.09 ms there), on the CUDA cores the operations (0.17
// ms). Two forms, picked by dtype:
//   window_attn_bwd_kernel (fp32, the checking dtype): every product as
//     fp32 FMAs from shared memory, a 16 x 16 thread grid over the padded
//     64 x 64 tile, as the forward's fma route (window_attn_kernel).
//   window_attn_bwd_tc_kernel (bf16): the products on the tensor cores
//     (mma.sync m16n8k16, fp32 accumulation), a warp per 16 query rows for
//     S, dP, o and dq (the forward's window_core layout: the
//     probabilities and dS / scale go from the accumulator fragments
//     straight into the A operands of o and dq), then, through shared
//     memory, a warp per 16 key rows for dv = Pc^T do and dk = (dS /
//     scale)^T q. dS / scale enters the tensor cores as two bf16 parts,
//     hi = bf16(x) and lo = bf16(x - hi), so dq and dk keep 16 of the
//     plain version's 24 fp32 bits before their rounding to bf16.
//
#include "swin_window.cuh"

namespace mtp {

namespace swin_bwd {
constexpr int LDQ = kHeadDim + 1;  // q, k, v, do tiles [64][33]
constexpr int LDP = kTile + 1;     // Pc and dS / scale tiles [64][65]
constexpr int kSmemFloats = 4 * kTile * LDQ + 2 * kTile * LDP;
}  // namespace swin_bwd

// The fp32 form. qkv [I, 49, 3C] (x.w_qkv without its bias), bqkv [3C]
// and dov [I, 49, C] (the heads' cotangent); q|k|v = qkv + bqkv; bias
// [nh, 49, 49] fp32; smask [M, 49, 49] int8 (1 = masked) or NULL, window i
// taking smask[i % M]. Writes heads [I, 49, C] (o) and dqkv [I, 49, 3C],
// and part [G, nh, 49 * 49] fp32 (block (g, h)'s sum of dS over its
// windows). grid (G, nh), kThreads threads, kSmemFloats floats of dynamic
// shared memory.
__global__ void __launch_bounds__(kThreads) window_attn_bwd_kernel(
    const float* __restrict__ qkv, const float* __restrict__ bqkv,
    const float* __restrict__ dov, const float* __restrict__ bias,
    const int8_t* __restrict__ smask, int M, float* __restrict__ heads,
    float* __restrict__ dqkv, float* __restrict__ part, int I, int C,
    float scale) {
  using namespace swin_bwd;
  extern __shared__ float swin_bwd_smem[];
  float* qs = swin_bwd_smem;       // [64][LDQ] each
  float* ks = qs + kTile * LDQ;
  float* vs = ks + kTile * LDQ;
  float* ds = vs + kTile * LDQ;    // do
  float* ps = ds + kTile * LDQ;    // [64][LDP]: Pc
  float* ss = ps + kTile * LDP;    // [64][LDP]: dS / scale
  const int G = gridDim.x, h = blockIdx.y, nh = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* bh = bias + (size_t)h * kWin * kWin;
  float bsum[4][4];
  zero(bsum);
  for (int win = blockIdx.x; win < I; win += G) {
    const float* base = qkv + (size_t)win * kWin * 3 * C + h * kHeadDim;
    const float* dbase = dov + (size_t)win * kWin * C + h * kHeadDim;
    for (int e = tid; e < kTile * kHeadDim; e += kThreads) {
      const int r = e / kHeadDim, d = e - r * kHeadDim;
      float q = 0.0f, k = 0.0f, v = 0.0f, o = 0.0f;
      if (r < kWin) {
        const float* row = base + (size_t)r * 3 * C + d;
        const float* bq = bqkv + h * kHeadDim + d;
        q = row[0] + bq[0];
        k = row[C] + bq[C];
        v = row[2 * C] + bq[2 * C];
        o = dbase[(size_t)r * C + d];
      }
      qs[r * LDQ + d] = q;
      ks[r * LDQ + d] = k;
      vs[r * LDQ + d] = v;
      ds[r * LDQ + d] = o;
    }
    __syncthreads();
    // S = q k^T and dP = do v^T, rows ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty + 16 * i) * LDQ + d];
        da[i] = ds[(ty + 16 * i) * LDQ + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ks[(tx + 16 * j) * LDQ + d];
        vb[j] = vs[(tx + 16 * j) * LDQ + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
    const int8_t* mw =
        smask == nullptr ? nullptr : smask + (size_t)(win % M) * kWin * kWin;
    // the softmax of each row (its 64 keys in the 16 threads that share
    // ty), then dS; padded query rows take P = 0 and add nothing
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool masked[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        masked[j] = r < kWin && c < kWin && mw != nullptr &&
                    mw[r * kWin + c] != 0;
        if (c >= kWin) {
          s[i][j] = -INFINITY;  // padded key: out of the softmax
        } else if (r >= kWin) {
          s[i][j] = 0.0f;       // padded query row: zeroed below
        } else {
          s[i][j] = masked[j] ? kMaskFill : s[i][j] / scale + bh[r * kWin + c];
        }
      }
      float m = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      m = half_warp_max(m);
      float l = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m);
        l += s[i][j];
      }
      l = half_warp_sum(l);
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = r < kWin ? s[i][j] / l : 0.0f;
        s[i][j] = p;
        dot = fmaf(dp[i][j], p, dot);
        ps[r * LDP + tx + 16 * j] = p;
      }
      dot = half_warp_sum(dot);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float g = masked[j] ? 0.0f : s[i][j] * (dp[i][j] - dot);
        bsum[i][j] += g;
        ss[r * LDP + tx + 16 * j] = g / scale;
      }
    }
    __syncthreads();
    // o = Pc v and dq = (dS / scale) k over the 49 keys: rows ty + 16 i,
    // head columns tx + 16 j
    float o[4][2], dq[4][2];
    zero(o);
    zero(dq);
#pragma unroll 7
    for (int c = 0; c < kWin; ++c) {
      float pa[4], sa[4], vb[2], kb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[(ty + 16 * i) * LDP + c];
        sa[i] = ss[(ty + 16 * i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        vb[j] = vs[c * LDQ + tx + 16 * j];
        kb[j] = ks[c * LDQ + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          o[i][j] = fmaf(pa[i], vb[j], o[i][j]);
          dq[i][j] = fmaf(sa[i], kb[j], dq[i][j]);
        }
    }
    // dv = Pc^T do and dk = (dS / scale)^T q over the 49 query rows: key
    // rows ty + 16 i, head columns tx + 16 j
    float dv[4][2], dk[4][2];
    zero(dv);
    zero(dk);
#pragma unroll 7
    for (int r = 0; r < kWin; ++r) {
      float pa[4], sa[4], db[2], qb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[r * LDP + ty + 16 * i];
        sa[i] = ss[r * LDP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        db[j] = ds[r * LDQ + tx + 16 * j];
        qb[j] = qs[r * LDQ + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dv[i][j] = fmaf(pa[i], db[j], dv[i][j]);
          dk[i][j] = fmaf(sa[i], qb[j], dk[i][j]);
        }
    }
    float* ob = heads + (size_t)win * kWin * C + h * kHeadDim;
    float* gb = dqkv + (size_t)win * kWin * 3 * C + h * kHeadDim;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= kWin) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = tx + 16 * j;
        ob[(size_t)r * C + d] = o[i][j];
        gb[(size_t)r * 3 * C + d] = dq[i][j];
        gb[(size_t)r * 3 * C + C + d] = dk[i][j];
        gb[(size_t)r * 3 * C + 2 * C + d] = dv[i][j];
      }
    }
    // every thread is done with this window's tiles before the next
    // window's loads
    __syncthreads();
  }
  float* pb = part + ((size_t)blockIdx.x * nh + h) * kWin * kWin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= kWin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < kWin) pb[r * kWin + c] = bsum[i][j];
    }
  }
}

// The bf16 form: grid (G, nh), kTcThreads threads (warp w: query rows
// 16 w .. + 16, then key rows 16 w .. + 16), TcBwd::kBytes of dynamic
// shared memory: q, k, v, do [64][40] bf16, Pc, hi and lo of dS / scale
// [64][72] bf16, the head's bias [49][49] fp32 and its q|k|v biases [3][32]
// fp32. Arguments as window_attn_bwd_kernel's.
namespace swin_bwd {
constexpr int kTcThreads = 128;
struct TcBwd {
  static constexpr int LDH = pitch(kHeadDim), LDS = pitch(kTile);
  static constexpr int HEAD = kTile * LDH, SQ = kTile * LDS;
  static constexpr int kBytes = (4 * HEAD + 3 * SQ) * (int)sizeof(bf16) +
                                (kWin * kWin + 3 * kHeadDim) * (int)sizeof(float);
};
}  // namespace swin_bwd

__global__ void __launch_bounds__(swin_bwd::kTcThreads) window_attn_bwd_tc_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bqkv,
    const bf16* __restrict__ dov, const float* __restrict__ bias,
    const int8_t* __restrict__ smask, int M, bf16* __restrict__ heads,
    bf16* __restrict__ dqkv, float* __restrict__ part, int I, int C,
    float scale) {
  using namespace swin_bwd;
  using L = TcBwd;
  extern __shared__ __align__(16) unsigned char swin_bwd_tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(swin_bwd_tc_smem);
  bf16* ks = qs + L::HEAD;
  bf16* vs = ks + L::HEAD;
  bf16* ds = vs + L::HEAD;    // do
  bf16* ps = ds + L::HEAD;    // Pc [query][key]
  bf16* hs = ps + L::SQ;      // hi of dS / scale
  bf16* ls = hs + L::SQ;      // lo of dS / scale
  float* bs = reinterpret_cast<float*>(ls + L::SQ);
  float* bq = bs + kWin * kWin;  // the head's q, k, v biases
  const int G = gridDim.x, h = blockIdx.y, nh = gridDim.y;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int e = tid; e < kWin * kWin; e += kTcThreads)
    bs[e] = bias[(size_t)h * kWin * kWin + e];
  for (int e = tid; e < 3 * kHeadDim; e += kTcThreads)
    bq[e] = bf(bqkv[(e / kHeadDim) * C + h * kHeadDim + e % kHeadDim]);
  float bsum[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) bsum[j][e] = 0.0f;
  for (int win = blockIdx.x; win < I; win += G) {
    const bf16* base = qkv + (size_t)win * kWin * 3 * C + h * kHeadDim;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      stage_rows<kHeadDim, kTcThreads>(qs + m * L::HEAD, L::LDH, base + m * C,
                                       3 * C, kTile, kWin, tid);
    stage_rows<kHeadDim, kTcThreads>(
        ds, L::LDH, dov + (size_t)win * kWin * C + h * kHeadDim, C, kTile,
        kWin, tid);
    cp_async_commit();
    cp_async_wait<0>();
    // the tiles have landed (and, at the first window, the biases)
    __syncthreads();
    // q|k|v = bf16(x.w_qkv + b_qkv), two columns at a time
    for (int e = tid; e < 3 * kWin * (kHeadDim / 2); e += kTcThreads) {
      const int m = e / (kWin * (kHeadDim / 2));
      const int rc = e - m * (kWin * (kHeadDim / 2));
      const int r = rc / (kHeadDim / 2), c = 2 * (rc - r * (kHeadDim / 2));
      uint32_t* p = reinterpret_cast<uint32_t*>(qs + m * L::HEAD +
                                                r * L::LDH + c);
      const uint32_t v = *p;
      *p = pack_bf16(__uint_as_float(v << 16) + bq[m * kHeadDim + c],
                     __uint_as_float(v & 0xffff0000u) +
                         bq[m * kHeadDim + c + 1]);
    }
    __syncthreads();
    // S = q k^T and dP = do v^T for the warp's 16 query rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, frag_a(qs, L::LDH, 16 * w, kk, lane));
      ldsm_x4(ad, frag_a(ds, L::LDH, 16 * w, kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, frag_b_nk(ks, L::LDH, 16 * np, kk, lane));
        mma16816(s[2 * np], aq, b[0], b[1]);
        mma16816(s[2 * np + 1], aq, b[2], b[3]);
        ldsm_x4(b, frag_b_nk(vs, L::LDH, 16 * np, kk, lane));
        mma16816(dp[2 * np], ad, b[0], b[1]);
        mma16816(dp[2 * np + 1], ad, b[2], b[3]);
      }
    }
    // scores, the softmax of rows g and g + 8 (each row's 64 keys in the
    // four lanes that share g), dP rounded to bf16, dS. As the forward's
    // window_core: the shift mask's bits (shifted by the lane's column
    // offset once), products by 1 / scale and by the row sum's
    // reciprocal, __expf: fp32 units against the plain version's
    // divisions and expf.
    uint64_t m0, m1;
    mask_bits(smask == nullptr ? nullptr
                               : smask + (size_t)(win % M) * kWin * kWin,
              w, lane, m0, m1);
    m0 >>= 2 * t;
    m1 >>= 2 * t;
    const float inv_scale = 1.0f / scale;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * w + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
        float v;
        if (c >= kWin) {
          v = -INFINITY;  // padded key: out of the softmax
        } else if (r >= kWin) {
          v = 0.0f;       // padded query row: zeroed below
        } else {
          const uint64_t m = (e >> 1) ? m1 : m0;
          v = ((m >> (8 * j + (e & 1))) & 1)
              ? kMaskFill : s[j][e] * inv_scale + bs[r * kWin + c];
        }
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - mx[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    float dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      // padded query rows take P = 0
      l[hh] = 16 * w + g + 8 * hh < kWin ? 1.0f / l[hh] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= l[e >> 1];
        dp[j][e] = rnd<bf16>(dp[j][e]);
        dot[e >> 1] = fmaf(dp[j][e], s[j][e], dot[e >> 1]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 1);
      dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 2);
    }
    // Pc into shared memory, dS into the bias sums, dS / scale (in dp's
    // place) as hi and lo into shared memory; a masked key's dS is 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * w + g + 8 * hh, c = 8 * j + 2 * t;
        const uint64_t m = hh ? m1 : m0;
        float hi[2], lo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * hh + e;
          const float gd = ((m >> (8 * j + e)) & 1)
              ? 0.0f : s[j][k] * (dp[j][k] - dot[hh]);
          bsum[j][k] += gd;
          dp[j][k] = gd * inv_scale;
          hi[e] = rnd<bf16>(dp[j][k]);
          lo[e] = dp[j][k] - hi[e];
        }
        *reinterpret_cast<uint32_t*>(ps + r * L::LDS + c) =
            pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(hs + r * L::LDS + c) =
            pack_bf16(hi[0], hi[1]);
        *reinterpret_cast<uint32_t*>(ls + r * L::LDS + c) =
            pack_bf16(lo[0], lo[1]);
      }
    // o = Pc v and dq = (dS / scale) k, the A operands from the fragments
    float o[4][4], dq[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = dq[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ap[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 2 * kk + (q >> 1), e = 2 * (q & 1);
        ah[q] = pack_bf16(dp[j][e], dp[j][e + 1]);
        al[q] = pack_bf16(dp[j][e] - rnd<bf16>(dp[j][e]),
                          dp[j][e + 1] - rnd<bf16>(dp[j][e + 1]));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, frag_b_kn(vs, L::LDH, 16 * kk, 16 * np, lane));
        mma16816(o[2 * np], ap, b[0], b[1]);
        mma16816(o[2 * np + 1], ap, b[2], b[3]);
        ldsm_x4_t(b, frag_b_kn(ks, L::LDH, 16 * kk, 16 * np, lane));
        mma16816(dq[2 * np], ah, b[0], b[1]);
        mma16816(dq[2 * np + 1], ah, b[2], b[3]);
        mma16816(dq[2 * np], al, b[0], b[1]);
        mma16816(dq[2 * np + 1], al, b[2], b[3]);
      }
    }
    bf16* ob = heads + (size_t)win * kWin * C + h * kHeadDim;
    bf16* gb = dqkv + (size_t)win * kWin * 3 * C + h * kHeadDim;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * w + g + 8 * hh, c = 8 * j + 2 * t;
        if (r >= kWin) continue;
        *reinterpret_cast<uint32_t*>(ob + (size_t)r * C + c) =
            pack_bf16(o[j][2 * hh], o[j][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(gb + (size_t)r * 3 * C + c) =
            pack_bf16(dq[j][2 * hh], dq[j][2 * hh + 1]);
      }
    // every warp's rows of Pc and dS / scale are in shared memory
    __syncthreads();
    // dv = Pc^T do and dk = (dS / scale)^T q for the warp's 16 key rows
    float dv[4][4], dk[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[j][e] = dk[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      uint32_t ap[4], ah[4], al[4];
      ldsm_x4_t(ap, frag_a_t(ps, L::LDS, kk, 16 * w, lane));
      ldsm_x4_t(ah, frag_a_t(hs, L::LDS, kk, 16 * w, lane));
      ldsm_x4_t(al, frag_a_t(ls, L::LDS, kk, 16 * w, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, frag_b_kn(ds, L::LDH, kk, 16 * np, lane));
        mma16816(dv[2 * np], ap, b[0], b[1]);
        mma16816(dv[2 * np + 1], ap, b[2], b[3]);
        ldsm_x4_t(b, frag_b_kn(qs, L::LDH, kk, 16 * np, lane));
        mma16816(dk[2 * np], ah, b[0], b[1]);
        mma16816(dk[2 * np + 1], ah, b[2], b[3]);
        mma16816(dk[2 * np], al, b[0], b[1]);
        mma16816(dk[2 * np + 1], al, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * w + g + 8 * hh, c = 8 * j + 2 * t;
        if (r >= kWin) continue;
        *reinterpret_cast<uint32_t*>(gb + (size_t)r * 3 * C + C + c) =
            pack_bf16(dk[j][2 * hh], dk[j][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(gb + (size_t)r * 3 * C + 2 * C + c) =
            pack_bf16(dv[j][2 * hh], dv[j][2 * hh + 1]);
      }
    // every warp is done with this window's tiles before the next
    // window's loads
    __syncthreads();
  }
  float* pb = part + ((size_t)blockIdx.x * nh + h) * kWin * kWin;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      if (r < kWin && c < kWin) pb[r * kWin + c] = bsum[j][e];
    }
}

static cudaError_t launch_window_bwd_tc(const void* qkv, const void* bqkv,
                                        const void* dov, const float* bias,
                                        const int8_t* smask, int M,
                                        void* heads, void* dqkv, float* part,
                                        int I, int C, int G, float scale,
                                        cudaStream_t stream) {
  constexpr int bytes = swin_bwd::TcBwd::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  window_attn_bwd_tc_kernel<<<dim3(G, C / kHeadDim),
                              swin_bwd::kTcThreads, bytes, stream>>>(
      (const bf16*)qkv, (const bf16*)bqkv, (const bf16*)dov, bias, smask, M,
      (bf16*)heads, (bf16*)dqkv, part, I, C, scale);
  return cudaGetLastError();
}

static cudaError_t launch_window_bwd(const void* qkv, const void* bqkv,
                                     const void* dov, const float* bias,
                                     const int8_t* smask, int M, void* heads,
                                     void* dqkv, float* part, int I, int C,
                                     int G, float scale,
                                     cudaStream_t stream) {
  constexpr int bytes = swin_bwd::kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  window_attn_bwd_kernel<<<dim3(G, C / kHeadDim), kThreads, bytes,
                           stream>>>(
      (const float*)qkv, (const float*)bqkv, (const float*)dov, bias, smask,
      M, (float*)heads, (float*)dqkv, part, I, C, scale);
  return cudaGetLastError();
}

}  // namespace mtp

// The window core's backward: qkv [I, 49, 3C] (x.w_qkv of every token,
// without its bias), bqkv [3C] and dov [I, 49, C] (the cotangent of the
// heads' output, do = dout.w_proj^T) in the dtype (0 = fp32, 1 = bf16);
// bias [C/32, 49, 49] fp32;
// smask int8 [M, 49, 49] with M dividing I, or NULL. Writes heads
// [I, 49, C] (o) and dqkv [I, 49, 3C] in the dtype and part fp32
// [G, C/32, 49 * 49], the sums of dS over windows g, g + G, ... (G <= I).
// C % 32 == 0; scale = sqrt(32). Returns cudaGetLastError().
extern "C" int swin_attention_bwd(const void* qkv, const void* bqkv,
                                  const void* dov, const void* bias,
                                  const void* smask,
                                  void* heads, void* dqkv, void* part, int I,
                                  int C, int M, int G, float scale,
                                  int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bi = (const float*)bias;
  const int8_t* sm = (const int8_t*)smask;
  if (I <= 0 || C <= 0 || C % kHeadDim != 0 || G <= 0 || G > I ||
      (sm != nullptr && (M <= 0 || I % M != 0)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_window_bwd(qkv, bqkv, dov, bi, sm, M, heads, dqkv,
                                  (float*)part, I, C, G, scale, s);
  if (dtype == 1)
    return (int)launch_window_bwd_tc(qkv, bqkv, dov, bi, sm, M, heads, dqkv,
                                     (float*)part, I, C, G, scale, s);
  return (int)cudaErrorInvalidValue;
}
