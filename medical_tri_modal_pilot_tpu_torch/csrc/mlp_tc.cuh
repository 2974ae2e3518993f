// The LN -> MLP -> residual tile loop of the bf16 routes on the tensor
// cores, shared by the FFN forward (ffn.cu::ffn_fwd_tc_kernel: StdLN,
// ReLU and Philox dropout) and the Swin MLP (swin_mlp.cu::
// swin_mlp_tc_kernel: LayerNorm, exact GELU), plus the pieces the FFN
// backward's tile pass (ffn.cu::ffn_bwd_tc_kernel) shares with them: the
// chunk ring's stage, the dropout arithmetic.
//
//   y = x + out(W2 . hid(W1 . norm(x) + b1) + b2)
//
// A block owns 128 rows. It stages them by cp.async, normalises them in
// fp32, a warp per row, and leaves them in shared memory as bf16, rounded
// where each plain version rounds: the A operand of the first product.
// Then it walks the hidden width in 64-column chunks whose W1 [C][64] and
// W2 [64][C] slices stream through a two-stage cp.async ring (one stage
// loads while the other is read). Per chunk, on mma.sync.m16n8k16 with
// fp32 accumulation:
//   h = norm . W1c                        (ldmatrix A and B from the ring)
//   hid(h) on the accumulator fragments   (bias, activation, dropout)
//   acc += h . W2c                        (A straight from h's fragments)
// The C fragments of two neighbouring n8 tiles are the A fragment of a
// k16 step (mma.cuh), so the hidden layer never leaves registers: no trip
// through shared or device memory. During the last chunk the free stage
// takes the tile's x again; out() then works on acc's fragments against
// it in shared memory (b2, dropout, the residual, one rounding), and the
// tile leaves in 16-byte rows.
//
// Warps: 8, one per 16-row slab, each computing all 64 hidden columns of
// its slab's chunk and all C output columns: a thread holds 16 x C / 32
// fp32 of acc (C / 2: 128 registers at C = 256), which bounds the fused
// loop to C <= 256. 128-row tiles read each weight chunk from L2 once per
// 128 rows; 64-row tiles (two warps a slab, each with half of a chunk's
// hidden columns, their partial acc summed at the end) measured slower
// on an H100 (PERF.md). What is not the products' time was arranged by
// clock64() timers per phase: the norm runs while the first chunk lands;
// the next chunk's b1 and keep bits (Philox) are drawn among the current
// chunk's second product; the epilogue reads x from shared memory.
//
// Providers are template parameters: the normalisation (StdLN: Bessel
// variance, eps on the std, kernels/ffn.py::ln_f32; LayerNorm: biased
// variance, eps 1e-5 on it), the hidden epilogue (ReluDropout, GeluErf)
// and the output epilogue (FfnOut, ResidualOut). Each epilogue works on
// one n8 tile's fragment of a lane (rows g and g + 8, columns 2t and
// 2t + 1, g = lane >> 2, t = lane & 3) and is called by every lane of a
// warp at once: the dropout trades keep bits between lanes by shuffle.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace mtp {

constexpr int kMlpThreads = 256;  // 8 warps
constexpr int kFch = 64;          // hidden columns per chunk

// The FFN's dropout: keep an element when its Philox word is below thr;
// kept values are divided by q (q_t: rounded to the compute dtype, the
// forward's divisor; q_f: fp32, the backward's).
struct Dropout {
  uint2 key;      // the seed's low and high words
  uint32_t thr;   // keep when the draw is below floor(q * 2^32)
  float q_t;      // q rounded to T (the forward's divisor)
  float q_f;      // q in fp32 (the backward's divisor)
  int on;
  int row0;       // the first row's place in the whole masks (data ranks)
};

// the Dropout of the C entry points' arguments (seed: the Philox key;
// row0: the rows' offset in the masks, a data rank's first row)
static inline Dropout make_dropout(unsigned long long seed, unsigned int thr,
                                   float q_t, float q_f, int on, int row0) {
  Dropout d;
  d.key = make_uint2((uint32_t)(seed & 0xffffffffull),
                     (uint32_t)(seed >> 32));
  d.thr = thr;
  d.q_t = q_t;
  d.q_f = q_f;
  d.on = on;
  d.row0 = row0;
  return d;
}

// x / q for the dropout divisor q given iq = 1 / q: the product, then
// one FMA correction (the division's own Newton step), without the
// special-case path of an IEEE division (q is in (0, 1], x finite)
static __device__ __forceinline__ float div_q(float x, float q, float iq) {
  const float y = x * iq;
  return fmaf(fmaf(-y, q, x), iq, y);
}

// Keep bits of mask m (0: hidden, 1: output) for a lane's two columns of
// the n8 tile whose columns start at col8 (a multiple of 8): bits0 at row
// `row`, bits1 at row + 8, bit e for column col8 + 2t + e. Element (r, c)
// keeps word c % 4 of Philox at counter (c / 4, d.row0 + r, m), as
// dropout_keep (common.cuh). Lanes t and t ^ 1 share a counter: each draws
// for one of the two rows and they trade the other row's bits, one draw
// per four elements. Every lane of the warp must call it.
static __device__ __forceinline__ void keep_bits(const Dropout& d, int m,
                                                 int col8, int row, int t,
                                                 uint32_t& bits0,
                                                 uint32_t& bits1) {
  const bool odd = (t & 1) != 0;
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)col8 / 4 + (t >> 1),
                 (uint32_t)(d.row0 + row + (odd ? 8 : 0)), (uint32_t)m, 0u),
      d.key);
  const uint32_t lo = (uint32_t)(w.x < d.thr) | ((uint32_t)(w.y < d.thr) << 1);
  const uint32_t hi = (uint32_t)(w.z < d.thr) | ((uint32_t)(w.w < d.thr) << 1);
  const uint32_t mine = odd ? hi : lo;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
  bits0 = odd ? got : mine;
  bits1 = odd ? mine : got;
}

// one stage of the chunk ring: W1[:, f0:f0+64] as [C][64] and
// W2[f0:f0+64, :] as [64][C], bf16 tiles of pitch width + 8
template <int C>
struct MlpStage {
  static constexpr int LDC = pitch(C), LDF = pitch(kFch);
  static constexpr int W1 = C * LDF;
  static constexpr int W2 = kFch * LDC;
  static constexpr int kElems = W1 + W2;
};

// chunk f0 of w1 [C, F] and w2 [F, C] into a stage, by NTHREADS threads
template <int C, int NTHREADS>
static __device__ __forceinline__ void stage_chunk(bf16* st,
                                                   const bf16* __restrict__ w1,
                                                   const bf16* __restrict__ w2,
                                                   int f0, int F, int tid) {
  using S = MlpStage<C>;
  stage_rows<kFch, NTHREADS>(st, S::LDF, w1 + f0, F, C, C, tid);
  stage_rows<C, NTHREADS>(st + S::W1, S::LDC, w2 + (size_t)f0 * C, C, kFch,
                          kFch, tid);
}

// rows [r0, r0 + rows) of a row-major bf16 [*, C] matrix copied, 16 bytes
// per copy (a dead tile's residual)
template <int C>
static __device__ __forceinline__ void copy_rows16(const bf16* __restrict__ src,
                                                   bf16* __restrict__ dst,
                                                   int r0, int rows, int tid) {
  static_assert(C % 8 == 0, "whole 16-byte pieces");
  const uint4* s = reinterpret_cast<const uint4*>(src + (size_t)r0 * C);
  uint4* d = reinterpret_cast<uint4*>(dst + (size_t)r0 * C);
  for (int e = tid; e < rows * (C / 8); e += kMlpThreads) d[e] = s[e];
}

// the tile loop's geometry and shared memory (bytes): 8 warps of 16
// rows, the normalised tile [128][C], then the two-stage ring, whose
// stages also hold the tile's x for the output epilogue, then b2
constexpr int kMlpRows = 128;

template <int C>
struct MlpTc {
  static_assert(C % 32 == 0 && C <= 256, "the fused loop takes C <= 256");
  static constexpr int LDC = pitch(C);
  static constexpr int A = kMlpRows * LDC;
  static constexpr int STAGE =
      MlpStage<C>::kElems > A ? MlpStage<C>::kElems : A;
  // then b2 in fp32
  static constexpr int kBytes =
      (A + 2 * STAGE) * (int)sizeof(bf16) + C * (int)sizeof(float);
};

// ----------------------------------------------------------------------
// normalisations of the bf16 rows warp, warp + 8, ... of a [128][C] tile
// in shared memory (pitch ld), in place, by one warp (lane l holds
// columns l, l + 32, ...; gamma and beta in registers), rounded to bf16:
// bf16(((x - mean) * inv) * gamma + beta), inv from the row's sum of
// squared deviations by inv_std
template <int C, class InvStd>
static __device__ __forceinline__ void norm_rows(
    bf16* xs, int ld, int warp, int lane, const float* __restrict__ gamma,
    const float* __restrict__ beta, InvStd inv_std) {
  float ga[C / 32], be[C / 32];
#pragma unroll
  for (int j = 0; j < C / 32; ++j) {
    ga[j] = gamma[lane + 32 * j];
    be[j] = beta[lane + 32 * j];
  }
  for (int r = warp; r < kMlpRows; r += kMlpThreads / 32) {
    bf16* xr = xs + r * ld;
    float xv[C / 32];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      xv[j] = bf(xr[lane + 32 * j]);
      s += xv[j];
    }
    const float mu = warp_sum(s) / (float)C;
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const float d = xv[j] - mu;
      v += d * d;
    }
    const float inv = inv_std(warp_sum(v));
#pragma unroll
    for (int j = 0; j < C / 32; ++j)
      xr[lane + 32 * j] =
          __float2bfloat16_rn(((xv[j] - mu) * inv) * ga[j] + be[j]);
  }
}

// StdLayerNorm (ln_tile's arithmetic and order): Bessel variance, eps
// added to the std, variance floor
struct StdLN {
  const float* __restrict__ gamma;
  const float* __restrict__ beta;
  template <int C>
  __device__ __forceinline__ void rows(bf16* xs, int ld, int warp,
                                       int lane) const {
    norm_rows<C>(xs, ld, warp, lane, gamma, beta, [](float ss) {
      return 1.0f / (sqrtf(fmaxf(ss / (float)(C - 1), kVarFloor)) +
                     kStdLnEps);
    });
  }
};

// torch's LayerNorm (layer_norm_row's arithmetic): biased variance, eps
// inside the square root
struct LayerNorm {
  const float* __restrict__ gamma;
  const float* __restrict__ beta;
  float eps;
  template <int C>
  __device__ __forceinline__ void rows(bf16* xs, int ld, int warp,
                                       int lane) const {
    const float e = eps;
    norm_rows<C>(xs, ld, warp, lane, gamma, beta, [e](float ss) {
      return 1.0f / sqrtf(ss / (float)C + e);
    });
  }
};

// ----------------------------------------------------------------------
// hidden epilogues: h[j] is the fragment of hidden columns f + 8j .. + 7
// at rows row (c0, c1) and row + 8 (c2, c3); the result is bf16-exact.
// pre(p, q, ...) fills part q of what apply() needs (tiles 2q, 2q + 1:
// b1 at the lane's columns, the keep bits), so that the tile loop can run
// it among the previous chunk's products.

// the FFN's: relu(bf16(bf16(acc) + b1)), then dropout: kept values
// bf16(h / q_t) (torch_ffn, the TPU kernel's _fwd_kernel)
struct ReluDropout {
  const bf16* __restrict__ b1;
  Dropout drop;
  float iq;  // 1 / q_t
  template <int NT>
  struct Pre {
    uint32_t bias[NT];  // two bf16
    uint32_t keep;      // tile j's 4 bits at 4j: (row, col 2t + e) at e,
                        // (row + 8, col 2t + e) at 2 + e
  };
  template <int NT>
  __device__ __forceinline__ void pre(Pre<NT>& p, int q, int row, int f,
                                      int t) const {
    if (q == 0) p.keep = 0xffffffffu;
#pragma unroll
    for (int j = 2 * q; j < 2 * q + 2; ++j) {
      p.bias[j] = *reinterpret_cast<const uint32_t*>(b1 + f + 8 * j + 2 * t);
      if (drop.on) {
        uint32_t b0, b8;
        keep_bits(drop, 0, f + 8 * j, row, t, b0, b8);
        p.keep = (p.keep & ~(15u << (4 * j))) | ((b0 | (b8 << 2)) << (4 * j));
      }
    }
  }
  template <int NT>
  __device__ __forceinline__ void apply(float (&h)[NT][4],
                                        const Pre<NT>& p) const {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bj = __uint_as_float((e & 1) == 0 ? p.bias[j] << 16
                                                      : p.bias[j] & 0xffff0000u);
        float v = fmaxf(rnd<bf16>(rnd<bf16>(h[j][e]) + bj), 0.0f);
        if (drop.on)
          v = ((p.keep >> (4 * j + e)) & 1u)
                  ? rnd<bf16>(div_q(v, drop.q_t, iq)) : 0.0f;
        h[j][e] = v;
      }
  }
};

// the Swin MLP's: bf16(gelu(acc + b1)), all in fp32, erf exact
// (torch_swin_mlp)
struct GeluErf {
  const float* __restrict__ b1;
  template <int NT>
  struct Pre {
    float2 bias[NT];
  };
  template <int NT>
  __device__ __forceinline__ void pre(Pre<NT>& p, int q, int, int f,
                                      int t) const {
#pragma unroll
    for (int j = 2 * q; j < 2 * q + 2; ++j)
      p.bias[j] = *reinterpret_cast<const float2*>(b1 + f + 8 * j + 2 * t);
  }
  template <int NT>
  __device__ __forceinline__ void apply(float (&h)[NT][4],
                                        const Pre<NT>& p) const {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[j][e] = rnd<bf16>(gelu_exact(
            h[j][e] + ((e & 1) == 0 ? p.bias[j].x : p.bias[j].y)));
  }
};

// ----------------------------------------------------------------------
// output epilogues: bias() stages b2 in fp32 into shared memory; rows()
// says which of the lane's rows (r0 + lr, r0 + lr + 8) take the output;
// then, per n8 tile, c is acc's fragment of columns col8 .. col8 + 7 at
// the tile's rows lr and lr + 8; xs holds the tile's x in shared memory
// (pitch ld) and gets y in place (a row not taken keeps x).

// the FFN's: z = bf16(bf16(acc) + b2), dropout as the hidden's (mask 1),
// y = bf16(x + z); rows of dead 64-row tiles (valid flag 0) keep x
struct FfnOut {
  const bf16* __restrict__ b2;
  const int8_t* __restrict__ valid;
  Dropout drop;
  float iq;
  int R;
  template <int C>
  __device__ __forceinline__ void bias(float* dst, int tid) const {
    for (int c = tid; c < C; c += kMlpThreads) dst[c] = bf(b2[c]);
  }
  __device__ __forceinline__ uint32_t rows(int r0, int lr) const {
    uint32_t take = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + lr + 8 * h;
      if (r < R && (valid == nullptr || valid[r / kTile] != 0))
        take |= 1u << h;
    }
    return take;
  }
  __device__ __forceinline__ void operator()(const float (&c)[4],
                                             const float* bs, bf16* xs,
                                             int ld, int r0, int lr,
                                             uint32_t take, int col8,
                                             int t) const {
    uint32_t bits[2] = {3u, 3u};
    if (drop.on) keep_bits(drop, 1, col8, r0 + lr, t, bits[0], bits[1]);
    const int col = col8 + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bs + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!((take >> h) & 1u)) continue;
      uint32_t* p = reinterpret_cast<uint32_t*>(xs + (lr + 8 * h) * ld + col);
      const uint32_t xx = *p;
      float z[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        z[e] = rnd<bf16>(rnd<bf16>(c[2 * h + e]) + (e == 0 ? bb.x : bb.y));
        if (drop.on)
          z[e] = ((bits[h] >> e) & 1u)
                     ? rnd<bf16>(div_q(z[e], drop.q_t, iq)) : 0.0f;
        z[e] += __uint_as_float(e == 0 ? xx << 16 : xx & 0xffff0000u);
      }
      *p = pack_bf16(z[0], z[1]);
    }
  }
};

// the Swin MLP's: y = bf16(x + (acc + b2)), in fp32 (rows past R are
// computed and never stored)
struct ResidualOut {
  const float* __restrict__ b2;
  template <int C>
  __device__ __forceinline__ void bias(float* dst, int tid) const {
    for (int c = tid; c < C; c += kMlpThreads) dst[c] = b2[c];
  }
  __device__ __forceinline__ uint32_t rows(int, int) const { return 3u; }
  __device__ __forceinline__ void operator()(const float (&c)[4],
                                             const float* bs, bf16* xs,
                                             int ld, int, int lr, uint32_t,
                                             int col8, int t) const {
    const int col = col8 + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bs + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* p = reinterpret_cast<uint32_t*>(xs + (lr + 8 * h) * ld + col);
      const uint32_t xx = *p;
      *p = pack_bf16(__uint_as_float(xx << 16) + (c[2 * h] + bb.x),
                     __uint_as_float(xx & 0xffff0000u) +
                         (c[2 * h + 1] + bb.y));
    }
  }
};

// ----------------------------------------------------------------------
// The tile loop over rows r0 .. r0 + 128 of x [R, C] into y (rows past R
// are zero-filled and never stored), w1 [C, F], w2 [F, C], F % 64 == 0, by
// kMlpThreads threads; smem holds MlpTc<C>::kBytes. Warp w owns rows
// 16 w .. 16 w + 15 of the tile and all 64 hidden columns of a chunk.
template <int C, class Norm, class Hidden, class Out>
static __device__ __forceinline__ void mlp_tile(
    const bf16* __restrict__ x, bf16* __restrict__ y,
    const bf16* __restrict__ w1, const bf16* __restrict__ w2, int R, int F,
    int r0, const Norm& norm, const Hidden& hid, const Out& out,
    unsigned char* smem) {
  using L = MlpTc<C>;
  constexpr int NT = kFch / 8;  // n8 tiles of a chunk
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* ring = as + L::A;
  float* bs = reinterpret_cast<float*>(ring + 2 * L::STAGE);  // b2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows = min(kMlpRows, R - r0);
  const int lr = 16 * warp + g;  // the lane's first row in the tile
  const bf16* xt = x + (size_t)r0 * C;
  // the tile's x, then the first chunk: the norm runs while it lands
  stage_rows<C, kMlpThreads>(as, L::LDC, xt, C, kMlpRows, rows, tid);
  cp_async_commit();
  stage_chunk<C, kMlpThreads>(ring, w1, w2, 0, F, tid);
  cp_async_commit();
  typename Hidden::template Pre<NT> pre;
#pragma unroll
  for (int q = 0; q < NT / 2; ++q) hid.pre(pre, q, r0 + lr, 0, t);
  out.template bias<C>(bs, tid);
  const uint32_t take = out.rows(r0, lr);
  cp_async_wait<1>();
  __syncthreads();
  norm.template rows<C>(as, L::LDC, warp, lane);

  float acc[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int nch = F / kFch;
  for (int it = 0; it < nch; ++it) {
    const int f0 = it * kFch;
    // chunk it has landed (at it == 0, every row's norm too); every warp
    // is done with chunk it - 1, whose stage is refilled next: with the
    // next chunk, or after the last with the tile's x again, for the
    // output epilogue
    cp_async_wait<0>();
    __syncthreads();
    bf16* nxt = ring + ((it + 1) & 1) * L::STAGE;
    if (it + 1 < nch)
      stage_chunk<C, kMlpThreads>(nxt, w1, w2, f0 + kFch, F, tid);
    else
      stage_rows<C, kMlpThreads>(nxt, L::LDC, xt, C, kMlpRows, rows, tid);
    cp_async_commit();
    const bf16* s1 = ring + (it & 1) * L::STAGE;
    const bf16* s2 = s1 + MlpStage<C>::W1;
    float h[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] = 0.0f;
    // h = norm . W1c: 16 rows x 64 hidden columns
#pragma unroll 4
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, frag_a(as, L::LDC, 16 * warp, kk, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, frag_b_kn(s1, MlpStage<C>::LDF, kk, 16 * np, lane));
        mma16816(h[2 * np], a, b[0], b[1]);
        mma16816(h[2 * np + 1], a, b[2], b[3]);
      }
    }
    hid.apply(h, pre);
    // acc += h . W2c, h's fragments as the A operand; the next chunk's
    // pre() among the products (the last chunk's repeats its own columns)
    const int fn = it + 1 < nch ? f0 + kFch : f0;
#pragma unroll
    for (int s = 0; s < NT / 2; ++s) {
      const uint32_t a[4] = {pack_bf16(h[2 * s][0], h[2 * s][1]),
                             pack_bf16(h[2 * s][2], h[2 * s][3]),
                             pack_bf16(h[2 * s + 1][0], h[2 * s + 1][1]),
                             pack_bf16(h[2 * s + 1][2], h[2 * s + 1][3])};
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, frag_b_kn(s2, L::LDC, 16 * s, 16 * np, lane));
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
      hid.pre(pre, s, r0 + lr, fn, t);
    }
  }
  // the tile's x has landed in the free stage: y in its place, then out
  // in 16-byte rows
  cp_async_wait<0>();
  __syncthreads();
  bf16* xs = ring + (nch & 1) * L::STAGE;
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
    out(acc[j], bs, xs, L::LDC, r0, lr, take, 8 * j, t);
  __syncthreads();
  constexpr int per_row = C / 8;
  for (int e = tid; e < rows * per_row; e += kMlpThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    *reinterpret_cast<uint4*>(y + (size_t)(r0 + r) * C + c) =
        *reinterpret_cast<const uint4*>(xs + r * L::LDC + c);
  }
}

}  // namespace mtp
