// Swin window attention over pre-windowed tokens [I, 49, C], 32-wide
// heads: qkv projection, per-head scores / sqrt(32) + relative-position
// bias, shifted-window mask (-65504), softmax, @v, output projection.
// Forward only (the trunk is frozen).
//
// Replaces medical_tri_modal_pilot_tpu/kernels/swin_attention.py::
// _pallas_window_attention (body _kernel), reached through
// pallas_window_attention.
//
// What bounds it on an H100: the two projections (8*T*C^2 operations for T
// tokens) outweigh the window products (4*T*49*C) at every stage. Against
// the bytes (x and out, T*C elements each, the weights and the bias) the
// operations are the limit at Swin-T's stages 2-4 and in fp32; at stage 1
// (C = 96) in bf16 the bytes are, narrowly. Three routes, which the
// wrapper picks by dtype and width (kernels/swin_attention.py route):
//
//   fma (fp32, the checking dtype): three launches of fp32 FMA loops,
//     1. gemm_kernel (common.cuh): q|k|v = x.w_qkv + b_qkv over all I*49
//        rows into a [I, 49, 3C] scratch, 64 x 64 output tiles;
//     2. window_attn_kernel: one block per (window, head), 49 tokens
//        padded to 64, scores, bias, the window's shift mask (window i of
//        an image takes mask i % M), softmax over the 49 real keys, @v,
//        into a [I, 49, C] scratch;
//     3. gemm_kernel again: out = heads.w_proj + b_proj.
//   split (bf16, C too wide to fuse: Swin-T's stages 2-4): the same three
//     launches on the tensor cores, gemm_bf16_kernel (mma.cuh) for the
//     projections and window_attn_tc_kernel for the window core.
//   fused (bf16, C = 96: stage 1, the widest I and the one bound by
//     bytes): swin_fused_kernel, one launch. A persistent block keeps
//     w_qkv and w_proj in shared memory and walks window pairs: it stages
//     both windows' x by cp.async (the next pair's while this one
//     computes), projects q|k|v into shared memory, runs the window core
//     per head and projects out, so only x is read and out written.
//
// The window core on the tensor cores: a warp owns 16 of the 64 (padded)
// query rows; S = Q K^T (16 x 64, depth 32) by mma.sync m16n8k16 with
// fp32 accumulation; scale, bias, shift mask (-65504), padded keys (-inf)
// and the softmax work on the accumulator fragments in registers; the
// probabilities, rounded to bf16, are the A fragments of P V (V through
// ldmatrix.trans).
//
// Rounding follows the plain version (kernels/swin_attention.py), which
// follows the XLA oracle: q|k|v and the projection rounded to T after the
// fp32 sum, then the bias added in T; scores in fp32; probabilities
// rounded to T; @v rounded to T. (The Pallas kernel adds the qkv bias in
// fp32 before rounding; bf16 results may differ from it by one unit.)
#include "common.cuh"
#include "mma.cuh"

namespace mtp {

constexpr int kWin = 49;     // tokens per 7x7 window
constexpr int kHeadDim = 32;

// heads[i, :, h*32:(h+1)*32] = softmax(q k^T / scale + bias[h], mask) v for
// window i, head h, in fp32; qkv [I, 49, 3C]; bias [nh, 49, 49]; smask
// [M, 49, 49] int8 (1 = masked) or NULL. grid (I, nh).
__global__ void __launch_bounds__(kThreads) window_attn_kernel(
    const float* __restrict__ qkv, const float* __restrict__ bias,
    const int8_t* __restrict__ smask, int M, float* __restrict__ heads,
    int C, float scale) {
  constexpr int LDQ = kHeadDim + 1;
  constexpr int LDP = kTile + 1;
  __shared__ float qs[kTile][LDQ];
  __shared__ float ks[kTile][LDQ];
  __shared__ float vs[kTile][kHeadDim];
  __shared__ float ps[kTile][LDP];
  const int win = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* base = qkv + (size_t)win * kWin * 3 * C + h * kHeadDim;
  for (int e = tid; e < kTile * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, d = e - r * kHeadDim;
    float q = 0.0f, k = 0.0f, v = 0.0f;
    if (r < kWin) {
      const float* row = base + (size_t)r * 3 * C + d;
      q = row[0];
      k = row[C];
      v = row[2 * C];
    }
    qs[r][d] = q;
    ks[r][d] = k;
    vs[r][d] = v;
  }
  __syncthreads();
  float s[4][4];
  zero(s);
#pragma unroll 8
  for (int d = 0; d < kHeadDim; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = qs[ty + 16 * i][d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kb[j] = ks[tx + 16 * j][d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
  }
  const float* bh = bias + (size_t)h * kWin * kWin;
  const int8_t* mw =
      smask == nullptr ? nullptr : smask + (size_t)(win % M) * kWin * kWin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c >= kWin) {
        s[i][j] = -INFINITY;  // padded key: out of the softmax
      } else if (r >= kWin) {
        s[i][j] = 0.0f;       // padded query row: never stored
      } else {
        const int rc = r * kWin + c;
        s[i][j] = (mw != nullptr && mw[rc] != 0)
            ? kMaskFill : s[i][j] / scale + bh[rc];
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
#pragma unroll
    for (int j = 0; j < 4; ++j) ps[r][tx + 16 * j] = s[i][j] / l;
  }
  __syncthreads();
  float o[4][2];
  zero(o);
#pragma unroll 8
  for (int k = 0; k < kWin; ++k) {
    float pa[4], vb[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = ps[ty + 16 * i][k];
#pragma unroll
    for (int j = 0; j < 2; ++j) vb[j] = vs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) o[i][j] = fmaf(pa[i], vb[j], o[i][j]);
  }
  float* ob = heads + (size_t)win * kWin * C + h * kHeadDim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= kWin) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ob[(size_t)r * C + tx + 16 * j] = o[i][j];
  }
}

// The shift-mask bits of rows g and g + 8 (g = lane >> 2) of the 16 rows
// 16 w .. 16 w + 15 of a window: bit c set when key c is masked. mw: the
// window's mask [49, 49] int8, or NULL (no bits). The 16 rows' bytes are
// all loaded before the first ballot, so their latencies overlap.
static __device__ __forceinline__ void mask_bits(const int8_t* __restrict__ mw,
                                                 int w, int lane,
                                                 uint64_t& m0, uint64_t& m1) {
  m0 = m1 = 0;
  if (mw == nullptr) return;
  const int g = lane >> 2;
  int8_t lo[16], hi[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * w + rr;
    lo[rr] = r < kWin ? mw[r * kWin + lane] : 0;
    hi[rr] = r < kWin && lane + 32 < kWin ? mw[r * kWin + lane + 32] : 0;
  }
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const uint64_t bits =
        ((uint64_t)__ballot_sync(0xffffffffu, hi[rr] != 0) << 32) |
        __ballot_sync(0xffffffffu, lo[rr] != 0);
    if (rr == g) m0 = bits;
    if (rr == g + 8) m1 = bits;
  }
}

// The window core of one warp on the tensor cores: rows [16 w, 16 w + 16)
// of a 64-row window (49 real), one head. Its softmax multiplies by
// 1/sqrt(32) and by the reciprocal of the row sum and exponentiates with
// __expf: against the plain version's divisions and expf that moves a
// probability by an fp32 unit or two, far below its rounding to bf16. q, k, v: shared [64][ldq] tiles
// (column offset applied by the caller) holding rows 49..63 finite; bh:
// bias[h] [49, 49] fp32 (shared or device memory); m0, m1: mask_bits of
// the window. Writes the warp's 16 rows x 32 columns of
// softmax(q k^T / scale + bias, mask) v in bf16 for rows < 49 to heads
// (pitch ldo; shared or device memory), after its reads of q, so heads may
// be q itself.
static __device__ __forceinline__ void window_core(
    const bf16* q, const bf16* k, const bf16* v, int ldq, int w,
    const float* bh, uint64_t m0, uint64_t m1, float scale, bf16* heads,
    int ldo, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // the bias at this lane's scores, read ahead of the products
  float bv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      bv[j][e] = r < kWin && c < kWin ? bh[r * kWin + c] : 0.0f;
    }
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, frag_a(q, ldq, 16 * w, kk, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, frag_b_nk(k, ldq, 16 * np, kk, lane));
      mma16816(s[2 * np], a, b[0], b[1]);
      mma16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }
  // scores, then the softmax of rows g and g + 8 of the warp's 16: each
  // row's 64 columns lie in the 4 lanes that share g. The mask bits are
  // shifted by the lane's column offset once, so each score tests a bit
  // at a constant position.
  m0 >>= 2 * t;
  m1 >>= 2 * t;
  const float inv_scale = 1.0f / scale;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      float v_;
      if (c >= kWin) {
        v_ = -INFINITY;  // padded key: out of the softmax
      } else if (r >= kWin) {
        v_ = 0.0f;       // padded query row: never stored
      } else {
        const uint64_t m = (e >> 1) ? m1 : m0;
        v_ = ((m >> (8 * j + (e & 1))) & 1) ? kMaskFill
                                             : s[j][e] * inv_scale + bv[j][e];
      }
      s[j][e] = v_;
      mx[e >> 1] = fmaxf(mx[e >> 1], v_);
    }
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __expf(s[j][e] - mx[e >> 1]);
      l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.0f / l[h];
  }
  // O = P V, P rounded to bf16 as the plain version casts it
  float o[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0] * l[0], s[2 * kk][1] * l[0]);
    a[1] = pack_bf16(s[2 * kk][2] * l[1], s[2 * kk][3] * l[1]);
    a[2] = pack_bf16(s[2 * kk + 1][0] * l[0], s[2 * kk + 1][1] * l[0]);
    a[3] = pack_bf16(s[2 * kk + 1][2] * l[1], s[2 * kk + 1][3] * l[1]);
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, frag_b_kn(v, ldq, 16 * kk, 16 * dp, lane));
      mma16816(o[2 * dp], a, b[0], b[1]);
      mma16816(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + g + 8 * h;
      if (r < kWin)
        *reinterpret_cast<uint32_t*>(heads + (size_t)r * ldo + 8 * j + 2 * t) =
            pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
    }
}

// The split route's window core: one block per window and group of
// heads_per_block heads (the launch makes groups only where too few
// windows would fill the card); q, k and v of the next head are staged by
// cp.async while one head computes. qkv [I, 49, 3C] bf16; heads
// [I, 49, C] bf16. grid (I, C / 32 / heads_per_block), 128 threads.
constexpr int kCoreThreads = 128;

__global__ void __launch_bounds__(kCoreThreads) window_attn_tc_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ bias,
    const int8_t* __restrict__ smask, int M, bf16* __restrict__ heads,
    int C, int heads_per_block, float scale) {
  constexpr int LD = pitch(kHeadDim);
  __shared__ __align__(16) bf16 tiles[2][3][kTile * LD];
  const int win = blockIdx.x, h0 = blockIdx.y * heads_per_block;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* base = qkv + (size_t)win * kWin * 3 * C;
  auto load = [&](int h, int st) {
#pragma unroll
    for (int m = 0; m < 3; ++m)
      stage_rows<kHeadDim, kCoreThreads>(tiles[st][m], LD,
                                         base + m * C + h * kHeadDim, 3 * C,
                                         kTile, kWin, tid);
  };
  load(h0, 0);
  cp_async_commit();
  uint64_t m0, m1;
  mask_bits(smask == nullptr ? nullptr
                             : smask + (size_t)(win % M) * kWin * kWin,
            warp, lane, m0, m1);
  for (int i = 0; i < heads_per_block; ++i) {
    const int h = h0 + i;
    cp_async_wait<0>();
    __syncthreads();
    // the stage refilled here was read for the last head, before the
    // barrier
    if (i + 1 < heads_per_block) load(h + 1, (i + 1) & 1);
    cp_async_commit();
    const int st = i & 1;
    window_core(tiles[st][0], tiles[st][1], tiles[st][2], LD, warp,
                bias + (size_t)h * kWin * kWin, m0, m1, scale,
                heads + (size_t)win * kWin * C + h * kHeadDim, C, lane);
  }
}

// The fused route, C = 96 (three heads). Shared memory (bf16 tiles, pitch
// width + 8): w_qkv [C][3C], w_proj [C][C], x [2 windows][64][C],
// q|k|v [2 windows][64][3C] (each head's output replaces its q), then the
// bias fp32 [NH][49][49]. 256 threads: warp w works on window w >> 2 of
// the pair, rows 16 (w & 3) .. + 16. Once q|k|v are projected, x's buffer
// takes the next pair's x by cp.async while this pair's heads and output
// projection compute. grid: one persistent block per SM (at most the
// number of pairs).
constexpr int kFusedThreads = 256;

struct Fused {
  static constexpr int NH = 3;
  static constexpr int C = NH * kHeadDim;
  static constexpr int LDW = pitch(3 * C), LDP = pitch(C);
  static constexpr int W_QKV = C * LDW, W_PROJ = C * LDP;
  static constexpr int X = kTile * LDP, QKV = kTile * LDW;
  static constexpr int kElems = W_QKV + W_PROJ + 2 * X + 2 * QKV;
  static constexpr int kBias = NH * kWin * kWin;
  static constexpr int kBytes =
      kElems * (int)sizeof(bf16) + kBias * (int)sizeof(float);
};

__global__ void __launch_bounds__(kFusedThreads, 1) swin_fused_kernel(
    const bf16* __restrict__ xw, const bf16* __restrict__ wqkv,
    const bf16* __restrict__ bqkv, const bf16* __restrict__ wproj,
    const bf16* __restrict__ bproj, const float* __restrict__ bias,
    const int8_t* __restrict__ smask, int M, bf16* __restrict__ out, int I,
    float scale) {
  using L = Fused;
  constexpr int C = L::C;
  extern __shared__ __align__(16) unsigned char fused_smem[];
  bf16* sw = reinterpret_cast<bf16*>(fused_smem);
  bf16* sp = sw + L::W_QKV;
  bf16* sx = sp + L::W_PROJ;     // [window]
  bf16* sq = sx + 2 * L::X;      // [window]
  float* sb = reinterpret_cast<float*>(sq + 2 * L::QKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wl = warp >> 2, slab = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int npairs = (I + 1) / 2;
  auto load_x = [&](int pair) {
    for (int wi = 0; wi < 2; ++wi) {
      const int win = 2 * pair + wi;
      stage_rows<C, kFusedThreads>(sx + wi * L::X, L::LDP,
                                   xw + (size_t)min(win, I - 1) * kWin * C,
                                   C, kTile, win < I ? kWin : 0, tid);
    }
  };
  stage_rows<3 * C, kFusedThreads>(sw, L::LDW, wqkv, 3 * C, C, C, tid);
  stage_rows<C, kFusedThreads>(sp, L::LDP, wproj, C, C, C, tid);
  if ((int)blockIdx.x < npairs) load_x(blockIdx.x);
  cp_async_commit();
  for (int e = tid; e < L::kBias; e += kFusedThreads) sb[e] = bias[e];
  for (int pair = blockIdx.x; pair < npairs; pair += gridDim.x) {
    const int win = 2 * pair + wl;
    const bool live = win < I;
    // the window's shift-mask rows, loaded while x lands
    uint64_t m0 = 0, m1 = 0;
    if (live)
      mask_bits(smask == nullptr ? nullptr
                                 : smask + (size_t)(win % M) * kWin * kWin,
                slab, lane, m0, m1);
    cp_async_wait<0>();
    // this pair's x has landed; every warp is done with the last pair's
    // q|k|v
    __syncthreads();
    const bf16* x = sx + wl * L::X;
    bf16* q = sq + wl * L::QKV;
    // q|k|v of the warp's 16 rows, 32 columns at a time
    if (live) {
#pragma unroll 1
      for (int n0 = 0; n0 < 3 * C; n0 += 32) {
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < C; kk += 16) {
          uint32_t a[4];
          ldsm_x4(a, frag_a(x, L::LDP, 16 * slab, kk, lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldsm_x4_t(b, frag_b_kn(sw, L::LDW, kk, n0 + 16 * np, lane));
            mma16816(acc[2 * np], a, b[0], b[1]);
            mma16816(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float b0 = bf(bqkv[col]), b1 = bf(bqkv[col + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * slab + g + 8 * h;
            *reinterpret_cast<uint32_t*>(q + r * L::LDW + col) =
                pack_bf16(rnd<bf16>(acc[j][2 * h]) + b0,
                          rnd<bf16>(acc[j][2 * h + 1]) + b1);
          }
        }
      }
    }
    // q|k|v complete; x is free for the next pair
    __syncthreads();
    if (pair + (int)gridDim.x < npairs) load_x(pair + gridDim.x);
    cp_async_commit();
    if (!live) continue;
    // the window core per head; each head's output replaces its q (each
    // warp reads and writes its own 16 rows)
#pragma unroll 1
    for (int h = 0; h < L::NH; ++h)
      window_core(q + h * kHeadDim, q + C + h * kHeadDim,
                  q + 2 * C + h * kHeadDim, L::LDW, slab,
                  sb + h * kWin * kWin, m0, m1, scale, q + h * kHeadDim,
                  L::LDW, lane);
    __syncwarp();
    // out = heads . w_proj + b_proj for the warp's rows
    float acc[C / 8][4];
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, frag_a(q, L::LDW, 16 * slab, kk, lane));
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, frag_b_kn(sp, L::LDP, kk, 16 * np, lane));
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    bf16* ow = out + (size_t)win * kWin * C;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float b0 = bf(bproj[col]), b1 = bf(bproj[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * slab + g + 8 * h;
        if (r < kWin)
          *reinterpret_cast<uint32_t*>(ow + (size_t)r * C + col) =
              pack_bf16(rnd<bf16>(acc[j][2 * h]) + b0,
                        rnd<bf16>(acc[j][2 * h + 1]) + b1);
      }
    }
  }
  cp_async_wait<0>();
}

static cudaError_t launch_fused(const void* xw, const void* wqkv,
                                const void* bqkv, const void* wproj,
                                const void* bproj, const float* bias,
                                const int8_t* smask, void* out, int I, int M,
                                float scale, cudaStream_t stream) {
  constexpr int bytes = Fused::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      swin_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int npairs = (I + 1) / 2;
  const int blocks = npairs < sms ? npairs : sms;
  swin_fused_kernel<<<blocks, kFusedThreads, bytes, stream>>>(
      (const bf16*)xw, (const bf16*)wqkv, (const bf16*)bqkv,
      (const bf16*)wproj, (const bf16*)bproj, bias, smask, M, (bf16*)out, I,
      scale);
  return cudaGetLastError();
}

static cudaError_t launch_split(const void* xw, const void* wqkv,
                                const void* bqkv, const void* wproj,
                                const void* bproj, const float* bias,
                                const int8_t* smask, void* qkv, void* heads,
                                void* out, int I, int C, int M, float scale,
                                cudaStream_t stream) {
  const int R = I * kWin;
  const dim3 g1((R + kTile - 1) / kTile, (3 * C + kTile - 1) / kTile);
  gemm_bf16_kernel<<<g1, kGemmThreads, 0, stream>>>(
      (const bf16*)xw, (const bf16*)wqkv, nullptr,
      EpiBiasT<bf16>{(const bf16*)bqkv, (bf16*)qkv, 3 * C}, R, C, 3 * C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // head groups only where the windows alone leave the card's SMs short
  // of two blocks each
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nh = C / kHeadDim;
  int groups = 1;
  while (groups < nh && (I * groups < 2 * sms || nh % groups != 0)) ++groups;
  window_attn_tc_kernel<<<dim3(I, groups), kCoreThreads, 0, stream>>>(
      (const bf16*)qkv, bias, smask, M, (bf16*)heads, C, nh / groups, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g3((R + kTile - 1) / kTile, (C + kTile - 1) / kTile);
  gemm_bf16_kernel<<<g3, kGemmThreads, 0, stream>>>(
      (const bf16*)heads, (const bf16*)wproj, nullptr,
      EpiBiasT<bf16>{(const bf16*)bproj, (bf16*)out, C}, R, C, C);
  return cudaGetLastError();
}

static cudaError_t launch_fma(const void* xw, const void* wqkv,
                              const void* bqkv, const void* wproj,
                              const void* bproj, const float* bias,
                              const int8_t* smask, void* qkv, void* heads,
                              void* out, int I, int C, int M, float scale,
                              cudaStream_t stream) {
  const int R = I * kWin;
  const dim3 g1((R + kTile - 1) / kTile, (3 * C + kTile - 1) / kTile);
  gemm_kernel<<<g1, kThreads, 0, stream>>>(
      (const float*)xw, (const float*)wqkv, nullptr,
      EpiBiasT<float>{(const float*)bqkv, (float*)qkv, 3 * C}, R, C, 3 * C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  window_attn_kernel<<<dim3(I, C / kHeadDim), kThreads, 0, stream>>>(
      (const float*)qkv, bias, smask, M, (float*)heads, C, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g3((R + kTile - 1) / kTile, (C + kTile - 1) / kTile);
  gemm_kernel<<<g3, kThreads, 0, stream>>>(
      (const float*)heads, (const float*)wproj, nullptr,
      EpiBiasT<float>{(const float*)bproj, (float*)out, C}, R, C, C);
  return cudaGetLastError();
}

}  // namespace mtp

// Routes (kernels/swin_attention.py ROUTES): 0 = fma (fp32), 1 = fused
// (bf16, C = 96), 2 = split (bf16). dtype: 0 = fp32, 1 =
// bf16 for xw [I, 49, C], wqkv [C, 3C], bqkv [3C], wproj [C, C], bproj
// [C], the scratches qkv [I, 49, 3C] and heads [I, 49, C] (routes 0 and 2;
// NULL for 1), and out [I, 49, C]; bias [C/32, 49, 49] fp32; smask int8
// [M, 49, 49] with M dividing I, or NULL (then M is ignored). C % 32 == 0;
// scale = sqrt(32), the score divisor. Returns cudaGetLastError().
extern "C" int swin_attention_fwd(const void* xw, const void* wqkv,
                                  const void* bqkv, const void* wproj,
                                  const void* bproj, const void* bias,
                                  const void* smask, void* qkv, void* heads,
                                  void* out, int I, int C, int M, float scale,
                                  int dtype, int route, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bi = (const float*)bias;
  const int8_t* sm = (const int8_t*)smask;
  if (I <= 0 || C <= 0 || C % kHeadDim != 0 || C % kKChunk != 0 ||
      (sm != nullptr && (M <= 0 || I % M != 0)))
    return (int)cudaErrorInvalidValue;
  if (route == 0 && dtype == 0)
    return (int)launch_fma(xw, wqkv, bqkv, wproj, bproj, bi, sm, qkv, heads,
                           out, I, C, M, scale, s);
  if (route == 2 && dtype == 1)
    return (int)launch_split(xw, wqkv, bqkv, wproj, bproj, bi, sm, qkv,
                             heads, out, I, C, M, scale, s);
  if (route == 1 && dtype == 1 && C == Fused::C)
    return (int)launch_fused(xw, wqkv, bqkv, wproj, bproj, bi, sm, out, I, M,
                             scale, s);
  return (int)cudaErrorInvalidValue;
}

// The fused route's shared-memory bytes (at C = 96).
extern "C" int swin_attention_fused_smem() { return mtp::Fused::kBytes; }
