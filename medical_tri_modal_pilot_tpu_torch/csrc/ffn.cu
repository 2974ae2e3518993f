// Fused pre-norm feed-forward block,
//   y = x + drop(W2.drop(relu(W1.StdLN(x) + b1)) + b2),
// forward with in-kernel dropout and per-tile row skipping, and its
// backward. The dropout masks alone are dropout.cu's.
//
// Replaces medical_tri_modal_pilot_tpu/kernels/ffn.py::_call_fwd (body
// _fwd_kernel) and ::_call_bwd (body _bwd_kernel / _bwd_block), reached
// through pallas_ffn.
//
// What bounds it on an H100: two products of 2*R*C*F operations each
// (R = 64*1024 rows, C = 256, F = 1024 on the TIE stream) against R*C
// elements in and out, so the operations, not the bytes, are the limit.
// Unfused, the [R, F] hidden layer would make a round trip through device
// memory (4x the stream); the TPU kernel keeps it in VMEM and so does this
// one: a block owns a row tile, normalises it, and walks d_ff in 64-wide
// chunks, h = relu(LN.W1[:, c] + b1[c]), acc += h.W2[c, :]. Only x is read
// and y written. A tile whose valid flag is 0 (every row past its sample's
// valid length) copies the residual and does no arithmetic.
//
// Two forms of the forward, picked by dtype (kernels/ffn.py::ffn_route):
// ffn_kernel, fp32 FMAs on register tiles over 64-row tiles (fp32, the
// checking dtype); and ffn_fwd_tc_kernel, the bf16 forward on the tensor
// cores, the tile loop of mlp_tc.cuh with StdLN, ReluDropout and FfnOut:
// 128-row tiles, the hidden chunk kept in registers between the two
// products, W1/W2 chunks through the cp.async ring the backward's tile
// pass also uses. The row flags stay per 64 rows: a 128-row tile whose
// two flags are 0 copies x; one with a single live half computes both
// halves and stores x on the dead one. (64-row tiles, two warps a row
// slab splitting each chunk, measured slower on an H100: PERF.md.) Both
// forms, and the tile pass below, are built for C = 64, 128 and 256; at
// C = 512 the route is ffn_split.cu's.
//
// Dropout: the TPU kernel draws from the TPU's hardware generator per
// 256-row block; its bits cannot be reproduced here. This kernel keeps an
// element with the Philox4x32-10 draw keyed by (seed, row, column) of the
// flattened [R, F] hidden and [R, C] output (dropout_keep, common.cuh), so
// the masks do not depend on the tile size and the backward regenerates
// them without storing them. Kept values are divided by q = 1 - p rounded
// to T, as the TPU kernel divides by q in its compute dtype.
//
// Backward: per 64-row tile the kernel recomputes StdLN and the hidden
// chunks, regenerates both masks and writes dx. The weight gradients sum
// over all R rows; the TPU accumulates them in its sequential grid, which
// blocks running in parallel cannot do. So the tile pass writes the
// operands of those sums once, in T (LN, the dropped hidden h_d, dz and
// dh, the values the TPU kernel feeds its products), and wgrad.cu reduces
// them: dW1 = LN^T dh, dW2 = h_d^T dz, in split-K slices summed in a fixed
// order. dgamma and dbeta leave as per-tile partial sums, reduced the same
// way. Deterministic; no atomics. A tile whose flag is 0 writes dx = dy and
// zero partials and nothing else; the wrapper hands the same flags to
// wgrad, which leaves those rows unread.
//
// Two forms of the tile pass, picked by dtype: ffn_bwd_kernel, fp32 FMAs
// on register tiles (fp32, the checking dtype); and ffn_bwd_tc_kernel, the
// bf16 pass on the tensor cores (mma.sync m16n8k16, fp32 accumulation).
// The latter stages the tile's x and dy by cp.async, keeps its LN and dz
// in bf16 in shared memory (the A operands, rounded where the TPU kernel
// rounds) and walks d_ff in 64-wide chunks whose W1 and W2 slices stream
// through a two-stage cp.async ring: h_pre = LN.W1c and dh_d = dz.W2c^T on
// the tensor cores, the ReLU and mask logic of ffn_bwd_kernel on the
// accumulator fragments, dh in bf16 into shared memory, dln += dh.W1c^T
// on the tensor cores into fp32 registers; h_d and dh leave through shared
// memory in 16-byte rows, and the StdLN backward runs on the fragments.
// Timers per phase (clock64) found the products a minor share of a tile;
// what remains around them is arranged so: the hidden's dropout divisions
// are a reciprocal product with one FMA correction, since an IEEE
// division's special-case path costs more than the tile's products; the
// StdLN backward reads x and dy from shared memory, staged during the last
// chunk; Philox draws once for four mask elements (dz) or for two lanes'
// four (the hidden, traded by a shuffle), the fewest the generator allows.
#include "mlp_tc.cuh"

namespace mtp {

// grid (ceil(R/64)); C = 16 * NJC.
template <typename T, int NJC>
__global__ void __launch_bounds__(kThreads) ffn_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, const int8_t* __restrict__ valid,
    T* __restrict__ y, int R, int F, Dropout drop) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1;
  constexpr int LDH = kTile + 1;
  extern __shared__ float smem[];
  float* lns = smem;              // kTile x LDA: StdLN of the tile
  float* hs = lns + kTile * LDA;  // kTile x LDH: hidden chunk
  float* Bs = hs + kTile * LDH;   // kKChunk x C: weight chunk
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, R - r0);
  if (valid != nullptr && valid[tile] == 0) {
    copy_rows<T>(x, y, r0, rows, C, tid);
    return;
  }
  ln_tile<T>(x, r0, R, C, gamma, beta, lns, LDA, tid);
  float acc[4][NJC];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += kTile) {
    float hacc[4][4];
    zero(hacc);
    gemm_tile<T, 4>(lns, LDA, C, w1, F, f0, Bs, hacc, tx, ty, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        float h = fmaxf(
            rnd<T>(rnd<T>(hacc[i][j]) + Num<T>::load(b1[f0 + col])), 0.0f);
        if (drop.on)
          h = dropout_keep(drop.key, drop.thr, 0, drop.row0 + r0 + row,
                           f0 + col)
                  ? rnd<T>(h / drop.q_t) : 0.0f;
        hs[row * LDH + col] = h;
      }
    // gemm_tile's first barrier orders the hidden-chunk writes before
    // its reads
    gemm_tile<T, NJC>(hs, LDH, kTile, w2 + (size_t)f0 * C, C, 0, Bs, acc,
                      tx, ty, tid);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJC; ++j) {
      const int col = tx + 16 * j;
      const size_t off = (size_t)(r0 + row) * C + col;
      float z = rnd<T>(rnd<T>(acc[i][j]) + Num<T>::load(b2[col]));
      if (drop.on)
        z = dropout_keep(drop.key, drop.thr, 1, drop.row0 + r0 + row, col)
                ? rnd<T>(z / drop.q_t) : 0.0f;
      y[off] = Num<T>::store(Num<T>::load(x[off]) + z);
    }
  }
}

// grid (ceil(R/64)). Writes dx [R, C] and gpart [tiles, 2C] (the tile's
// dgamma | dbeta sums) and, on the rows of live tiles, the weight
// gradients' operands ln_o and dz_o [R, C], hd_o and dh_o [R, F].
template <typename T, int NJC>
__global__ void __launch_bounds__(kThreads) ffn_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const int8_t* __restrict__ valid, const T* __restrict__ dy,
    T* __restrict__ dx, T* __restrict__ ln_o, T* __restrict__ dz_o,
    T* __restrict__ hd_o, T* __restrict__ dh_o, float* __restrict__ gpart,
    int R, int F, Dropout drop) {
  constexpr int C = 16 * NJC;
  constexpr int LDA = C + 1;
  constexpr int LDH = kTile + 1;
  extern __shared__ float smem[];
  float* lns = smem;               // kTile x LDA: StdLN of the tile
  float* dzs = lns + kTile * LDA;  // kTile x LDA: dz, rounded to T
  float* hs = dzs + kTile * LDA;   // kTile x LDH: dh chunk
  float* Bs = hs + kTile * LDH;    // kKChunk x max(C, 64): weight chunk
  float* stats = Bs + kKChunk * (C > kTile ? C : kTile);  // 4 x kTile
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(kTile, R - r0);
  float* gp = gpart + (size_t)tile * 2 * C;
  if (valid != nullptr && valid[tile] == 0) {
    // the forward passed x through: dx = dy, nothing reaches the weights
    copy_rows<T>(dy, dx, r0, rows, C, tid);
    for (int c = tid; c < 2 * C; c += kThreads) gp[c] = 0.0f;
    return;
  }
  ln_tile<T>(x, r0, R, C, gamma, beta, lns, LDA, tid, stats);
  for (int e = tid; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    float dz = 0.0f;
    if (r < rows) {
      const size_t off = (size_t)(r0 + r) * C + c;
      dz = Num<T>::load(dy[off]);
      if (drop.on)
        dz = dropout_keep(drop.key, drop.thr, 1, drop.row0 + r0 + r, c)
                 ? dz / drop.q_f : 0.0f;
      dz = rnd<T>(dz);
      dz_o[off] = Num<T>::store(dz);
      ln_o[off] = Num<T>::store(lns[r * LDA + c]);
    }
    dzs[r * LDA + c] = dz;
  }
  __syncthreads();
  float dln[4][NJC];
  zero(dln);
  for (int f0 = 0; f0 < F; f0 += kTile) {
    float hacc[4][4], dacc[4][4];
    zero(hacc);
    zero(dacc);
    gemm_tile<T, 4>(lns, LDA, C, w1, F, f0, Bs, hacc, tx, ty, tid);
    // dh_d = dz . W2[f0:f0+64, :]^T
    gemm_tile_t<T, 4>(dzs, LDA, C, w2 + (size_t)f0 * C, C, 0, Bs, dacc, tx,
                      ty, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j, f = f0 + col;
        const float hpre = rnd<T>(rnd<T>(hacc[i][j]) + Num<T>::load(b1[f]));
        float hd = fmaxf(hpre, 0.0f);
        float dh = dacc[i][j];
        if (drop.on) {
          const bool keep =
              dropout_keep(drop.key, drop.thr, 0, drop.row0 + r0 + row, f);
          hd = keep ? rnd<T>(hd / drop.q_t) : 0.0f;
          dh = keep ? dh / drop.q_f : 0.0f;
        }
        dh = rnd<T>(hpre > 0.0f ? dh : 0.0f);
        hs[row * LDH + col] = dh;
        if (row < rows) {
          const size_t off = (size_t)(r0 + row) * F + f;
          hd_o[off] = Num<T>::store(hd);
          dh_o[off] = Num<T>::store(dh);
        }
      }
    // dln += dh . W1[:, f0:f0+64]^T (the first barrier orders hs)
    gemm_tile_t<T, NJC>(hs, LDH, kTile, w1 + f0, F, 0, Bs, dln, tx, ty, tid);
  }
  stdln_backward_tile<T, NJC, false>(dln, x, dy, dx, r0, rows, gamma, stats,
                                     Bs, gp, tx, ty, tid);
}

// The bf16 tile pass on the tensor cores. Shared memory (bf16 tiles,
// pitch width + 8): lns and dzs [64][C], the weight ring [2 stages] x
// (W1[:, f0:f0+64] as [C][64], W2[f0:f0+64, :] as [64][C]), dhs and hds
// [64][64], then the StdLN stats fp32 [4][64]. Before the chunk loop the
// ring's second stage holds the tile's x and dy (staged by cp.async with
// the first weight chunk); during the last chunk they are staged again
// into its free stage, for the StdLN backward, whose cross-warp sums go
// through the other stage once the loop is done. The ring's stage and its
// loads are the forward's (mlp_tc.cuh::MlpStage, stage_chunk), and so are
// the dropout's keep bits (keep_bits). 256 threads: warp w
// computes rows 16 (w & 3) .. + 16 of the tile, hidden columns
// 32 (w >> 2) .. + 32 of each chunk and dln columns (C / 2)(w >> 2) ..
// + C / 2. The weight sums' operands leave through shared memory in
// 16-byte rows. grid (ceil(R/64)).
template <int C>
struct FfnBwdTc {
  static constexpr int LDC = pitch(C), LDF = pitch(kFch);
  static constexpr int LN = kTile * LDC;   // lns, dzs; x, dy
  static constexpr int W1 = MlpStage<C>::W1;  // a W1 chunk, [c][f]
  static constexpr int W2 = MlpStage<C>::W2;  // a W2 chunk, [f][c]
  static constexpr int DH = kTile * LDF;   // dhs, hds
  static constexpr int RING = 2 * (W1 + W2);
  static constexpr int kBytes = (2 * LN + RING + 2 * DH) * (int)sizeof(bf16) +
                                4 * kTile * (int)sizeof(float);
  static_assert(2 * LN <= W1 + W2, "x and dy fit in a stage of the ring");
  static_assert((4 * kTile + 8 * C) * sizeof(float) <=
                    (W1 + W2) * sizeof(bf16),
                "the epilogue's sums fit in a stage of the ring");
};

// rows [0, rows) x cols [0, width) of a shared bf16 tile (pitch ld,
// width % 8 == 0) to rows r0 .. r0 + rows of the row-major matrix dst
// (leading dimension ldd), 16 bytes per store
static __device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                                  int ldd, int r0, int rows,
                                                  int width, const bf16* src,
                                                  int ld, int tid) {
  const int per_row = width >> 3;
  for (int e = tid; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) << 3;
    *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// blocks an SM that the tile pass's launch bounds ask for
constexpr int kFfnBwdTcBlocks = 1;

template <int NJC>
__global__ void __launch_bounds__(kThreads, kFfnBwdTcBlocks) ffn_bwd_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    const int8_t* __restrict__ valid, const bf16* __restrict__ dy,
    bf16* __restrict__ dx, bf16* __restrict__ ln_o, bf16* __restrict__ dz_o,
    bf16* __restrict__ hd_o, bf16* __restrict__ dh_o,
    float* __restrict__ gpart, int R, int F, Dropout drop) {
  constexpr int C = 16 * NJC;
  using L = FfnBwdTc<C>;
  extern __shared__ __align__(16) unsigned char ffn_smem[];
  bf16* lns = reinterpret_cast<bf16*>(ffn_smem);
  bf16* dzs = lns + L::LN;
  bf16* ring = dzs + L::LN;  // [stage][W1 chunk | W2 chunk]
  bf16* dhs = ring + L::RING;
  bf16* hds = dhs + L::DH;
  float* stats = reinterpret_cast<float*>(hds + L::DH);
  const int tile = blockIdx.x, r0 = tile * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = min(kTile, R - r0);
  float* gp = gpart + (size_t)tile * 2 * C;
  if (valid != nullptr && valid[tile] == 0) {
    // the forward passed x through: dx = dy, nothing reaches the weights
    copy_rows16<C>(dy, dx, r0, rows, tid);
    for (int c = tid; c < 2 * C; c += kThreads) gp[c] = 0.0f;
    return;
  }
  // the tile's x and dy into the ring's second stage (rows past R zero),
  // the first weight chunk into its first
  bf16* xs = ring + L::W1 + L::W2;
  bf16* dys = xs + L::LN;
  stage_rows<C, kThreads>(xs, L::LDC, x + (size_t)r0 * C, C, kTile, rows,
                          tid);
  stage_rows<C, kThreads>(dys, L::LDC, dy + (size_t)r0 * C, C, kTile, rows,
                          tid);
  stage_chunk<C, kThreads>(ring, w1, w2, 0, F, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // StdLN of the tile (ln_tile's arithmetic and order, one warp per row),
  // rounded to bf16; rows past R are zeros, so their LN is beta and their
  // dz 0: they add nothing and are never stored
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float xv[C / 32];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      xv[j] = bf(xs[r * L::LDC + lane + 32 * j]);
      s += xv[j];
    }
    const float mu = warp_sum(s) / (float)C;
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const float d = xv[j] - mu;
      v += d * d;
    }
    const float var = warp_sum(v) / (float)(C - 1);
    const float sd = sqrtf(fmaxf(var, kVarFloor));
    const float inv = 1.0f / (sd + kStdLnEps);
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      lns[r * L::LDC + c] =
          __float2bfloat16_rn(((xv[j] - mu) * inv) * gamma[c] + beta[c]);
    }
    if (lane == 0) {
      stats[r] = mu;
      stats[kTile + r] = inv;
      stats[2 * kTile + r] = sd;
      stats[3 * kTile + r] = var;
    }
  }
  // dz = drop(dy) / q rounded to bf16, four columns (one Philox draw) per
  // thread
  for (int e = tid; e < kTile * (C / 4); e += kThreads) {
    const int r = e / (C / 4), c = (e - r * (C / 4)) * 4;
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = bf(dys[r * L::LDC + c + k]);
    if (drop.on) {
      const uint4 w = philox4x32_10(
          make_uint4((uint32_t)c >> 2, (uint32_t)(drop.row0 + r0 + r), 1u, 0u),
          drop.key);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        d[k] = u[k] < drop.thr ? d[k] / drop.q_f : 0.0f;
    }
    uint2 packed;
    packed.x = pack_bf16(d[0], d[1]);
    packed.y = pack_bf16(d[2], d[3]);
    *reinterpret_cast<uint2*>(dzs + r * L::LDC + c) = packed;
  }
  __syncthreads();
  store_rows(ln_o, C, r0, rows, C, lns, L::LDC, tid);
  store_rows(dz_o, C, r0, rows, C, dzs, L::LDC, tid);

  const int rs = warp & 3, ch = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  float dln[NJC][4];
#pragma unroll
  for (int j = 0; j < NJC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dln[j][e] = 0.0f;
  const float iq_t = 1.0f / drop.q_t, iq_f = 1.0f / drop.q_f;
  const int nch = F / kFch;
  for (int it = 0; it < nch; ++it) {
    const int f0 = it * kFch, st = it & 1;
    cp_async_wait<0>();
    // chunk it has landed; every warp is done with chunk it - 1, whose
    // stage is refilled next (at it == 0 the stage held x and dy), and
    // with dhs and hds
    __syncthreads();
    if (it + 1 < nch) {
      stage_chunk<C, kThreads>(ring + (st ^ 1) * (L::W1 + L::W2), w1, w2,
                               f0 + kFch, F, tid);
    } else {
      // the last chunk: x and dy again, for the StdLN backward
      bf16* xe = ring + (st ^ 1) * (L::W1 + L::W2);
      stage_rows<C, kThreads>(xe, L::LDC, x + (size_t)r0 * C, C, kTile, rows,
                              tid);
      stage_rows<C, kThreads>(xe + L::LN, L::LDC, dy + (size_t)r0 * C, C,
                              kTile, rows, tid);
    }
    cp_async_commit();
    const bf16* s1 = ring + st * (L::W1 + L::W2);
    const bf16* s2 = s1 + L::W1;
    // b1 at the lane's columns, read ahead of the products
    uint32_t bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bias[j] = *reinterpret_cast<const uint32_t*>(b1 + f0 + 32 * ch + 8 * j +
                                                   2 * t);
    float hacc[4][4], dacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[j][e] = dacc[j][e] = 0.0f;
    // h_pre = LN . W1c and dh_d = dz . W2c^T, 16 rows x 32 columns
#pragma unroll 4
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t al[4], ad[4];
      ldsm_x4(al, frag_a(lns, L::LDC, 16 * rs, kk, lane));
      ldsm_x4(ad, frag_a(dzs, L::LDC, 16 * rs, kk, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, frag_b_kn(s1, L::LDF, kk, 32 * ch + 16 * np, lane));
        mma16816(hacc[2 * np], al, b[0], b[1]);
        mma16816(hacc[2 * np + 1], al, b[2], b[3]);
        ldsm_x4(b, frag_b_nk(s2, L::LDC, 32 * ch + 16 * np, kk, lane));
        mma16816(dacc[2 * np], ad, b[0], b[1]);
        mma16816(dacc[2 * np + 1], ad, b[2], b[3]);
      }
    }
    // ffn_bwd_kernel's ReLU and mask logic on the fragments, the hidden
    // mask's keep bits drawn once per four elements (keep_bits)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // keep bits of rows g (bits0) and g + 8 (bits1), two columns each
      uint32_t bits0 = 3u, bits1 = 3u;
      if (drop.on)
        keep_bits(drop, 0, f0 + 32 * ch + 8 * j, r0 + 16 * rs + g, t, bits0,
                  bits1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t bits = h == 0 ? bits0 : bits1;
        const int r = 16 * rs + g + 8 * h, fc = 32 * ch + 8 * j + 2 * t;
        float hd[2], dh[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bj = __uint_as_float(e == 0 ? bias[j] << 16
                                                  : bias[j] & 0xffff0000u);
          const float hpre = rnd<bf16>(rnd<bf16>(hacc[j][2 * h + e]) + bj);
          hd[e] = fmaxf(hpre, 0.0f);
          dh[e] = dacc[j][2 * h + e];
          if (drop.on) {
            const bool keep = (bits >> e) & 1u;
            hd[e] = keep ? rnd<bf16>(div_q(hd[e], drop.q_t, iq_t)) : 0.0f;
            dh[e] = keep ? div_q(dh[e], drop.q_f, iq_f) : 0.0f;
          }
          dh[e] = rnd<bf16>(hpre > 0.0f ? dh[e] : 0.0f);
        }
        *reinterpret_cast<uint32_t*>(dhs + r * L::LDF + fc) =
            pack_bf16(dh[0], dh[1]);
        *reinterpret_cast<uint32_t*>(hds + r * L::LDF + fc) =
            pack_bf16(hd[0], hd[1]);
      }
    }
    __syncthreads();
    store_rows(hd_o + f0, F, r0, rows, kFch, hds, L::LDF, tid);
    store_rows(dh_o + f0, F, r0, rows, kFch, dhs, L::LDF, tid);
    // dln += dh . W1c^T, 16 rows x C / 2 columns (W1c is [c][f]: the B
    // operand stored [n][k])
#pragma unroll
    for (int kk = 0; kk < kFch; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, frag_a(dhs, L::LDF, 16 * rs, kk, lane));
#pragma unroll
      for (int np = 0; np < NJC / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, frag_b_nk(s1, L::LDF, (C / 2) * ch + 16 * np, kk, lane));
        mma16816(dln[2 * np], a, b[0], b[1]);
        mma16816(dln[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // The StdLN backward on the fragments (stdln_backward_tile's arithmetic,
  // ROUND_TWICE false, its sums in another order): x and dy from the free
  // stage of the ring, the cross-warp sums through the other stage.
  const int last = (nch - 1) & 1;
  const bf16* xe = ring + (last ^ 1) * (L::W1 + L::W2);
  const bf16* dye = xe + L::LN;
  float* rrow = reinterpret_cast<float*>(ring + last * (L::W1 + L::W2));
  float* rcol = rrow + 2 * 2 * kTile;  // [4 row slabs][2C]
  float A[2] = {0.0f, 0.0f}, S[2] = {0.0f, 0.0f};
  float gs[NJC][2], bs[NJC][2];
#pragma unroll
  for (int j = 0; j < NJC; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = (C / 2) * ch + 8 * j + 2 * t + e;
      const float gam = gamma[col];
      gs[j][e] = bs[j][e] = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rs + g + 8 * h;
        const float c = stats[kTile + r];
        const float xhat = (bf(xe[r * L::LDC + col]) - stats[r]) * c;
        const float d = dln[j][2 * h + e];
        gs[j][e] += d * xhat;
        bs[j][e] += d;
        const float dxhat = d * gam;
        A[h] += dxhat * (xhat / c);
        S[h] += dxhat;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      A[h] += __shfl_xor_sync(0xffffffffu, A[h], off);
      S[h] += __shfl_xor_sync(0xffffffffu, S[h], off);
    }
    if (t == 0) {
      const int r = 16 * rs + g + 8 * h;
      rrow[(ch * kTile + r) * 2] = A[h];
      rrow[(ch * kTile + r) * 2 + 1] = S[h];
    }
  }
  // column sums over the warp's 16 rows: the 8 lanes that share t
#pragma unroll
  for (int j = 0; j < NJC; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        gs[j][e] += __shfl_xor_sync(0xffffffffu, gs[j][e], off);
        bs[j][e] += __shfl_xor_sync(0xffffffffu, bs[j][e], off);
      }
      if (g == 0) {
        const int col = (C / 2) * ch + 8 * j + 2 * t + e;
        rcol[rs * 2 * C + col] = gs[j][e];
        rcol[rs * 2 * C + C + col] = bs[j][e];
      }
    }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * rs + g + 8 * h;
    if (r >= rows) continue;
    const float a = rrow[r * 2] + rrow[(kTile + r) * 2];
    const float mean = (rrow[r * 2 + 1] + rrow[(kTile + r) * 2 + 1]) / (float)C;
    const float mu = stats[r], c = stats[kTile + r];
    const float sd = stats[2 * kTile + r], var = stats[3 * kTile + r];
    const float k2 = (c * c) * a * (var > kVarFloor ? 1.0f : 0.0f) /
                     ((float)(C - 1) * sd);
#pragma unroll
    for (int j = 0; j < NJC; ++j) {
      const int col = (C / 2) * ch + 8 * j + 2 * t;
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xhat = (bf(xe[r * L::LDC + col + e]) - mu) * c;
        const float dxhat = dln[j][2 * h + e] * gamma[col + e];
        o[e] = bf(dye[r * L::LDC + col + e]) +
               (c * (dxhat - mean) - k2 * (xhat / c));
      }
      *reinterpret_cast<uint32_t*>(dx + (size_t)(r0 + r) * C + col) =
          pack_bf16(o[0], o[1]);
    }
  }
  for (int col = tid; col < 2 * C; col += kThreads)
    gp[col] = rcol[col] + rcol[2 * C + col] + rcol[4 * C + col] +
              rcol[6 * C + col];
}

// The bf16 forward on the tensor cores: the tile loop of mlp_tc.cuh with
// StdLN, ReluDropout and FfnOut over 128-row tiles. A tile whose 64-row
// flags are all 0 copies x. grid (ceil(R / kMlpRows)).

// blocks an SM that the forward's launch bounds ask for at width C: two
// while two blocks' rows and rings fit an SM
__host__ __device__ constexpr int ffn_fwd_min_blocks(int C) {
  return C <= 96 ? 2 : 1;
}

template <int C>
__global__ void __launch_bounds__(kMlpThreads, ffn_fwd_min_blocks(C))
    ffn_fwd_tc_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                      const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                      const int8_t* __restrict__ valid, bf16* __restrict__ y,
                      int R, int F, Dropout drop) {
  extern __shared__ __align__(16) unsigned char ffn_fwd_smem[];
  const int r0 = blockIdx.x * kMlpRows;
  if (valid != nullptr) {
    bool live = false;
    for (int k = 0; k < kMlpRows / kTile && r0 + k * kTile < R; ++k)
      live |= valid[r0 / kTile + k] != 0;
    if (!live) {
      copy_rows16<C>(x, y, r0, min(kMlpRows, R - r0), threadIdx.x);
      return;
    }
  }
  const float iq = 1.0f / drop.q_t;
  mlp_tile<C>(x, y, w1, w2, R, F, r0, StdLN{gamma, beta},
              ReluDropout{b1, drop, iq}, FfnOut{b2, valid, drop, iq, R},
              ffn_fwd_smem);
}

template <typename T, int NJC>
static cudaError_t launch(const void* x, const float* gamma,
                          const float* beta, const void* w1, const void* b1,
                          const void* w2, const void* b2,
                          const int8_t* valid, void* y, int R, int F,
                          Dropout drop, cudaStream_t stream) {
  constexpr int C = 16 * NJC;
  const size_t smem = sizeof(float) *
      (kTile * (C + 1) + kTile * (kTile + 1) + kKChunk * C);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T, NJC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kTile - 1) / kTile;
  ffn_kernel<T, NJC><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, valid, (T*)y, R, F, drop);
  return cudaGetLastError();
}

template <int C>
static cudaError_t launch_fwd_tc(const void* x, const float* gamma,
                                 const float* beta, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, const int8_t* valid, void* y,
                                 int R, int F, Dropout drop,
                                 cudaStream_t stream) {
  constexpr int bytes = MlpTc<C>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kMlpRows - 1) / kMlpRows;
  ffn_fwd_tc_kernel<C><<<blocks, kMlpThreads, bytes, stream>>>(
      (const bf16*)x, gamma, beta, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, valid, (bf16*)y, R, F, drop);
  return cudaGetLastError();
}

template <typename T, int NJC>
static cudaError_t launch_bwd(const void* x, const float* gamma,
                              const float* beta, const void* w1,
                              const void* b1, const void* w2,
                              const int8_t* valid, const void* dy, void* dx,
                              void* ln_o, void* dz_o, void* hd_o, void* dh_o,
                              float* gpart, int R, int F, Dropout drop,
                              cudaStream_t stream) {
  constexpr int C = 16 * NJC;
  const size_t smem = sizeof(float) *
      (2 * kTile * (C + 1) + kTile * (kTile + 1) +
       kKChunk * (C > kTile ? C : kTile) + 4 * kTile);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_kernel<T, NJC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kTile - 1) / kTile;
  ffn_bwd_kernel<T, NJC><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, gamma, beta, (const T*)w1, (const T*)b1, (const T*)w2,
      valid, (const T*)dy, (T*)dx, (T*)ln_o, (T*)dz_o, (T*)hd_o, (T*)dh_o,
      gpart, R, F, drop);
  return cudaGetLastError();
}

template <int NJC>
static cudaError_t launch_bwd_tc(const void* x, const float* gamma,
                                 const float* beta, const void* w1,
                                 const void* b1, const void* w2,
                                 const int8_t* valid, const void* dy,
                                 void* dx, void* ln_o, void* dz_o,
                                 void* hd_o, void* dh_o, float* gpart, int R,
                                 int F, Dropout drop, cudaStream_t stream) {
  constexpr int bytes = FfnBwdTc<16 * NJC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_tc_kernel<NJC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kTile - 1) / kTile;
  ffn_bwd_tc_kernel<NJC><<<blocks, kThreads, bytes, stream>>>(
      (const bf16*)x, gamma, beta, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, valid, (const bf16*)dy, (bf16*)dx, (bf16*)ln_o,
      (bf16*)dz_o, (bf16*)hd_o, (bf16*)dh_o, gpart, R, F, drop);
  return cudaGetLastError();
}

}  // namespace mtp

// The forward: fp32 FMAs (ffn_kernel) for dtype 0, the tensor cores
// (ffn_fwd_tc_kernel) for dtype 1 (bf16), for x, w1 [C, F], b1, w2 [F, C],
// b2 and y; gamma and beta fp32; valid: int8 [ceil(R/64)] flags of 64-row
// tiles or NULL (every tile live). C in {64, 128, 256} (512: ffn_split.cu),
// F % 64 == 0. Dropout when drop != 0: keep below thr, kept values divided
// by q_t; the masks' rows counted from row0 (a data rank's first row of
// the whole batch). Returns cudaGetLastError().
extern "C" int ffn_fwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* valid, void* y, int R,
                       int C, int F, unsigned long long seed,
                       unsigned int thr, float q_t, int drop, int row0,
                       int dtype, void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* v = (const int8_t*)valid;
  const Dropout d = make_dropout(seed, thr, q_t, 1.0f, drop, row0);
  if (R < 0 || F <= 0 || F % kTile != 0 || row0 < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
#define MTP_FWD(CC) \
  if (dtype == 0 && C == CC) \
    return (int)launch<float, CC / 16>(x, g, be, w1, b1, w2, b2, v, y, R, F, d, s); \
  if (dtype == 1 && C == CC) \
    return (int)launch_fwd_tc<CC>(x, g, be, w1, b1, w2, b2, v, y, R, F, d, s);
  MTP_FWD(64) MTP_FWD(128) MTP_FWD(256)
#undef MTP_FWD
  return (int)cudaErrorInvalidValue;
}

// shared-memory bytes of the bf16 forward (ffn_fwd_tc_kernel) at width C,
// 0 for a width it is not built for
extern "C" int ffn_tc_smem(int C) {
  using namespace mtp;
  if (C == 256) return MlpTc<256>::kBytes;
  if (C == 128) return MlpTc<128>::kBytes;
  if (C == 64) return MlpTc<64>::kBytes;
  return 0;
}

// blocks an SM that the fused bf16 kernels' launch bounds ask for at width
// C (0 ffn_fwd_tc_kernel, 1 ffn_bwd_tc_kernel), 0 for a width they are not
// built for: kernels/ffn.py::tc_min_blocks mirrors this
extern "C" int ffn_tc_min_blocks(int kernel, int C) {
  using namespace mtp;
  if (C != 64 && C != 128 && C != 256) return 0;
  switch (kernel) {
    case 0: return ffn_fwd_min_blocks(C);
    case 1: return kFfnBwdTcBlocks;
  }
  return -1;
}

// The backward tile pass: fp32 FMAs for dtype 0, the tensor cores for
// dtype 1 (bf16). dy, dx, ln_o, dz_o [R, C] and hd_o, dh_o [R, F] in the
// dtype (ln_o .. dh_o written on the rows of live tiles only); gpart fp32
// [ceil(R/64), 2C]. Dropout as ffn_fwd, with q_f = q in fp32 dividing the
// cotangents.
extern "C" int ffn_bwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* valid, const void* dy, void* dx,
                       void* ln_o, void* dz_o, void* hd_o, void* dh_o,
                       void* gpart, int R, int C, int F,
                       unsigned long long seed, unsigned int thr, float q_t,
                       float q_f, int drop, int row0, int dtype,
                       void* stream) {
  using namespace mtp;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* be = (const float*)beta;
  const int8_t* v = (const int8_t*)valid;
  float* gp = (float*)gpart;
  const Dropout d = make_dropout(seed, thr, q_t, q_f, drop, row0);
  if (F <= 0 || F % kTile != 0 || row0 < 0) return (int)cudaErrorInvalidValue;
#define MTP_BWD(CC) \
  if (dtype == 0 && C == CC) \
    return (int)launch_bwd<float, CC / 16>(x, g, be, w1, b1, w2, v, dy, dx, ln_o, dz_o, hd_o, dh_o, gp, R, F, d, s); \
  if (dtype == 1 && C == CC) \
    return (int)launch_bwd_tc<CC / 16>(x, g, be, w1, b1, w2, v, dy, dx, ln_o, dz_o, hd_o, dh_o, gp, R, F, d, s);
  MTP_BWD(64) MTP_BWD(128) MTP_BWD(256)
#undef MTP_BWD
  return (int)cudaErrorInvalidValue;
}
