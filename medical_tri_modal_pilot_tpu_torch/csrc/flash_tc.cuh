// The flash-attention tile loops on the tensor cores (mma.sync m16n8k16,
// bf16 operands, fp32 accumulation) that both attention kernels of the
// bf16 route share: the attention block (attn_block.cu, attn_block_bwd.cu,
// q|k|v in one [B, L, 3C] scratch, a key mask, Lq == Lk) and the masked
// attention (attention.cu, q, k and v apart as [B, L, H * DH], Lq and Lk
// apart, no mask, a key mask or a block mask).
//
// Each loop works on one (sample, head), from base pointers to its first
// row and its head's first column: q [Lq rows, leading dimension ldq], k
// and v [Lk rows, ldkv], dO [Lq rows, ldo], the head's (m, l) stats
// [Lq][2] and delta [Lq]; a mask provider (NoMask, KeyMask, BlockMask)
// gives the masked bits of a 64-key span of a query row or of a 64-row
// span of a key. One block of kTcThreads threads, warp w owning rows
// 16 w .. 16 w + 15 of the block's 64-row tile (q rows forward and in dQ,
// keys in dK/dV); tiles of the other side stream through a two-stage
// cp.async ring. A warp whose 16 rows all lie past the array does no
// products (it still stages its share and meets every barrier): inside
// the dK/dV and dQ loops, and in the forward by calling flash_fwd_idle
// in place of flash_fwd_tile.
//
// Scores: s = (q . k) * mult; a masked (query, key) pair scores -65504, so
// a query whose keys are all masked attends uniformly over them; a key
// past Lk (tile padding) scores -inf and leaves the softmax. Roundings
// follow the TPU kernels: P is rounded to bf16 from the C fragments
// before P V, l is summed from the fp32 P; the backward's P is
// exp(s - m) / l from the saved stats, rounded to bf16 before
// dV += P^T dO; dS is rounded to bf16 before its products. With SPLIT
// (the block-mask attention block, attn_block_bwd.cu) dS enters dK and
// dQ as two bf16 parts (ds_frags): that rounding and what it leaves, so
// those products carry about 16 bits of dS (PERF.md §6).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace mtp {

// 4 warps, warp w owns rows 16 w .. 16 w + 15 of a 64-row tile
constexpr int kTcThreads = 128;

// shared-memory bytes of the loops (bf16 tiles of pitch DH + 8): the
// forward, q [64][DH] and a two-stage ring of k and v [64][DH]
__host__ __device__ constexpr int attn_tc_smem(int dh) {
  return 2 * 5 * kTile * pitch(dh);
}
// dK/dV: k and v [64][DH], a two-stage ring of q and dO [64][DH] with the
// rows' m, 1 / l and delta (fp32 [2][3][64])
__host__ __device__ constexpr int dkv_tc_smem(int dh) {
  return 2 * 6 * kTile * pitch(dh) + 4 * 2 * 3 * kTile;
}
// dQ: q and dO [64][DH], a two-stage ring of k and v
__host__ __device__ constexpr int dq_tc_smem(int dh) {
  return 2 * 6 * kTile * pitch(dh);
}

// blocks an SM that a flash kernel's launch bounds ask for: `blocks` up
// to DH = 64; at DH = 128 two, whatever the loop (a thread's 16 n8 tiles
// of the output or of dK and dV take 64 and 128 fp32 registers, and the
// tiles of pitch 136 take 85-104 KB a block)
__host__ __device__ constexpr int flash_min_blocks(int dh, int blocks) {
  return dh > 64 ? 2 : blocks;
}
// the `blocks` of the forward, dK/dV and dQ loops' kernels
constexpr int kFlashFwdBlocks = 4, kFlashDkvBlocks = 3, kFlashDqBlocks = 4;

// rows [row0, row0 + 64) x DH columns of a row-major bf16 matrix (nrows
// rows, leading dimension ld, src at the first column) into a shared tile
// of pitch pitch(DH), by kTcThreads threads; rows past nrows are
// zero-filled and not read
template <int DH>
static __device__ __forceinline__ void stage_head(bf16* dst,
                                                  const bf16* __restrict__ src,
                                                  int row0, int nrows, int ld,
                                                  int tid) {
  constexpr int per_row = DH / 8, LD = pitch(DH);
  for (int e = tid; e < kTile * per_row; e += kTcThreads) {
    const int r = e / per_row, c = (e % per_row) * 8;
    const bool in = row0 + r < nrows;
    cp_async16(dst + r * LD + c, in ? src + (size_t)(row0 + r) * ld + c : src,
               in);
  }
}

// One past the last key whose mask byte is 0, or Lk when every key is
// masked (such a query attends uniformly over all Lk keys; keys masked
// past the last live one take exp(-65504 - m) = 0 otherwise, so a key loop
// may stop there). mb: one sample's mask row [Lk]. By one warp, every lane
// getting the result; 16 independent byte loads per lane in flight.
static __device__ __forceinline__ int scan_key_end(
    const int8_t* __restrict__ mb, int Lk, int lane) {
  constexpr int kBatch = 16;
  int last = -1;
  for (int base = 0; base < Lk; base += 32 * kBatch) {
    int8_t byte[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int key = base + 32 * i + lane;
      byte[i] = key < Lk ? mb[key] : (int8_t)1;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (byte[i] == 0) last = base + 32 * i + lane;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  return last < 0 ? Lk : last + 1;
}

// dS of a warp's 16 x 16 block (C fragments d) as the A fragments of its
// products: rounded to bf16 (hi) and, with SPLIT, the bf16 of what that
// rounding leaves (lo), a second product whose sum with the first carries
// about 16 bits of each value
template <bool SPLIT>
static __device__ __forceinline__ void ds_frags(const float (&d)[2][4],
                                                uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = d[i >> 1][2 * (i & 1)], b = d[i >> 1][2 * (i & 1) + 1];
    hi[i] = pack_bf16(a, b);
    if constexpr (SPLIT) {
      const __nv_bfloat162 h =
          *reinterpret_cast<const __nv_bfloat162*>(&hi[i]);
      lo[i] = pack_bf16(a - bf(h.x), b - bf(h.y));
    }
  }
}

// Bits 0 and 1 of each byte j of the 64-bit span lo | hi << 32 (shifted
// right by 2 t beforehand: the columns 8 j + 2 t + (e & 1) of a lane's C
// fragments over a 64-wide span), gathered into bits 2 j and 2 j + 1 of a
// 16-bit word: one register where the masks of several spans are held
// across the products. gather_pairs moves bits
// 8 i and 8 i + 1 of x to 2 i + 24 and 2 i + 25 by one product (the
// other partial products land, without carries, below bit 24 or past 31)
// and shifts them down.
static __device__ __forceinline__ uint32_t gather_pairs(uint32_t x) {
  return ((x & 0x03030303u) * 0x01041040u) >> 24;
}
static __device__ __forceinline__ uint32_t frag_bits(uint32_t lo,
                                                     uint32_t hi) {
  return gather_pairs(lo) | gather_pairs(hi) << 8;
}

// The columns at or past live (>= 1) of a 64-wide span, as rows() gives
// masked keys: columns 0 .. 31 in lo, 32 .. 63 in hi, shifted right by 2 t
static __device__ __forceinline__ void pad_words(int live, int t,
                                                 uint32_t& lo, uint32_t& hi) {
  lo = (live >= 32 ? 0u : ~0u << live) >> (2 * t);
  hi = (live >= 64 ? 0u : live <= 32 ? ~0u : ~0u << (live - 32)) >> (2 * t);
}

// Mask providers, for the masked pairs of a lane's C fragments (g =
// lane >> 2, t = lane & 3, e the fragment element):
//   rows(r0, k0, lane, lo, hi): S = Q K^T of 16 query rows x 64 keys; for
//     query r0 + g + 8 h the masked keys k0 .. k0 + 31 (lo[h]) and
//     k0 + 32 .. k0 + 63 (hi[h]) shifted right by 2 t, so that key
//     k0 + 8 j + 2 t + (e & 1) is bit 8 (j & 3) + (e & 1) of lo[h] (j < 4)
//     or hi[h] (j >= 4): a test at a constant position of a register;
//   cols(q0, c0, lane): S^T = K Q^T of 16 keys x 64 query rows; bit
//     2 j + (e & 1) + 16 h of one word for query q0 + 8 j + 2 t + (e & 1)
//     against key c0 + g + 8 h.
// Pairs past the arrays read as unmasked. Called by a whole warp (the
// ballots). key_end(lane): the key loop's bound (scan_key_end for a key
// mask, else Lk). tile(qt, kt): the class of the 64 x 64 tile of query
// tile qt and key tile kt (kTileDead: every pair masked, the loops skip
// it; kTileFull: none, rows() and cols() are not called; kTileMixed: the
// masked bits are read). at(mask, tmap, b, Lq, Lk): the provider of sample
// b from a [B, Lk] or [B, Lq, Lk] int8 mask and, for a block mask, its
// tile map (or NULL: every tile mixed).
constexpr int8_t kTileDead = 0, kTileFull = 1, kTileMixed = 2;

struct NoMask {
  int Lk;
  static __device__ __forceinline__ NoMask at(const int8_t*, const int8_t*,
                                              int, int, int Lk) {
    return NoMask{Lk};
  }
  __device__ __forceinline__ int key_end(int) const { return Lk; }
  __device__ __forceinline__ int tile(int, int) const { return kTileFull; }
  __device__ __forceinline__ void rows(int, int, int, uint32_t (&lo)[2],
                                       uint32_t (&hi)[2]) const {
    lo[0] = lo[1] = hi[0] = hi[1] = 0u;
  }
  __device__ __forceinline__ uint32_t cols(int, int, int) const { return 0u; }
};

// a key mask: mb one sample's int8 row [Lk], nonzero = masked; the keys of
// a 64-key span by ballot, the same for every query row
struct KeyMask {
  const int8_t* __restrict__ mb;
  int Lk;
  static __device__ __forceinline__ KeyMask at(const int8_t* mask,
                                               const int8_t*, int b, int,
                                               int Lk) {
    return KeyMask{mask + (size_t)b * Lk, Lk};
  }
  __device__ __forceinline__ int key_end(int lane) const {
    return scan_key_end(mb, Lk, lane);
  }
  __device__ __forceinline__ int tile(int, int) const { return kTileMixed; }
  __device__ __forceinline__ void rows(int, int k0, int lane,
                                       uint32_t (&lo)[2],
                                       uint32_t (&hi)[2]) const {
    const int a = k0 + lane, c = a + 32, sh = 2 * (lane & 3);
    lo[0] = lo[1] = __ballot_sync(0xffffffffu, a < Lk && mb[a] != 0) >> sh;
    hi[0] = hi[1] = __ballot_sync(0xffffffffu, c < Lk && mb[c] != 0) >> sh;
  }
  __device__ __forceinline__ uint32_t cols(int, int c0, int lane) const {
    uint32_t bits = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = c0 + (lane >> 2) + 8 * h;
      if (key < Lk && mb[key] != 0) bits |= 0xffffu << (16 * h);
    }
    return bits;
  }
};

// a block mask: mb one sample's int8 [Lq][Lk], nonzero = masked; a 64-bit
// span per (query row, 64 keys) or (key, 64 query rows) by ballot over the
// lanes, each lane keeping the two it needs. tm: the sample's tile map
// [ceil(Lq/64)][nk] (block_tile_map_kernel, attn_block.cu), or NULL
struct BlockMask {
  const int8_t* __restrict__ mb;
  const int8_t* __restrict__ tm;
  int Lq, Lk, nk;
  static __device__ __forceinline__ BlockMask at(const int8_t* mask,
                                                 const int8_t* tmap, int b,
                                                 int Lq, int Lk) {
    const int nq = (Lq + kTile - 1) / kTile, nk = (Lk + kTile - 1) / kTile;
    return BlockMask{mask + (size_t)b * Lq * Lk,
                     tmap ? tmap + (size_t)b * nq * nk : nullptr, Lq, Lk,
                     nk};
  }
  __device__ __forceinline__ int key_end(int) const { return Lk; }
  __device__ __forceinline__ int tile(int qt, int kt) const {
    return tm ? tm[qt * nk + kt] : kTileMixed;
  }
  __device__ __forceinline__ void rows(int r0, int k0, int lane,
                                       uint32_t (&lo)[2],
                                       uint32_t (&hi)[2]) const {
    const int a = k0 + lane, c = a + 32, g = lane >> 2, sh = 2 * (lane & 3);
    lo[0] = lo[1] = hi[0] = hi[1] = 0u;
    for (int r = 0; r < 16; ++r) {
      const int q = r0 + r;
      const int8_t* row = mb + (size_t)q * Lk;
      const uint32_t wl =
          __ballot_sync(0xffffffffu, q < Lq && a < Lk && row[a] != 0) >> sh;
      const uint32_t wh =
          __ballot_sync(0xffffffffu, q < Lq && c < Lk && row[c] != 0) >> sh;
      if (r == g) lo[0] = wl, hi[0] = wh;
      if (r == g + 8) lo[1] = wl, hi[1] = wh;
    }
  }
  __device__ __forceinline__ uint32_t cols(int q0, int c0, int lane) const {
    const int lo = q0 + lane, hi = lo + 32, g = lane >> 2;
    uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
    for (int c = 0; c < 16; ++c) {
      const int key = c0 + c;
      const uint32_t wl = __ballot_sync(
          0xffffffffu, key < Lk && lo < Lq && mb[(size_t)lo * Lk + key] != 0);
      const uint32_t wh = __ballot_sync(
          0xffffffffu, key < Lk && hi < Lq && mb[(size_t)hi * Lk + key] != 0);
      if (c == g) w[0][0] = wl, w[0][1] = wh;
      if (c == g + 8) w[1][0] = wl, w[1][1] = wh;
    }
    const int sh = 2 * (lane & 3);
    return frag_bits(w[0][0] >> sh, w[0][1] >> sh) |
           frag_bits(w[1][0] >> sh, w[1][1] >> sh) << 16;
  }
};

// the first key tile at or after kt, below nkt, that is not dead for q
// tile qt (nkt if none); the first q tile at or after qt, below nqt, in
// which key tile kt is not dead
template <class Mask>
static __device__ __forceinline__ int next_key(const Mask& mask, int qt,
                                               int kt, int nkt) {
  while (kt < nkt && mask.tile(qt, kt) == kTileDead) ++kt;
  return kt;
}
template <class Mask>
static __device__ __forceinline__ int next_query(const Mask& mask, int qt,
                                                 int kt, int nqt) {
  while (qt < nqt && mask.tile(qt, kt) == kTileDead) ++qt;
  return qt;
}

// key tile kt (keys kt * 64 ..) of k and v into stage st of a two-stage
// [2][k, v][64][pitch] ring, by the whole block
template <int DH>
static __device__ __forceinline__ void stage_kv(bf16* ring,
                                                const bf16* __restrict__ k,
                                                const bf16* __restrict__ v,
                                                int kt, int st, int Lk,
                                                int ldkv, int tid) {
  bf16* dst = ring + st * 2 * kTile * pitch(DH);
  stage_head<DH>(dst, k, kt * kTile, Lk, ldkv, tid);
  stage_head<DH>(dst + kTile * pitch(DH), v, kt * kTile, Lk, ldkv, tid);
}

// The forward of q rows [q0, q0 + 64) of one (sample, head) against keys
// [0, ke): o = sum over keys of P v (P = exp(s - m) rounded to bf16, not
// yet divided by l), the row max m and l = sum of the fp32 exp(s - m), for
// the lane's rows 16 w + g (index 0) and + 8 (index 1). Key tiles dead for
// this q tile are skipped (their pairs would add exp(-65504 - m) = 0, or,
// ahead of a live tile, be scaled away by exp(-65504 - m) = 0; a q tile
// holding a row with every key masked has no dead tile, block_tile_map);
// full tiles read no mask bits. smem: attn_tc_smem bytes. Every warp of
// the block calls it, or flash_fwd_idle with the same arguments and mask
// (a warp whose rows all lie past Lq may: its share of the
// staging and the barriers, no products; a branch inside the products'
// loop cost the attention block's forward 5 %).
template <int DH, class Mask>
static __device__ __forceinline__ void flash_fwd_tile(
    unsigned char* smem, const bf16* __restrict__ q, int ldq,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ldkv, int q0,
    int Lq, int Lk, int ke, const Mask& mask, float mult,
    float (&o)[DH / 8][4], float (&m)[2], float (&l)[2]) {
  constexpr int LD = pitch(DH), TILE = kTile * LD, ND = DH / 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* kvs = qs + TILE;                      // [2][k, v][64][LD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int qt = q0 / kTile, nkt = (ke + kTile - 1) / kTile;
  int kt = next_key(mask, qt, 0, nkt);
  stage_head<DH>(qs, q, q0, Lq, ldq, tid);
  if (kt < nkt) stage_kv<DH>(kvs, k, v, kt, 0, Lk, ldkv, tid);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.0f;
  uint32_t qf[DH / 16][4];
  for (int it = 0; kt < nkt; ++it) {
    cp_async_wait<0>();
    // tile kt has landed; every warp is done with the previous one
    __syncthreads();
    const int nxt = next_key(mask, qt, kt + 1, nkt);
    if (nxt < nkt)
      stage_kv<DH>(kvs, k, v, nxt, (it + 1) & 1, Lk, ldkv, tid);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldsm_x4(qf[kk], frag_a(qs, LD, 16 * warp, 16 * kk, lane));
    }
    const bf16* ks = kvs + (it & 1) * 2 * TILE;
    const bf16* vs = ks + TILE;
    // the lane's masked pairs, and its keys past Lk (the last tile's)
    uint32_t mlo[2] = {0u, 0u}, mhi[2] = {0u, 0u}, plo, phi;
    if (mask.tile(qt, kt) == kTileMixed)
      mask.rows(q0 + 16 * warp, kt * kTile, lane, mlo, mhi);
    pad_words(Lk - kt * kTile, t, plo, phi);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, frag_b_nk(ks, LD, 16 * np, 16 * kk, lane));
        mma16816(s[2 * np], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = 8 * (j & 3) + (e & 1);
        float sv = s[j][e] * mult;
        if (((j < 4 ? mlo[e >> 1] : mhi[e >> 1]) >> bit) & 1) sv = kMaskFill;
        if (((j < 4 ? plo : phi) >> bit) & 1) sv = -INFINITY;
        s[j][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = __expf(m[hh] - mx[hh]);  // 0 at the first tile
      m[hh] = mx[hh];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l[hh] = l[hh] * alpha[hh] + rs[hh];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    // O += P V, P rounded to bf16 from the C fragments (V through
    // ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, frag_b_kn(vs, LD, 16 * kk, 16 * dp, lane));
        mma16816(o[2 * dp], a, bv[0], bv[1]);
        mma16816(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    kt = nxt;
  }
  cp_async_wait<0>();
}

// flash_fwd_tile's staging and barriers without its products, for a warp
// whose 16 q rows all lie past Lq
template <int DH, class Mask>
static __device__ __forceinline__ void flash_fwd_idle(
    unsigned char* smem, const bf16* __restrict__ q, int ldq,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ldkv, int q0,
    int Lq, int Lk, int ke, const Mask& mask) {
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kvs = qs + kTile * pitch(DH);
  const int tid = threadIdx.x, qt = q0 / kTile;
  const int nkt = (ke + kTile - 1) / kTile;
  int kt = next_key(mask, qt, 0, nkt);
  stage_head<DH>(qs, q, q0, Lq, ldq, tid);
  if (kt < nkt) stage_kv<DH>(kvs, k, v, kt, 0, Lk, ldkv, tid);
  cp_async_commit();
  for (int it = 0; kt < nkt; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    kt = next_key(mask, qt, kt + 1, nkt);
    if (kt < nkt)
      stage_kv<DH>(kvs, k, v, kt, (it + 1) & 1, Lk, ldkv, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// dK and dV of keys [k0, k0 + 64) of one (sample, head), summed over the q
// tiles that start before qe (rows past Lq add nothing) and in which the
// key tile is not dead (there every p is 0 and every dS masked; full
// tiles read no mask bits), for the lane's keys 16 w + g (index 0) and
// + 8 (index 1). S^T = K Q^T and dP^T = V dO^T
// per warp (16 keys x 64 q rows), P^T and dS^T on the fragments, rounded
// to bf16 into the A fragments of dV += P^T dO and dK += dS^T Q (dS^T in
// two bf16 parts with SPLIT). smem: dkv_tc_smem bytes.
template <int DH, bool SPLIT, class Mask>
static __device__ __forceinline__ void flash_dkv_tile(
    unsigned char* smem, const bf16* __restrict__ q, int ldq,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ldkv,
    const bf16* __restrict__ dout, int ldo, const float* __restrict__ stats,
    const float* __restrict__ delta, int k0, int Lq, int Lk, int qe,
    const Mask& mask, float mult, float (&dk)[DH / 8][4],
    float (&dv)[DH / 8][4]) {
  constexpr int LD = pitch(DH), TILE = kTile * LD, ND = DH / 8;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* vs = ks + TILE;
  bf16* ring = vs + TILE;                             // [2][q, dO][64][LD]
  float* rowv = reinterpret_cast<float*>(ring + 4 * TILE);  // [2][3][64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int kt = k0 / kTile, nqt = (qe + kTile - 1) / kTile;
  const bool active = k0 + 16 * warp < Lk;
  int qt = next_query(mask, 0, kt, nqt);
  stage_head<DH>(ks, k, k0, Lk, ldkv, tid);
  stage_head<DH>(vs, v, k0, Lk, ldkv, tid);
  if (qt < nqt) {
    stage_head<DH>(ring, q, qt * kTile, Lq, ldq, tid);
    stage_head<DH>(ring + TILE, dout, qt * kTile, Lq, ldo, tid);
  }
  cp_async_commit();
  // the rows' m, 1 / l and delta of q tile qt (rows past Lq: p is 0)
  float rm = 0.0f, ril = 1.0f, rdl = 0.0f;
  auto row_scalars = [&](int qt) {
    const int qr = qt * kTile + tid;
    rm = 0.0f, ril = 1.0f, rdl = 0.0f;
    if (tid < kTile && qr < Lq) {
      const float2 ml =
          *reinterpret_cast<const float2*>(stats + (size_t)qr * 2);
      rm = ml.x;
      ril = 1.0f / ml.y;
      rdl = delta[qr];
    }
  };
  auto put_scalars = [&](int st) {
    if (tid < kTile) {
      rowv[st * 3 * kTile + tid] = rm;
      rowv[st * 3 * kTile + kTile + tid] = ril;
      rowv[st * 3 * kTile + 2 * kTile + tid] = rdl;
    }
  };
  if (qt < nqt) {
    row_scalars(qt);
    put_scalars(0);
  }
  uint32_t vf[DH / 16][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  for (int it = 0; qt < nqt; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    // q tile qt has landed with its scalars; every warp is done with the
    // previous one, whose stage is refilled next
    __syncthreads();
    const int nq = next_query(mask, qt + 1, kt, nqt);
    if (nq < nqt) {
      bf16* nxt = ring + (st ^ 1) * 2 * TILE;
      stage_head<DH>(nxt, q, nq * kTile, Lq, ldq, tid);
      stage_head<DH>(nxt + TILE, dout, nq * kTile, Lq, ldo, tid);
      row_scalars(nq);
    }
    cp_async_commit();
    if (active) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          ldsm_x4(vf[kk], frag_a(vs, LD, 16 * warp, 16 * kk, lane));
      }
      const bf16* qs = ring + st * 2 * TILE;
      const bf16* dos = qs + TILE;
      const float* rv = rowv + st * 3 * kTile;
      const int q0 = qt * kTile;
      // S^T = K Q^T: 16 keys x 64 q rows per warp
      float sT[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, frag_a(ks, LD, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bq[4];
          ldsm_x4(bq, frag_b_nk(qs, LD, 16 * np, 16 * kk, lane));
          mma16816(sT[2 * np], kf, bq[0], bq[1]);
          mma16816(sT[2 * np + 1], kf, bq[2], bq[3]);
        }
      }
      // P^T in place, key 16 w + g + 8 (e >> 1), q row 8 j + 2 t + (e & 1):
      // a masked pair keeps its probability (from -65504, which dV takes)
      // and has no score gradient. Keys past Lk and q rows past Lq need no
      // test: their k, v, q and dO rows are zero-filled and such q rows
      // take m = 0, 1 / l = 1, delta = 0, so they add nothing to a live
      // key, and a padded key's own rows are never stored.
      const uint32_t mbits = mask.tile(qt, kt) == kTileMixed
                                 ? mask.cols(q0, k0 + 16 * warp, lane)
                                 : 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          const int bit = 2 * j + (e & 1) + 16 * (e >> 1);
          const float sc = ((mbits >> bit) & 1) ? kMaskFill : sT[j][e] * mult;
          sT[j][e] = __expf(sc - rv[qc]) * rv[kTile + qc];
        }
      // per block of 16 q rows: dP^T = V dO^T, dS^T, then dV += P^T dO and
      // dK += dS^T Q with P^T and dS^T rounded to bf16
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        float dpt[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpt[jj][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t bo[4];
          ldsm_x4(bo, frag_b_nk(dos, LD, 16 * np, 16 * kk, lane));
          mma16816(dpt[0], vf[kk], bo[0], bo[1]);
          mma16816(dpt[1], vf[kk], bo[2], bo[3]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 2 * np + jj;
            const int qc = 8 * j + 2 * t + (e & 1);
            const int bit = 2 * j + (e & 1) + 16 * (e >> 1);
            dpt[jj][e] = ((mbits >> bit) & 1)
                             ? 0.0f
                             : sT[j][e] * (dpt[jj][e] - rv[2 * kTile + qc]) *
                                   mult;
          }
        uint32_t pa[4], da[4], dl[4];
        pa[0] = pack_bf16(sT[2 * np][0], sT[2 * np][1]);
        pa[1] = pack_bf16(sT[2 * np][2], sT[2 * np][3]);
        pa[2] = pack_bf16(sT[2 * np + 1][0], sT[2 * np + 1][1]);
        pa[3] = pack_bf16(sT[2 * np + 1][2], sT[2 * np + 1][3]);
        ds_frags<SPLIT>(dpt, da, dl);
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, frag_b_kn(dos, LD, 16 * np, 16 * dp, lane));
          mma16816(dv[2 * dp], pa, bo[0], bo[1]);
          mma16816(dv[2 * dp + 1], pa, bo[2], bo[3]);
          ldsm_x4_t(bq, frag_b_kn(qs, LD, 16 * np, 16 * dp, lane));
          mma16816(dk[2 * dp], da, bq[0], bq[1]);
          mma16816(dk[2 * dp + 1], da, bq[2], bq[3]);
          if constexpr (SPLIT) {
            mma16816(dk[2 * dp], dl, bq[0], bq[1]);
            mma16816(dk[2 * dp + 1], dl, bq[2], bq[3]);
          }
        }
      }
    }
    if (nq < nqt) put_scalars(st ^ 1);
    qt = nq;
  }
  cp_async_wait<0>();
}

// dQ of q rows [q0, q0 + 64) of one (sample, head), summed over keys
// [0, ke) in the key tiles not dead for this q tile (a masked pair has no
// score gradient; full tiles read no mask bits), for the lane's rows
// 16 w + g (index 0) and + 8 (index 1): per
// block of 16 keys S = Q K^T and dP = dO V^T, dS on the fragments, then
// dQ += dS K with dS rounded to bf16 (two parts with SPLIT; K through
// ldmatrix.trans). smem: dq_tc_smem bytes.
template <int DH, bool SPLIT, class Mask>
static __device__ __forceinline__ void flash_dq_tile(
    unsigned char* smem, const bf16* __restrict__ q, int ldq,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ldkv,
    const bf16* __restrict__ dout, int ldo, const float* __restrict__ stats,
    const float* __restrict__ delta, int q0, int Lq, int Lk, int ke,
    const Mask& mask, float mult, float (&dq)[DH / 8][4]) {
  constexpr int LD = pitch(DH), TILE = kTile * LD, ND = DH / 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* dos = qs + TILE;
  bf16* ring = dos + TILE;  // [2][k, v][64][LD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = q0 / kTile, nkt = (ke + kTile - 1) / kTile;
  const bool active = q0 + 16 * warp < Lq;
  int kt = next_key(mask, qt, 0, nkt);
  stage_head<DH>(qs, q, q0, Lq, ldq, tid);
  stage_head<DH>(dos, dout, q0, Lq, ldo, tid);
  if (kt < nkt) stage_kv<DH>(ring, k, v, kt, 0, Lk, ldkv, tid);
  cp_async_commit();
  // m, 1 / l and delta of the lane's rows 16 w + g and + 8 (rows past Lq:
  // 0, 1, 0)
  float rm[2], ril[2], rdl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qr = q0 + 16 * warp + g + 8 * hh;
    rm[hh] = 0.0f, ril[hh] = 1.0f, rdl[hh] = 0.0f;
    if (qr < Lq) {
      const float2 ml =
          *reinterpret_cast<const float2*>(stats + (size_t)qr * 2);
      rm[hh] = ml.x;
      ril[hh] = 1.0f / ml.y;
      rdl[hh] = delta[qr];
    }
  }
  uint32_t qf[DH / 16][4], of[DH / 16][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;
  for (int it = 0; kt < nkt; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const int cur = kt;
    kt = next_key(mask, qt, kt + 1, nkt);
    if (kt < nkt)
      stage_kv<DH>(ring, k, v, kt, (it + 1) & 1, Lk, ldkv, tid);
    cp_async_commit();
    if (!active) continue;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        ldsm_x4(qf[kk], frag_a(qs, LD, 16 * warp, 16 * kk, lane));
        ldsm_x4(of[kk], frag_a(dos, LD, 16 * warp, 16 * kk, lane));
      }
    }
    const bf16* ks = ring + (it & 1) * 2 * TILE;
    const bf16* vs = ks + TILE;
    // the lane's pairs with a score gradient: the key unmasked and within
    // Lk (a padded key's p may overflow where m = -65504, and 0 * inf
    // would reach dq). q rows past Lq need no test: their q and dO rows
    // are zero-filled with m = 0, 1 / l = 1, delta = 0, so dS is 0 there.
    uint32_t dead;
    {
      uint32_t mlo[2] = {0u, 0u}, mhi[2] = {0u, 0u}, plo, phi;
      if (mask.tile(qt, cur) == kTileMixed)
        mask.rows(q0 + 16 * warp, cur * kTile, lane, mlo, mhi);
      pad_words(Lk - cur * kTile, t, plo, phi);
      const uint32_t pz = frag_bits(plo, phi);
      dead = (frag_bits(mlo[0], mhi[0]) | pz) |
             (frag_bits(mlo[1], mhi[1]) | pz) << 16;
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, frag_b_nk(ks, LD, 16 * np, 16 * kk, lane));
        mma16816(s[0], qf[kk], bk[0], bk[1]);
        mma16816(s[1], qf[kk], bk[2], bk[3]);
        ldsm_x4(bv, frag_b_nk(vs, LD, 16 * np, 16 * kk, lane));
        mma16816(dp[0], of[kk], bv[0], bv[1]);
        mma16816(dp[1], of[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bit = 2 * (2 * np + jj) + (e & 1) + 16 * (e >> 1);
          const int hh = e >> 1;
          float ds = 0.0f;
          if (!((dead >> bit) & 1)) {
            const float p = __expf(s[jj][e] * mult - rm[hh]) * ril[hh];
            ds = p * (dp[jj][e] - rdl[hh]) * mult;
          }
          s[jj][e] = ds;
        }
      uint32_t da[4], dl[4];
      ds_frags<SPLIT>(s, da, dl);
#pragma unroll
      for (int dd = 0; dd < DH / 16; ++dd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, frag_b_kn(ks, LD, 16 * np, 16 * dd, lane));
        mma16816(dq[2 * dd], da, bk[0], bk[1]);
        mma16816(dq[2 * dd + 1], da, bk[2], bk[3]);
        if constexpr (SPLIT) {
          mma16816(dq[2 * dd], dl, bk[0], bk[1]);
          mma16816(dq[2 * dd + 1], dl, bk[2], bk[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// delta[h][r] = sum_d dy[r, h DH + d] o[r, h DH + d] in fp32 for rows
// [r0, r0 + rows) of one sample's [L, C] pair (C = H * DH), every head;
// delta is the sample's [H][L]. NW warps, a warp per row, 8 columns (16
// bytes) per lane.
template <int DH, int NW>
static __device__ __forceinline__ void delta_rows(
    const bf16* __restrict__ dy, const bf16* __restrict__ o,
    float* __restrict__ delta, int r0, int rows, int L, int C, int warp,
    int lane) {
  for (int r = warp; r < rows; r += NW) {
    const size_t row = (size_t)(r0 + r) * C;
    for (int c0 = 0; c0 < C; c0 += 256) {
      const int c = c0 + lane * 8;
      float s = 0.0f;
      if (c < C) {
        const uint4 a = *reinterpret_cast<const uint4*>(dy + row + c);
        const uint4 b = *reinterpret_cast<const uint4*>(o + row + c);
        const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 af = __bfloat1622float2(ap[i]);
          const float2 bf2 = __bfloat1622float2(bp[i]);
          s += af.x * bf2.x + af.y * bf2.y;
        }
      }
      // the DH / 8 lanes of one head
#pragma unroll
      for (int off = 1; off < DH / 8; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (c < C && (lane & (DH / 8 - 1)) == 0)
        delta[(size_t)(c / DH) * L + r0 + r] = s;
    }
  }
}

}  // namespace mtp
