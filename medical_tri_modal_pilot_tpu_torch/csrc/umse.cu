// UMSE TIE-token embedding, per token (row r of R = B * L):
//   out[r] = relu(LN(v_r Wv + bv)) + relu(LN(t_r Wt + bt)) + table[id_r],
// its forward and its backward.
//
// Replaces medical_tri_modal_pilot_tpu/kernels/umse.py::_pallas_umse (body
// _kernel) and, for the gradient, that file's _fused_bwd: jax.vjp of
// xla_umse, which XLA fuses into a few passes. Eager PyTorch has no such
// fusion: autograd of the plain formula runs some 130 launches over [R, D]
// fp32 intermediates.
//
// What bounds it on an H100: the bytes at best. The forward reads 12
// bytes a token and writes its D values (512 bytes in bf16 at D = 256);
// the backward reads the token and dout's D values and writes only the
// [8 + n_ids, D] gradients. At R = 64 * 1000 either moves 33 MB, 0.010
// ms at 3.35 TB/s. The arithmetic around those bytes is what these
// kernels spend their time on: some 20 instructions a row element forward
// and twice that backward, and the row statistics' warp reductions, whose
// shuffles issue at a fifth of the FP32 rate.
//
// Design: a warp owns a row, a lane D / 32 consecutive columns, so a row
// leaves in one 16-byte store a lane (bf16, D = 256) and the LayerNorm
// statistics reduce by shuffles. A lane keeps its columns of the eight
// stem vectors in registers for the whole kernel, w and b rounded to T
// once. The bf16 affine runs two columns at a time, the bf16x2 multiply
// and add each rounding once as torch's and XLA's bf16 ops round (an fma
// there, rounding once in all, flips the relu mask of enough elements to
// move the gradients by whole units). A warp loads the (time, value, id)
// of 32 rows at once, one row a lane, and hands them round by shuffles;
// it takes two rows at a time, whose four stem rows reduce together in
// one reduce-scatter (warp_sums), so their latencies overlap and the
// shuffles fall from 40 to 17. StemRows is the one device function of
// both kernels: the backward recomputes each stem with the forward's
// roundings (the affine in T; fp32 statistics, E[h^2] - mu^2 clamped at
// 0, eps 1e-5), so its relu mask is the forward's. The forward stages the
// table and a zero row in shared memory (ids outside the table read the
// zeros, as the TPU kernel's one-hot product gives) and casts the fp32 sum
// to T once.
//
// The backward (the closed form of kernels/umse.py::torch_umse_bwd): per
// row and stem, dy = dout where y > 0, dn = dy * scale, dh = rs (dn -
// mean(dn) - n mean(dn n)) rounded to T where the JAX vjp rounds it (the
// h.astype(f32) cast), dW += dh * x_T and db += dh, dscale += dy n and
// dbias += dy; the table row of id gets dout. One block an SM walks a
// share of the rows; a lane sums its columns of both stems' dW, db,
// dscale and dbias in fp32 registers, and of the table gradient in its
// warp's own [n_ids, D] region of shared memory, which no other lane
// touches. dout arrives two rows at a time through the warp's two-slot
// ring by cp.async, the next rows in flight while the warp works on
// these. The block adds its warps' sums in warp order into one partial
// row; col_sum (wgrad.cu) adds the blocks' rows in block order. No float
// atomics: two runs are bit for bit the same.
#include <string.h>

#include <type_traits>

#include "mma.cuh"

namespace mtp {

constexpr float kUmseEps = 1e-5f;
constexpr int kUmseWarps = 8;                    // warps a block, at most
constexpr int kUmseFwdMaxBlocks = 4096;
constexpr int kUmseMaxTableBytes = 48 * 1024;    // kernels/umse.py mirrors
constexpr int kUmseBwdSmemBytes = 200 * 1024;    // the warps' regions
constexpr int kUmseStage = 2;  // dout rows a ring slot, two slots a warp

struct UmseStems {  // [0] the value stem, [1] the time stem; fp32 [D] each
  const float* w[2];
  const float* b[2];
  const float* s[2];
  const float* be[2];
};

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// a lane's V consecutive columns of one stem's vectors: w and b rounded to
// T (kept as bf16 pairs for the paired affine), scale and bias in fp32
template <typename T, int V>
struct StemCols {
  static constexpr bool kPairs = kIsBf16<T> && V % 2 == 0;
  __nv_bfloat162 w2[kPairs ? V / 2 : 1], b2[kPairs ? V / 2 : 1];
  float w[V], b[V], s[V], be[V];
  __device__ __forceinline__ void load(const UmseStems& p, int m, int c0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      w[k] = rnd<T>(p.w[m][c0 + k]);
      b[k] = rnd<T>(p.b[m][c0 + k]);
      s[k] = p.s[m][c0 + k];
      be[k] = p.be[m][c0 + k];
    }
    if constexpr (kPairs) {
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        w2[i] = __floats2bfloat162_rn(w[2 * i], w[2 * i + 1]);
        b2[i] = __floats2bfloat162_rn(b[2 * i], b[2 * i + 1]);
      }
    }
  }
};

// bf16x2 product and sum, each rounded once to nearest even (as torch's
// and XLA's bf16 ops round them), with the rounding mode given so that
// the compiler does not contract the pair into one fma
static __device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a,
                                                       __nv_bfloat162 b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;"
      : "=r"(d)
      : "r"(*reinterpret_cast<const uint32_t*>(&a)),
        "r"(*reinterpret_cast<const uint32_t*>(&b)));
  return *reinterpret_cast<const __nv_bfloat162*>(&d);
}

static __device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a,
                                                       __nv_bfloat162 b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;"
      : "=r"(d)
      : "r"(*reinterpret_cast<const uint32_t*>(&a)),
        "r"(*reinterpret_cast<const uint32_t*>(&b)));
  return *reinterpret_cast<const __nv_bfloat162*>(&d);
}

// h = rnd(rnd(a_T w_T) + b_T) in fp32 for the lane's V columns; in bf16
// two columns at a time
template <typename T, int V>
static __device__ __forceinline__ void affine(float a,
                                              const StemCols<T, V>& p,
                                              float (&h)[V]) {
  if constexpr (StemCols<T, V>::kPairs) {
    const __nv_bfloat162 a2 = __float2bfloat162_rn(a);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f =
          __bfloat1622float2(add_rn(mul_rn(a2, p.w2[i]), p.b2[i]));
      h[2 * i] = f.x;
      h[2 * i + 1] = f.y;
    }
  } else {
    const float at = rnd<T>(a);
#pragma unroll
    for (int k = 0; k < V; ++k)
      h[k] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(at, p.w[k])), p.b[k]));
  }
}

// The exchanges of warp_sums from lane offset OFF down, M values carried:
// while M > 1 a lane keeps the half of its values that its bit OFF picks
// and hands the other half to its partner, whose sums it adds
template <int M, int OFF, int N>
static __device__ __forceinline__ void reduce_scatter(float (&c)[N],
                                                      int lane) {
  if constexpr (OFF > 0) {
    if constexpr (M > 1) {
      constexpr int H = M / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? c[i] : c[i + H];
        const float keep = up ? c[i + H] : c[i];
        c[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<H, OFF / 2, N>(c, lane);
    } else {
      c[0] += __shfl_xor_sync(0xffffffffu, c[0], OFF);
      reduce_scatter<1, OFF / 2, N>(c, lane);
    }
  }
}

// v[i] summed over the warp, N values at once (N a power of two up to 32):
// a reduce-scatter leaves lane l with the whole sum of value l / (32 / N),
// and N shuffles hand each sum to every lane. N - 1 + (5 - log2 N) + N
// shuffles in all where one butterfly a value takes 5 N: the shuffle unit
// issues one warp's shuffle a clock per SM, a fifth of the FP32 rate.
template <int N>
static __device__ __forceinline__ void warp_sums(float (&v)[N]) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0,
                "warp_sums takes a power of two up to 32 values");
  constexpr int kGroup = 32 / N;  // lanes that end with one value's sum
  const int lane = threadIdx.x & 31;
  float c[N];
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = v[i];
  reduce_scatter<N, 16, N>(c, lane);
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = __shfl_sync(0xffffffffu, c[0], i * kGroup);
}

// N stem rows over the warp, the lane's V columns: entry q is stem q % 2
// (0 value, 1 time) of row q / 2, at the scalar a[q]. h = affine(a), its
// LayerNorm with fp32 statistics (E[h^2] - mu^2 clamped at 0, eps 1e-5),
// n = (h - mu) rs and y = n scale + bias (kernels/umse.py::stem before its
// relu); the N rows reduce in one shuffle loop, so their latencies
// overlap. The forward and the backward both run this, so the backward's
// relu mask is the forward's.
template <typename T, int V, int N>
struct StemRows {
  float n[N][V], y[N][V];
  float rs[N];
  bool var_live[N];  // E[h^2] - mu^2 >= 0: the clamp passes the gradient

  __device__ __forceinline__ void run(const float (&a)[N],
                                      const StemCols<T, V> (&ps)[2]) {
    constexpr float kInvD = 1.0f / (32 * V);
    float sums[2 * N];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      affine<T, V>(a[q], ps[q & 1], n[q]);
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1 += n[q][k];
        s2 = fmaf(n[q][k], n[q][k], s2);
      }
      sums[2 * q] = s1;
      sums[2 * q + 1] = s2;
    }
    warp_sums(sums);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float mu = sums[2 * q] * kInvD;
      const float var = __fsub_rn(sums[2 * q + 1] * kInvD, __fmul_rn(mu, mu));
      var_live[q] = var >= 0.0f;
      rs[q] = rsqrtf(fmaxf(var, 0.0f) + kUmseEps);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        n[q][k] = __fmul_rn(n[q][k] - mu, rs[q]);
        y[q][k] = fmaf(n[q][k], ps[q & 1].s[k], ps[q & 1].be[k]);
      }
    }
  }
};

// row r's (time, value, id); id -1 past the rows or outside the table (an
// id truncates toward zero, as torch's cast to int64 does)
static __device__ __forceinline__ void load_token(const float* __restrict__ x,
                                                  int r, int r_end, int n_ids,
                                                  float& t, float& v,
                                                  int& id) {
  t = v = 0.0f;
  id = -1;
  if (r >= r_end) return;
  const float* p = x + (size_t)3 * r;
  t = p[0];
  v = p[1];
  const float f = p[2];
  if (f > -1.0f && f < (float)n_ids) id = (int)f;
}

template <int B> struct Chunk;
template <> struct Chunk<16> { using type = uint4; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<4> { using type = uint32_t; };
template <> struct Chunk<2> { using type = uint16_t; };

// V consecutive T values at src (aligned to their size, or 16 bytes) to
// fp32, in 16-byte pieces where they span as much
template <typename T, int V>
static __device__ __forceinline__ void load_cols(const T* __restrict__ src,
                                                 float (&f)[V]) {
  constexpr int kBytes = (int)sizeof(T) * V;
  constexpr int kC = kBytes < 16 ? kBytes : 16;
  constexpr int kE = kC / (int)sizeof(T);
  using C = typename Chunk<kC>::type;
#pragma unroll
  for (int i = 0; i < kBytes / kC; ++i) {
    const C c = reinterpret_cast<const C*>(src)[i];
    T t[kE];
    memcpy(t, &c, kC);
#pragma unroll
    for (int e = 0; e < kE; ++e) f[i * kE + e] = Num<T>::load(t[e]);
  }
}

template <typename T, int V>
static __device__ __forceinline__ void store_cols(T* __restrict__ dst,
                                                  const float (&f)[V]) {
  constexpr int kBytes = (int)sizeof(T) * V;
  constexpr int kC = kBytes < 16 ? kBytes : 16;
  constexpr int kE = kC / (int)sizeof(T);
  using C = typename Chunk<kC>::type;
#pragma unroll
  for (int i = 0; i < kBytes / kC; ++i) {
    T t[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) t[e] = Num<T>::store(f[i * kE + e]);
    C c;
    memcpy(&c, t, kC);
    reinterpret_cast<C*>(dst)[i] = c;
  }
}

// the forward of NR rows (their tokens in lanes j .. j + NR - 1) to out
template <typename T, int V, int NR>
static __device__ __forceinline__ void fwd_rows(
    float t, float v, int id, int j, const StemCols<T, V> (&ps)[2],
    const float* tab, int n_ids, T* __restrict__ out, int c0) {
  constexpr int D = 32 * V;
  float a[2 * NR];
  const float* trow[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    a[2 * r] = __shfl_sync(0xffffffffu, v, j + r);
    a[2 * r + 1] = __shfl_sync(0xffffffffu, t, j + r);
    const int idr = __shfl_sync(0xffffffffu, id, j + r);
    // an id outside the table reads the zero row past its end
    trow[r] = tab + (idr >= 0 ? idr : n_ids) * D + c0;
  }
  StemRows<T, V, 2 * NR> st;
  st.run(a, ps);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float o[V];
#pragma unroll
    for (int k = 0; k < V; ++k)
      o[k] = fmaxf(st.y[2 * r][k], 0.0f) + fmaxf(st.y[2 * r + 1][k], 0.0f) +
             trow[r][k];
    store_cols<T, V>(out + (size_t)r * D, o);
  }
}

// grid (ceil(R / (32 kUmseWarps)), at most kUmseFwdMaxBlocks); dynamic
// shared memory: the table and a zero row, (n_ids + 1) * D fp32
template <typename T, int D>
__global__ void __launch_bounds__(32 * kUmseWarps, 2) umse_fwd_kernel(
    const float* __restrict__ x, UmseStems p,
    const float* __restrict__ table, T* __restrict__ out, int R,
    int n_ids) {
  constexpr int V = D / 32;
  extern __shared__ __align__(16) float tab[];
  for (int i = threadIdx.x; i < (n_ids + 1) * D; i += blockDim.x)
    tab[i] = i < n_ids * D ? table[i] : 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31, c0 = lane * V;
  StemCols<T, V> ps[2];
  ps[0].load(p, 0, c0);
  ps[1].load(p, 1, c0);
  const int stride = gridDim.x * kUmseWarps * 32;
  for (int r0 = (blockIdx.x * kUmseWarps + (threadIdx.x >> 5)) * 32; r0 < R;
       r0 += stride) {
    float t, v;
    int id;
    load_token(x, r0 + lane, R, n_ids, t, v, id);
    const int nr = min(32, R - r0);
    T* row = out + (size_t)r0 * D + c0;
    int j = 0;
    for (; j + 2 <= nr; j += 2)
      fwd_rows<T, V, 2>(t, v, id, j, ps, tab, n_ids, row + (size_t)j * D,
                        c0);
    if (j < nr)
      fwd_rows<T, V, 1>(t, v, id, j, ps, tab, n_ids, row + (size_t)j * D,
                        c0);
  }
}

// f rounded to T, two values at a time in bf16
template <typename T, int V>
static __device__ __forceinline__ void rnd_cols(float (&f)[V]) {
  if constexpr (kIsBf16<T> && V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 r =
          __bfloat1622float2(__floats2bfloat162_rn(f[2 * i], f[2 * i + 1]));
      f[2 * i] = r.x;
      f[2 * i + 1] = r.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = rnd<T>(f[k]);
  }
}

// The backward's per-lane sums of both stems over the lane's V columns:
// dW, db, dscale, dbias, fp32
template <int V>
struct StemGrads {
  float w[2][V], b[2][V], s[2][V], be[2][V];
};

// the backward of NR rows (their tokens in lanes j .. j + NR - 1, their
// cotangents g): both stems' sums into acc, the table's into the warp's
// region
template <typename T, int V, int NR>
static __device__ __forceinline__ void bwd_rows(
    float t, float v, int id, int j, const float (&g)[NR][V],
    const StemCols<T, V> (&ps)[2], StemGrads<V>& acc, float* region,
    int c0) {
  constexpr int D = 32 * V;
  constexpr float kInvD = 1.0f / D;
  float a[2 * NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    a[2 * r] = __shfl_sync(0xffffffffu, v, j + r);
    a[2 * r + 1] = __shfl_sync(0xffffffffu, t, j + r);
  }
  StemRows<T, V, 2 * NR> st;
  st.run(a, ps);
  // dy = g where y > 0; dn = dy scale (in place of y); dscale += dy n,
  // dbias += dy; the sums of dn and dn n over the row
  float q[4 * NR];
#pragma unroll
  for (int e = 0; e < 2 * NR; ++e) {
    const int m = e & 1;
    float q1 = 0.0f, q2 = 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float dy = st.y[e][k] > 0.0f ? g[e >> 1][k] : 0.0f;
      acc.s[m][k] = fmaf(dy, st.n[e][k], acc.s[m][k]);
      acc.be[m][k] += dy;
      const float dn = dy * ps[m].s[k];
      st.y[e][k] = dn;
      q1 += dn;
      q2 = fmaf(dn, st.n[e][k], q2);
    }
    q[2 * e] = q1;
    q[2 * e + 1] = q2;
  }
  warp_sums(q);
  // dh = rs (dn - mean(dn) - n mean(dn n)) = dn rs + n c2 + c1, rounded to
  // T; dW += dh a_T, db += dh
#pragma unroll
  for (int e = 0; e < 2 * NR; ++e) {
    const int m = e & 1;
    const float rs = st.rs[e];
    const float c1 = -rs * (q[2 * e] * kInvD);
    const float c2 = st.var_live[e] ? -rs * (q[2 * e + 1] * kInvD) : 0.0f;
    const float at = rnd<T>(a[e]);
    float dh[V];
#pragma unroll
    for (int k = 0; k < V; ++k)
      dh[k] = fmaf(st.y[e][k], rs, fmaf(st.n[e][k], c2, c1));
    rnd_cols<T, V>(dh);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      acc.w[m][k] = fmaf(dh[k], at, acc.w[m][k]);
      acc.b[m][k] += dh[k];
    }
  }
  // the table row of each id gets g: the warp's own region, the lane's own
  // columns
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int idr = __shfl_sync(0xffffffffu, id, j + r);
    if (idr < 0) continue;
    float* row = region + idr * D + c0;
#pragma unroll
    for (int k = 0; k < V; ++k) row[k] += g[r][k];
  }
}

// Up to kUmseStage rows of dout from src (row stride D) into a ring slot,
// asynchronously, 16 bytes a lane; rows past ``rows`` are zero-filled and
// not read
template <typename T, int D>
static __device__ __forceinline__ void stage_rows(T* slot, const T* src,
                                                  int rows, int lane) {
  constexpr int kRowBytes = D * (int)sizeof(T), kPieces = kRowBytes / 16;
  for (int i = lane; i < kUmseStage * kPieces; i += 32) {
    const int row = i / kPieces, off = row * kRowBytes + (i % kPieces) * 16;
    const bool in = row < rows;
    cp_async16(reinterpret_cast<char*>(slot) + off,
               reinterpret_cast<const char*>(src) + (in ? off : 0), in);
  }
}

// grid (blocks), block 32 * nw threads; block b takes rows [b rpb, (b + 1)
// rpb) and writes part[b] = [dwv, dbv, dsv, dbbv, dwt, dbt, dst, dbbt] (D
// each) | dtable [n_ids, D], fp32. Dynamic shared memory: per warp a
// region of max(n_ids, 8) * D fp32 (the table's sums), then per warp a
// ring of two slots of kUmseStage dout rows, through which the warp's
// rows arrive by cp.async a pair of rows ahead of their use.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kUmseWarps, 1) umse_bwd_kernel(
    const float* __restrict__ x, UmseStems p, const T* __restrict__ dout,
    float* __restrict__ part, int R, int n_ids, int rpb) {
  constexpr int V = D / 32;
  constexpr int kSlot = kUmseStage * D;  // T elements a ring slot
  extern __shared__ __align__(16) float acc[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, c0 = lane * V;
  const int region = max(n_ids, 8) * D;
  for (int i = threadIdx.x; i < nw * region; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  float* mine = acc + warp * region;
  T* ring = reinterpret_cast<T*>(acc + nw * region) + warp * 2 * kSlot;
  StemCols<T, V> ps[2];
  ps[0].load(p, 0, c0);
  ps[1].load(p, 1, c0);
  StemGrads<V> sums;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int k = 0; k < V; ++k)
      sums.w[m][k] = sums.b[m][k] = sums.s[m][k] = sums.be[m][k] = 0.0f;
  const int r_begin = blockIdx.x * rpb, r_end = min(R, r_begin + rpb);
  for (int r0 = r_begin + warp * 32; r0 < r_end; r0 += nw * 32) {
    float t, v;
    int id;
    load_token(x, r0 + lane, r_end, n_ids, t, v, id);
    const int nr = min(32, r_end - r0);
    const T* grow = dout + (size_t)r0 * D;
    // pairs of rows; pair q's rows arrive in slot q % 2, two pairs ahead
    const int pairs = (nr + kUmseStage - 1) / kUmseStage;
    for (int q = 0; q < 2; ++q) {
      if (q < pairs)
        stage_rows<T, D>(ring + q * kSlot, grow + (size_t)q * kSlot,
                         nr - q * kUmseStage, lane);
      cp_async_commit();
    }
    for (int q = 0; q < pairs; ++q) {
      cp_async_wait<1>();
      __syncwarp();
      const T* slot = ring + (q & 1) * kSlot;
      const int j = q * kUmseStage;
      if (j + 2 <= nr) {
        float g[2][V];
        load_cols<T, V>(slot + c0, g[0]);
        load_cols<T, V>(slot + D + c0, g[1]);
        bwd_rows<T, V, 2>(t, v, id, j, g, ps, sums, mine, c0);
      } else {
        float g[1][V];
        load_cols<T, V>(slot + c0, g[0]);
        bwd_rows<T, V, 1>(t, v, id, j, g, ps, sums, mine, c0);
      }
      __syncwarp();
      if (q + 2 < pairs)
        stage_rows<T, D>(ring + (q & 1) * kSlot,
                         grow + (size_t)(q + 2) * kSlot,
                         nr - (q + 2) * kUmseStage, lane);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * (8 + n_ids) * D;
  for (int i = threadIdx.x; i < n_ids * D; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += acc[w * region + i];
    out[8 * D + i] = s;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mine[(4 * m + 0) * D + c0 + k] = sums.w[m][k];
      mine[(4 * m + 1) * D + c0 + k] = sums.b[m][k];
      mine[(4 * m + 2) * D + c0 + k] = sums.s[m][k];
      mine[(4 * m + 3) * D + c0 + k] = sums.be[m][k];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * D; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += acc[w * region + i];
    out[i] = s;
  }
}

template <typename T, int D>
static cudaError_t launch_fwd(const float* x, const UmseStems& p,
                             const float* table, void* out, int R, int n_ids,
                             cudaStream_t stream) {
  const int rows = 32 * kUmseWarps;
  const int blocks = min((R + rows - 1) / rows, kUmseFwdMaxBlocks);
  const int smem = (n_ids + 1) * D * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        umse_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  umse_fwd_kernel<T, D><<<blocks, rows, smem, stream>>>(x, p, table, (T*)out,
                                                        R, n_ids);
  return cudaGetLastError();
}

template <typename T, int D>
static cudaError_t launch_bwd(const float* x, const UmseStems& p,
                             const void* dout, float* part, int R, int n_ids,
                             int blocks, cudaStream_t stream) {
  const int warp_bytes = (n_ids > 8 ? n_ids : 8) * D * (int)sizeof(float) +
                         2 * kUmseStage * D * (int)sizeof(T);
  const int nw = min(kUmseWarps, kUmseBwdSmemBytes / warp_bytes);
  const int smem = nw * warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      umse_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int rpb = (R + blocks - 1) / blocks;
  umse_bwd_kernel<T, D><<<blocks, 32 * nw, smem, stream>>>(
      x, p, (const T*)dout, part, R, n_ids, rpb);
  return cudaGetLastError();
}

static UmseStems make_stems(const void* wv, const void* bv, const void* sv,
                            const void* bbv, const void* wt, const void* bt,
                            const void* st, const void* bbt) {
  UmseStems p;
  p.w[0] = (const float*)wv;
  p.b[0] = (const float*)bv;
  p.s[0] = (const float*)sv;
  p.be[0] = (const float*)bbv;
  p.w[1] = (const float*)wt;
  p.b[1] = (const float*)bt;
  p.s[1] = (const float*)st;
  p.be[1] = (const float*)bbt;
  return p;
}

static bool umse_shape_ok(int R, int D, int n_ids) {
  return R > 0 && n_ids > 0 &&
         (long long)n_ids * D * (long long)sizeof(float) <= kUmseMaxTableBytes;
}

}  // namespace mtp

extern "C" int col_sum(const void* part, int S, int N, void* out,
                       void* stream);

// out [R, D] in the dtype (0 fp32, 1 bf16) from x fp32 [R, 3] (time, value,
// id), the eight stem vectors fp32 [D] and table fp32 [n_ids, D]; D in 32,
// 64, 128, 256. Returns cudaGetLastError().
extern "C" int umse_fwd(const void* x, const void* wv, const void* bv,
                        const void* sv, const void* bbv, const void* wt,
                        const void* bt, const void* st, const void* bbt,
                        const void* table, void* out, int R, int D, int n_ids,
                        int dtype, void* stream) {
  using namespace mtp;
  if (!umse_shape_ok(R, D, n_ids)) return (int)cudaErrorInvalidValue;
  const UmseStems p = make_stems(wv, bv, sv, bbv, wt, bt, st, bbt);
  const float* xf = (const float*)x;
  const float* tb = (const float*)table;
  cudaStream_t s = (cudaStream_t)stream;
#define UMSE_FWD(TT, DD) \
  if (D == DD) return (int)launch_fwd<TT, DD>(xf, p, tb, out, R, n_ids, s);
  if (dtype == 0) {
    UMSE_FWD(float, 32) UMSE_FWD(float, 64) UMSE_FWD(float, 128)
    UMSE_FWD(float, 256)
  } else if (dtype == 1) {
    UMSE_FWD(__nv_bfloat16, 32) UMSE_FWD(__nv_bfloat16, 64)
    UMSE_FWD(__nv_bfloat16, 128) UMSE_FWD(__nv_bfloat16, 256)
  }
#undef UMSE_FWD
  return (int)cudaErrorInvalidValue;
}

// The gradients of umse_fwd's output for the cotangent dout [R, D] (the
// dtype's): grads fp32 [(8 + n_ids) * D] = dwv | dbv | dsv | dbbv | dwt |
// dbt | dst | dbbt | dtable, through part fp32 [blocks, (8 + n_ids) * D],
// in two launches (the row pass, then col_sum). Returns cudaGetLastError().
extern "C" int umse_bwd(const void* x, const void* wv, const void* bv,
                        const void* sv, const void* bbv, const void* wt,
                        const void* bt, const void* st, const void* bbt,
                        const void* dout, void* part, void* grads, int R,
                        int D, int n_ids, int blocks, int dtype,
                        void* stream) {
  using namespace mtp;
  if (!umse_shape_ok(R, D, n_ids) || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const UmseStems p = make_stems(wv, bv, sv, bbv, wt, bt, st, bbt);
  const float* xf = (const float*)x;
  float* pt = (float*)part;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define UMSE_BWD(TT, DD) \
  if (D == DD) err = launch_bwd<TT, DD>(xf, p, dout, pt, R, n_ids, blocks, s);
  if (dtype == 0) {
    UMSE_BWD(float, 32) UMSE_BWD(float, 64) UMSE_BWD(float, 128)
    UMSE_BWD(float, 256)
  } else if (dtype == 1) {
    UMSE_BWD(__nv_bfloat16, 32) UMSE_BWD(__nv_bfloat16, 64)
    UMSE_BWD(__nv_bfloat16, 128) UMSE_BWD(__nv_bfloat16, 256)
  }
#undef UMSE_BWD
  if (err != cudaSuccess) return (int)err;
  return col_sum(part, blocks, (8 + n_ids) * D, grads, stream);
}
