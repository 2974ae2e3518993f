// bf16 tensor-core building blocks for the Hopper kernels of the port:
// cp.async staging, ldmatrix fragment loads and mma.sync.m16n8k16 with
// fp32 accumulation, plus a tile GEMM with gemm_kernel's kEpiBiasT and
// kEpiBiasResidual epilogues that more than one source can launch.
//
// Fragment layouts of mma.m16n8k16 (g = lane >> 2, t = lane & 3):
//   A 16 x 16: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//              a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9)
//   B 16 x 8:  b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g)
//   C 16 x 8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// Two bf16 values share a 32-bit register, the lower column in the low
// half. The C fragments of two neighbouring n8 tiles are the A fragment
// of a k16 step, which lets a product's result feed the next product
// from registers (the attention's probabilities).
//
// Shared-memory tiles are row-major bf16 with a row pitch of (width + 8)
// elements: for widths that are multiples of 16 the pitch is an odd
// number of 16-byte units, so the eight rows an ldmatrix phase reads fall
// in distinct bank groups.
#pragma once

#include "common.cuh"

namespace mtp {

using bf16 = __nv_bfloat16;

// row pitch (elements) of a shared-memory tile of the given width
__host__ __device__ constexpr int pitch(int width) { return width + 8; }

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (the
// source is then not read)
static __device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                                  bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the address of row (l & 7) of
// matrix (l >> 3)
static __device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                               const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed on delivery
static __device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                                 const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores, bf16 operands, fp32 accumulation
static __device__ __forceinline__ void mma16816(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

static __device__ __forceinline__ float bf(bf16 v) {
  return __bfloat162float(v);
}

// Fragment addresses of a lane, for a 16 x 16 block at (r0, c0) of a
// row-major tile with pitch ld:
// the A fragment of a [m][k] tile (ldsm_x4)
static __device__ __forceinline__ const bf16* frag_a(const bf16* s, int ld,
                                                     int r0, int c0,
                                                     int lane) {
  return s + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}
// the A fragment of a tile stored transposed, [k][m], at k0 = r0, m0 = c0
// (ldsm_x4_t)
static __device__ __forceinline__ const bf16* frag_a_t(const bf16* s, int ld,
                                                       int r0, int c0,
                                                       int lane) {
  return s + (r0 + ((lane >> 4) << 3) + (lane & 7)) * ld + c0 +
         (((lane >> 3) & 1) << 3);
}
// the B fragments of two n8 tiles of a [k][n] tile, k0 = r0, n0 = c0
// (ldsm_x4_t): r[0], r[1] for columns n0..n0+7, r[2], r[3] for n0+8..
static __device__ __forceinline__ const bf16* frag_b_kn(const bf16* s, int ld,
                                                        int r0, int c0,
                                                        int lane) {
  return s + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}
// the B fragments of two n8 tiles of a [n][k] tile, n0 = r0, k0 = c0
// (ldsm_x4): r[0], r[1] for rows n0..n0+7, r[2], r[3] for n0+8..
static __device__ __forceinline__ const bf16* frag_b_nk(const bf16* s, int ld,
                                                        int r0, int c0,
                                                        int lane) {
  return s + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
         (((lane >> 3) & 1) << 3);
}

// rows [0, nrows) x cols [0, WIDTH) of a row-major bf16 matrix (leading
// dimension lds) into a shared tile (pitch ld), 16 bytes per cp.async by
// NTHREADS threads; rows in [valid, nrows) are zero-filled. WIDTH % 8 == 0.
template <int WIDTH, int NTHREADS>
static __device__ __forceinline__ void stage_rows(bf16* dst, int ld,
                                                  const bf16* src, int lds,
                                                  int nrows, int valid,
                                                  int tid) {
  constexpr int per_row = WIDTH / 8;
  for (int e = tid; e < nrows * per_row; e += NTHREADS) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    const bool in = r < valid;
    cp_async16(dst + r * ld + c, in ? src + (size_t)r * lds + c : src, in);
  }
}

// out = epilogue(sum_k a[r, k] w[k, n]) in bf16 on the tensor cores, with
// gemm_kernel's epilogues: kEpiBiasT, T(T(acc) + bias[n]) with a bf16
// bias; kEpiBiasResidual, T(res[r, n] + (acc + bias[n])) with an fp32 bias
// (res NULL for the former). a [R, K], w [K, N], bias [N], res and
// out [R, N] row-major; K % 32 == 0, N % 8 == 0. 64 x 64 output tiles over
// four warps (32 x 32 each), operands staged 32 deep by cp.async in a
// three-stage ring. grid (ceil(R/64), ceil(N/64)), 128 threads. (A
// template so that every source including this header may launch it.)
constexpr int kGemmThreads = 128;
constexpr int kGemmBK = 32;
constexpr int kGemmStages = 3;

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads) gemm_bf16_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ w,
    const void* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ out, int R, int K, int N) {
  static_assert(EPI == kEpiBiasT || EPI == kEpiBiasResidual,
                "gemm_bf16_kernel: kEpiBiasT or kEpiBiasResidual");
  constexpr int LDA = pitch(kGemmBK), LDB = pitch(kTile);
  __shared__ __align__(16) bf16 As[kGemmStages][kTile * LDA];
  __shared__ __align__(16) bf16 Bs[kGemmStages][kGemmBK * LDB];
  const int r0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int nk = K / kGemmBK;

  auto load = [&](int kt, int st) {
    const int k0 = kt * kGemmBK;
    // a: 64 rows x 32 columns, 4 chunks of 8 per row
    for (int e = tid; e < kTile * 4; e += kGemmThreads) {
      const int r = e >> 2, c = (e & 3) << 3;
      const bool in = r0 + r < R;
      cp_async16(&As[st][r * LDA + c],
                 in ? a + (size_t)(r0 + r) * K + k0 + c : a, in);
    }
    // w: 32 rows x 64 columns, 8 chunks per row
    for (int e = tid; e < kGemmBK * 8; e += kGemmThreads) {
      const int r = e >> 3, c = (e & 7) << 3;
      const bool in = n0 + c < N;
      cp_async16(&Bs[st][r * LDB + c],
                 in ? w + (size_t)(k0 + r) * N + n0 + c : w, in);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration kt - 1, before the
    // barrier above
    if (kt + kGemmStages - 1 < nk)
      load(kt + kGemmStages - 1, (kt + kGemmStages - 1) % kGemmStages);
    cp_async_commit();
    const bf16* as = As[kt % kGemmStages];
    const bf16* bs = Bs[kt % kGemmStages];
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], frag_a(as, LDA, wm + 16 * i, kk, lane));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_t(bfr[j], frag_b_kn(bs, LDB, kk, wn + 16 * j, lane));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma16816(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          mma16816(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
  }
  cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + 8 * j + 2 * t;
      if (col >= N) continue;
      float b0, b1;
      if (EPI == kEpiBiasT) {
        b0 = bf(((const bf16*)bias)[col]);
        b1 = bf(((const bf16*)bias)[col + 1]);
      } else {
        b0 = ((const float*)bias)[col];
        b1 = ((const float*)bias)[col + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wm + 16 * i + g + 8 * h;
        if (row >= R) continue;
        const size_t off = (size_t)row * N + col;
        float v0, v1;
        if (EPI == kEpiBiasT) {
          v0 = rnd<bf16>(acc[i][j][2 * h]) + b0;
          v1 = rnd<bf16>(acc[i][j][2 * h + 1]) + b1;
        } else {
          const uint32_t rr = *reinterpret_cast<const uint32_t*>(res + off);
          v0 = __uint_as_float(rr << 16) + (acc[i][j][2 * h] + b0);
          v1 = __uint_as_float(rr & 0xffff0000u) + (acc[i][j][2 * h + 1] + b1);
        }
        *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(v0, v1);
      }
    }
}

}  // namespace mtp
