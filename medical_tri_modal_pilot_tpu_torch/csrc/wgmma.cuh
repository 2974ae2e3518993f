// The Hopper GEMM mainloop of the port: out = epi(A . B) on the tensor
// cores through wgmma.mma_async, fed by the Tensor Memory Accelerator.
//
// Shape of the kernel (wg_gemm_kernel), as the card wants it:
//   - Loads: TMA tensor-map loads (cp.async.bulk.tensor.2d) with the
//     128-byte swizzle that wgmma reads, into a ring of kWgStages stages of
//     64-deep K slices (A 128 x 64, B 256 x 64 bf16: 48 KB a stage; three
//     stages beside a staged epilogue's 64 KB tile, else four), each
//     with a full and an empty mbarrier. The tensor maps are built on the
//     host in the C entries (cuTensorMapEncodeTiled, reached through the
//     runtime's driver entry point, so the library links nothing new) and
//     passed as __grid_constant__ parameters.
//   - Warps: warpgroup 0 is the producer (one thread issues the loads; the
//     group gives its registers up with setmaxnreg), warpgroups 1 and 2 the
//     consumers, each owning 64 rows of a 128 x 256 output tile and running
//     wgmma m64n256k16 with the tile's fp32 sum in 128 registers a thread
//     (setmaxnreg raises them to kWgConsumerRegs). A consumer keeps one
//     group of products in flight: it releases a stage once the next
//     stage's products are issued and the earlier ones have retired.
//   - Scheduling: persistent blocks, one an SM, walk the output tiles (and,
//     for sums over rows, the row slices), so that one tile's epilogue
//     overlaps the producer's loads of the next.
//   - Operands: A is K-major ([M][K] row-major: activations) or MN-major
//     ([K][M]: the weight sums, whose depth runs over rows); B likewise
//     ([N][K] or [K][N]); wgmma transposes 16-bit operands itself.
//   - Row flags (valid: int8, one per 64 rows, or NULL): over M (the row
//     products), a 128-row tile whose two halves are both flagged 0 is
//     neither loaded nor multiplied, and a consumer whose own 64 rows are
//     flagged 0 runs the epilogue's dead() in place of its stores; over K
//     (KROWS: sums over rows), a 64-row slice flagged 0 is skipped by the
//     producer and the consumers alike, so its rows may hold anything.
//   - Epilogues (functors). A staged one (kStaged; bf16 outputs) leaves
//     through shared memory: while a tile's first products run, each
//     consumer waits until its half of the output tile (kWgOutBytes / 2,
//     four swizzled [64][64] boxes) has been read by the last tile's TMA
//     stores, fetches the epilogue's C operand (operand(): the residual x,
//     or the hidden layer hd) into its own places of it by cp.async, and
//     over the first four stages draws its keep bits (keep(row, col), a
//     whole warp together: one Philox draw serves two lanes) into shared
//     memory; after the products apply(col, v, c, keep) turns a lane's
//     four sums (rows row and row + 8, columns col and col + 1) into
//     outputs in place, they go to the half, and one thread stores the
//     half by TMA (out_ptr(), out_ld()) without waiting. So the stores,
//     the C operand's loads and the draws overlap the products.
//     Else frag(row, col, v, z, M) stores a lane's four sums itself.
//     dead(r0, rows, n0, tid, nthreads, ncols) runs for a flagged half;
//     with KROWS col(z, col, v0, v1) takes the sums of B's columns col,
//     col + 1 over the unit's live rows (the bias gradient beside the
//     weight's), summed by the m-tile-0 units' first consumer from the
//     swizzled stages in row order. Sums run in a fixed order (no
//     atomics), so results repeat bit for bit.
//
// Written for the ffn split route at C = 512 (ffn_split.cu), where every
// product of the bf16 forward and backward runs on it; it replaces no TPU
// kernel by itself (ffn_split.cu's kernels replace kernels/ffn.py's
// _call_fwd and _call_bwd at that width). Bound on an H100: operations, 2
// M N K at 989 TFLOP/s. The bf16 epilogues stage their tile in shared
// memory and leave by a TMA store, so that the next tile's products do
// not wait on stores from registers; a dropout epilogue's Philox draws
// (one per four outputs) remain its largest cost (PERF.md §6).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include <algorithm>

#include "mma.cuh"

namespace mtp {

constexpr int kWgBM = 128;  // output rows of a tile: two consumers of 64
constexpr int kWgBN = 256;  // output columns of a tile
constexpr int kWgBK = 64;   // depth of a stage: one 128-byte bf16 row
// stages in the ring: four, or three beside a staged epilogue's tile
template <bool STAGED>
constexpr int kWgStages = STAGED ? 3 : 4;
constexpr int kWgThreads = 384;  // the producer warpgroup, two consumers
constexpr int kWgConsumerWarps = 8;  // each releases a stage once
constexpr int kWgProducerRegs = 40;
constexpr int kWgConsumerRegs = 232;
// bytes of a stage's A (128 x 64) and B (256 x 64) tiles, bf16
constexpr int kWgABytes = kWgBM * kWgBK * 2;
constexpr int kWgBBytes = kWgBN * kWgBK * 2;
constexpr int kWgStageBytes = kWgABytes + kWgBBytes;
// a 64 x 64 box (a swizzle atom row of 128 bytes, 64 rows)
constexpr int kWgBox = kWgBK * kWgBK * 2;
static_assert(kWgStageBytes % 1024 == 0, "stages keep the 1024-byte "
              "alignment of the 128-byte swizzle");

// a staged epilogue's output tile: two 64-row halves, one a consumer, of
// four [64 rows][64 columns] bf16 boxes in the 128-byte swizzle
constexpr int kWgOutBytes = kWgBM * kWgBN * 2;

// a staged epilogue's keep bits: four words a consumer thread
constexpr int kWgKeepBytes = 4 * 4 * 2 * 128;

// dynamic shared memory of wg_gemm_kernel: the ring, a staged epilogue's
// tile and keep bits, the ring's mbarriers, and room to align the ring to
// 1024 bytes
__host__ __device__ constexpr int wg_gemm_smem(bool staged) {
  return 1024 + (staged ? 3 : 4) * kWgStageBytes +
         (staged ? kWgOutBytes + kWgKeepBytes : 0) + 2 * (staged ? 3 : 4) * 8;
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive and expect `bytes` of TMA transactions in the current phase
static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
static __device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// the box of map at (c0 inner, c1 outer) into dst, completing on bar
static __device__ __forceinline__ void tma_load_2d(void* dst,
                                                   const CUtensorMap* map,
                                                   int c0, int c1,
                                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the box of shared memory at src to map at (c0 inner, c1 outer), in the
// thread's bulk group; the box's parts past the array are not written
static __device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                                    const void* src, int c0,
                                                    int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}
static __device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until the thread's bulk stores have read their shared memory
static __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// wait until the thread's bulk stores are done
static __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the thread's writes to shared memory, seen by the TMA (async proxy)
static __device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !pred
static __device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                                 bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// a barrier of the 128 threads of one consumer warpgroup (ids 1 and 2)
static __device__ __forceinline__ void wg_bar(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are in flight
template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
static __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
static __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units). K-major tiles (128-byte
// rows of K): the stride is 1024 (eight rows), the leading offset unused;
// MN-major tiles (128-byte rows of MN, one row per k): the stride is 1024
// (eight k rows), the leading offset the distance between 64-wide MN
// boxes.
static __device__ __forceinline__ uint64_t wg_desc(const void* p,
                                                   uint32_t lbo,
                                                   uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// d (+)= a . b for one 64 x 256 x 16 step of a warpgroup, a and b read
// through their shared-memory descriptors; TA / TB 1 where the operand is
// MN-major (wgmma transposes 16-bit operands itself); scale_d 0 overwrites
// d. d holds the 64 x 256 fp32 sum as mma.sync's C fragments of 32 n8
// tiles: d[4 j + e] is row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e &
// 1) of warp w of the warpgroup (g = lane >> 2, t = lane & 3).
template <int TA, int TB>
static __device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                        uint64_t da,
                                                        uint64_t db,
                                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// epi(A . B) over M x N, depth K (see the head of this file). A: the map ta
// of [M][K] (AMN false; boxes 64 k x 128 rows) or [K][M] (AMN; boxes 64 x
// 64); B: tb of [N][K] (BMN false; 64 k x 256 rows) or [K][N] (BMN; 64 x
// 64); to: the output's map (a staged epilogue's; boxes 64 x 64). M, N
// multiples of kWgBM, kWgBN (M ragged for row products), K of kWgBK;
// KROWS: K runs over rows (ragged) in `slices` slices of kslice rows
// (multiples of kWgBK), unit z of a tile summing slice z; else slices = 1.
// grid: at most one block an SM, kWgThreads threads,
// wg_gemm_smem(Epi::kStaged) bytes.
template <bool AMN, bool BMN, bool KROWS, class Epi>
__global__ void __launch_bounds__(kWgThreads, 1) wg_gemm_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap to,
    const int8_t* __restrict__ valid, Epi epi, int M, int N, int K,
    int slices, int kslice) {
  static_assert(!KROWS || BMN, "the column sums read MN-major B stages");
  constexpr bool STAGED = Epi::kStaged;
  static_assert(!(STAGED && KROWS), "sums over rows store from registers");
  constexpr int S = kWgStages<STAGED>;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* obuf = ring + S * kWgStageBytes;  // STAGED
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(obuf + kWgOutBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      obuf + (STAGED ? kWgOutBytes + kWgKeepBytes : 0));
  uint64_t* empty = full + S;
  const int mtiles = (M + kWgBM - 1) / kWgBM, ntiles = N / kWgBN;
  const int units = mtiles * ntiles * (KROWS ? slices : 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // unit u: its tile (mt, nt) and row slice z; its depth [k0, k1)
  auto unit = [&](int u, int& mt, int& nt, int& z, int& k0, int& k1) {
    z = KROWS ? u % slices : 0;
    const int t = KROWS ? u / slices : u;
    mt = t / ntiles;
    nt = t - mt * ntiles;
    k0 = KROWS ? z * kslice : 0;
    k1 = KROWS ? min(K, k0 + kslice) : K;
  };
  auto half_live = [&](int mt, int h) {
    const int r = mt * kWgBM + h * (kWgBM / 2);
    return r < M && (valid == nullptr || valid[r / kTile] != 0);
  };
  auto chunk_live = [&](int k) {
    return !KROWS || valid == nullptr || valid[k / kTile] != 0;
  };
  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread keeps the ring full
    reg_dealloc<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      int s = 0, ph = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int mt, nt, z, k0, k1;
        unit(u, mt, nt, z, k0, k1);
        if (!KROWS && !half_live(mt, 0) && !half_live(mt, 1)) continue;
        const int m0 = mt * kWgBM, n0 = nt * kWgBN;
        for (int k = k0; k < k1; k += kWgBK) {
          if (!chunk_live(k)) continue;
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], kWgStageBytes);
          unsigned char* a = ring + s * kWgStageBytes;
          unsigned char* b = a + kWgABytes;
          if (AMN) {
            tma_load_2d(a, &ta, m0, k, &full[s]);
            tma_load_2d(a + kWgBox, &ta, m0 + kWgBK, k, &full[s]);
          } else {
            tma_load_2d(a, &ta, k, m0, &full[s]);
          }
          if (BMN) {
#pragma unroll
            for (int i = 0; i < kWgBN / kWgBK; ++i)
              tma_load_2d(b + i * kWgBox, &tb, n0 + i * kWgBK, k, &full[s]);
          } else {
            tma_load_2d(b, &tb, k, n0, &full[s]);
          }
          if (++s == S) s = 0, ph ^= 1;
        }
      }
    }
  } else {
    reg_alloc<kWgConsumerRegs>();
    const int ct = threadIdx.x - 128, cw = ct >> 7;  // consumer 0 or 1
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    // this lane's rows 16 warp + g (+ 8) of its half, and where its pair
    // of columns 8 j + 2 t sits in that half's swizzled output boxes
    const int hr = 16 * warp + g;
    unsigned char* half = obuf + cw * (kWgOutBytes / 2);
    auto opos = [&](int r, int j) {
      return half + (j >> 3) * kWgBox + r * 128 +
             ((((j & 7) ^ (r & 7)) << 4) | (t << 2));
    };
    bool stored = false;  // a bulk store of this thread is in flight
    int s = 0, ph = 0;
    float acc[128];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int mt, nt, z, k0, k1;
      unit(u, mt, nt, z, k0, k1);
      const int r0 = mt * kWgBM + cw * (kWgBM / 2), n0 = nt * kWgBN;
      const int rows = min(kWgBM / 2, M - r0);
      const int row = r0 + hr;
      if (!KROWS && !half_live(mt, 0) && !half_live(mt, 1)) {
        if (rows > 0) epi.dead(r0, rows, n0, ct & 127, 128, kWgBN);
        continue;
      }
      const bool live = KROWS || half_live(mt, cw);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      // B's columns 2 ct, 2 ct + 1 summed over the unit's live rows
      // (KROWS, m-tile 0, the first consumer)
      const bool csum = KROWS && mt == 0 && cw == 0;
      float cs0 = 0.0f, cs1 = 0.0f;
      // a staged epilogue's keep bits: keep_s[w][ct], word w holding
      // fragments 8 w .. 8 w + 7, drawn at stage w < 4 beside the products
      // (eight independent Philox chains: a draw issues slowly with two
      // consumer warps a scheduler, and the chains let them overlap)
      uint32_t* kb = keep_s + ct;
      auto draw = [&](int w) {
        if constexpr (STAGED) {
          uint32_t bits = 0u;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            bits |= epi.keep(row, n0 + 8 * (8 * w + q) + 2 * t) << (4 * q);
          kb[w * 256] = bits;
        }
      };
      int prev = -1, it = 0;
      for (int k = k0; k < k1; k += kWgBK) {
        if (!chunk_live(k)) continue;
        mbar_wait(&full[s], ph);
        const unsigned char* a = ring + s * kWgStageBytes;
        const unsigned char* b = a + kWgABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          // consumer cw's 64 rows: box cw (MN-major), or rows 64 cw ..
          // of 128-byte rows (K-major), kWgBox bytes in either layout
          const uint64_t da =
              AMN ? wg_desc(a + cw * kWgBox + kk * 2048, kWgBox, 1024)
                  : wg_desc(a + cw * kWgBox + kk * 32, 16, 1024);
          const uint64_t db = BMN ? wg_desc(b + kk * 2048, kWgBox, 1024)
                                  : wg_desc(b + kk * 32, 16, 1024);
          wgmma_m64n256k16<AMN, BMN>(acc, da, db, 1);
        }
        wgmma_commit();
        if constexpr (STAGED) {
          if (live) {
            if (it == 0) {
              // while the first products run: once the last tile's
              // stores have read this half, its C operand into the half
              // (each lane's own places)
              if (stored && (ct & 127) == 0) bulk_wait_read();
              wg_bar(cw);
              const bf16* cop = epi.operand();
              if (cop != nullptr)
#pragma unroll 4
                for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int r = row + 8 * h;
                    cp_async4(opos(hr + 8 * h, j),
                              cop + (size_t)min(r, M - 1) * epi.operand_ld() +
                                  n0 + 8 * j + 2 * t,
                              r < M);
                  }
              cp_async_commit();
            }
            if (it < kWgBN / 64) draw(it);
          }
        }
        if (csum) {
          // columns 2 ct, 2 ct + 1 of the stage's [64 k][64 n] boxes,
          // swizzled: row r's 16-byte chunk q sits at chunk q ^ (r & 7)
          const int n = 2 * ct, q = (n & 63) >> 3;
          const unsigned char* col = b + (n >> 6) * kWgBox + (n & 7) * 2;
#pragma unroll 8
          for (int r = 0; r < kWgBK; ++r) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    col + r * 128 + ((q ^ (r & 7)) << 4)));
            cs0 += v.x;
            cs1 += v.y;
          }
        }
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        ++it;
        if (++s == S) s = 0, ph ^= 1;
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      if constexpr (STAGED)  // the draws a short depth left
        if (live)
          for (; it < kWgBN / 64; ++it) draw(it);
      if (!live) {
        if (rows > 0) epi.dead(r0, rows, n0, ct & 127, 128, kWgBN);
        continue;
      }
      if constexpr (STAGED) {
        // the tile through this half's boxes, then out by TMA stores
        cp_async_wait_all();
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          uint32_t* p0 = reinterpret_cast<uint32_t*>(opos(hr, j));
          uint32_t* p1 = reinterpret_cast<uint32_t*>(opos(hr + 8, j));
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (epi.operand() != nullptr) {
            const float2 c0 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p0));
            const float2 c1 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p1));
            c[0] = c0.x, c[1] = c0.y, c[2] = c1.x, c[3] = c1.y;
          }
          float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                        acc[4 * j + 3]};
          epi.apply(n0 + 8 * j + 2 * t, v, c,
                    (kb[(j >> 3) * 256] >> (4 * (j & 7))) & 0xFu);
          *p0 = pack_bf16(v[0], v[1]);
          *p1 = pack_bf16(v[2], v[3]);
        }
        fence_async_shared();
        wg_bar(cw);
        if ((ct & 127) == 0) {
#pragma unroll
          for (int i = 0; i < kWgBN / kWgBK; ++i)
            tma_store_2d(&to, half + i * kWgBox, n0 + i * kWgBK, r0);
          bulk_commit();
          stored = true;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          const float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                              acc[4 * j + 3]};
          epi.frag(row, n0 + 8 * j + 2 * t, v, z, M);
        }
        if constexpr (KROWS)
          if (csum) epi.col(z, n0 + 2 * ct, cs0, cs1);
      }
    }
    if (STAGED && stored) bulk_wait();
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (so the library links no libcuda), NULL if the driver has none
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// the tensor map of a row-major bf16 [outer][inner] array (row stride ld
// elements) in boxes of box_inner x box_outer (box_inner * 2 = 128 bytes,
// the swizzle's row), 128-byte swizzle, zeros past the array's edges
static bool wg_tmap(CUtensorMap* map, const void* base, int inner, int outer,
                    int ld, int box_inner, int box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dim, stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch epi(A . B): a with row stride lda ([M][K], or [K][M] with AMN), b
// with ldb ([N][K], or [K][N] with BMN); one block an SM at most. A staged
// epilogue names its bf16 [M][N] output (out, ldo).
template <bool AMN, bool BMN, bool KROWS, class Epi>
static cudaError_t launch_wg_gemm(const bf16* a, int lda, const bf16* b,
                                  int ldb, const int8_t* valid,
                                  const Epi& epi, int M, int N, int K,
                                  int slices, int kslice,
                                  cudaStream_t stream) {
  if (M <= 0 || N % kWgBN != 0 || K <= 0 || slices <= 0 ||
      (!KROWS && K % kWgBK != 0) ||
      (KROWS && (kslice % kWgBK != 0 || M % kWgBM != 0)))
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb, to;
  bool ok =
      (AMN ? wg_tmap(&ta, a, M, K, lda, kWgBK, kWgBK)
           : wg_tmap(&ta, a, K, M, lda, kWgBK, kWgBM)) &&
      (BMN ? wg_tmap(&tb, b, N, K, ldb, kWgBK, kWgBK)
           : wg_tmap(&tb, b, K, N, ldb, kWgBK, kWgBN));
  if constexpr (Epi::kStaged)
    ok = ok && wg_tmap(&to, epi.out_ptr(), N, M, epi.out_ld(), kWgBK,
                       kWgBM / 2);
  else
    to = ta;  // unread
  if (!ok) return cudaErrorInvalidValue;
  constexpr int smem = wg_gemm_smem(Epi::kStaged);
  auto kernel = wg_gemm_kernel<AMN, BMN, KROWS, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int units = (M + kWgBM - 1) / kWgBM * (N / kWgBN) *
                    (KROWS ? slices : 1);
  kernel<<<std::min(units, sms), kWgThreads, smem, stream>>>(
      ta, tb, to, valid, epi, M, N, K, slices, kslice);
  return cudaGetLastError();
}

}  // namespace mtp
