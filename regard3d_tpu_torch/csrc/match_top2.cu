// Fused squared-L2 distance + running top-2 nearest-neighbour search, and
// the two ablations of it that split its time between product and merge.
//
// Replaces the three Pallas TPU kernels of the JAX package:
//   K1  regard3d_tpu/kernels/match.py:l2_top2_block_pallas
//       (_match_block_kernel): a block of P image pairs read through a
//       (P, 2) pair table out of one (B, N, D) descriptor array;
//   K2  regard3d_tpu/kernels/match.py:l2_top2_pallas (_match_kernel): one
//       (M, D) x (N, D) pair with a mask on B, its own entry point: a fused
//       prologue kernel and one cluster launch of the K1 bodies with P = 1;
//   K3  tools/profile_matcher.py:_ablated_block (_ablate_kernel): K1's bf16
//       grid with the top-2 merge ablated, as two epilogue modes of the bf16
//       kernel below (MM_ONLY, MIN_ONLY), so they share its tiling exactly.
//
// For every pair p and row r of A = desc[pairs[p, 0]] the FULL mode returns
// d1 = the smallest and d2 = the second smallest squared L2 distance to the
// rows of B = desc[pairs[p, 1]], and i1 = the column of d1. It keeps the TPU
// kernel's arithmetic: d = |b|^2 - 2 a.b with |b|^2 precomputed by the
// caller from the f32 descriptors (3e38 on masked rows of B), |a|^2 added
// once at the end from the values the product saw, the sum clamped at 0.
// Ties go to the lowest column (lax.top_k / argmin semantics); an equal
// second value gives d2 == d1. Ragged M and N are masked in the kernel
// (rows of A and B past the end are zero-filled by TMA, their |b|^2 is
// 3e38).
//
// MM_ONLY: out[p, r] = min(3e38, min over column tiles t of a_r . b_{t*TN}),
// the first column of every 128-wide tile, no |b|^2, no mask. MIN_ONLY:
// out[p, r] = min(3e38, min over all columns of |b|^2 - 2 a.b), no |a|^2,
// no clamp. Both return only d1.
//
// What bounds each case on an H100 SXM: 2 * P * M * N * D operations;
// the bytes (B * N * D inputs, 3 * P * M outputs) are small next to them.
// Both kernels are warp-specialised for Hopper: a block of 384 threads is
// one producer warpgroup, whose first warp keeps TMA loads
// (cp.async.bulk.tensor) in flight into a ring of shared-memory stages
// guarded by mbarriers (full: the bytes landed; empty: every consumer warp
// is done with the stage), and two consumer warpgroups. The producer gives
// its registers to the consumers (setmaxnreg 40 / 232); its other three
// warps sum |a|^2 of the block's rows while the consumers work. Rows of A
// and B are k-contiguous in shared memory as TMA lands them, from a tensor
// map over (images, rows, D) with a 128-row box; one block per SM.
//   * bf16 (K1 ANN presets, K3): the tensor cores, 989 TFLOP/s dense. The
//     block's 128-row A tile stays resident; 128 x 128 B tiles and their
//     |b|^2 stream through a four-stage ring. D = 144 is 288 bytes a row
//     and the 128-byte swizzle takes at most 64 bf16, so a tile is two
//     64-wide boxes under the 128-byte swizzle and one 16-wide box under
//     the 32-byte swizzle, each with its own wgmma descriptor: 36 KB a
//     tile, where three zero-filled 64-wide boxes would take 48 KB and
//     leave room for three stages. Each consumer warpgroup owns 64 rows and
//     runs wgmma.mma_async m64n128k16 (A and B from shared memory) into two
//     accumulator sets in turn: the wgmma of tile t+1 is in flight while
//     the warpgroup runs the top-2 of tile t on its fragments (rows
//     lane/4 and lane/4 + 8 of its warp's 16, columns 8j + 2 (lane % 4) +
//     {0, 1}, visited in increasing order with a strict '<'). Every wgmma
//     issue is unconditional in the loop body, so ptxas can tell which
//     accumulator set a wait retires and injects no wait of its own (it
//     did when the issue sat under a branch: the merge then ran after the
//     product, not beside it). The top-2's ALU work (~5 FMNMX/FSETP/SEL a
//     distance) now bounds FULL; a vote-and-skip epilogue and a ballot of
//     the column groups to visit were both slower, and five stages or a
//     240/24 register split were no faster (tools/kernel_report.py;
//     PERF.md). The product stays live in MM_ONLY although its epilogue
//     reads one column per tile: ptxas deletes an mma whose result is
//     dead, so MM_ONLY also reads every accumulator under a branch on a
//     kernel argument that is 0 at run time; chip_smoke.py counts the
//     HGMMA of each mode in the SASS. A compile-time D = 144 (LIOP) unrolls
//     the k loop; D at run time (up to 288) takes a two-stage ring.
//   * f32 (the stage's default, K2): FP32 FFMA, 67 TFLOP/s; no TF32, so the
//     result matches Precision.HIGHEST up to summation order. A stage holds
//     one 32-deep k slice (128 bytes a row, 128-byte swizzle, the last one
//     zero-filled past D by TMA) of the A tile and of two B tiles: consumer
//     warpgroup w takes column tile 2s + w of step s, so one block per SM
//     walks its columns two tiles at a time, and a 768-column call (384
//     blocks) runs in under three even waves where two blocks per SM left
//     a 1.45-wave tail. A thread owns an 8 x 16 micro-tile (rows rg + 4i,
//     columns cg + 8j of its warp's 32 x 128, lane = 8 rg + cg), read as
//     float4 along k from the swizzled rows without bank conflicts: 512
//     FFMA per 24 shared loads, the 128 accumulators in the consumers' 232
//     registers without spills. The two warpgroups' top-2 meet in shared
//     memory at the end.
//   * Small grids (K2: 4000 rows make 32 row tiles for 132 SMs): the
//     columns are split over the R ranks of a thread-block cluster
//     (cudaLaunchKernelEx with a cluster dimension along z, R <= 8, so
//     blockIdx.z is the rank and the R blocks sit on R SMs of one GPC). The
//     ranks of a cluster share one 128-row tile of A; rank r walks a
//     contiguous range of whole column tiles, publishes its partial (d1,
//     i1, d2) per row in its shared memory, and after a cluster barrier
//     rank r merges rows [128 r / R, 128 (r+1) / R)
//     over all ranks through distributed shared memory (mapa +
//     ld.shared::cluster), in increasing rank, that is column, order, with
//     the index-aware tie rule (an exact tie across ranks keeps the lower
//     column and gives d2 == d1), and stores them. A second cluster barrier
//     keeps every block resident until its peers have read it. One launch,
//     no scratch in device memory, no merge kernel. The caller picks R from
//     how many clusters the card holds (cudaOccupancyMaxActiveClusters: an
//     H100's GPCs hold 30 clusters of 4 such blocks, 39 of 3), so K2's
//     (4000, 3001) call is one wave: 32 clusters of 3 ranks x 8 tiles.
//     Both dtypes; FULL mode only (the K3 modes time K1's grid, which needs
//     no split). With R = 1 a block stores its rows itself, as K1 does.
//     The rank is blockIdx.z, as in the earlier split over blockIdx.z:
//     with the ranks folded into blockIdx.x instead, ptxas scheduled K1's
//     f32 loop otherwise and K1 f32 ran 2.5-2.9% slower.
//   * K2's prologue (l2_top2_prep_kernel, a warp a row): |b|^2 from the
//     values as given under the mask, and with `round` the bf16 copies of
//     both f32 operands that the tensor-core kernel's tensor maps read, in
//     one pass over A and B (4 MB at K2's shape) into a caller-allocated
//     workspace. Done once a call here, where doing it in the main kernel's
//     producer warps would repeat it in every row-tile cluster (32 times at
//     K2's shape) and, for bf16, write the 128-byte swizzle from the
//     generic proxy behind an extra ring stage.
// The tensor maps are encoded on the host for every call
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion
// so the library needs no -lcuda; a cache of them saved no host time that
// stood out from the host's noise) and passed as __grid_constant__
// parameters. The caller does not pass the image counts, so a map's image
// extent is 2^31: TMA bounds the rows and columns, the caller the pair
// indices.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TM = 128;       // rows of A per block
constexpr int TN = 128;       // columns (rows of B) per tile
constexpr int THREADS = 384;  // one producer and two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int BF16_STAGES_144 = 4;  // ring depth at D = 144
constexpr int BF16_STAGES_RT = 2;   // ring depth with D at run time
constexpr int F32_STAGES = 4;
constexpr int F32_KS = 32;          // depth of one f32 k slice (128 bytes)
constexpr int F32_SLICE = TM * F32_KS * 4;  // bytes of one tile's slice
constexpr float BIG = 3.0e38f;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_DEVICES = 64;   // devices whose kernel attributes are cached
constexpr int MAX_RANKS = 8;      // blocks of a cluster (the portable limit)
constexpr int PREP_THREADS = 256; // the prologue's block: a warp a row
constexpr unsigned IMAGES = 1u << 31;  // image extent of a tensor map

enum Mode { FULL = 0, MM_ONLY = 1, MIN_ONLY = 2 };

// ---------------------------------------------------------------------------
// running top-2
// ---------------------------------------------------------------------------

// visit column c with distance v; columns arrive in increasing order, so a
// strict '<' keeps the lowest index among equal values
__device__ __forceinline__ void push(float v, int c, float& d1, int& i1,
                                     float& d2) {
  const bool lt = v < d1;
  d2 = fminf(d2, fmaxf(d1, v));
  i1 = lt ? c : i1;
  d1 = fminf(d1, v);
}

// merge a partial result over a disjoint set of columns (any order)
__device__ __forceinline__ void merge(float& d1, int& i1, float& d2,
                                      float od1, int oi1, float od2) {
  if (od1 < d1 || (od1 == d1 && oi1 < i1)) {
    d2 = fminf(od2, d1);
    d1 = od1;
    i1 = oi1;
  } else {
    d2 = fminf(d2, od1);
  }
}

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma, register hand-over
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and announce `bytes` of TMA traffic that complete the phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// announce `bytes` of TMA traffic that complete the phase, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map (k, row, image) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row,
                                         int img) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row),
      "r"(img)
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// barrier `id` over the `n` threads of the consumer warpgroups
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins the accumulators: reads after a wgmma_wait stay after it
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor of a K-major operand: start address,
// stride between 8-row groups (sbo bytes), swizzle (1 = 128 B, 3 = 32 B);
// the leading offset is unused by swizzled K-major layouts
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

#define R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define R16(i) R4(i), R4(i + 4), R4(i + 8), R4(i + 12)

// d (64 x 128, f32) = or += A (64 x 16, bf16) * B^T (128 x 16, bf16), both
// K-major in shared memory; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : R16(0), R16(16), R16(32), R16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef R16
#undef R4

// ---------------------------------------------------------------------------
// clusters: the ranks of one row tile merge their column ranges
// ---------------------------------------------------------------------------

// every non-exited thread of the cluster arrives (release) and waits
// (acquire): shared-memory writes before it are seen by peers after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the 32-bit word at shared address `addr` of this block, read in the
// block of cluster rank `rank` (distributed shared memory)
__device__ __forceinline__ uint32_t ld_rank(uint32_t addr, int rank) {
  uint32_t remote, v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(remote)
      : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.b32 %0, [%1];\n" : "=r"(v) : "r"(remote));
  return v;
}

// Row rl (r = row0 + rl, output o) with the block's top-2 (d1, i1, d2)
// over its columns and |a|^2 an. One rank: the block stores the row, final
// (d1 + |a|^2, i1, d2 + |a|^2) clamped at 0. R ranks: every rank publishes
// its partial in red ([3][TM] words of shared memory); rank rl * R / TM
// merges the row over the ranks in increasing rank (column) order and
// stores it. Every thread that holds a row calls this, in every rank.
__device__ __forceinline__ void finish_row(int rl, int r, int M, long long o,
                                           float d1, int i1, float d2,
                                           float an, float* red, int ranks,
                                           int rank, float* d1o, int* i1o,
                                           float* d2o) {
  if (ranks > 1) {
    red[rl] = d1;
    reinterpret_cast<int*>(red)[TM + rl] = i1;
    red[2 * TM + rl] = d2;
    cluster_sync();
    const bool mine = rl * ranks / TM == rank;
    if (mine) {
      // every rank's partial in flight at once, then merged in rank order
      const uint32_t base = smem_u32(red) + 4 * rl;
      uint32_t w[MAX_RANKS][3];
#pragma unroll
      for (int q = 0; q < MAX_RANKS; ++q)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (q < ranks) w[q][k] = ld_rank(base + 4 * TM * k, q);
      d1 = __uint_as_float(w[0][0]);
      i1 = (int)w[0][1];
      d2 = __uint_as_float(w[0][2]);
#pragma unroll
      for (int q = 1; q < MAX_RANKS; ++q)
        if (q < ranks)
          merge(d1, i1, d2, __uint_as_float(w[q][0]), (int)w[q][1],
                __uint_as_float(w[q][2]));
    }
    // no block exits while a peer may still read its red
    cluster_sync();
    if (!mine) return;
  }
  if (r >= M) return;
  d1o[o] = fmaxf(d1 + an, 0.f);
  i1o[o] = i1;
  d2o[o] = fmaxf(d2 + an, 0.f);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (K1 bf16, K2 bf16, K3)
// ---------------------------------------------------------------------------

// A tile of 128 rows x D bf16 in shared memory: D / 64 regions of 64
// columns (128-byte rows, 128B swizzle, 16 KB) and then (D % 64) / 16
// regions of 16 columns (32-byte rows, 32B swizzle, 4 KB); 256 D bytes.
struct Bf16Tile {
  int q, r, nk, bytes;
  __device__ __forceinline__ explicit Bf16Tile(int D)
      : q(D >> 6), r((D & 63) >> 4), nk(D >> 4), bytes(TM * D * 2) {}
  // descriptor of k step s (16 columns) for the 64 rows from row0 of the
  // tile at `base`
  __device__ __forceinline__ uint64_t desc(uint32_t base, int s,
                                           int row0) const {
    if (s < 4 * q)
      return smem_desc(base + (s >> 2) * 16384 + row0 * 128 + (s & 3) * 32,
                       1024, 1);
    return smem_desc(base + q * 16384 + (s - 4 * q) * 4096 + row0 * 32, 256,
                     3);
  }
  // the boxes of rows row0.. of image img, from the two maps
  __device__ __forceinline__ void load(uint32_t base, const CUtensorMap* m128,
                                       const CUtensorMap* m32, uint32_t bar,
                                       int row0, int img) const {
    for (int c = 0; c < q; ++c)
      tma_load(base + c * 16384, m128, bar, 64 * c, row0, img);
    for (int c = 0; c < r; ++c)
      tma_load(base + q * 16384 + c * 4096, m32, bar, 64 * q + 16 * c, row0,
               img);
  }
};

// the product of one column tile into acc: nk wgmma k steps, one group
template <int DC>
__device__ __forceinline__ void mma_tile(float (&acc)[64], const Bf16Tile& tl,
                                         uint32_t a_base, uint32_t b_base,
                                         int arow0) {
  wgmma_fence();
  if (DC > 0) {
#pragma unroll
    for (int s = 0; s < DC / 16; ++s)
      wgmma_m64n128(acc, tl.desc(a_base, s, arow0), tl.desc(b_base, s, 0),
                    s > 0);
  } else {
    for (int s = 0; s < tl.nk; ++s)
      wgmma_m64n128(acc, tl.desc(a_base, s, arow0), tl.desc(b_base, s, 0),
                    s > 0);
  }
  wgmma_commit();
}

// the top-2 (or an ablation) of one column tile on the fragments:
// acc[4j + 2h + e] is row g + 8h of the warp's 16, column 8j + 2t + e
template <int MODE>
__device__ __forceinline__ void epilogue(const float (&acc)[64],
                                         const float* bns, int col0, int t,
                                         float (&d1)[2], int (&i1)[2],
                                         float (&d2)[2], int keep_live) {
  if (MODE == MM_ONLY) {
    if (t == 0) {
      d1[0] = fminf(d1[0], acc[0]);
      d1[1] = fminf(d1[1], acc[2]);
    }
    // ptxas deletes an mma whose result is never read, `asm volatile` or
    // not; every accumulator is read under a branch on an argument that
    // is 0 at run time, so the whole product stays
    if (keep_live) {
#pragma unroll
      for (int q = 0; q < 64; ++q)
        d1[(q >> 1) & 1] = fminf(d1[(q >> 1) & 1], acc[q]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 16 && MODE != MM_ONLY; ++j) {
    const float2 bn = *reinterpret_cast<const float2*>(bns + 8 * j + 2 * t);
    const int c = col0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = fmaf(-2.f, acc[4 * j + 2 * h], bn.x);
      const float v1 = fmaf(-2.f, acc[4 * j + 2 * h + 1], bn.y);
      if (MODE == MIN_ONLY) {
        d1[h] = fminf(d1[h], fminf(v0, v1));
      } else {
        push(v0, c, d1[h], i1[h], d2[h]);
        push(v1, c + 1, d1[h], i1[h], d2[h]);
      }
    }
  }
}

// one step of a consumer warpgroup: the tile in acc (ring slot i) is in
// flight; unless it is the last, start tile + 1 into other; wait for acc,
// merge it, free its slot. Every issue is unconditional, so ptxas can tell
// which accumulator set a wait retires.
template <int MODE, int DC, int STAGES, bool LAST>
__device__ __forceinline__ void consume(
    float (&acc)[64], float (&other)[64], const Bf16Tile& tl, int tile, int i,
    uint32_t a_base, uint32_t b_base, uint32_t bars, const float* bns,
    int arow0, int t, int lane, float (&d1)[2], int (&i1)[2], float (&d2)[2],
    int keep_live) {
  if (!LAST) {
    const int sn = (i + 1) % STAGES;
    mbar_wait(bars + 8 * sn, ((i + 1) / STAGES) & 1);
    mma_tile<DC>(other, tl, a_base, b_base + sn * tl.bytes, arow0);
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_acc(acc);
  const int s = i % STAGES;
  epilogue<MODE>(acc, bns + s * TN, tile * TN, t, d1, i1, d2, keep_live);
  __syncwarp();
  if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
}

// DC > 0 fixes D at compile time (LIOP's 144) and unrolls the k loop;
// DC = 0 takes D at run time. STAGES: depth of the B ring.
template <int MODE, int DC, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
l2_top2_wgmma_kernel(__grid_constant__ const CUtensorMap a128,
                     __grid_constant__ const CUtensorMap a32,
                     __grid_constant__ const CUtensorMap b128,
                     __grid_constant__ const CUtensorMap b32,
                     const __nv_bfloat16* __restrict__ A,
                     const float* __restrict__ bnorm,
                     const int* __restrict__ pairs, int M, int N, int Drt,
                     int tiles_per_rank, float* __restrict__ out_d1,
                     int* __restrict__ out_i1, float* __restrict__ out_d2,
                     int keep_live) {
  extern __shared__ unsigned char smem_raw[];
  const int D = DC > 0 ? DC : Drt;
  const Bf16Tile tl(D);
  // 1024-byte alignment for the 128B swizzle's pattern
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + tl.bytes;                 // [STAGES]
  float* bns = reinterpret_cast<float*>(smem + (1 + STAGES) * tl.bytes);
  float* ans = bns + STAGES * TN;                            // [TM] |a|^2
  const uint32_t bars = smem_u32(ans + TM);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s), then the A
  // tile's and |a|^2's
  const uint32_t a_full = bars + 16 * STAGES;
  const uint32_t an_full = a_full + 8;
  // the cluster's partials, [3][TM] words after the barriers
  float* red = reinterpret_cast<float*>(smem + (1 + STAGES) * tl.bytes +
                                        (STAGES * TN + TM) * 4 +
                                        8 * (2 * STAGES + 2));

  // blockIdx.z is the rank: a cluster spans z
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int ia = pairs[2 * p];
  const int ib = pairs[2 * p + 1];
  const int ntiles = (N + TN - 1) / TN;
  const int t0 = blockIdx.z * tiles_per_rank;
  const int n = min(t0 + tiles_per_rank, ntiles) - t0;    // tiles of the range
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 32);                 // the producer warp
      mbar_init(bars + 8 * (STAGES + s), 8);       // the consumer warps
    }
    mbar_init(a_full, 1);
    mbar_init(an_full, 96);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // producer warpgroup: its first warp loads the tiles through TMA and
    // |b|^2 (3e38 past N) through its registers, a tile ahead; the other
    // three take |a|^2 of the A tile's rows from the bf16 values the
    // product sees, in increasing k
    regs_release<PRODUCER_REGS>();
    if (warp != 0) {
      if (MODE == FULL) {
        for (int x = threadIdx.x - 32; x < TM; x += 96) {
          const int r = row0 + x;
          float an = 0.f;
          if (r < M) {
            const uint4* arow = reinterpret_cast<const uint4*>(
                A + ((long long)ia * M + r) * D);
            for (int c = 0; c < D / 8; ++c) {
              const uint4 v = __ldg(arow + c);
              const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&w4[u]));
                an = fmaf(f.x, f.x, an);
                an = fmaf(f.y, f.y, an);
              }
            }
          }
          ans[x] = an;
        }
        mbar_arrive(an_full);
      }
      return;
    }
    if (lane == 0) {
      mbar_arrive_tx(a_full, tl.bytes);
      tl.load(a_base, &a128, &a32, a_full, row0, ia);
    }
    const float* bn = bnorm + (long long)ib * N;
    float next[TN / 32];
    auto fetch = [&](int tile) {
#pragma unroll
      for (int u = 0; u < TN / 32; ++u) {
        const int c = tile * TN + 32 * u + lane;
        next[u] = c < N ? __ldg(bn + c) : BIG;
      }
    };
    if (n > 0) fetch(t0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      mbar_wait(bars + 8 * (STAGES + s), ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bars + 8 * s, tl.bytes);
        tl.load(b_base + s * tl.bytes, &b128, &b32, bars + 8 * s,
                (t0 + i) * TN, ib);
      }
#pragma unroll
      for (int u = 0; u < TN / 32; ++u) bns[s * TN + 32 * u + lane] = next[u];
      if (i + 1 < n) fetch(t0 + i + 1);
      mbar_arrive(bars + 8 * s);
    }
    return;
  }

  // consumer warpgroup cw owns rows 64 cw .. 64 cw + 63 of the tile; a
  // lane holds rows g and g + 8 of its warp's 16
  regs_claim<CONSUMER_REGS>();
  const int cw = (warp >> 2) - 1;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int arow0 = 64 * cw;
  float d1[2] = {BIG, BIG}, d2[2] = {BIG, BIG};
  int i1[2] = {0, 0};
  float acc0[64], acc1[64];

  mbar_wait(a_full, 0);
  if (n > 0) {
    mbar_wait(bars, 0);
    mma_tile<DC>(acc0, tl, a_base, b_base, arow0);
    // tile k is in flight in acc0 at the top of every pass
    int k = 0;
    for (; k + 2 < n; k += 2) {
      consume<MODE, DC, STAGES, false>(acc0, acc1, tl, t0 + k, k, a_base,
                                       b_base, bars, bns, arow0, t, lane, d1,
                                       i1, d2, keep_live);
      consume<MODE, DC, STAGES, false>(acc1, acc0, tl, t0 + k + 1, k + 1,
                                       a_base, b_base, bars, bns, arow0, t,
                                       lane, d1, i1, d2, keep_live);
    }
    if (k + 1 < n) {
      consume<MODE, DC, STAGES, false>(acc0, acc1, tl, t0 + k, k, a_base,
                                       b_base, bars, bns, arow0, t, lane, d1,
                                       i1, d2, keep_live);
      consume<MODE, DC, STAGES, true>(acc1, acc0, tl, t0 + k + 1, k + 1,
                                      a_base, b_base, bars, bns, arow0, t,
                                      lane, d1, i1, d2, keep_live);
    } else {
      consume<MODE, DC, STAGES, true>(acc0, acc1, tl, t0 + k, k, a_base,
                                      b_base, bars, bns, arow0, t, lane, d1,
                                      i1, d2, keep_live);
    }
  }

  // merge the 4 lanes of a quad (same rows, other columns): every lane of
  // the quad ends with the rows' result
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float od1 = __shfl_xor_sync(0xffffffffu, d1[h], off);
      if (MODE == FULL) {
        const int oi1 = __shfl_xor_sync(0xffffffffu, i1[h], off);
        const float od2 = __shfl_xor_sync(0xffffffffu, d2[h], off);
        merge(d1[h], i1[h], d2[h], od1, oi1, od2);
      } else {
        d1[h] = fminf(d1[h], od1);
      }
    }
  // lane t < 2 of the quad writes row g + 8 t
  if (t >= 2) return;
  const int rl = arow0 + 16 * (warp & 3) + g + 8 * t;
  const int r = row0 + rl;
  const long long o = (long long)p * M + r;
  const float rd1 = t ? d1[1] : d1[0];
  if (MODE != FULL) {
    if (r < M) out_d1[o] = rd1;
    return;
  }
  mbar_wait(an_full, 0);
  finish_row(rl, r, M, o, rd1, t ? i1[1] : i1[0], t ? d2[1] : d2[0], ans[rl],
             red, gridDim.z, blockIdx.z, out_d1, out_i1, out_d2);
}

// ---------------------------------------------------------------------------
// f32 FFMA kernel (K1 f32, K2 f32)
// ---------------------------------------------------------------------------

// byte offset of the 16-byte chunk kc of row r in a 128B-swizzled slice
__device__ __forceinline__ int swz128(int r, int kc) {
  return r * 128 + ((kc ^ (r & 7)) << 4);
}

__global__ void __launch_bounds__(THREADS, 1)
l2_top2_f32_kernel(__grid_constant__ const CUtensorMap amap,
                   __grid_constant__ const CUtensorMap bmap,
                   const float* __restrict__ A,
                   const float* __restrict__ bnorm,
                   const int* __restrict__ pairs, int M, int N, int D,
                   int tiles_per_rank, float* __restrict__ out_d1,
                   int* __restrict__ out_i1, float* __restrict__ out_d2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // stage s: the A slice, then the slices of the step's two B tiles
  constexpr int STAGE = 3 * F32_SLICE;
  const uint32_t ring = smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + F32_STAGES * STAGE);
  float* ans = red + 2 * 3 * TM;               // red: [2][3][TM] words
  const uint32_t bars = smem_u32(ans + TM);    // full, empty, |a|^2's
  const uint32_t an_full = bars + 16 * F32_STAGES;

  // blockIdx.z is the rank: a cluster spans z
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int ia = pairs[2 * p];
  const int ib = pairs[2 * p + 1];
  const int ntiles = (N + TN - 1) / TN;
  const int t0 = blockIdx.z * tiles_per_rank;
  const int t1 = min(t0 + tiles_per_rank, ntiles);
  const int cend = min(N, t1 * TN);   // columns past it are not this range's
  const int nsteps = max(t1 - t0 + 1, 0) / 2;
  const int nslices = (D + F32_KS - 1) / F32_KS;
  const int items = nsteps * nslices;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                        // full
      mbar_init(bars + 8 * (F32_STAGES + s), 8);         // empty
    }
    mbar_init(an_full, 96);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // producer: one thread keeps the ring full; warps 1-3 take |a|^2 of
    // the A tile's rows, in increasing k
    regs_release<PRODUCER_REGS>();
    if (warp != 0) {
      for (int x = threadIdx.x - 32; x < TM; x += 96) {
        const int r = row0 + x;
        float an = 0.f;
        if (r < M) {
          const float4* arow = reinterpret_cast<const float4*>(
              A + ((long long)ia * M + r) * D);
          for (int k = 0; k < D / 4; ++k) {
            const float4 v = __ldg(arow + k);
            an = fmaf(v.x, v.x, an);
            an = fmaf(v.y, v.y, an);
            an = fmaf(v.z, v.z, an);
            an = fmaf(v.w, v.w, an);
          }
        }
        ans[x] = an;
      }
      mbar_arrive(an_full);
      return;
    }
    if (lane != 0) return;
    for (int i = 0; i < items; ++i) {
      const int s = i % F32_STAGES;
      const int step = i / nslices;
      const int k = (i - step * nslices) * F32_KS;
      const int tile = t0 + 2 * step;
      const uint32_t st = ring + s * STAGE;
      mbar_wait(bars + 8 * (F32_STAGES + s), ((i / F32_STAGES) & 1) ^ 1);
      mbar_arrive_tx(bars + 8 * s, STAGE);
      tma_load(st, &amap, bars + 8 * s, k, row0, ia);
      tma_load(st + F32_SLICE, &bmap, bars + 8 * s, k, tile * TN, ib);
      tma_load(st + 2 * F32_SLICE, &bmap, bars + 8 * s, k, (tile + 1) * TN,
               ib);
    }
    return;
  }

  regs_claim<CONSUMER_REGS>();
  const int cw = (warp >> 2) - 1;       // column tile 2 step + cw
  const int rg = lane >> 3;             // rows 32 (warp % 4) + rg + 4 i
  const int cg = lane & 7;              // columns cg + 8 j
  const int rbase = 32 * (warp & 3) + rg;
  const float* bn = bnorm + (long long)ib * N;

  float d1[8], d2[8];
  int i1[8];
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d1[i] = BIG;
    d2[i] = BIG;
    i1[i] = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  }

  for (int i = 0; i < items; ++i) {
    const int s = i % F32_STAGES;
    const int step = i / nslices;
    const int sl = i - step * nslices;
    const int nk4 = min(F32_KS, D - sl * F32_KS) >> 2;
    mbar_wait(bars + 8 * s, (i / F32_STAGES) & 1);
    const unsigned char* as = smem + s * STAGE;
    const unsigned char* bs = as + (1 + cw) * F32_SLICE;
#pragma unroll
    for (int kc = 0; kc < F32_KS / 4; ++kc) {
      if (kc >= nk4) break;
      float4 a[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a[r] = *reinterpret_cast<const float4*>(as + swz128(rbase + 4 * r,
                                                            kc));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            bs + swz128(cg + 8 * j, kc));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float x = acc[r][j];
          x = fmaf(a[r].x, b.x, x);
          x = fmaf(a[r].y, b.y, x);
          x = fmaf(a[r].z, b.z, x);
          acc[r][j] = fmaf(a[r].w, b.w, x);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (F32_STAGES + s));
    if (sl == nslices - 1) {
      // the tile's products are complete: merge its columns in order
      const int col0 = (t0 + 2 * step + cw) * TN;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col0 + cg + 8 * j;
        const float bnv = c < cend ? __ldg(bn + c) : BIG;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          push(fmaf(-2.f, acc[r][j], bnv), c, d1[r], i1[r], d2[r]);
          acc[r][j] = 0.f;
        }
      }
    }
  }

  // the 8 lanes of a row group (same rows, other columns): every lane ends
  // with the rows' result
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float od1 = __shfl_xor_sync(0xffffffffu, d1[r], off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, i1[r], off);
      const float od2 = __shfl_xor_sync(0xffffffffu, d2[r], off);
      merge(d1[r], i1[r], d2[r], od1, oi1, od2);
    }
  // lane cg takes row rbase + 4 cg (selects, not a dynamic index)
  float rd1 = d1[0], rd2 = d2[0];
  int ri1 = i1[0];
#pragma unroll
  for (int r = 1; r < 8; ++r)
    if (cg == r) {
      rd1 = d1[r];
      ri1 = i1[r];
      rd2 = d2[r];
    }
  const int rl = rbase + 4 * cg;
  float* mine = red + cw * 3 * TM;
  mine[rl] = rd1;
  reinterpret_cast<int*>(mine)[TM + rl] = ri1;
  mine[2 * TM + rl] = rd2;
  named_sync(1, 2 * 128);
  if (cw != 0) return;
  const float* other = red + 3 * TM;
  merge(rd1, ri1, rd2, other[rl], reinterpret_cast<const int*>(other)[TM + rl],
        other[2 * TM + rl]);
  const int r = row0 + rl;
  mbar_wait(an_full, 0);
  // the warpgroup's own slot of red holds the cluster's partials
  finish_row(rl, r, M, (long long)p * M + r, rd1, ri1, rd2, ans[rl], mine,
             gridDim.z, blockIdx.z, out_d1, out_i1, out_d2);
}

// ---------------------------------------------------------------------------
// K2's prologue
// ---------------------------------------------------------------------------

// A warp a row: rows 0..N-1 of B get bnorm = |b|^2 of their values as
// given (f32, or bf16 when bf16_in), 3e38 where mask is 0; with A16/B16 set
// (f32 in) the rows of B and then of A are also rounded to bf16 there. Lane
// l takes the 16-byte chunks l, l + 32, ... of a row; a shuffle tree sums
// them. The call's pair table (0, 0) goes to `pair`.
__global__ void __launch_bounds__(PREP_THREADS)
l2_top2_prep_kernel(const void* __restrict__ A, const void* __restrict__ B,
                    const unsigned char* __restrict__ mask, int M, int N,
                    int D, int bf16_in, __nv_bfloat16* __restrict__ A16,
                    __nv_bfloat16* __restrict__ B16,
                    float* __restrict__ bnorm, int* __restrict__ pair) {
  if (blockIdx.x == 0 && threadIdx.x < 2) pair[threadIdx.x] = 0;
  const long long w =
      ((long long)blockIdx.x * PREP_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const bool rnd = A16 != nullptr;
  if (w >= N + (rnd ? (long long)M : 0)) return;      // whole warps
  const bool isb = w < N;
  const long long row = isb ? w : w - N;
  float s = 0.f;
  if (bf16_in) {
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(B) + row * D);
    for (int c = lane; c < D / 8; c += 32) {
      const uint4 v = __ldg(src + c);
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w4[u]));
        s = fmaf(f.x, f.x, s);
        s = fmaf(f.y, f.y, s);
      }
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(
        static_cast<const float*>(isb ? B : A) + row * D);
    __nv_bfloat162* dst =
        rnd ? reinterpret_cast<__nv_bfloat162*>((isb ? B16 : A16) + row * D)
            : nullptr;
    for (int c = lane; c < D / 4; c += 32) {
      const float4 v = __ldg(src + c);
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
      if (rnd) {
        // round to nearest even, as torch's .to(torch.bfloat16)
        dst[2 * c] = __floats2bfloat162_rn(v.x, v.y);
        dst[2 * c + 1] = __floats2bfloat162_rn(v.z, v.w);
      }
    }
  }
  if (!isb) return;                                   // whole warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) bnorm[row] = mask[row] ? s : BIG;
}

// ---------------------------------------------------------------------------
// host: tensor maps, attributes, launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// map over (images, rows, D) of row-major data at base with a box of
// box_k x 128 rows x 1 image; rows past `rows` and columns past D read 0
cudaError_t make_map(CUtensorMap* map, const void* base, bool bf16, int rows,
                     int D, int box_k, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, IMAGES};
  const cuuint64_t strides[2] = {D * es, (cuuint64_t)rows * D * es};
  const cuuint32_t box[3] = {(cuuint32_t)box_k, TM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int bf16_stages(int D) { return D == 144 ? BF16_STAGES_144 : BF16_STAGES_RT; }

// dynamic shared memory of the bf16 kernel: alignment slack, the A tile and
// the ring of B tiles, their |b|^2, |a|^2, the barriers, the cluster's
// partials
int bf16_smem(int D) {
  const int st = bf16_stages(D);
  return 1024 + (1 + st) * TM * D * 2 + (st * TN + TM) * 4 +
         8 * (2 * st + 2) + 3 * TM * 4;
}

constexpr int F32_SMEM = 1024 + F32_STAGES * 3 * F32_SLICE +
                         (2 * 3 + 1) * TM * 4 + 8 * (2 * F32_STAGES + 1);

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the kernel's attributes, set once per device rather than before every
// launch: its dynamic shared memory and all of the SM's 228 KB as shared
// memory. Two threads that both set them do no harm.
template <typename K>
cudaError_t set_attributes(K kernel, int smem,
                           std::atomic<bool> (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && ready[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e == cudaSuccess && dev < MAX_DEVICES)
    ready[dev].store(true, std::memory_order_release);
  return e;
}

// a launch of THREADS-thread blocks, as clusters of `ranks` blocks along z
// when ranks > 1 (grid.z == ranks: blockIdx.z is the cluster rank)
cudaLaunchConfig_t config(dim3 grid, int ranks, int smem, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = ranks;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  return cfg;
}

template <int MODE, int DC>
cudaError_t launch_wgmma_d(dim3 grid, int ranks, int per, cudaStream_t s,
                           const void* A, const void* B, const float* bnorm,
                           const int* pairs, int M, int N, int D, float* d1,
                           int* i1, float* d2) {
  constexpr int ST = DC == 144 ? BF16_STAGES_144 : BF16_STAGES_RT;
  static std::atomic<bool> ready[MAX_DEVICES];
  auto kernel = l2_top2_wgmma_kernel<MODE, DC, ST>;
  cudaError_t e = set_attributes(kernel, MAX_SMEM, ready);
  CUtensorMap a128, a32, b128, b32;
  if (e == cudaSuccess)
    e = make_map(&a128, A, true, M, D, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = make_map(&a32, A, true, M, D, 16, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == cudaSuccess)
    e = make_map(&b128, B, true, N, D, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = make_map(&b32, B, true, N, D, 16, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(grid, ranks, bf16_smem(D), s, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, a128, a32, b128, b32,
                            static_cast<const __nv_bfloat16*>(A), bnorm,
                            pairs, M, N, D, per, d1, i1, d2,
                            /*keep_live=*/0);
}

template <int MODE>
cudaError_t launch_wgmma(dim3 grid, int ranks, int per, cudaStream_t s,
                         const void* A, const void* B, const float* bnorm,
                         const int* pairs, int M, int N, int D, float* d1,
                         int* i1, float* d2) {
  if (D == 144)
    return launch_wgmma_d<MODE, 144>(grid, ranks, per, s, A, B, bnorm, pairs,
                                     M, N, D, d1, i1, d2);
  return launch_wgmma_d<MODE, 0>(grid, ranks, per, s, A, B, bnorm, pairs, M,
                                 N, D, d1, i1, d2);
}

cudaError_t launch_f32(dim3 grid, int ranks, int per, cudaStream_t s,
                       const void* A, const void* B, const float* bnorm,
                       const int* pairs, int M, int N, int D, float* d1,
                       int* i1, float* d2) {
  static std::atomic<bool> ready[MAX_DEVICES];
  cudaError_t e = set_attributes(l2_top2_f32_kernel, F32_SMEM, ready);
  CUtensorMap am, bm;
  if (e == cudaSuccess)
    e = make_map(&am, A, false, M, D, F32_KS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = make_map(&bm, B, false, N, D, F32_KS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(grid, ranks, F32_SMEM, s, &attr);
  return cudaLaunchKernelEx(&cfg, l2_top2_f32_kernel, am, bm,
                            static_cast<const float*>(A), bnorm, pairs, M, N,
                            D, per, d1, i1, d2);
}

// checks and launches one call of the top-2 kernels (see r3d_l2_top2);
// `ranks` becomes the most ranks of ceil(ntiles / ranks) column tiles that
// leave none empty
cudaError_t run_top2(int dtype, int mode, const void* A, const void* B,
                     const float* bnorm, const int* pairs, int P, int M,
                     int N, int D, int ranks, float* d1, int* i1, float* d2,
                     cudaStream_t s) {
  if (P <= 0 || M <= 0 || N <= 0 || D <= 0 || D % 16 != 0 || ranks < 1 ||
      ranks > MAX_RANKS)
    return cudaErrorInvalidValue;
  if (mode != FULL && (dtype != 1 || ranks != 1 || mode > MIN_ONLY))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) % 16)
    return cudaErrorInvalidValue;
  // the bf16 kernel's A tile, its ring of B tiles (two at a run-time D),
  // their |b|^2 and the cluster's partials must fit in 227 KB of shared
  // memory: D <= 288
  if (dtype == 1 && bf16_smem(D) > MAX_SMEM) return cudaErrorInvalidValue;
  const int ntiles = cdiv(N, TN);
  const int per = cdiv(ntiles, ranks);
  ranks = cdiv(ntiles, per);
  const dim3 grid(cdiv(M, TM), P, ranks);
  if (dtype == 0)
    return launch_f32(grid, ranks, per, s, A, B, bnorm, pairs, M, N, D, d1,
                      i1, d2);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (mode == FULL)
    return launch_wgmma<FULL>(grid, ranks, per, s, A, B, bnorm, pairs, M, N,
                              D, d1, i1, d2);
  if (mode == MM_ONLY)
    return launch_wgmma<MM_ONLY>(grid, ranks, per, s, A, B, bnorm, pairs, M,
                                 N, D, d1, i1, d2);
  return launch_wgmma<MIN_ONLY>(grid, ranks, per, s, A, B, bnorm, pairs, M,
                                N, D, d1, i1, d2);
}

// K2's workspace: the pair table (0, 0) in 16 bytes, then |b|^2 (16-byte
// aligned for TMA), then with rounding the bf16 operands
constexpr long long PAIR_BYTES = 16;
long long bnorm_bytes(int N) { return ((long long)N * 4 + 15) / 16 * 16; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = FULL, 1 = MM_ONLY,
// 2 = MIN_ONLY (bf16 only, ranks == 1, writes only d1).
// A: (*, M, D), B: (*, N, D) row-major, 16-byte aligned; bnorm: (*, N) f32;
// pairs: (P, 2) int32 image indices into A and B. Outputs d1, d2: (P, M)
// f32 and i1: (P, M) int32. ranks > 1 (at most 8) splits the columns over
// the ranks of a thread-block cluster, each a range of whole 128-column
// tiles. Launches on `stream` and returns the launch's error (0 on
// success).
extern "C" int r3d_l2_top2(int dtype, int mode, const void* A, const void* B,
                           const float* bnorm, const int* pairs, int P, int M,
                           int N, int D, int ranks, float* d1, int* i1,
                           float* d2, void* stream) {
  return (int)run_top2(dtype, mode, A, B, bnorm, pairs, P, M, N, D, ranks,
                       d1, i1, d2, reinterpret_cast<cudaStream_t>(stream));
}

// Bytes of the workspace of r3d_l2_top2_pair: the pair table, |b|^2, then
// with `round` the bf16 copies of A and B.
extern "C" long long r3d_l2_top2_pair_workspace(int M, int N, int D,
                                                int round) {
  return PAIR_BYTES + bnorm_bytes(N) +
         (round ? (long long)(M + N) * D * 2 : 0);
}

// K2, one FULL call on one pair: A (M, D), B (N, D) of type dtype (0 =
// float32, 1 = bfloat16), row-major and 16-byte aligned, mask_b (N,) bytes
// (0 = masked row of B); round = 1 (float32 only) rounds both operands to
// bfloat16 for the tensor-core kernel, with |b|^2 from the f32 values.
// Launches the prologue into `work` (r3d_l2_top2_pair_workspace bytes,
// 16-byte aligned), then the top-2 kernel on `ranks` cluster ranks. Outputs
// d1, d2: (M,) f32, i1: (M,) int32. Returns the first launch error (0 on
// success).
extern "C" int r3d_l2_top2_pair(int dtype, int round, const void* A,
                                const void* B, const unsigned char* mask_b,
                                int M, int N, int D, int ranks, void* work,
                                float* d1, int* i1, float* d2, void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D % 16 != 0 || (dtype != 0 && round) ||
      dtype < 0 || dtype > 1 || reinterpret_cast<uintptr_t>(work) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int* pair = static_cast<int*>(work);
  float* bnorm = reinterpret_cast<float*>(static_cast<char*>(work) +
                                          PAIR_BYTES);
  __nv_bfloat16* A16 = nullptr;
  __nv_bfloat16* B16 = nullptr;
  if (round) {
    A16 = reinterpret_cast<__nv_bfloat16*>(static_cast<char*>(work) +
                                           PAIR_BYTES + bnorm_bytes(N));
    B16 = A16 + (long long)M * D;
  }
  const long long rows = N + (round ? (long long)M : 0);
  const long long blocks = (rows * 32 + PREP_THREADS - 1) / PREP_THREADS;
  l2_top2_prep_kernel<<<(unsigned)blocks, PREP_THREADS, 0, s>>>(
      A, B, mask_b, M, N, D, dtype, A16, B16, bnorm, pair);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)run_top2(round ? 1 : dtype, FULL, round ? A16 : A,
                       round ? B16 : B, bnorm, pair, 1, M, N, D, ranks, d1,
                       i1, d2, s);
}

// How many clusters of `ranks` blocks of the FULL kernel for (dtype, D)
// the card can hold at once (cudaOccupancyMaxActiveClusters), in *count.
extern "C" int r3d_l2_top2_clusters(int dtype, int D, int ranks, int* count) {
  if (ranks < 1 || ranks > MAX_RANKS || D <= 0 || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(dim3(1, 1, ranks), ranks, 0, nullptr,
                                  &attr);
  cfg.numAttrs = 1;
  cudaError_t e;
  if (dtype == 0) {
    static std::atomic<bool> ready[MAX_DEVICES];
    cfg.dynamicSmemBytes = F32_SMEM;
    e = set_attributes(l2_top2_f32_kernel, F32_SMEM, ready);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(count, l2_top2_f32_kernel, &cfg);
  } else if (D == 144) {
    static std::atomic<bool> ready[MAX_DEVICES];
    auto kernel = l2_top2_wgmma_kernel<FULL, 144, BF16_STAGES_144>;
    cfg.dynamicSmemBytes = bf16_smem(D);
    e = set_attributes(kernel, MAX_SMEM, ready);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  } else {
    static std::atomic<bool> ready[MAX_DEVICES];
    auto kernel = l2_top2_wgmma_kernel<FULL, 0, BF16_STAGES_RT>;
    cfg.dynamicSmemBytes = bf16_smem(D);
    e = set_attributes(kernel, MAX_SMEM, ready);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  }
  return (int)e;
}
