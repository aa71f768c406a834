// Fused squared-L2 distance + running top-2 nearest-neighbour search, and
// the two ablations of it that split its time between product and merge.
//
// Replaces the three Pallas TPU kernels of the JAX package:
//   K1  regard3d_tpu/kernels/match.py:l2_top2_block_pallas
//       (_match_block_kernel): a block of P image pairs read through a
//       (P, 2) pair table out of one (B, N, D) descriptor array;
//   K2  regard3d_tpu/kernels/match.py:l2_top2_pallas (_match_kernel): one
//       (M, D) x (N, D) pair, served here as the P = 1 call with separate
//       A and B base pointers;
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
// (rows of A and B past the end are zero-filled, their |b|^2 is 3e38).
//
// MM_ONLY: out[p, r] = min(3e38, min over column tiles t of a_r . b_{t*TN}),
// the first column of every 128-wide tile, no |b|^2, no mask. MIN_ONLY:
// out[p, r] = min(3e38, min over all columns of |b|^2 - 2 a.b), no |a|^2,
// no clamp. Both return only d1.
//
// What bounds each case on an H100 SXM: 2 * P * M * N * D operations;
// the bytes (B * N * D inputs, 3 * P * M outputs) are small next to them.
//   * bf16 (K1 ANN presets, K3): the tensor cores, 989 TFLOP/s dense. The
//     design: mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix;
//     a 128 x 128 block tile, 8 warps of 64 x 32; the block's A tile
//     (128 x D) stays resident in shared memory for its whole column loop,
//     B tiles and their |b|^2 stream through a two-stage cp.async ring.
//     Rows are XOR-swizzled in 16-byte chunks, so ldmatrix has no bank
//     conflicts without padding, and at D = 144 two blocks fit on an SM
//     (3 x 36 KB). The top-2 merge runs on the accumulator fragments: a lane
//     owns rows lane/4 and lane/4 + 8 of each m16 tile and columns
//     2 (lane % 4) + {0, 1} of each n8 tile, visited in increasing order
//     with a strict '<'. Instruction issue and latency, not the tensor
//     cores, hold it back: on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W) at
//     P = 64, N = 4096, D = 144, MM_ONLY takes 0.96-1.01 ms (313-321
//     TFLOP/s, a third of the peak) and FULL 1.34-1.37 ms (chip_smoke.py;
//     PERF.md).
//     The product stays live in MM_ONLY although its epilogue reads one
//     column per tile: `asm volatile` binds only the front end, and ptxas
//     deletes an mma whose result is dead, so MM_ONLY
//     also reads every accumulator under a branch on a kernel argument that
//     is 0 at run time. chip_smoke.py counts the HMMA of each mode in the
//     SASS. A compile-time D = 144 (LIOP) folds the swizzle into constants
//     and unrolls the k loop. wgmma + TMA is later work.
//   * f32 (the stage's default, K2): FP32 FFMA, 67 TFLOP/s; no TF32, so the
//     result matches Precision.HIGHEST up to summation order. The design:
//     a 128 x 128 block tile, an 8 x 8 register micro-tile per thread (two
//     4-wide groups 64 apart, so shared-memory reads are conflict-free),
//     16-deep k slices staged transposed by 4-byte cp.async into a
//     double-buffered ring; 64 FFMA per four 16-byte shared loads. The
//     source pointers and A's row masks are fixed per block and the k
//     slices advance by counters, so the loop does no integer division.
//   * Small grids (K2: 4000 rows make 32 row tiles for 132 SMs): the
//     columns are split into S ranges, blockIdx.z picks one; each block
//     writes a partial (d1, i1, d2) into caller-allocated scratch and a
//     small merge kernel combines the ranges in increasing order with the
//     index-aware tie rule (an exact tie across ranges keeps the lower
//     column and gives d2 == d1). Both dtypes; FULL mode only (the K3 modes
//     time K1's grid, which needs no split).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TM = 128;       // rows of A per block
constexpr int TN = 128;       // columns (rows of B) per tile
constexpr int THREADS = 256;
constexpr int KT = 16;        // depth of one f32 k slice
constexpr int FPAD = 4;       // f32 staging row padding (keeps 16 B alignment)
constexpr float BIG = 3.0e38f;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_DEVICES = 64;   // devices whose kernel attributes are cached

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

// Final (d1 + |a|^2, i1, d2 + |a|^2), clamped at 0, or with a column split
// the raw partial of range blockIdx.z (and |a|^2 from range 0) into
// part = [S][3][P*M] words + [P*M] |a|^2.
__device__ __forceinline__ void store_top2(long long o, long long PM,
                                           float d1, int i1, float d2,
                                           float an, float* d1o, int* i1o,
                                           float* d2o, float* part) {
  if (part == nullptr) {
    d1o[o] = fmaxf(d1 + an, 0.f);
    i1o[o] = i1;
    d2o[o] = fmaxf(d2 + an, 0.f);
  } else {
    float* q = part + 3LL * blockIdx.z * PM;
    q[o] = d1;
    reinterpret_cast<int*>(q)[PM + o] = i1;
    q[2 * PM + o] = d2;
    if (blockIdx.z == 0) part[3LL * gridDim.z * PM + o] = an;
  }
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; pred == false zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (K1 bf16, K2 bf16, K3)
// ---------------------------------------------------------------------------

// Shared-memory tiles hold rows of s = D / 8 chunks of 16 bytes. Chunk c of
// row r lives at chunk c ^ f(r) of that row: the 8 row addresses of one
// ldmatrix (same c, 8 consecutive rows) then fall into 8 distinct groups of
// four banks. With a row stride of s chunks, rows q apart share a bank group
// when q * s = 0 mod 8 (q = 8 / gcd(s, 8)), and f(r) = (r / q) mod (8 / q)
// separates them; c ^ f(r) stays inside the row because s is a multiple of
// 8 / q.
struct Swizzle {
  int s, shift, mask;
  __device__ __forceinline__ explicit Swizzle(int D) : s(D >> 3) {
    shift = (s & 7) == 0 ? 0 : ((s & 3) == 0 ? 1 : 2);
    mask = (8 >> shift) - 1;
  }
  __device__ __forceinline__ int operator()(int r, int c) const {
    return (r * s + (c ^ ((r >> shift) & mask))) << 4;
  }
};

__device__ __forceinline__ void load_rows_bf16(unsigned char* tile,
                                               const __nv_bfloat16* src,
                                               int row0, int rows, int D,
                                               const Swizzle& sw) {
  const int n = TM * sw.s;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int r = idx / sw.s;
    const int c = idx - r * sw.s;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* g = ok ? src + (long long)(row0 + r) * D + c * 8
                                : src;
    cp_async16(tile + sw(r, c), g, ok);
  }
}

// DC > 0 fixes D at compile time (LIOP's 144): the swizzle folds into
// constants and the k loop unrolls fully; DC = 0 takes D at run time.
template <int MODE, int DC>
__global__ void __launch_bounds__(THREADS, 2)
l2_top2_mma_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ B,
                   const float* __restrict__ bnorm,
                   const int* __restrict__ pairs, int M, int N, int Drt,
                   int tiles_per_split, float* __restrict__ out_d1,
                   int* __restrict__ out_i1, float* __restrict__ out_d2,
                   float* __restrict__ part, int keep_live) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = DC > 0 ? DC : Drt;
  const Swizzle sw(D);
  const int tile_bytes = TM * sw.s * 16;
  unsigned char* As = smem;
  unsigned char* Bs = smem + tile_bytes;                // 2 stages
  float* bns = reinterpret_cast<float*>(smem + 3 * tile_bytes);  // [2][TN]

  const int p = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const long long ia = pairs[2 * p];
  const long long ib = pairs[2 * p + 1];
  const __nv_bfloat16* Ab = A + ia * (long long)M * D;
  const __nv_bfloat16* Bb = B + ib * (long long)N * D;
  const float* bn = bnorm + ib * (long long)N;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;   // rows wm*64 .. +64
  const int wn = warp & 3;    // columns wn*32 .. +32
  const int g = lane >> 2;
  const int t = lane & 3;

  const int ntiles = (N + TN - 1) / TN;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, ntiles);

  auto load_b = [&](int tile, int st) {
    load_rows_bf16(Bs + st * tile_bytes, Bb, tile * TN, N, D, sw);
    if (tid < TN) {
      const int c = tile * TN + tid;
      if (c < N) cp_async4(&bns[st * TN + tid], bn + c, true);
      else bns[st * TN + tid] = BIG;
    }
  };

  load_rows_bf16(As, Ab, row0, M, D, sw);
  if (t0 < t1) load_b(t0, 0);
  cp_commit();
  if (t0 + 1 < t1) load_b(t0 + 1, 1);
  cp_commit();

  // running state of the 8 rows this lane owns: [m16 tile][upper/lower 8]
  float run_d1[4][2], run_d2[4][2];
  int run_i1[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      run_d1[mt][h] = BIG;
      run_d2[mt][h] = BIG;
      run_i1[mt][h] = 0;
    }

  const uint32_t a_base = smem_u32(As);
  const int nk = D >> 4;
  for (int tile = t0; tile < t1; ++tile) {
    const int st = (tile - t0) & 1;
    cp_wait<1>();
    __syncthreads();
    const uint32_t b_base = smem_u32(Bs + st * tile_bytes);

    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
    for (int ks = 0; ks < nk; ++ks) {
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int mat = lane >> 3;
        const int n = wn * 32 + np * 16 + (mat >> 1) * 8 + (lane & 7);
        ldsm_x4(b_base + sw(n, 2 * ks + (mat & 1)), bf[2 * np][0],
                bf[2 * np][1], bf[2 * np + 1][0], bf[2 * np + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + (lane & 15);
        uint32_t af[4];
        ldsm_x4(a_base + sw(r, 2 * ks + (lane >> 4)), af[0], af[1], af[2],
                af[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }

    // epilogue on the fragments: acc[mt][nt][2h + j] is row
    // wm*64 + mt*16 + g + 8h, column wn*32 + nt*8 + 2t + j of the tile
    const int col0 = tile * TN;
    if (MODE == MM_ONLY) {
      if (wn == 0 && t == 0) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            run_d1[mt][h] = fminf(run_d1[mt][h], acc[mt][0][2 * h]);
      }
      // ptxas deletes an mma whose result is never read, `asm volatile` or
      // not; every accumulator is read under a branch on an argument that
      // is 0 at run time, so the whole product stays
      if (keep_live) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              run_d1[mt][q >> 1] = fminf(run_d1[mt][q >> 1], acc[mt][nt][q]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cl = wn * 32 + nt * 8 + 2 * t + j;
          const float bnv = bns[st * TN + cl];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = fmaf(-2.f, acc[mt][nt][2 * h + j], bnv);
              if (MODE == MIN_ONLY)
                run_d1[mt][h] = fminf(run_d1[mt][h], v);
              else
                push(v, col0 + cl, run_d1[mt][h], run_i1[mt][h],
                     run_d2[mt][h]);
            }
        }
    }
    __syncthreads();
    if (tile + 2 < t1) load_b(tile + 2, st);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();

  // merge the 4 lanes of a quad (same rows, other columns)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od1 = __shfl_xor_sync(0xffffffffu, run_d1[mt][h], off);
        if (MODE == FULL) {
          const int oi1 = __shfl_xor_sync(0xffffffffu, run_i1[mt][h], off);
          const float od2 = __shfl_xor_sync(0xffffffffu, run_d2[mt][h], off);
          merge(run_d1[mt][h], run_i1[mt][h], run_d2[mt][h], od1, oi1, od2);
        } else {
          run_d1[mt][h] = fminf(run_d1[mt][h], od1);
        }
      }

  // then the 4 warps that share rows, through shared memory (the B ring is
  // free now; the A tile stays for |a|^2)
  float* red_d1 = reinterpret_cast<float*>(Bs);     // [4][TM]
  int* red_i1 = reinterpret_cast<int*>(red_d1 + 4 * TM);
  float* red_d2 = red_d1 + 8 * TM;
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * 64 + mt * 16 + g + 8 * h;
        red_d1[wn * TM + rl] = run_d1[mt][h];
        red_i1[wn * TM + rl] = run_i1[mt][h];
        red_d2[wn * TM + rl] = run_d2[mt][h];
      }
  }
  __syncthreads();

  if (tid < TM && row0 + tid < M) {
    const int r = row0 + tid;
    const long long o = (long long)p * M + r;
    float d1 = red_d1[tid];
    int i1 = red_i1[tid];
    float d2 = red_d2[tid];
    for (int w = 1; w < 4; ++w) {
      if (MODE == FULL)
        merge(d1, i1, d2, red_d1[w * TM + tid], red_i1[w * TM + tid],
              red_d2[w * TM + tid]);
      else
        d1 = fminf(d1, red_d1[w * TM + tid]);
    }
    if (MODE != FULL) {
      out_d1[o] = d1;
      return;
    }
    // |a|^2 from the bf16 values the product saw, in increasing k
    float an = 0.f;
    for (int c = 0; c < sw.s; ++c) {
      const uint4 x = *reinterpret_cast<const uint4*>(As + sw(tid, c));
      const uint32_t w4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w4[q]));
        an = fmaf(f.x, f.x, an);
        an = fmaf(f.y, f.y, an);
      }
    }
    store_top2(o, (long long)gridDim.y * M, d1, i1, d2, an, out_d1, out_i1,
               out_d2, part);
  }
}

// ---------------------------------------------------------------------------
// f32 FFMA kernel (K1 f32, K2 f32)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2)
l2_top2_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bnorm,
                   const int* __restrict__ pairs, int M, int N, int D,
                   int tiles_per_split, float* __restrict__ out_d1,
                   int* __restrict__ out_i1, float* __restrict__ out_d2,
                   float* __restrict__ part) {
  // staging ring [2][KT][TM + FPAD] for A and B (k-major, so a thread reads
  // its 4 consecutive rows / columns with one 16-byte load); reused for the
  // cross-thread merge after the loop
  constexpr int STAGE = KT * (TM + FPAD);
  __shared__ __align__(16) float sm[4 * STAGE];
  float* As = sm;
  float* Bs = sm + 2 * STAGE;

  const int p = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const long long ia = pairs[2 * p];
  const long long ib = pairs[2 * p + 1];
  const float* Ab = A + ia * (long long)M * D;
  const float* Bb = B + ib * (long long)N * D;
  const float* bn = bnorm + ib * (long long)N;

  const int tid = threadIdx.x;
  const int tx = tid & 15;    // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = tid >> 4;    // rows    ty*4 + {0..3} and 64 + ty*4 + {0..3}
  const int lk = tid & 15;    // staging: k of the slice
  const int lr = tid >> 4;    // staging: rows lr + 16 i

  const int ntiles = (N + TN - 1) / TN;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, ntiles);
  const int nk = D / KT;
  const int steps = max(t1 - t0, 0) * nk;

  // per-thread sources: row lr + 16 i of the A tile and of a B tile; the
  // row masks of A and the pointers are fixed for the block
  const long long rs = 16LL * D;
  const float* a_src = Ab + (long long)(row0 + lr) * D + lk;
  const float* b_src = Bb + (long long)lr * D + lk;
  unsigned amask = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    amask |= (row0 + lr + 16 * i < M) ? (1u << i) : 0u;

  auto load = [&](int tile, int ks, int st) {
    float* as = As + st * STAGE + lk * (TM + FPAD);
    float* bs = Bs + st * STAGE + lk * (TN + FPAD);
    const float* pa = a_src + ks * KT;
    const float* pb = b_src + (long long)tile * TN * D + ks * KT;
    const int cb = tile * TN + lr;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool oka = (amask >> i) & 1u;
      cp_async4(as + lr + 16 * i, oka ? pa + i * rs : Ab, oka);
      const bool okb = cb + 16 * i < N;
      cp_async4(bs + lr + 16 * i, okb ? pb + i * rs : Bb, okb);
    }
  };

  float run_d1[8], run_d2[8];
  int run_i1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run_d1[i] = BIG;
    run_d2[i] = BIG;
    run_i1[i] = 0;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int lt = t0, lks = 0;   // the next k slice to load: tile, slice
  int ct = t0, cks = 0;   // the k slice being computed
  if (steps > 0) {
    load(lt, lks, 0);
    if (++lks == nk) { lks = 0; ++lt; }
  }
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    if (s + 1 < steps) {
      load(lt, lks, st ^ 1);
      if (++lks == nk) { lks = 0; ++lt; }
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* as = As + st * STAGE;
    const float* bs = Bs + st * STAGE;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          as + k * (TM + FPAD) + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(
          as + k * (TM + FPAD) + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(
          bs + k * (TN + FPAD) + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          bs + k * (TN + FPAD) + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (++cks == nk) {
      // merge this tile into the running top-2 (columns in increasing order)
      const int col0 = ct * TN;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        const float bnv = c < N ? __ldg(bn + c) : BIG;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          push(fmaf(-2.f, acc[i][j], bnv), c, run_d1[i], run_i1[i],
               run_d2[i]);
          acc[i][j] = 0.f;
        }
      }
      cks = 0;
      ++ct;
    }
    __syncthreads();
  }
  cp_wait<0>();
  __syncthreads();

  // the 16 threads of a row merge through shared memory
  float* red_d1 = sm;                                   // [16][TM]
  int* red_i1 = reinterpret_cast<int*>(sm + 16 * TM);
  float* red_d2 = sm + 32 * TM;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rl = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
    red_d1[tx * TM + rl] = run_d1[i];
    red_i1[tx * TM + rl] = run_i1[i];
    red_d2[tx * TM + rl] = run_d2[i];
  }
  __syncthreads();

  if (tid < TM && row0 + tid < M) {
    const int r = row0 + tid;
    float d1 = red_d1[tid];
    int i1 = red_i1[tid];
    float d2 = red_d2[tid];
    for (int w = 1; w < 16; ++w)
      merge(d1, i1, d2, red_d1[w * TM + tid], red_i1[w * TM + tid],
            red_d2[w * TM + tid]);
    const float* arow = Ab + (long long)r * D;
    float an = 0.f;
    for (int k = 0; k < D; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(arow + k);
      an = fmaf(v.x, v.x, an);
      an = fmaf(v.y, v.y, an);
      an = fmaf(v.z, v.z, an);
      an = fmaf(v.w, v.w, an);
    }
    store_top2((long long)p * M + r, (long long)gridDim.y * M, d1, i1, d2,
               an, out_d1, out_i1, out_d2, part);
  }
}

// ---------------------------------------------------------------------------
// merge of the column ranges of a split call
// ---------------------------------------------------------------------------

__global__ void merge_splits_kernel(const float* __restrict__ part, int S,
                                    long long PM, float* __restrict__ out_d1,
                                    int* __restrict__ out_i1,
                                    float* __restrict__ out_d2) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= PM) return;
  const int* ipart = reinterpret_cast<const int*>(part);
  float d1 = part[o];
  int i1 = ipart[PM + o];
  float d2 = part[2 * PM + o];
  for (int s = 1; s < S; ++s) {
    const long long b = 3LL * s * PM;
    merge(d1, i1, d2, part[b + o], ipart[b + PM + o], part[b + 2 * PM + o]);
  }
  const float an = part[3LL * S * PM + o];
  out_d1[o] = fmaxf(d1 + an, 0.f);
  out_i1[o] = i1;
  out_d2[o] = fmaxf(d2 + an, 0.f);
}

// The kernel instance's attributes, set once per device rather than before
// every launch: dynamic shared memory up to MAX_SMEM, enough for any D the
// launcher accepts, and all of the SM's 228 KB as shared memory. Two
// threads that both set them do no harm.
template <int MODE, int DC>
cudaError_t set_mma_attributes() {
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && ready[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(l2_top2_mma_kernel<MODE, DC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(l2_top2_mma_kernel<MODE, DC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (e == cudaSuccess && dev < MAX_DEVICES)
    ready[dev].store(true, std::memory_order_release);
  return e;
}

template <int MODE, int DC>
cudaError_t launch_mma_d(dim3 grid, cudaStream_t s, const void* A,
                         const void* B, const float* bnorm, const int* pairs,
                         int M, int N, int D, int tps, float* d1, int* i1,
                         float* d2, float* part) {
  const int smem = 3 * TM * D * 2 + 2 * TN * 4;
  const cudaError_t e = set_mma_attributes<MODE, DC>();
  if (e != cudaSuccess) return e;
  l2_top2_mma_kernel<MODE, DC><<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(B), bnorm, pairs, M, N, D, tps, d1,
      i1, d2, part, /*keep_live=*/0);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mma(dim3 grid, cudaStream_t s, const void* A,
                       const void* B, const float* bnorm, const int* pairs,
                       int M, int N, int D, int tps, float* d1, int* i1,
                       float* d2, float* part) {
  if (D == 144)
    return launch_mma_d<MODE, 144>(grid, s, A, B, bnorm, pairs, M, N, D, tps,
                                   d1, i1, d2, part);
  return launch_mma_d<MODE, 0>(grid, s, A, B, bnorm, pairs, M, N, D, tps, d1,
                               i1, d2, part);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = FULL, 1 = MM_ONLY,
// 2 = MIN_ONLY (bf16 only, splits == 1, writes only d1).
// A: (*, M, D), B: (*, N, D) row-major, 16-byte aligned; bnorm: (*, N) f32;
// pairs: (P, 2) int32 image indices into A and B. Outputs d1, d2: (P, M)
// f32 and i1: (P, M) int32. splits > 1 splits the columns into that many
// ranges of whole 128-column tiles; part then holds (3 * splits + 1) * P * M
// words of scratch. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int r3d_l2_top2(int dtype, int mode, const void* A, const void* B,
                           const float* bnorm, const int* pairs, int P, int M,
                           int N, int D, int splits, float* d1, int* i1,
                           float* d2, float* part, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || D <= 0 || D % 16 != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (mode != FULL && (dtype != 1 || splits != 1 || mode > MIN_ONLY))
    return (int)cudaErrorInvalidValue;
  // the bf16 kernel's A tile and two B tiles (3 x 128 x D bf16) plus 1 KB
  // of |b|^2 must fit in 227 KB of shared memory: D <= 288
  if (dtype == 1 && 3 * TM * D * 2 + 2 * TN * 4 > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (N + TN - 1) / TN;
  const int tps = (ntiles + splits - 1) / splits;
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  float* scratch = splits > 1 ? part : nullptr;
  const dim3 grid((M + TM - 1) / TM, P, splits);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    l2_top2_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), bnorm,
        pairs, M, N, D, tps, d1, i1, d2, scratch);
    e = cudaGetLastError();
  } else if (dtype == 1) {
    if (mode == FULL)
      e = launch_mma<FULL>(grid, s, A, B, bnorm, pairs, M, N, D, tps, d1, i1,
                           d2, scratch);
    else if (mode == MM_ONLY)
      e = launch_mma<MM_ONLY>(grid, s, A, B, bnorm, pairs, M, N, D, tps, d1,
                              i1, d2, nullptr);
    else
      e = launch_mma<MIN_ONLY>(grid, s, A, B, bnorm, pairs, M, N, D, tps, d1,
                               i1, d2, nullptr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long PM = (long long)P * M;
  merge_splits_kernel<<<(unsigned)((PM + 255) / 256), 256, 0, s>>>(
      part, splits, PM, d1, i1, d2);
  return (int)cudaGetLastError();
}
