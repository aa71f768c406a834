// The bundle adjustment's segment tables on the card, shared by the
// kernels that reduce over them (schur_pcg.cu, ba_linearize.cu).
//
// A table is the layout's own (core/segments.py): padded (rows (n, cap)
// int64 and mask (n, cap) float32, cap > 0) or sorted (order (O,) int64 and
// lengths (n,) int64, cap 0). A reduction over a table walks each segment's
// entries in table order. Long segments split into items of CHUNK
// consecutive entries, summed apart and then per segment, so a kernel's sum
// does not depend on its grid. A sorted table's segment starts and each
// table's item starts are exclusive scans made once by a kernel's prologue
// (table_scans), with each item's segment.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#ifndef R3D_HD
#ifdef __CUDACC__
#define R3D_HD __host__ __device__ __forceinline__
#else
#define R3D_HD inline
#endif
#endif

namespace baseg {

constexpr int CHUNK = 64;        // table entries an item
constexpr int NSCAN = 5;         // prologue scans (three starts, two items)

struct Table {
  const long long* idx;           // rows (n * cap) or order (O)
  const float* mask;              // padded form
  const long long* len;           // sorted form: lengths (n)
  long long* start;               // sorted form: (n + 1) exclusive prefix
  long long* item;                // (n + 1) exclusive prefix of items
  int* seg;                       // cam, intr: the segment of each item
  long long n, cap;               // cap > 0: padded

  R3D_HD long long begin(long long s) const {
    return cap ? s * cap : start[s];
  }
  R3D_HD long long size(long long s) const { return cap ? cap : len[s]; }
  // the observation of entry j, -1 for a pad slot (two independent loads)
  R3D_HD long long obs(long long j) const {
    const long long o = idx[j];
    return (cap && mask[j] == 0.0f) ? -1 : o;
  }
  R3D_HD long long items_max(long long O) const {
    return cap ? n * ((cap + CHUNK - 1) / CHUNK) : (O + CHUNK - 1) / CHUNK + n;
  }
};

// ---------------------------------------------------------------------------
// workspace
// ---------------------------------------------------------------------------

inline size_t up16(size_t b) { return (b + 15) & ~size_t(15); }

// Consecutive 16-byte-aligned pieces of a workspace; with a null base it
// only counts the bytes
struct Carve {
  char* base;
  size_t off = 0;
  template <typename U>
  U* take(long long n) {
    U* p = reinterpret_cast<U*>(base ? base + off : nullptr);
    off += up16(sizeof(U) * size_t(n > 0 ? n : 1));
    return p;
  }
};

// The three tables (cam, pt, intr) of n[t] segments over O rows, their
// scans' outputs taken from the workspace
inline void carve_tables(Carve& c, Table* tab, const long long* const* idx,
                         const float* const* mask,
                         const long long* const* lengths,
                         const long long* cap, const long long* n,
                         long long O) {
  for (int t = 0; t < 3; ++t) {
    Table& tb = tab[t];
    tb.idx = idx[t];
    tb.mask = mask[t];
    tb.len = lengths[t];
    tb.n = n[t];
    tb.cap = cap[t];
    tb.start = c.take<long long>(n[t] + 1);
    tb.item = c.take<long long>(n[t] + 1);
    tb.seg = c.take<int>(t == 1 ? 0 : tb.items_max(O));
  }
}

#ifdef __CUDACC__

// out[s] = sum of f(s') over s' < s, out[n] the total: one block of BLOCK
// threads
template <int BLOCK, typename F>
__device__ void block_scan(long long n, F f, long long* out, long long* sh) {
  const long long per = (n + BLOCK - 1) / BLOCK;
  const long long b = threadIdx.x * per, e = b + per < n ? b + per : n;
  long long sum = 0;
  for (long long s = b; s < e; ++s) sum += f(s);
  sh[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < BLOCK; off <<= 1) {
    const long long v = threadIdx.x >= off ? sh[threadIdx.x - off] : 0;
    __syncthreads();
    sh[threadIdx.x] += v;
    __syncthreads();
  }
  long long run = threadIdx.x ? sh[threadIdx.x - 1] : 0;
  for (long long s = b; s < e; ++s) {
    out[s] = run;
    run += f(s);
  }
  if (threadIdx.x == BLOCK - 1) out[n] = sh[BLOCK - 1];
  __syncthreads();
}

// the sum of v over the block of BLOCK threads, to every thread (fixed
// tree); `sh`: BLOCK values of shared memory
template <int BLOCK, typename T>
__device__ T block_sum(T v, T* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const T total = sh[0];
  __syncthreads();
  return total;
}

// The prologue's scans, one a block (blocks 0 to NSCAN - 1): each sorted
// table's segment starts, then the items of the camera and intrinsic
// tables with each item's segment. `sh`: BLOCK long longs of shared memory
template <int BLOCK>
__device__ void table_scans(const Table* tab, long long* sh) {
  for (int task = blockIdx.x; task < NSCAN; task += gridDim.x) {
    const Table& tb = tab[task < 3 ? task : (task == 3 ? 0 : 2)];
    if (task < 3) {
      if (!tb.cap)
        block_scan<BLOCK>(tb.n, [&](long long s) { return tb.len[s]; },
                          tb.start, sh);
    } else {
      block_scan<BLOCK>(tb.n, [&](long long s) {
        return (tb.size(s) + CHUNK - 1) / CHUNK;
      }, tb.item, sh);
      // each item's segment, the last s with item[s] <= it, by a binary
      // search a thread (one thread a segment would write the one
      // intrinsic group's ~300 items alone)
      for (long long it = threadIdx.x; it < tb.item[tb.n]; it += BLOCK) {
        long long lo = 0, hi = tb.n - 1;
        while (lo < hi) {
          const long long mid = (lo + hi + 1) / 2;
          if (tb.item[mid] <= it) lo = mid;
          else hi = mid - 1;
        }
        tb.seg[it] = int(lo);
      }
    }
  }
}

// This thread's first index of a grid-stride loop, consecutive indices on
// consecutive blocks: a short loop still spreads over every SM
__device__ inline long long spread_id() {
  return blockIdx.x + (long long)gridDim.x * threadIdx.x;
}

// The blocks of `kernel` (`block` threads, static shared memory only) that
// one wave holds on card `device`: what a cooperative launch may take.
// `cached` keeps the count (0: not read yet).
inline cudaError_t wave_blocks(const void* kernel, int block, int device,
                               int* cached) {
  if (*cached) return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block,
                                                    0);
  if (e != cudaSuccess) return e;
  if (!per_sm) return cudaErrorLaunchOutOfResources;
  *cached = per_sm * sms;
  return cudaSuccess;
}

// runs f on card `device`, the calling thread's current device restored
template <typename F>
int on_device(int device, F f) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  const int err = f();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

#endif  // __CUDACC__

}  // namespace baseg
