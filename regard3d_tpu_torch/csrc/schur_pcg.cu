// The damped implicit-Schur PCG solve of one Levenberg-Marquardt trial of
// bundle adjustment (regard3d_tpu_torch/ba/lm.py:_solve_schur), whole, in
// one cooperative launch: the damped block inverses, the right-hand side,
// up to cg_iterations Jacobi-preconditioned CG steps on the reduced camera
// system S = U - W V^-1 W^T with implicit S-products, and the
// back-substitution of the points.
//
// Replaces no Pallas kernel. The JAX package ran this solve as XLA's
// lax.while_loop (regard3d_tpu/ba/lm.py:345, the CG; :224, the LM loop
// around it): one compiled loop. The port's plain version is an eager loop
// of 40 fixed steps under a device-side stop flag, ~70 operations a step,
// ~2,790 a trial: 78% of the ~3,580 device operations of an LM iteration,
// which made BA, most of the sfm cells' step, host-launch-bound (the device
// ~80% idle).
//
// What it computes is what _solve_schur computes, in the same precision
// (T = float or double), statement for statement:
//   * Vinv = (Vl + (lam diag(Vl) + 1e-12) I)^-1 per point (3x3, by
//     cofactors; the plain version factors with inv_ex);
//     Ud = U + (lam diag(U) + 1e-12) I, Uid = Ui + (lam diag(Ui) + 1) I;
//   * rc = (-gc + W_c Vinv gp) * free, ri = (-gi + W_i Vinv gp) * free;
//     the Jacobi preconditioner 1 / max(diag, 1e-12), masked;
//   * each CG step: S p, the implicit product (a per-point pass
//     t = sum wB^T (A pc + Ji pi), y = Vinv t; then per camera
//     sum wA^T (Ji pi - B y) and per intrinsic group sum wJi^T (A pc - B y),
//     plus Ud pc, Uid pi, masked), alpha = rz / max(p.Sp, 1e-30), the
//     updates of x, r, z, rz and beta = rz' / max(rz, 1e-30);
//   * the stop: the plain loop freezes its state at the first step with
//     rz <= cg_tol^2 rz0 and changes nothing after it, so this kernel
//     leaves the loop there: the same state, without the frozen steps;
//   * dp = Vinv (-gp - W^T x).
// Rounding differs from the plain version's only by summation order, the
// 3x3 inverse and the fused multiply-adds nvcc contracts. One exception
// where nothing is refined: with every intrinsic dof fixed the intrinsic
// rows of S p are 0 times a finite value in the plain version; the kernel
// skips their sums (they could differ only where those sums are not
// finite).
//
// Determinism: no atomics. The per-point sums run over the point's rows in
// table order in one thread; the per-camera and per-intrinsic sums in two
// levels, items of CHUNK consecutive table entries (one warp: two entries a
// lane, then a fixed shuffle tree) and the items of a segment (one warp,
// strided, then the same tree); the dots in one block (strided, then a
// fixed tree in shared memory). None of it depends on the grid's size, so
// two calls give the same bits on any card.
//
// What bounds it on an H100 SXM: neither FLOP nor HBM. A step reads the
// Jacobian blocks about twice (A 2x6, B 2x3, Ji 2x9, w and three int64 ids:
// ~170 bytes an observation; ~3 MB at the 11-view cell's 17,928 rows), all
// of it L2-resident (50 MB), and does ~200 FLOP an observation: ~2 us of
// bytes at the HBM rate. Its floor is latency: three grid barriers a step
// (point pass -> item pass -> the block-0 update) and the chains of
// dependent, scattered loads inside each pass. Measured on an H100 80GB
// HBM3 at 700 W at the 11-view cell's shapes (globaltimer stamps of block
// 0): a step 16-17 us, of it the point pass 3.6, the item pass 3.6, block
// 0's update 5.8 and each barrier 1.1 us; a solve of 40 steps 0.68 ms,
// against the plain solve's ~2,790 operations (35-65 ms of host enqueue
// on the card). A first version that packed the work into the fewest
// blocks (consecutive points on one block) took 39 us a step: its point
// pass ran on 9 SMs and took 19 us.
//
// Design: one persistent cooperative grid (cudaLaunchCooperativeKernel, the
// blocks that fit on the card at once, consecutive points and items on
// consecutive SMs), BLOCK threads a block, grid.sync() between dependent
// phases. Segment tables are the layout's own, walked as ba_segments.cuh
// sets out (its prologue scans are this kernel's too). The CG vectors
// ([V*6 | K*9]) live in the workspace; block 0 owns their updates. Every
// length is a grid-stride loop: no size cap.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ba_segments.cuh"

namespace cg = cooperative_groups;

namespace spcg {

using namespace baseg;

constexpr int BLOCK = 512;
constexpr int WARPS = BLOCK / 32;

// The arguments, as the wrapper fills them (ctypes.Structure of 8-byte
// fields): float tensors of the problem's dtype, int64 ids, bool masks;
// per table (cam, pt, intr) either rows (n, cap) int64 and mask (n, cap)
// float32 (cap > 0) or order (O,) int64 and lengths (n,) int64 (cap 0).
struct Args {
  const void *A, *B, *Ji, *w, *U, *Vl, *Ui, *gc, *gp, *gi;
  const long long *view_id, *intr_id, *point_id;
  const bool *fixed, *intr_free;
  const long long* idx[3];
  const float* mask[3];
  const long long* lengths[3];
  long long cap[3];
  long long V, L, K, O, iterations;
  double lam, tol2;
  void *dc, *dp, *di;
  long long* steps;               // CG steps run are added here (may be null)
  void* work;
};

template <typename T>
struct Params {
  const T *A, *B, *Ji, *w, *U, *Vl, *Ui, *gc, *gp, *gi;
  const long long *vid, *iid, *pid;
  const bool *fixed, *ifree;
  Table tab[3];                   // cam, pt, intr
  long long V, L, K, iters;
  T lam, tol2;
  T *dc, *dp, *di;
  long long* steps;
  // workspace
  T *Vinv, *y;                    // (L, 9), (L, 3)
  T *pm, *p, *r, *s, *prec, *free;  // [V*6 | K*9] each
  T *part_c, *part_i;             // items x 6, items x 9
  T* scal;                        // rz, stop
  int* any_free;                  // an intrinsic dof is refined
};

// ---------------------------------------------------------------------------
// workspace
// ---------------------------------------------------------------------------

template <typename T>
size_t carve(const Args& a, Params<T>* P) {
  Carve c{static_cast<char*>(a.work)};
  const long long n[3] = {a.V, a.L, a.K};
  const long long nv = a.V * 6 + a.K * 9;
  carve_tables(c, P->tab, a.idx, a.mask, a.lengths, a.cap, n, a.O);
  P->Vinv = c.take<T>(a.L * 9);
  P->y = c.take<T>(a.L * 3);
  P->pm = c.take<T>(nv);
  P->p = c.take<T>(nv);
  P->r = c.take<T>(nv);
  P->s = c.take<T>(nv);
  P->prec = c.take<T>(nv);
  P->free = c.take<T>(nv);
  P->part_c = c.take<T>(P->tab[0].items_max(a.O) * 6);
  P->part_i = c.take<T>(P->tab[2].items_max(a.O) * 9);
  P->scal = c.take<T>(2);
  P->any_free = c.take<int>(1);
  return c.off;
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// max(v, lo), NaN kept (torch.clamp_min)
template <typename T>
__device__ T clamp_min(T v, T lo) {
  return v < lo ? lo : v;
}

template <typename T>
__device__ void inv3(const T* m, T lam, T* out) {
  T a[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) a[i] = m[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i * 4] = a[i * 4] + (lam * a[i * 4] + T(1e-12));
  const T c00 = a[4] * a[8] - a[5] * a[7];
  const T c01 = a[5] * a[6] - a[3] * a[8];
  const T c02 = a[3] * a[7] - a[4] * a[6];
  const T det = a[0] * c00 + a[1] * c01 + a[2] * c02;
  out[0] = c00 / det;
  out[1] = (a[2] * a[7] - a[1] * a[8]) / det;
  out[2] = (a[1] * a[5] - a[2] * a[4]) / det;
  out[3] = c01 / det;
  out[4] = (a[0] * a[8] - a[2] * a[6]) / det;
  out[5] = (a[2] * a[3] - a[0] * a[5]) / det;
  out[6] = c02 / det;
  out[7] = (a[1] * a[6] - a[0] * a[7]) / det;
  out[8] = (a[0] * a[4] - a[1] * a[3]) / det;
}

// J (2 x N, row-major) x -> (2,)
template <typename T, int N>
__device__ void jx(const T* J, const T* x, T* out) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    T acc = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) acc += J[k * N + i] * x[i];
    out[k] = acc;
  }
}

// ---------------------------------------------------------------------------
// phases
// ---------------------------------------------------------------------------

// Per point l: t = sum over its rows of wB^T (A xc + Ji xi); CG: y = Vinv t;
// back-substitution: dp = Vinv (-gp - t).
template <typename T, bool BACK>
__device__ void point_pass(const Params<T>& P, const T* xc, const T* xi) {
  const Table& tb = P.tab[1];
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long l = spread_id(); l < P.L; l += stride) {
    T t[3] = {0, 0, 0};
    const long long b = tb.begin(l), e = b + tb.size(l);
    // the rows in order, four at a time so their loads overlap
    for (long long j0 = b; j0 < e; j0 += 4) {
      long long os[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) os[u] = j0 + u < e ? tb.obs(j0 + u) : -1;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long o = os[u];
        if (o < 0) continue;
        T ax[2], ix[2];
        jx<T, 6>(P.A + o * 12, xc + P.vid[o] * 6, ax);
        jx<T, 9>(P.Ji + o * 18, xi + P.iid[o] * 9, ix);
        const T wo = P.w[o];
        const T s0 = ax[0] + ix[0], s1 = ax[1] + ix[1];
        const T* Bo = P.B + o * 6;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          t[c] += (Bo[c] * wo) * s0 + (Bo[3 + c] * wo) * s1;
      }
    }
    const T* Vi = P.Vinv + l * 9;
    if (BACK) {
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c] = -P.gp[l * 3 + c] - t[c];
    }
    T* out = BACK ? P.dp + l * 3 : P.y + l * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[c] = Vi[c * 3] * t[0] + Vi[c * 3 + 1] * t[1] + Vi[c * 3 + 2] * t[2];
  }
}

// One item of table `tb` (camera: NC 6, intrinsics: NC 9) by one warp: the
// sum over its entries of wA^T (Ji pi - B y) or wJi^T (A pc - B y).
template <typename T, int NC>
__device__ void item_sum(const Params<T>& P, const Table& tb, long long it,
                         T* part) {
  const int lane = threadIdx.x & 31;
  const long long s = tb.seg[it];
  const long long q = it - tb.item[s];
  const long long b = tb.begin(s), e = b + tb.size(s);
  T acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0;
#pragma unroll
  for (int m = 0; m < CHUNK / 32; ++m) {
    const long long j = b + q * CHUNK + m * 32 + lane;
    const long long o = j < e ? tb.obs(j) : -1;
    if (o < 0) continue;
    const T* yo = P.y + P.pid[o] * 3;
    T by[2], ux[2];
    jx<T, 3>(P.B + o * 6, yo, by);
    if (NC == 6) jx<T, 9>(P.Ji + o * 18, P.pm + P.V * 6 + P.iid[o] * 9, ux);
    else jx<T, 6>(P.A + o * 12, P.pm + P.vid[o] * 6, ux);
    const T e0 = ux[0] - by[0], e1 = ux[1] - by[1];
    const T wo = P.w[o];
    const T* J = NC == 6 ? P.A + o * 12 : P.Ji + o * 18;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      acc[i] += (J[i] * wo) * e0 + (J[NC + i] * wo) * e1;
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i) part[it * NC + i] = acc[i];
  }
}

// Every block: the items of the camera table, then (if an intrinsic dof is
// refined) those of the intrinsic table, a warp an item.
template <typename T>
__device__ void item_pass(const Params<T>& P) {
  const long long warp = blockIdx.x + (long long)gridDim.x * (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long ic = P.tab[0].item[P.V];
  const long long ii = *P.any_free ? P.tab[2].item[P.K] : 0;
  for (long long it = warp; it < ic + ii; it += nwarps) {
    if (it < ic) item_sum<T, 6>(P, P.tab[0], it, P.part_c);
    else item_sum<T, 9>(P, P.tab[2], it - ic, P.part_i);
  }
}

// Block 0: each segment's items summed (a warp a segment, lane c its row
// c). RHS: r = (-g - sum) * free (the sum ran with pm = 0, so it is
// -W Vinv gp); CG: s = (Ud pm + sum) * free.
template <typename T, bool RHS>
__device__ void segment_sums(const Params<T>& P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nc = P.V * 6;
  const long long nseg = P.V + (*P.any_free ? P.K : 0);
  for (long long sg = warp; sg < nseg; sg += WARPS) {
    const bool cam = sg < P.V;
    const long long s = cam ? sg : sg - P.V;
    const Table& tb = P.tab[cam ? 0 : 2];
    const int nc_ = cam ? 6 : 9;
    const T* part = cam ? P.part_c : P.part_i;
    T acc[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) acc[i] = 0;
    for (long long it = tb.item[s] + lane; it < tb.item[s + 1]; it += 32) {
#pragma unroll
      for (int i = 0; i < 9; ++i)
        if (i < nc_) acc[i] += part[it * nc_ + i];
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
    }
    // lane 0 holds the sums; lane c computes row c of the segment
    T sum = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const T v = __shfl_sync(0xffffffffu, acc[i], 0);
      if (lane == i) sum = v;
    }
    if (lane >= nc_) continue;
    const long long j0 = cam ? s * 6 : nc + s * 9, j = j0 + lane;
    if (RHS) {
      const T g = cam ? P.gc[s * 6 + lane] : P.gi[s * 9 + lane];
      P.r[j] = (-g + (-sum)) * P.free[j];
    } else {
      const T* M = (cam ? P.U + s * 36 : P.Ui + s * 81) + lane * nc_;
      const T damp = cam ? T(1e-12) : T(1);
      T u = 0;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        if (k < nc_) {
          T m = M[k];
          if (k == lane) m = m + (P.lam * m + damp);
          u += m * P.pm[j0 + k];
        }
      }
      P.s[j] = (u + sum) * P.free[j];
    }
  }
  // with no refined intrinsic dof the intrinsic rows are 0 times a sum
  if (!*P.any_free) {
    for (long long j = nc + threadIdx.x; j < nc + P.K * 9; j += BLOCK) {
      if (RHS) P.r[j] = (-P.gi[j - nc]) * P.free[j];
      else P.s[j] = T(0) * P.free[j];
    }
  }
  __syncthreads();
}

// sum over j in [a, b) of x[j] * y[j], block 0
template <typename T>
__device__ T dot(const T* x, const T* y, long long a, long long b, T* sh) {
  T acc = 0;
  for (long long j = a + threadIdx.x; j < b; j += BLOCK) acc += x[j] * y[j];
  return block_sum<BLOCK>(acc, sh);
}

template <typename T>
__device__ T& xref(const Params<T>& P, long long j) {
  const long long nc = P.V * 6;
  return j < nc ? P.dc[j] : P.di[j - nc];
}

// Block 0: the right-hand side's end: x = 0, z = M r, p = z, rz, stop.
template <typename T>
__device__ void cg_start(const Params<T>& P, T* sh) {
  segment_sums<T, true>(P);
  const long long nc = P.V * 6, nv = nc + P.K * 9;
  for (long long j = threadIdx.x; j < nv; j += BLOCK) {
    xref(P, j) = T(0);
    const T z = P.r[j] * P.prec[j] * P.free[j];
    P.p[j] = z;
    P.pm[j] = z * P.free[j];
    P.s[j] = z;
  }
  __syncthreads();
  const T rz = dot(P.r, P.s, 0, nc, sh) + dot(P.r, P.s, nc, nv, sh);
  if (threadIdx.x == 0) {
    P.scal[0] = rz;
    P.scal[1] = P.tol2 * rz;
  }
}

// Block 0: one CG step's update, after the item pass.
template <typename T>
__device__ void cg_update(const Params<T>& P, T* sh) {
  segment_sums<T, false>(P);
  const long long nc = P.V * 6, nv = nc + P.K * 9;
  const T rz = P.scal[0];
  const T pap = dot(P.p, P.s, 0, nc, sh) + dot(P.p, P.s, nc, nv, sh);
  const T alpha = rz / clamp_min(pap, T(1e-30));
  for (long long j = threadIdx.x; j < nv; j += BLOCK) {
    T& x = xref(P, j);
    x = x + alpha * P.p[j];
    const T r = P.r[j] - alpha * P.s[j];
    P.r[j] = r;
    P.s[j] = r * P.prec[j] * P.free[j];          // z
  }
  __syncthreads();
  const T rzn = dot(P.r, P.s, 0, nc, sh) + dot(P.r, P.s, nc, nv, sh);
  const T beta = rzn / clamp_min(rz, T(1e-30));
  for (long long j = threadIdx.x; j < nv; j += BLOCK) {
    const T p = P.s[j] + beta * P.p[j];
    P.p[j] = p;
    P.pm[j] = p * P.free[j];
  }
  if (threadIdx.x == 0) P.scal[0] = rzn;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK, 1) schur_pcg_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ long long shl[BLOCK];
  __shared__ T sh[BLOCK];
  const long long nc = P.V * 6, nv = nc + P.K * 9;
  const long long tid = spread_id();
  const long long stride = (long long)gridDim.x * BLOCK;

  // prologue: the tables' scans, one a block
  table_scans<BLOCK>(P.tab, shl);
  if (blockIdx.x == 0) {
    int any = 0;
    for (long long j = threadIdx.x; j < P.K * 9; j += BLOCK)
      any |= P.ifree[j] ? 1 : 0;
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) *P.any_free = any;
  }
  // the damped point inverses and y = Vinv gp; the preconditioner
  for (long long l = tid; l < P.L; l += stride) {
    T* Vi = P.Vinv + l * 9;
    inv3(P.Vl + l * 9, P.lam, Vi);
    const T* g = P.gp + l * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      P.y[l * 3 + c] = Vi[c * 3] * g[0] + Vi[c * 3 + 1] * g[1]
                       + Vi[c * 3 + 2] * g[2];
  }
  for (long long j = tid; j < nv; j += stride) {
    const bool cam = j < nc;
    const long long s = cam ? j / 6 : (j - nc) / 9;
    const int c = cam ? int(j % 6) : int((j - nc) % 9);
    const T d = cam ? P.U[s * 36 + c * 7] : P.Ui[s * 81 + c * 10];
    const T dd = d + (P.lam * d + (cam ? T(1e-12) : T(1)));
    P.prec[j] = T(1) / clamp_min(dd, T(1e-12));
    P.free[j] = cam ? (P.fixed[s] ? T(0) : T(1))
                    : (P.ifree[s * 9 + c] ? T(1) : T(0));
    P.pm[j] = T(0);
  }
  grid.sync();

  // the right-hand side: the item pass with pm = 0 gives -W Vinv gp
  item_pass(P);
  grid.sync();
  if (blockIdx.x == 0) cg_start(P, sh);
  grid.sync();

  long long k = 0;
  for (; k < P.iters; ++k) {
    if (!(P.scal[0] > P.scal[1])) break;      // the plain loop's frozen state
    point_pass<T, false>(P, P.pm, P.pm + nc);
    grid.sync();
    item_pass(P);
    grid.sync();
    if (blockIdx.x == 0) cg_update(P, sh);
    grid.sync();
  }

  point_pass<T, true>(P, P.dc, P.di);
  if (tid == 0 && P.steps) *P.steps += k;
}

template <typename T>
int launch(const Args& a, cudaStream_t stream, int device) {
  Params<T> P;
  P.A = static_cast<const T*>(a.A);
  P.B = static_cast<const T*>(a.B);
  P.Ji = static_cast<const T*>(a.Ji);
  P.w = static_cast<const T*>(a.w);
  P.U = static_cast<const T*>(a.U);
  P.Vl = static_cast<const T*>(a.Vl);
  P.Ui = static_cast<const T*>(a.Ui);
  P.gc = static_cast<const T*>(a.gc);
  P.gp = static_cast<const T*>(a.gp);
  P.gi = static_cast<const T*>(a.gi);
  P.vid = a.view_id;
  P.iid = a.intr_id;
  P.pid = a.point_id;
  P.fixed = a.fixed;
  P.ifree = a.intr_free;
  P.V = a.V;
  P.L = a.L;
  P.K = a.K;
  P.iters = a.iterations;
  P.lam = T(a.lam);
  P.tol2 = T(a.tol2);
  P.dc = static_cast<T*>(a.dc);
  P.dp = static_cast<T*>(a.dp);
  P.di = static_cast<T*>(a.di);
  P.steps = a.steps;
  carve<T>(a, &P);

  // the blocks one wave holds (cooperative launch): each pass is short
  // and latency-bound, so it spreads over every SM (spread_id)
  static int cache[64][2];
  int& grid = cache[device & 63][sizeof(T) == 4 ? 0 : 1];
  const void* kernel = (const void*)schur_pcg_kernel<T>;
  cudaError_t e = wave_blocks(kernel, BLOCK, device, &grid);
  if (e != cudaSuccess) return int(e);
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(BLOCK), args, 0,
                                  stream);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace spcg

// Bytes of the workspace a call with these arguments needs (dtype 0:
// float, 1: double); `work` is not read.
extern "C" long long r3d_schur_pcg_workspace(int dtype,
                                             const spcg::Args* args) {
  spcg::Args a = *args;
  a.work = nullptr;
  if (dtype == 0) {
    spcg::Params<float> P;
    return (long long)spcg::carve<float>(a, &P);
  }
  spcg::Params<double> P;
  return (long long)spcg::carve<double>(a, &P);
}

// One damped Schur PCG solve on card `device`, on `stream`; writes dc (V,
// 6), dp (L, 3), di (K, 9). Returns a cudaError_t (0: the launch was
// taken).
extern "C" int r3d_schur_pcg(int dtype, int device, const spcg::Args* args,
                             void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return spcg::on_device(device, [&] {
    return dtype == 0 ? spcg::launch<float>(*args, s, device)
                      : spcg::launch<double>(*args, s, device);
  });
}
