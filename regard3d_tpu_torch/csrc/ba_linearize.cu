// The linearisation and the cost read of one Levenberg-Marquardt trial of
// bundle adjustment (regard3d_tpu_torch/ba/lm.py: _normal_blocks and
// compute_cost), each in one cooperative launch.
//
// Replaces no Pallas kernel. The JAX package left both to XLA, which fused
// the reference's vmap(jacfwd) over the observation table into a few
// kernels. The port's plain version takes the 18 Jacobian columns as a
// vmap-ped jvp over the whole table, in which camera.project evaluates all
// five distortion models for every row and picks one with a where: ~609
// eager device operations a trial for the linearisation, ~134 for a cost
// read, ~90% of an LM iteration's ~745 after the Schur PCG kernel
// (schur_pcg.cu), at ~40 us of host enqueue each.
//
// What it computes is what the plain version computes, in the same
// precision (T = float or double):
//   * per observation row, at zero increment, the residual
//     r = project(exp(dw) R0, C0 + dC, model, intr0 + dintr, X0 + dX) - xy
//     and its Jacobian against the 3+3+3+9 increments, split into
//     A (2x6: dw, dC), B (2x3: dX) and Ji (2x9: f, cx, cy, d0..d5), in
//     forward mode by hand: at zero increment exp(dw) R0 moves x_cam by
//     dw x x_cam (exp_so3's series branch), the division by the depth
//     keeps its guard (|depth| <= 1e-12 divides by 1e-12, whose tangent is
//     0), and only the row's own model is evaluated, with its derivatives
//     in closed form (fisheye: 1 below r = 1e-8, as the plain guard), and
//     no column where x_cam, the point or the focal is not finite (forward
//     mode turns every column NaN there);
//   * every non-finite entry of r, A, B, Ji and every row with weight <= 0
//     set to 0; w = weight * irls(r . r), Huber at huber_delta_px (1 when
//     it is 0);
//   * the block sums U = sum wA^T A (V, 6, 6), gc = sum wA^T r (V, 6),
//     Ui, gi over the intrinsic groups (K, 9, 9), (K, 9), and Vl, gp over
//     the points (L, 3, 3), (L, 3), each term (J_i w) J_j as _outer /
//     _jt_r write it;
//   * the cost: r . r per row, 1e12 where it is not finite, Huber's rho,
//     times the weight where it is > 0, summed to one scalar.
// Rounding differs from the plain version's only by summation order, the
// closed-form derivatives' operation order and the multiply-adds nvcc
// contracts.
//
// Determinism: no atomics. The per-point sums run over the point's rows in
// table order in one thread; the per-camera and per-intrinsic sums in two
// levels, items of CHUNK consecutive table entries (a warp an item: its
// entries staged 32 at a time in shared memory, a lane an output entry,
// the entries in order) and the items of a segment (a warp an output
// entry: a lane's items in order, then a fixed shuffle tree); the cost in
// chunks of COST_ROWS rows (four a thread, then a fixed tree), then the
// chunks in block 0 (strided, then the same tree). None of it depends on
// the grid's size.
//
// What bounds it on an H100 SXM: neither FLOP nor HBM. A row reads ~130
// bytes (the camera, point and intrinsic rows, xy, weight, four int64 ids)
// and writes ~160 (r, A, B, Ji, w in float32), ~5 MB at the 11-view cell's
// 17,928 rows: ~2 us at the HBM rate; a few hundred FLOP a row. Its floor
// is the launch and two grid barriers (~1 us each) and the chains of
// dependent, scattered loads in each pass: the row pass (gathers of three
// parameter rows), the point and item passes (rows in table order), the
// segment pass (items in order).
//
// Design: one persistent cooperative grid (the blocks one wave holds),
// BLOCK threads a block, grid.sync() between three passes:
//   1. the prologue's table scans (blocks 0-4, ba_segments.cuh) and the
//      row pass, a thread a row (consecutive rows on consecutive lanes, so
//      the block stores coalesce), every output row written;
//   2. the point pass (a thread a point: Vl, gp) and the item pass (a warp
//      an item of the camera table, then of the intrinsic table: its 42 or
//      90 partial sums);
//   3. the segment pass: each segment's items summed into U, gc, Ui, gi
//      (a warp an entry: the one intrinsic group of a project has ~300
//      items, which one thread would sum in a chain of dependent loads).
// The cost is a second, smaller cooperative kernel. The per-row arithmetic
// is __host__ __device__: outside nvcc this file is plain C++ without its
// kernels, which the CPU tests build with g++.

#include <cmath>
#include <cstdint>

#include "ba_segments.cuh"

namespace bal {

using namespace baseg;

// camera model codes (core/types.py; 0, pinhole, and any other code: no
// distortion)
constexpr int RADIAL_K1 = 1, RADIAL_K3 = 2, BROWN_T2 = 3, FISHEYE = 4;
constexpr int CAM_SUMS = 6 * 6 + 6;      // U, gc entries a camera
constexpr int INTR_SUMS = 9 * 9 + 9;     // Ui, gi entries an intrinsic group
constexpr int POINT_SUMS = 3 * 3 + 3;    // Vl, gp entries a point

R3D_HD float r_sqrt(float x) { return sqrtf(x); }
R3D_HD double r_sqrt(double x) { return sqrt(x); }
R3D_HD float r_atan(float x) { return atanf(x); }
R3D_HD double r_atan(double x) { return atan(x); }
R3D_HD float r_abs(float x) { return fabsf(x); }
R3D_HD double r_abs(double x) { return fabs(x); }
template <typename T>
R3D_HD bool r_finite(T x) {
#ifdef __CUDA_ARCH__
  return isfinite(x);
#else
  return std::isfinite(x);
#endif
}
// torch.clamp_min(a, lo): a NaN stays NaN
template <typename T>
R3D_HD T clamp_min(T a, T lo) { return lo > a ? lo : a; }

// cameras.add_disto of model `m` (any other code: pinhole) with distortion
// d0..d5 at normalized (x, y): xd; with JAC also its Jacobian against
// (x, y), J (2x2 row-major), and against d0..d5, D (2x6 row-major)
template <typename T, bool JAC>
R3D_HD void distort(int m, const T* d, T x, T y, T* xd, T* J, T* D) {
  if constexpr (JAC) {
    J[0] = T(1);
    J[1] = T(0);
    J[2] = T(0);
    J[3] = T(1);
    for (int k = 0; k < 12; ++k) D[k] = T(0);
  }
  xd[0] = x;
  xd[1] = y;
  const T r2 = x * x + y * y;
  if (m == RADIAL_K1) {
    const T s = T(1) + d[0] * r2;
    xd[0] = x * s;
    xd[1] = y * s;
    if constexpr (JAC) {
      const T s2 = T(2) * d[0];           // 2 ds/dr2
      J[0] = s + s2 * x * x;
      J[1] = s2 * x * y;
      J[2] = s2 * y * x;
      J[3] = s + s2 * y * y;
      D[0] = x * r2;
      D[6] = y * r2;
    }
  } else if (m == RADIAL_K3 || m == BROWN_T2) {
    const T r4 = r2 * r2, r6 = r4 * r2;
    const T s = T(1) + d[0] * r2 + d[1] * r4 + d[2] * r6;
    xd[0] = x * s;
    xd[1] = y * s;
    if constexpr (JAC) {
      const T s2 = T(2) * (d[0] + T(2) * d[1] * r2 + T(3) * d[2] * r4);
      J[0] = s + s2 * x * x;
      J[1] = s2 * x * y;
      J[2] = s2 * y * x;
      J[3] = s + s2 * y * y;
      D[0] = x * r2;
      D[1] = x * r4;
      D[2] = x * r6;
      D[6] = y * r2;
      D[7] = y * r4;
      D[8] = y * r6;
    }
    if (m == BROWN_T2) {                  // tangential t1 = d3, t2 = d4
      const T t1 = d[3], t2 = d[4];
      xd[0] = xd[0] + (T(2) * t1 * x * y + t2 * (r2 + T(2) * x * x));
      xd[1] = xd[1] + (t1 * (r2 + T(2) * y * y) + T(2) * t2 * x * y);
      if constexpr (JAC) {
        J[0] = J[0] + (T(2) * t1 * y + T(6) * t2 * x);
        J[1] = J[1] + (T(2) * t1 * x + T(2) * t2 * y);
        J[2] = J[2] + (T(2) * t1 * x + T(2) * t2 * y);
        J[3] = J[3] + (T(6) * t1 * y + T(2) * t2 * x);
        D[3] = T(2) * x * y;
        D[9] = r2 + T(2) * y * y;
        D[4] = r2 + T(2) * x * x;
        D[10] = T(2) * x * y;
      }
    }
  } else if (m == FISHEYE) {
    const T r = r_sqrt(r2 + T(1e-32));
    if (r > T(1e-8)) {                    // else xd = (x, y), J = I, D = 0
      const T th = r_atan(r), th2 = th * th;
      const T th4 = th2 * th2, th6 = th4 * th2, th8 = th4 * th4;
      const T poly = T(1) + d[0] * th2 + d[1] * th4 + d[2] * th6 + d[3] * th8;
      const T thd = th * poly;
      const T inv_r = T(1) / r;
      const T c = thd * inv_r;
      xd[0] = x * c;
      xd[1] = y * c;
      if constexpr (JAC) {
        // d thd / d th = poly + th * d poly / d th; d th / d r = 1/(1+r^2)
        const T dpoly = d[0] + T(2) * d[1] * th2 + T(3) * d[2] * th4
                        + T(4) * d[3] * th6;
        const T dthd = (poly + T(2) * th2 * dpoly) / (T(1) + r * r);
        const T dc = (dthd - c) * inv_r;           // d c / d r
        const T cx = dc * x * inv_r, cy = dc * y * inv_r;
        J[0] = c + x * cx;
        J[1] = x * cy;
        J[2] = y * cx;
        J[3] = c + y * cy;
        const T g[4] = {th * th2 * inv_r, th * th4 * inv_r, th * th6 * inv_r,
                        th * th8 * inv_r};
        for (int k = 0; k < 4; ++k) {
          D[k] = x * g[k];
          D[6 + k] = y * g[k];
        }
      }
    }
  }
}

// One observation at zero increment: camera rotation R (3x3 row-major) and
// centre C, intrinsic row p [f, cx, cy, d0..d5], point X, observed pixel
// xy, model code m. Writes the residual r (2); with JAC its Jacobian, A
// (2x6 row-major: dw, dC), B (2x3: dX), Ji (2x9: f, cx, cy, d0..d5).
template <typename T, bool JAC>
R3D_HD void project(const T* R, const T* C, const T* p, const T* X,
                    const T* xy, int m, T* r, T* A, T* B, T* Ji) {
  const T dx[3] = {X[0] - C[0], X[1] - C[1], X[2] - C[2]};
  T xc[3];
  for (int i = 0; i < 3; ++i)
    xc[i] = R[i * 3] * dx[0] + R[i * 3 + 1] * dx[1] + R[i * 3 + 2] * dx[2];
  const bool guard = !(r_abs(xc[2]) > T(1e-12));
  const T den = guard ? T(1e-12) : xc[2];
  const T x = xc[0] / den, y = xc[1] / den;
  T xd[2], J[4], D[12];
  distort<T, JAC>(m, p + 3, x, y, xd, J, D);
  const T f = p[0];
  r[0] = xd[0] * f + p[1] - xy[0];
  r[1] = xd[1] * f + p[2] - xy[1];
  if constexpr (JAC) {
    // d x_cam of each direction: dw_k moves it by e_k x x_cam, dX_k by
    // R[:, k], dC_k by -R[:, k]
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      T q[3];
      if (k < 3) {
        q[k] = T(0);
        q[(k + 1) % 3] = -xc[(k + 2) % 3];
        q[(k + 2) % 3] = xc[(k + 1) % 3];
      } else {
        for (int i = 0; i < 3; ++i) q[i] = R[i * 3 + (k - 3)];
      }
      const T q2 = guard ? T(0) : q[2];
      const T nx = (q[0] - x * q2) / den, ny = (q[1] - y * q2) / den;
      const T u = (J[0] * nx + J[1] * ny) * f;
      const T v = (J[2] * nx + J[3] * ny) * f;
      if (k < 3) {
        A[k] = u;
        A[6 + k] = v;
      } else {
        B[k - 3] = u;
        B[k] = v;
        A[k] = -u;
        A[6 + k] = -v;
      }
    }
    Ji[0] = xd[0];
    Ji[1] = T(1);
    Ji[2] = T(0);
    Ji[9] = xd[1];
    Ji[10] = T(0);
    Ji[11] = T(1);
    for (int k = 0; k < 6; ++k) {
      Ji[3 + k] = D[k] * f;
      Ji[12 + k] = D[6 + k] * f;
    }
    // forward mode multiplies each intermediate by each direction's
    // tangent: a non-finite x_cam, normalized or distorted point or focal
    // makes every column NaN (a NaN or an inf times a zero tangent), which
    // the masking sets to 0
    bool chain = r_finite(x) && r_finite(y) && r_finite(xd[0])
                 && r_finite(xd[1]) && r_finite(f);
    for (int i = 0; i < 3; ++i) chain = chain && r_finite(xc[i]);
    if (!chain) {
      for (int k = 0; k < 12; ++k) A[k] = T(0);
      for (int k = 0; k < 6; ++k) B[k] = T(0);
      for (int k = 0; k < 18; ++k) Ji[k] = T(0);
    }
  }
}

// The IRLS weight of a row with squared residual r2 (_irls_weights)
template <typename T>
R3D_HD T irls(T r2, double huber) {
  if (huber <= 0) return T(1);
  const T rn = r_sqrt(clamp_min(r2, T(1e-24)));
  return r2 <= T(huber * huber) ? T(1) : T(huber) / rn;
}

template <typename T>
R3D_HD T live_or_zero(bool live, T v) {
  return live && r_finite(v) ? v : T(0);
}

// _build_blocks' masking of one row in place (every non-finite entry and
// every row with weight <= 0 to 0); returns the row's w
template <typename T>
R3D_HD T mask_row(T weight, double huber, T* r, T* A, T* B, T* Ji) {
  const bool live = weight > T(0);
  for (int k = 0; k < 2; ++k) r[k] = live_or_zero(live, r[k]);
  for (int k = 0; k < 12; ++k) A[k] = live_or_zero(live, A[k]);
  for (int k = 0; k < 6; ++k) B[k] = live_or_zero(live, B[k]);
  for (int k = 0; k < 18; ++k) Ji[k] = live_or_zero(live, Ji[k]);
  return weight * irls(r[0] * r[0] + r[1] * r[1], huber);
}

// compute_cost's term of a row with residual r
template <typename T>
R3D_HD T cost_term(const T* r, T weight, double huber) {
  T r2 = r[0] * r[0] + r[1] * r[1];
  r2 = r_finite(r2) ? r2 : T(1e12);
  const T rho = huber > 0 && !(r2 <= T(huber * huber))
                    ? T(2.0 * huber) * r_sqrt(r2) - T(huber * huber)
                    : r2;
  return weight > T(0) ? rho * weight : T(0);
}

// A row's term of output entry e of the sums over its N-column block J
// (2 x N row-major) with weight w and residual r: e < N*N the entry
// (e / N, e % N) of (J w)^T J, else entry e - N*N of (J w)^T r
template <typename T, int N>
R3D_HD T normal_term(const T* J, T w, const T* r, int e) {
  if (e < N * N) {
    const int i = e / N, j = e % N;
    return (J[i] * w) * J[j] + (J[N + i] * w) * J[N + j];
  }
  const int i = e - N * N;
  return (J[i] * w) * r[0] + (J[N + i] * w) * r[1];
}

// Point l's sums (Vl row-major, then gp) over its rows in table order
template <typename T>
R3D_HD void point_sums(const Table& tb, long long l, const T* B, const T* w,
                       const T* r, T* acc) {
#pragma unroll
  for (int e = 0; e < POINT_SUMS; ++e) acc[e] = T(0);
  const long long b = tb.begin(l), end = b + tb.size(l);
  for (long long j = b; j < end; ++j) {
    const long long o = tb.obs(j);
    if (o < 0) continue;
#pragma unroll
    for (int e = 0; e < POINT_SUMS; ++e)
      acc[e] += normal_term<T, 3>(B + o * 6, w[o], r + o * 2, e);
  }
}

}  // namespace bal

#ifdef __CUDACC__

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace bal {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int COST_ROWS = 4 * BLOCK;     // rows of one partial of the cost
constexpr int STAGE = 2 * 9 + 3;         // a staged row: J (2 x N), r, w

// The arguments, as the wrapper fills them (ctypes.Structure of 8-byte
// fields): float tensors of the problem's dtype, int64 ids and model codes;
// per table (cam, pt, intr) either rows (n, cap) int64 and mask (n, cap)
// float32 (cap > 0) or order (O,) int64 and lengths (n,) int64 (cap 0).
// The cost entry reads no table and writes only `cost`.
struct Args {
  const void *R, *C, *intr, *X, *xy, *weight;
  const long long *view_id, *intr_id, *point_id, *model;
  const long long* idx[3];
  const float* mask[3];
  const long long* lengths[3];
  long long cap[3];
  long long V, L, K, O;
  double huber;
  void *r, *A, *B, *Ji, *w, *U, *Vl, *Ui, *gc, *gp, *gi;
  void* cost;
  void* work;
};

template <typename T>
struct Params {
  const T *R, *C, *intr, *X, *xy, *weight;
  const long long *vid, *iid, *pid, *model;
  Table tab[3];                   // cam, pt, intr
  long long V, L, K, O;
  double huber;
  T *r, *A, *B, *Ji, *w, *U, *Vl, *Ui, *gc, *gp, *gi, *cost;
  // workspace
  T *part_c, *part_i;             // items x CAM_SUMS, items x INTR_SUMS
  T* part;                        // the cost's partials, one a chunk
};

template <typename T>
void fill(const Args& a, Params<T>* P) {
  P->R = static_cast<const T*>(a.R);
  P->C = static_cast<const T*>(a.C);
  P->intr = static_cast<const T*>(a.intr);
  P->X = static_cast<const T*>(a.X);
  P->xy = static_cast<const T*>(a.xy);
  P->weight = static_cast<const T*>(a.weight);
  P->vid = a.view_id;
  P->iid = a.intr_id;
  P->pid = a.point_id;
  P->model = a.model;
  P->V = a.V;
  P->L = a.L;
  P->K = a.K;
  P->O = a.O;
  P->huber = a.huber;
  T** out[] = {&P->r, &P->A, &P->B, &P->Ji, &P->w, &P->U, &P->Vl,
               &P->Ui, &P->gc, &P->gp, &P->gi, &P->cost};
  void* const src[] = {a.r, a.A, a.B, a.Ji, a.w, a.U, a.Vl,
                       a.Ui, a.gc, a.gp, a.gi, a.cost};
  for (int i = 0; i < 12; ++i) *out[i] = static_cast<T*>(src[i]);
}

// the workspace of the linearisation (COST false) or of the cost
template <typename T, bool COST>
size_t carve(const Args& a, Params<T>* P) {
  Carve c{static_cast<char*>(a.work)};
  if (COST) {
    P->part = c.take<T>((a.O + COST_ROWS - 1) / COST_ROWS);
    return c.off;
  }
  const long long n[3] = {a.V, a.L, a.K};
  carve_tables(c, P->tab, a.idx, a.mask, a.lengths, a.cap, n, a.O);
  P->part_c = c.take<T>(P->tab[0].items_max(a.O) * CAM_SUMS);
  P->part_i = c.take<T>(P->tab[2].items_max(a.O) * INTR_SUMS);
  return c.off;
}

// ---------------------------------------------------------------------------
// passes
// ---------------------------------------------------------------------------

// 1. A thread a row: r, A, B, Ji, w, masked.
template <typename T>
__device__ void row_pass(const Params<T>& P) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long o = blockIdx.x * (long long)BLOCK + threadIdx.x; o < P.O;
       o += stride) {
    const long long v = P.vid[o], g = P.iid[o], l = P.pid[o];
    T r[2], A[12], B[6], Ji[18];
    project<T, true>(P.R + v * 9, P.C + v * 3, P.intr + g * 9, P.X + l * 3,
                     P.xy + o * 2, int(P.model[o]), r, A, B, Ji);
    const T w = mask_row(P.weight[o], P.huber, r, A, B, Ji);
    for (int k = 0; k < 2; ++k) P.r[o * 2 + k] = r[k];
    for (int k = 0; k < 12; ++k) P.A[o * 12 + k] = A[k];
    for (int k = 0; k < 6; ++k) P.B[o * 6 + k] = B[k];
    for (int k = 0; k < 18; ++k) P.Ji[o * 18 + k] = Ji[k];
    P.w[o] = w;
  }
}

// 2a. A thread a point: Vl, gp.
template <typename T>
__device__ void point_pass(const Params<T>& P) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long l = spread_id(); l < P.L; l += stride) {
    T acc[POINT_SUMS];
    point_sums(P.tab[1], l, P.B, P.w, P.r, acc);
#pragma unroll
    for (int e = 0; e < 9; ++e) P.Vl[l * 9 + e] = acc[e];
#pragma unroll
    for (int e = 0; e < 3; ++e) P.gp[l * 3 + e] = acc[9 + e];
  }
}

// Item k of table `tb` (its CHUNK entries in order) by one warp, over the
// blocks J of N columns: a round stages 32 entries' J, r and w in `st`
// (a lane an entry), then lane i sums entries i, i + 32, i + 64 of the
// item's N*N + N sums over the staged rows in order.
template <typename T, int N>
__device__ void item_sums(const Params<T>& P, const Table& tb, long long k,
                          const T* J, T* part, T* st, bool* ok) {
  constexpr int NS = N * N + N, PER = (NS + 31) / 32;
  const int lane = threadIdx.x & 31;
  const long long s = tb.seg[k];
  const long long seg_end = tb.begin(s) + tb.size(s);
  const long long b = tb.begin(s) + (k - tb.item[s]) * CHUNK;
  const long long end = b + CHUNK < seg_end ? b + CHUNK : seg_end;
  T acc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) acc[u] = T(0);
  for (long long j0 = b; j0 < end; j0 += 32) {
    const long long o = j0 + lane < end ? tb.obs(j0 + lane) : -1;
    T* row = st + lane * STAGE;
    if (o >= 0) {
#pragma unroll
      for (int c = 0; c < 2 * N; ++c) row[c] = J[o * 2 * N + c];
      row[2 * N] = P.r[o * 2];
      row[2 * N + 1] = P.r[o * 2 + 1];
      row[2 * N + 2] = P.w[o];
    }
    ok[lane] = o >= 0;
    __syncwarp();
    const int n = end - j0 < 32 ? int(end - j0) : 32;
    for (int t = 0; t < n; ++t) {
      if (!ok[t]) continue;
      const T* rt = st + t * STAGE;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = lane + 32 * u;
        if (e < NS)
          acc[u] += normal_term<T, N>(rt, rt[2 * N + 2], rt + 2 * N, e);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = lane + 32 * u;
    if (e < NS) part[k * NS + e] = acc[u];
  }
}

// 2b. A warp an item of the camera table, then of the intrinsic table.
template <typename T>
__device__ void item_pass(const Params<T>& P) {
  __shared__ T stage[WARPS][32 * STAGE];
  __shared__ bool ok[WARPS][32];
  const int wib = threadIdx.x >> 5;
  const long long warp = blockIdx.x + (long long)gridDim.x * wib;
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long ic = P.tab[0].item[P.V], ii = P.tab[2].item[P.K];
  for (long long it = warp; it < ic + ii; it += nwarps) {
    if (it < ic)
      item_sums<T, 6>(P, P.tab[0], it, P.A, P.part_c, stage[wib], ok[wib]);
    else
      item_sums<T, 9>(P, P.tab[2], it - ic, P.Ji, P.part_i, stage[wib],
                      ok[wib]);
  }
}

// 3. A warp an output entry of a camera or intrinsic group: lane i sums
// the segment's items i, i + 32, ... in order, then a fixed shuffle tree.
template <typename T>
__device__ void segment_pass(const Params<T>& P) {
  const int lane = threadIdx.x & 31;
  const long long warp = blockIdx.x + (long long)gridDim.x * (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long nc = P.V * CAM_SUMS, n = nc + P.K * INTR_SUMS;
  for (long long t = warp; t < n; t += nwarps) {
    const bool cam = t < nc;
    const int nsum = cam ? CAM_SUMS : INTR_SUMS;
    const long long s = (cam ? t : t - nc) / nsum;
    const int e = int((cam ? t : t - nc) % nsum);
    const Table& tb = P.tab[cam ? 0 : 2];
    const T* part = cam ? P.part_c : P.part_i;
    T acc = T(0);
    for (long long it = tb.item[s] + lane; it < tb.item[s + 1]; it += 32)
      acc += part[it * nsum + e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane) continue;
    const int nn = cam ? 36 : 81;
    if (e < nn) (cam ? P.U + s * 36 : P.Ui + s * 81)[e] = acc;
    else (cam ? P.gc + s * 6 : P.gi + s * 9)[e - nn] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(BLOCK, 1)
    ba_linearize_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ long long shl[BLOCK];
  table_scans<BLOCK>(P.tab, shl);
  row_pass(P);
  grid.sync();
  point_pass(P);
  item_pass(P);
  grid.sync();
  segment_pass(P);
}

// The cost: each chunk of COST_ROWS rows summed by one block (four rows a
// thread, then a fixed tree), then the chunks by block 0.
template <typename T>
__global__ void __launch_bounds__(BLOCK, 1) ba_cost_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T sh[BLOCK];
  const long long chunks = (P.O + COST_ROWS - 1) / COST_ROWS;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    T acc = T(0);
    for (int u = 0; u < COST_ROWS / BLOCK; ++u) {
      const long long o = c * COST_ROWS + u * BLOCK + threadIdx.x;
      if (o >= P.O) continue;
      const long long v = P.vid[o], g = P.iid[o], l = P.pid[o];
      T r[2];
      project<T, false>(P.R + v * 9, P.C + v * 3, P.intr + g * 9,
                        P.X + l * 3, P.xy + o * 2, int(P.model[o]), r,
                        nullptr, nullptr, nullptr);
      acc += cost_term(r, P.weight[o], P.huber);
    }
    const T total = block_sum<BLOCK>(acc, sh);
    if (threadIdx.x == 0) P.part[c] = total;
  }
  grid.sync();
  if (blockIdx.x == 0) {
    T acc = T(0);
    for (long long c = threadIdx.x; c < chunks; c += BLOCK) acc += P.part[c];
    const T total = block_sum<BLOCK>(acc, sh);
    if (threadIdx.x == 0) *P.cost = total;
  }
}

// One cooperative launch of the linearisation (COST false) or of the cost:
// the blocks one wave holds, the cost's at most one a chunk.
template <typename T, bool COST>
int launch(const Args& a, cudaStream_t stream, int device) {
  Params<T> P;
  fill(a, &P);
  carve<T, COST>(a, &P);
  static int cache[64];             // one an instance and card
  int& wave = cache[device & 63];
  const void* kernel = COST ? (const void*)ba_cost_kernel<T>
                            : (const void*)ba_linearize_kernel<T>;
  cudaError_t e = wave_blocks(kernel, BLOCK, device, &wave);
  if (e != cudaSuccess) return int(e);
  long long grid = wave;
  if (COST) {
    const long long chunks = (a.O + COST_ROWS - 1) / COST_ROWS;
    grid = chunks < 1 ? 1 : (chunks < grid ? chunks : grid);
  }
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(kernel, dim3(unsigned(grid)), dim3(BLOCK),
                                  args, 0, stream);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

template <bool COST>
long long workspace(int dtype, const Args* args) {
  Args a = *args;
  a.work = nullptr;
  if (dtype == 0) {
    Params<float> P;
    return (long long)carve<float, COST>(a, &P);
  }
  Params<double> P;
  return (long long)carve<double, COST>(a, &P);
}

template <bool COST>
int call(int dtype, int device, const Args* args, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return dtype == 0 ? launch<float, COST>(*args, s, device)
                      : launch<double, COST>(*args, s, device);
  });
}

}  // namespace bal

// Bytes of the workspace a linearisation with these arguments needs (dtype
// 0: float, 1: double); `work` is not read.
extern "C" long long r3d_ba_linearize_workspace(int dtype,
                                                const bal::Args* args) {
  return bal::workspace<false>(dtype, args);
}

// One linearisation on card `device`, on `stream`: writes r (O, 2), A (O,
// 2, 6), B (O, 2, 3), Ji (O, 2, 9), w (O,), U (V, 6, 6), Vl (L, 3, 3), Ui
// (K, 9, 9), gc (V, 6), gp (L, 3), gi (K, 9). Returns a cudaError_t (0: the
// launch was taken).
extern "C" int r3d_ba_linearize(int dtype, int device, const bal::Args* args,
                                void* stream) {
  return bal::call<false>(dtype, device, args, stream);
}

// Bytes of the workspace a cost read with these arguments needs.
extern "C" long long r3d_ba_cost_workspace(int dtype, const bal::Args* args) {
  return bal::workspace<true>(dtype, args);
}

// One cost read on card `device`, on `stream`: writes the scalar `cost`.
extern "C" int r3d_ba_cost(int dtype, int device, const bal::Args* args,
                           void* stream) {
  return bal::call<true>(dtype, device, args, stream);
}

#endif  // __CUDACC__
