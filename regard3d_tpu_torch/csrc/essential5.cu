// The E hypothesis sweep of AC-RANSAC: for every draw of five
// correspondences, Nistér's 5-point solve (up to 10 essential matrices) and
// the truncated score of every candidate over all of the pair's matches;
// per pair, the candidate of least score.
//
// Replaces no Pallas kernel. The JAX package ran this sweep as one
// XLA-compiled lax.scan (regard3d_tpu/kernels/ransac.py:_e_one); the port's
// plain version (regard3d_tpu_torch/kernels/ransac.py:e_sweep_plain) is an
// eager loop over chunks of 64 draws, each with the unrolled solver of
// kernels/geometry.py:fit_essential_5pt, and enqueues about 20k device
// operations a chunk: at 1024 iterations a 55-pair block took ~326k, which
// made compute-matches' filter host-launch-bound (the E sweep was 90% of
// its host time). This kernel is the whole sweep of one acransac_e_batch
// call in one C call (two launches).
//
// What it computes is what the plain sweep computes, in the same precision
// (T = float or double; the Durand-Kerner roots in complex float for both,
// as poly_roots casts to complex64), with the same algorithm and iteration
// counts, statement for statement in the plain version's order:
//   * the 5x9 design matrix with its rows normalised, A^T A;
//   * _nullspace4: A^T A + (1e-6 tr + 1e-30) I, factored once by the
//     unrolled Cholesky (the plain version factors it again for each of its
//     4 x 3 solves: the same arithmetic), 3 iterations of 4 solves and a
//     modified Gram-Schmidt with the max-abs rescale, the finite test and
//     the unit-vector fallback, from the start table the wrapper passes in;
//   * the 10x20 cubic system, Gauss-Jordan with partial pivoting on the 10
//     leading monomials and one refinement pass (lu_solve twice; the second
//     replays the first's pivots and factors, which is the arithmetic of
//     eliminating the same A again);
//   * the degree-10 polynomial, 80 Durand-Kerner steps from the wrapper's
//     start table (Jacobi updates, powers by repeated products as the plain
//     version's cumprod), the 1e-2 realness test, 3 Newton steps in T;
//   * the back-substitution for x and y by the largest of three 2x2
//     determinants, E = x N0 + y N1 + z N2 + N3, normalised, and ok = real,
//     finite, norm > 1e-12;
//   * each candidate's score: the sum over all cap slots of
//     min(r, max_err_sq), r the squared point-to-epipolar-line distance in
//     image 2, r = 1e30 on a masked slot and for a candidate that is not ok
//     (a NaN r, an ok candidate against a NaN point, stays NaN, as
//     torch.minimum keeps it).
// Per pair the candidate of least score wins, ties to the earliest in
// (draw, slot) order: the chunked loop's argmin and strict '<'. A chunk of
// 64 draws that holds a NaN score offers no candidate (argmin takes the
// NaN, '<' rejects it), and a pair whose every chunk is voided keeps the
// loop's start: a zero model, not ok. Rounding differs from the plain
// version's only by summation order and by the fused multiply-adds that
// nvcc contracts.
//
// What bounds it on an H100 SXM: FP32 (or FP64) ALU work, nothing else. A
// solve is about 1.7e5 FLOP, 85% of them the Durand-Kerner steps (80 x 10
// roots x ~180 FLOP); a candidate's score is 24 FLOP a slot. At the
// compute-matches cell's shapes (55 pairs, 1024 draws, cap 1024) that is
// 9.6 GFLOP of solves and 13.8 GFLOP of scoring: 0.35 ms at 67 TFLOP/s.
// The bytes (points, draws) are a few MB. The solve is scalar, dependent,
// register-heavy work with data-dependent pivots: one thread a draw, the
// 10x20 elimination in local memory (L1), the 10 roots' updates unrolled so
// they stay in registers and give the scheduler ten independent chains.
//
// Design: one block of 64 threads solves 64 consecutive draws of one pair
// and keeps their 640 candidates in registers (a thread its own 10); the
// block then streams the pair's points through shared memory in tiles of
// 256 (any cap: shared memory holds one tile, not the pair), each thread
// scoring its 10 candidates against every point of the tile (broadcast
// reads, no bank conflicts). The candidates never leave the block: its
// least (score, index) and that candidate's E go to a small workspace, and
// a second launch of one warp a pair reduces the blocks' partials in a
// fixed order. Both are deterministic (no atomics).
//
// Measured on an H100 80GB HBM3 at 700 W: 4.48 ms at the cell's shapes
// (the solve alone 1.53 ms), 13.35 ms at cap 4096, 2.02 ms at 16 pairs.
// Two launches back to back (the solve writing its candidates to device
// memory, then a scoring kernel of 64, 128 or 256 threads a block) took
// 4.67-4.71, 14.11-14.12 and 2.16-2.24 ms: the scoring kernel still holds
// a thread's 10 candidates in 168 registers, so it gains no occupancy and
// pays the round trip. Both stay 13x above the bound: 255 registers a
// thread leave 8 warps an SM, and the scoring runs at the solve's
// occupancy. A sweep is now ~5 ms of device time in a compute-matches step
// of ~3 s that the host's enqueue of the other filters bounds.

#include <cstdint>

#include <cmath>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define R3D_HD __host__ __device__ __forceinline__
#else
#define R3D_HD inline
#endif

namespace e5 {

constexpr int SOL = 10;      // candidates a draw
constexpr int DRAWS = 64;    // draws (threads) a block
constexpr int TILE = 256;    // points a shared-memory tile

R3D_HD float r_sqrt(float x) { return sqrtf(x); }
R3D_HD double r_sqrt(double x) { return sqrt(x); }
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
// the order of torch.argmax / amax: a NaN above everything, the first wins
template <typename T>
R3D_HD bool gt_nan(T a, T b) { return a > b || (a != a && b == b); }
template <typename T>
R3D_HD T safe_den(T d, T eps) {                       // geometry._safe_den
  return r_abs(d) > eps ? d : (d >= T(0) ? eps : -eps);
}

// c10::complex<float>'s division (numpy's: Smith's scaling)
R3D_HD void cdiv(float a, float b, float c, float d, float& re, float& im) {
  const float ac = fabsf(c), ad = fabsf(d);
  if (ac >= ad) {
    if (ac == 0.0f && ad == 0.0f) {
      re = a / ac;
      im = b / ad;
    } else {
      const float rat = d / c;
      const float scl = 1.0f / (c + d * rat);
      re = (a + b * rat) * scl;
      im = (b - a * rat) * scl;
    }
  } else {
    const float rat = c / d;
    const float scl = 1.0f / (d + c * rat);
    re = (a * rat + b) * scl;
    im = (b * rat - a) * scl;
  }
}

// geometry._mul_ll: linear forms (x, y, z, 1) -> quadratic coefficients in
// _QUAD order; statements in the plain version's (i, j) order
template <typename T>
R3D_HD void mul_ll(const T* a, const T* b, T* o) {
  o[0] = a[0] * b[0];
  o[3] = a[0] * b[1];
  o[4] = a[0] * b[2];
  o[6] = a[0] * b[3];
  o[3] += a[1] * b[0];
  o[1] = a[1] * b[1];
  o[5] = a[1] * b[2];
  o[7] = a[1] * b[3];
  o[4] += a[2] * b[0];
  o[5] += a[2] * b[1];
  o[2] = a[2] * b[2];
  o[8] = a[2] * b[3];
  o[6] += a[3] * b[0];
  o[7] += a[3] * b[1];
  o[8] += a[3] * b[2];
  o[9] = a[3] * b[3];
}

// geometry._mul_ql: quadratic x linear -> cubic coefficients in _MON3 order
template <typename T>
R3D_HD void mul_ql(const T* a, const T* b, T* o) {
  o[0] = a[0] * b[0];
  o[2] = a[0] * b[1];
  o[4] = a[0] * b[2];
  o[5] = a[0] * b[3];
  o[3] = a[1] * b[0];
  o[1] = a[1] * b[1];
  o[6] = a[1] * b[2];
  o[7] = a[1] * b[3];
  o[10] = a[2] * b[0];
  o[13] = a[2] * b[1];
  o[16] = a[2] * b[2];
  o[17] = a[2] * b[3];
  o[2] += a[3] * b[0];
  o[3] += a[3] * b[1];
  o[8] = a[3] * b[2];
  o[9] = a[3] * b[3];
  o[4] += a[4] * b[0];
  o[8] += a[4] * b[1];
  o[10] += a[4] * b[2];
  o[11] = a[4] * b[3];
  o[8] += a[5] * b[0];
  o[6] += a[5] * b[1];
  o[13] += a[5] * b[2];
  o[14] = a[5] * b[3];
  o[5] += a[6] * b[0];
  o[9] += a[6] * b[1];
  o[11] += a[6] * b[2];
  o[12] = a[6] * b[3];
  o[9] += a[7] * b[0];
  o[7] += a[7] * b[1];
  o[14] += a[7] * b[2];
  o[15] = a[7] * b[3];
  o[11] += a[8] * b[0];
  o[14] += a[8] * b[1];
  o[17] += a[8] * b[2];
  o[18] = a[8] * b[3];
  o[12] += a[9] * b[0];
  o[15] += a[9] * b[1];
  o[18] += a[9] * b[2];
  o[19] = a[9] * b[3];
}

// geometry._polymul: ascending coefficients, out[i + j] += a[i] b[j]
template <typename T, int LA, int LB>
R3D_HD void polymul(const T* a, const T* b, T* o) {
#pragma unroll
  for (int k = 0; k < LA + LB - 1; ++k) o[k] = T(0);
#pragma unroll
  for (int i = 0; i < LA; ++i)
#pragma unroll
    for (int j = 0; j < LB; ++j) o[i + j] += a[i] * b[j];
}

// sum p[k] z^k, the powers by repeated products
template <typename T, int L>
R3D_HD T peval(const T* p, T z) {
  T s = p[0], zk = T(1);
#pragma unroll
  for (int k = 1; k < L; ++k) {
    zk = zk * z;
    s += p[k] * zk;
  }
  return s;
}

// geometry._nullspace4 after the design matrix: the 4 eigenvectors of the
// smallest eigenvalues of the PSD 9x9 M (A^T A), as N[9][4]
template <typename T>
R3D_HD void nullspace4(T M[9][9], const T* start, T N[9][4]) {
  T tr = M[0][0];
#pragma unroll
  for (int i = 1; i < 9; ++i) tr += M[i][i];
  const T eps = T(1e-6) * tr + T(1e-30);
#pragma unroll
  for (int i = 0; i < 9; ++i) M[i][i] += eps;
  // chol_solve's factor: column j from cj = M[:, j] - L[:, :j] L[j, :j]
  T L[9][9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    T cj[9];
#pragma unroll
    for (int r = j; r < 9; ++r) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < j; ++i) acc += L[j][i] * L[r][i];
      cj[r] = M[r][j] - acc;
    }
    const T d = r_sqrt(clamp_min(cj[j], T(1e-30)));
#pragma unroll
    for (int r = j; r < 9; ++r) L[r][j] = cj[r] / d;
  }
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) N[i][c] = start[i * 4 + c];
  for (int it = 0; it < 3; ++it) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      T y[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < i; ++k) acc += L[i][k] * y[k];
        y[i] = (N[i][c] - acc) / L[i][i];
      }
#pragma unroll
      for (int i = 8; i >= 0; --i) {
        T acc = T(0);
#pragma unroll
        for (int k = i + 1; k < 9; ++k) acc += L[k][i] * N[k][c];
        N[i][c] = (y[i] - acc) / L[i][i];
      }
    }
    // orthonormalize: modified Gram-Schmidt, column by column
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int u = 0; u < c; ++u) {
        T dot = T(0);
#pragma unroll
        for (int i = 0; i < 9; ++i) dot += N[i][c] * N[i][u];
#pragma unroll
        for (int i = 0; i < 9; ++i) N[i][c] = N[i][c] - dot * N[i][u];
      }
      T m = r_abs(N[0][c]);
#pragma unroll
      for (int i = 1; i < 9; ++i)
        if (gt_nan(r_abs(N[i][c]), m)) m = r_abs(N[i][c]);
      m = clamp_min(m, T(1e-30));
      T n2 = T(0);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        T v = N[i][c] / m;
        v = r_finite(v) ? v : T(0);
        N[i][c] = v;
        n2 += v * v;
      }
      const T n = r_sqrt(n2);
      const T den = clamp_min(n, T(1e-30));
#pragma unroll
      for (int i = 0; i < 9; ++i)
        N[i][c] = n > T(1e-12) ? N[i][c] / den : T(i == c ? 1 : 0);
    }
  }
}

// geometry.lu_solve on [A | B] (10 x 20), then once more on the residual
// B - A X with the first pass's pivots and factors; C = X + X'
template <typename T>
R3D_HD void gauss_jordan_refined(T W[10][20], T C[10][10]) {
  T A0[10][10], B0[10][10], fac[10][10];
  int piv[10];
  for (int r = 0; r < 10; ++r)
    for (int c = 0; c < 10; ++c) {
      A0[r][c] = W[r][c];
      B0[r][c] = W[r][10 + c];
    }
  for (int k = 0; k < 10; ++k) {
    int p = k;
    T best = r_abs(W[k][k]);
    for (int r = k + 1; r < 10; ++r) {
      const T v = r_abs(W[r][k]);
      if (gt_nan(v, best)) {
        best = v;
        p = r;
      }
    }
    piv[k] = p;
    if (p != k)
      for (int c = 0; c < 20; ++c) {
        const T t = W[k][c];
        W[k][c] = W[p][c];
        W[p][c] = t;
      }
    const T den = safe_den(W[k][k], T(1e-20));
    for (int r = 0; r < 10; ++r) {
      if (r == k) continue;
      const T f = W[r][k] / den;
      fac[k][r] = f;
      for (int c = 0; c < 20; ++c) W[r][c] = W[r][c] - f * W[k][c];
    }
  }
  T diag[10];
  for (int r = 0; r < 10; ++r) {
    diag[r] = safe_den(W[r][r], T(1e-20));
    for (int c = 0; c < 10; ++c) C[r][c] = W[r][10 + c] / diag[r];
  }
  // the residual B - A C, eliminated with the same pivots and factors
  T R[10][10];
  for (int r = 0; r < 10; ++r)
    for (int c = 0; c < 10; ++c) {
      T acc = T(0);
      for (int j = 0; j < 10; ++j) acc += A0[r][j] * C[j][c];
      R[r][c] = B0[r][c] - acc;
    }
  for (int k = 0; k < 10; ++k) {
    const int p = piv[k];
    if (p != k)
      for (int c = 0; c < 10; ++c) {
        const T t = R[k][c];
        R[k][c] = R[p][c];
        R[p][c] = t;
      }
    for (int r = 0; r < 10; ++r) {
      if (r == k) continue;
      const T f = fac[k][r];
      for (int c = 0; c < 10; ++c) R[r][c] = R[r][c] - f * R[k][c];
    }
  }
  for (int r = 0; r < 10; ++r)
    for (int c = 0; c < 10; ++c) C[r][c] = C[r][c] + R[r][c] / diag[r];
}

// row_polys of fit_essential_5pt: <hi> - z <lo> as (alpha deg 3, beta deg
// 3, gamma deg 4), ascending in z
template <typename T>
R3D_HD void row_polys(const T* hi, const T* lo, T* a, T* b, T* g) {
  a[0] = hi[2];
  a[1] = hi[1] - lo[2];
  a[2] = hi[0] - lo[1];
  a[3] = T(0) - lo[0];
  b[0] = hi[5];
  b[1] = hi[4] - lo[5];
  b[2] = hi[3] - lo[4];
  b[3] = T(0) - lo[3];
  g[0] = hi[9];
  g[1] = hi[8] - lo[9];
  g[2] = hi[7] - lo[8];
  g[3] = hi[6] - lo[7];
  g[4] = T(0) - lo[6];
}

// A^T A of the 5 x 9 design matrix with its rows normalised
template <typename T>
R3D_HD void design_normal(const T* u1, const T* v1, const T* u2,
                          const T* v2, T M[9][9]) {
  T A[5][9];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const T row[9] = {u2[m] * u1[m], u2[m] * v1[m], u2[m],
                      v2[m] * u1[m], v2[m] * v1[m], v2[m],
                      u1[m],         v1[m],         T(1)};
    T n2 = T(0);
#pragma unroll
    for (int i = 0; i < 9; ++i) n2 += row[i] * row[i];
    const T den = clamp_min(r_sqrt(n2), T(1e-12));
#pragma unroll
    for (int i = 0; i < 9; ++i) A[m][i] = row[i] / den;
  }
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      T s = T(0);
#pragma unroll
      for (int m = 0; m < 5; ++m) s += A[m][i] * A[m][j];
      M[i][j] = s;
    }
}

// the 10 x 20 cubic constraints on E = x N0 + y N1 + z N2 + N3 (the linear
// form of entry r is N[r]): det(E), then 2 E E^T E - tr(E E^T) E entry by
// entry
template <typename T>
R3D_HD void cubic_system(const T N[9][4], T W[10][20]) {
  T q[10], c[20];
  // det3: + (00 11 22) + (01 12 20) + (02 10 21) - (02 11 20)
  //       - (00 12 21) - (01 10 22)
  const int tri[6][3] = {{0, 4, 8}, {1, 5, 6}, {2, 3, 7},
                         {2, 4, 6}, {0, 5, 7}, {1, 3, 8}};
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    mul_ll(N[tri[t][0]], N[tri[t][1]], q);
    mul_ql(q, N[tri[t][2]], c);
#pragma unroll
    for (int k = 0; k < 20; ++k)
      W[0][k] = t == 0 ? c[k] : (t < 3 ? W[0][k] + c[k] : W[0][k] - c[k]);
  }
  T EEt[3][3][10];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        mul_ll(N[3 * i + k], N[3 * j + k], q);
#pragma unroll
        for (int m = 0; m < 10; ++m)
          EEt[i][j][m] = k == 0 ? q[m] : EEt[i][j][m] + q[m];
      }
  T tr[10];
#pragma unroll
  for (int m = 0; m < 10; ++m)
    tr[m] = EEt[0][0][m] + EEt[1][1][m] + EEt[2][2][m];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s[20];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        mul_ql(EEt[i][k], N[3 * k + j], c);
#pragma unroll
        for (int m = 0; m < 20; ++m) s[m] = k == 0 ? c[m] : s[m] + c[m];
      }
      mul_ql(tr, N[3 * i + j], c);
#pragma unroll
      for (int m = 0; m < 20; ++m) W[1 + 3 * i + j][m] = T(2) * s[m] - c[m];
    }
}

// the degree-10 polynomial in z from the eliminated rows 4..9 of C, and
// the three row polynomials (alpha, beta, gamma) of each pair of rows
template <typename T>
R3D_HD void resultant(const T C[10][10], T a[3][4], T b[3][4], T g[3][5],
                      T n10[11]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    row_polys(C[4 + 2 * r], C[5 + 2 * r], a[r], b[r], g[r]);
  T m1[8], m2[8], m3[7], t0[8], t1[8], p0[11], p1[11], p2[11];
  polymul<T, 4, 5>(b[1], g[2], t0);
  polymul<T, 4, 5>(b[2], g[1], t1);
#pragma unroll
  for (int k = 0; k < 8; ++k) m1[k] = t0[k] - t1[k];
  polymul<T, 4, 5>(a[1], g[2], t0);
  polymul<T, 4, 5>(a[2], g[1], t1);
#pragma unroll
  for (int k = 0; k < 8; ++k) m2[k] = t0[k] - t1[k];
  polymul<T, 4, 4>(a[1], b[2], t0);
  polymul<T, 4, 4>(a[2], b[1], t1);
#pragma unroll
  for (int k = 0; k < 7; ++k) m3[k] = t0[k] - t1[k];
  polymul<T, 4, 8>(a[0], m1, p0);
  polymul<T, 4, 8>(b[0], m2, p1);
  polymul<T, 5, 7>(g[0], m3, p2);
#pragma unroll
  for (int k = 0; k < 11; ++k) n10[k] = p0[k] - p1[k] + p2[k];
}

// geometry.poly_roots(n10, 80) in complex float: monic, 80 Durand-Kerner
// steps (every root from the previous step's roots) from dk[k] * bound
template <typename T>
R3D_HD void dk_roots(const T n10[11], const float* dk, float zr[SOL],
                     float zi[SOL]) {
  float cr[11];
  float lead = float(n10[10]);
  lead = fabsf(lead) > 1e-25f ? lead : 1e-25f;
  float bound = 0.0f;
#pragma unroll
  for (int k = 0; k < 11; ++k) {
    float im;
    cdiv(float(n10[k]), 0.0f, lead, 0.0f, cr[k], im);
    if (k < 10 && (k == 0 || gt_nan(fabsf(cr[k]), bound)))
      bound = fabsf(cr[k]);
  }
  bound = 1.0f + bound;
#pragma unroll
  for (int k = 0; k < SOL; ++k) {
    zr[k] = dk[2 * k] * bound;
    zi[k] = dk[2 * k + 1] * bound;
  }
  for (int it = 0; it < 80; ++it) {
    float nr[SOL], ni[SOL];
#pragma unroll
    for (int i = 0; i < SOL; ++i) {
      float pr = cr[0], pi = 0.0f, wr = zr[i], wi = zi[i];
#pragma unroll
      for (int k = 1; k < 11; ++k) {
        if (k > 1) {
          const float t = wr * zr[i] - wi * zi[i];
          wi = wr * zi[i] + wi * zr[i];
          wr = t;
        }
        pr += cr[k] * wr;
        pi += cr[k] * wi;
      }
      float dr = 1.0f, di = 0.0f;
#pragma unroll
      for (int j = 0; j < SOL; ++j) {
        if (j == i) continue;
        const float er = zr[i] - zr[j], ei = zi[i] - zi[j];
        const float t = dr * er - di * ei;
        di = dr * ei + di * er;
        dr = t;
      }
      if (!(hypotf(dr, di) > 1e-30f)) {
        dr = 1e-30f;
        di = 0.0f;
      }
      float qr, qi;
      cdiv(pr, pi, dr, di, qr, qi);
      nr[i] = zr[i] - qr;
      ni[i] = zi[i] - qi;
    }
#pragma unroll
    for (int i = 0; i < SOL; ++i) {
      zr[i] = nr[i];
      zi[i] = ni[i];
    }
  }
}

// from the roots: the realness test, 3 Newton steps in T, x and y by the
// largest 2x2 determinant, E normalised and its ok flag
template <typename T>
R3D_HD void candidates(const T n10[11], const T a[3][4], const T b[3][4],
                       const T g[3][5], const T N[9][4], const float zr[SOL],
                       const float zi[SOL], T E[SOL][9], bool ok[SOL]) {
  T dcoef[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) dcoef[k] = n10[k + 1] * T(k + 1);
#pragma unroll
  for (int s = 0; s < SOL; ++s) {
    const bool real = fabsf(zi[s]) < 1e-2f * (1.0f + fabsf(zr[s]));
    T z = T(zr[s]);
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const T pz = peval<T, 11>(n10, z);
      const T dz = safe_den(peval<T, 10>(dcoef, z), T(1e-25));
      z = z - pz / dz;
    }
    T A[3], B[3], G[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      A[r] = peval<T, 4>(a[r], z);
      B[r] = peval<T, 4>(b[r], z);
      G[r] = peval<T, 5>(g[r], z);
    }
    const T dets[3] = {A[0] * B[1] - A[1] * B[0], A[0] * B[2] - A[2] * B[0],
                       A[1] * B[2] - A[2] * B[1]};
    const T xs[3] = {-G[0] * B[1] + G[1] * B[0], -G[0] * B[2] + G[2] * B[0],
                     -G[1] * B[2] + G[2] * B[1]};
    const T ys[3] = {-A[0] * G[1] + A[1] * G[0], -A[0] * G[2] + A[2] * G[0],
                     -A[1] * G[2] + A[2] * G[1]};
    int pick = 0;
    if (gt_nan(r_abs(dets[1]), r_abs(dets[pick]))) pick = 1;
    if (gt_nan(r_abs(dets[2]), r_abs(dets[pick]))) pick = 2;
    const T d = safe_den(dets[pick], T(1e-20));
    const T xv = xs[pick] / d, yv = ys[pick] / d;
    T n2 = T(0);
    bool finite = true;
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      const T e = xv * N[r][0] + yv * N[r][1] + z * N[r][2] + N[r][3];
      E[s][r] = e;
      n2 += e * e;
      finite = finite && r_finite(e);
    }
    const T nrm = r_sqrt(n2);
    ok[s] = real && nrm > T(1e-12) && finite;
    const T den = clamp_min(nrm, T(1e-12));
#pragma unroll
    for (int r = 0; r < 9; ++r) E[s][r] = E[s][r] / den;
  }
}

// fit_essential_5pt for one draw: E[s] (row-major 3x3) and ok[s] for the
// 10 candidate slots. start: _NULL4_START (9 x 4, row-major); dk: the
// Durand-Kerner start (0.4 + 0.9i)^(k + 1), k < 10, as (re, im) pairs.
template <typename T>
R3D_HD void solve5(const T* u1, const T* v1, const T* u2, const T* v2,
                   const T* start, const float* dk, T E[SOL][9],
                   bool ok[SOL]) {
  T N[9][4], n10[11], a[3][4], b[3][4], g[3][5];
  {
    T M[9][9];
    design_normal(u1, v1, u2, v2, M);
    nullspace4(M, start, N);
  }
  {
    T W[10][20], C[10][10];
    cubic_system(N, W);
    gauss_jordan_refined(W, C);
    resultant(C, a, b, g, n10);
  }
  float zr[SOL], zi[SOL];
  dk_roots(n10, dk, zr, zi);
  candidates(n10, a, b, g, N, zr, zi, E, ok);
}

// epipolar_dist_f: the squared distance of (u2, v2) to the line E (u1, v1, 1)
template <typename T>
R3D_HD T epi_resid(const T* e, T u1, T v1, T u2, T v2) {
  const T l0 = e[0] * u1 + e[1] * v1 + e[2];
  const T l1 = e[3] * u1 + e[4] * v1 + e[5];
  const T l2 = e[6] * u1 + e[7] * v1 + e[8];
  const T num = u2 * l0 + v2 * l1 + l2;
  return num * num / clamp_min(l0 * l0 + l1 * l1, T(1e-12));
}

// torch.minimum(r, max_err_sq): a NaN residual stays NaN
template <typename T>
R3D_HD T truncated(T r, T me) { return r >= me ? me : r; }

// (score, index) pairs: the lower score wins, a tie goes to the lower index
template <typename T>
R3D_HD bool before(T s, int i, T bs, int bi) {
  return s < bs || (s == bs && i < bi);
}

}  // namespace e5

#ifdef __CUDACC__

namespace e5 {

constexpr int NO_INDEX = 0x7fffffff;

template <typename T>
struct Work {                 // the per-block partials, carved from one buffer
  T* score;                   // (P, blocks)
  T* model;                   // (P, blocks, 9)
  int* index;                 // (P, blocks): draw * 10 + slot
  unsigned char* ok;          // (P, blocks)
};

template <typename T>
__host__ __device__ size_t work_bytes(int P, int blocks) {
  const size_t n = size_t(P) * blocks;
  return n * sizeof(T) * 10 + n * sizeof(int) + n;
}

template <typename T>
__host__ __device__ Work<T> carve(void* base, int P, int blocks) {
  const size_t n = size_t(P) * blocks;
  Work<T> w;
  w.score = static_cast<T*>(base);
  w.model = w.score + n;
  w.index = reinterpret_cast<int*>(w.model + n * 9);
  w.ok = reinterpret_cast<unsigned char*>(w.index + n);
  return w;
}

// block (blockIdx.x, pair blockIdx.y): draws blockIdx.x * DRAWS + thread
template <typename T>
__global__ void __launch_bounds__(DRAWS)
e_sweep_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
               const bool* __restrict__ mask, const T* __restrict__ max_err,
               const long long* __restrict__ idx, int cap, int iters,
               const T* __restrict__ start, const float* __restrict__ dk,
               Work<T> work) {
  __shared__ T s_start[36];
  __shared__ float s_dk[2 * SOL];
  __shared__ T s_pts[TILE][4];
  __shared__ bool s_valid[TILE];
  __shared__ T s_bs[DRAWS / 32];
  __shared__ int s_bi[DRAWS / 32];

  const int tid = threadIdx.x, p = blockIdx.y;
  const int draw = blockIdx.x * DRAWS + tid;
  const bool live = draw < iters;
  if (tid < 36) s_start[tid] = start[tid];
  if (tid < 2 * SOL) s_dk[tid] = dk[tid];
  __syncthreads();

  const T* px1 = x1 + size_t(p) * cap * 2;
  const T* px2 = x2 + size_t(p) * cap * 2;
  T E[SOL][9];
  bool ok[SOL];
  if (live) {
    T u1[5], v1[5], u2[5], v2[5];
    const long long* id = idx + (size_t(p) * iters + draw) * 5;
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      long long k = id[m];          // the caller's indices lie in [0, cap);
      k = k < 0 ? 0 : (k >= cap ? cap - 1 : k);   // none is read outside
      u1[m] = px1[2 * k];
      v1[m] = px1[2 * k + 1];
      u2[m] = px2[2 * k];
      v2[m] = px2[2 * k + 1];
    }
    solve5<T>(u1, v1, u2, v2, s_start, s_dk, E, ok);
  } else {
#pragma unroll
    for (int s = 0; s < SOL; ++s) {
      ok[s] = false;
#pragma unroll
      for (int r = 0; r < 9; ++r) E[s][r] = T(0);
    }
  }

  const T me = max_err[p];
  const T big = T(1e30);
  T score[SOL];
#pragma unroll
  for (int s = 0; s < SOL; ++s) score[s] = T(0);
  const bool* pm = mask + size_t(p) * cap;
  for (int t0 = 0; t0 < cap; t0 += TILE) {
    const int n = min(TILE, cap - t0);
    for (int i = tid; i < n; i += DRAWS) {
      s_pts[i][0] = px1[2 * (t0 + i)];
      s_pts[i][1] = px1[2 * (t0 + i) + 1];
      s_pts[i][2] = px2[2 * (t0 + i)];
      s_pts[i][3] = px2[2 * (t0 + i) + 1];
      s_valid[i] = pm[t0 + i];
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < n; ++i) {
        const T a = s_pts[i][0], b = s_pts[i][1];
        const T c = s_pts[i][2], d = s_pts[i][3];
        const bool v = s_valid[i];
#pragma unroll
        for (int s = 0; s < SOL; ++s) {
          T r = epi_resid(E[s], a, b, c, d);
          r = v && ok[s] ? r : big;
          score[s] += truncated(r, me);
        }
      }
    }
    __syncthreads();
  }

  // a NaN score (an ok candidate against a NaN point) voids the block's
  // draws, as the chunked loop's argmin takes the NaN and its strict '<'
  // then rejects the whole chunk
  bool has_nan = false;
#pragma unroll
  for (int s = 0; s < SOL; ++s) has_nan |= score[s] != score[s];
  const bool void_block = __syncthreads_or(live && has_nan);
  // the thread's best slot, then the block's best (score, index)
  T bs = score[0];
  int slot = 0;
#pragma unroll
  for (int s = 1; s < SOL; ++s)
    if (score[s] < bs) {
      bs = score[s];
      slot = s;
    }
  int bi = live && !void_block ? draw * SOL + slot : NO_INDEX;
  if (bi == NO_INDEX) bs = T(INFINITY);
  const int my_i = bi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (before(os, oi, bs, bi)) {
      bs = os;
      bi = oi;
    }
  }
  if ((tid & 31) == 0) {
    s_bs[tid >> 5] = bs;
    s_bi[tid >> 5] = bi;
  }
  __syncthreads();
  bs = s_bs[0];
  bi = s_bi[0];
#pragma unroll
  for (int w = 1; w < DRAWS / 32; ++w)
    if (before(s_bs[w], s_bi[w], bs, bi)) {
      bs = s_bs[w];
      bi = s_bi[w];
    }
  const size_t o = size_t(p) * gridDim.x + blockIdx.x;
  if (bi == NO_INDEX) {             // no live draw, or a voided block
    if (tid == 0) {
      work.score[o] = bs;
      work.index[o] = bi;
    }
  } else if (my_i == bi) {          // the one thread that holds the winner
    work.score[o] = bs;
    work.index[o] = bi;
#pragma unroll
    for (int s = 0; s < SOL; ++s)
      if (s == slot) {
        work.ok[o] = ok[s];
#pragma unroll
        for (int r = 0; r < 9; ++r) work.model[o * 9 + r] = E[s][r];
      }
  }
}

// the solve alone (fit_essential_5pt on the card, for tests and the
// smoke's candidate errors): sample s of x1, x2 (S, 5, 2) -> E (S, 10, 9),
// ok (S, 10)
template <typename T>
__global__ void __launch_bounds__(DRAWS)
e_solve_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int S,
               const T* __restrict__ start, const float* __restrict__ dk,
               T* __restrict__ E_out, bool* __restrict__ ok_out) {
  __shared__ T s_start[36];
  __shared__ float s_dk[2 * SOL];
  const int tid = threadIdx.x, s = blockIdx.x * DRAWS + tid;
  if (tid < 36) s_start[tid] = start[tid];
  if (tid < 2 * SOL) s_dk[tid] = dk[tid];
  __syncthreads();
  if (s >= S) return;
  T u1[5], v1[5], u2[5], v2[5], E[SOL][9];
  bool ok[SOL];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    u1[m] = x1[(size_t(s) * 5 + m) * 2];
    v1[m] = x1[(size_t(s) * 5 + m) * 2 + 1];
    u2[m] = x2[(size_t(s) * 5 + m) * 2];
    v2[m] = x2[(size_t(s) * 5 + m) * 2 + 1];
  }
  solve5<T>(u1, v1, u2, v2, s_start, s_dk, E, ok);
#pragma unroll
  for (int k = 0; k < SOL; ++k) {
    ok_out[size_t(s) * SOL + k] = ok[k];
#pragma unroll
    for (int r = 0; r < 9; ++r) E_out[(size_t(s) * SOL + k) * 9 + r] = E[k][r];
  }
}

// one warp a pair: the least of its blocks' partials -> model (P, 9), ok
template <typename T>
__global__ void __launch_bounds__(32)
e_select_kernel(Work<T> work, int blocks, T* __restrict__ model,
                bool* __restrict__ ok) {
  const int p = blockIdx.x, lane = threadIdx.x;
  T bs = T(INFINITY);
  int bi = NO_INDEX, bb = -1;
  for (int b = lane; b < blocks; b += 32) {
    const size_t o = size_t(p) * blocks + b;
    if (before(work.score[o], work.index[o], bs, bi)) {
      bs = work.score[o];
      bi = work.index[o];
      bb = b;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    const int ob = __shfl_down_sync(0xffffffffu, bb, off);
    if (before(os, oi, bs, bi)) {
      bs = os;
      bi = oi;
      bb = ob;
    }
  }
  if (lane == 0) {                  // every block voided: the plain loop's
    const size_t o = size_t(p) * blocks + bb;         // start, 0 and not ok
    for (int r = 0; r < 9; ++r)
      model[size_t(p) * 9 + r] = bb < 0 ? T(0) : work.model[o * 9 + r];
    ok[p] = bb >= 0 && work.ok[o] != 0;
  }
}

template <typename T>
int launch(const void* x1, const void* x2, const void* mask,
           const void* max_err, const void* idx, int P, int cap, int iters,
           const void* start, const void* dk, void* work, void* model,
           void* ok, cudaStream_t stream) {
  const int blocks = (iters + DRAWS - 1) / DRAWS;
  Work<T> w = carve<T>(work, P, blocks);
  e_sweep_kernel<T><<<dim3(blocks, P), DRAWS, 0, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const bool*>(mask), static_cast<const T*>(max_err),
      static_cast<const long long*>(idx), cap, iters,
      static_cast<const T*>(start), static_cast<const float*>(dk), w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  e_select_kernel<T><<<P, 32, 0, stream>>>(w, blocks, static_cast<T*>(model),
                                           static_cast<bool*>(ok));
  return int(cudaGetLastError());
}

template <typename T>
int launch_solve(const void* x1, const void* x2, int S, const void* start,
                 const void* dk, void* E, void* ok, cudaStream_t stream) {
  e_solve_kernel<T><<<(S + DRAWS - 1) / DRAWS, DRAWS, 0, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), S,
      static_cast<const T*>(start), static_cast<const float*>(dk),
      static_cast<T*>(E), static_cast<bool*>(ok));
  return int(cudaGetLastError());
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

}  // namespace e5

// Bytes of the workspace a call of P pairs and `iters` draws needs
// (dtype 0: float, 1: double).
extern "C" long long r3d_e_sweep_workspace(int dtype, int P, int iters) {
  const int blocks = (iters + e5::DRAWS - 1) / e5::DRAWS;
  return dtype == 0 ? (long long)e5::work_bytes<float>(P, blocks)
                    : (long long)e5::work_bytes<double>(P, blocks);
}

// The sweep of one acransac_e_batch call on card `device`, on `stream`:
// x1, x2 (P, cap, 2), mask (P, cap) bool, max_err (P,), idx (P, iters, 5)
// int64, start (9, 4), dk (10, 2) float, all contiguous on the card;
// writes model (P, 9) and ok (P,) bool. Returns a cudaError_t (0: both
// launches were taken).
extern "C" int r3d_e_sweep(int dtype, int device, const void* x1,
                           const void* x2, const void* mask,
                           const void* max_err, const void* idx, int P,
                           int cap, int iters, const void* start,
                           const void* dk, void* work, void* model, void* ok,
                           void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return e5::on_device(device, [&] {
    return dtype == 0
               ? e5::launch<float>(x1, x2, mask, max_err, idx, P, cap, iters,
                                   start, dk, work, model, ok, s)
               : e5::launch<double>(x1, x2, mask, max_err, idx, P, cap,
                                    iters, start, dk, work, model, ok, s);
  });
}

// The solve alone on card `device`: x1, x2 (S, 5, 2), start, dk as above;
// writes E (S, 10, 9) and ok (S, 10) bool.
extern "C" int r3d_e_solve(int dtype, int device, const void* x1,
                           const void* x2, int S, const void* start,
                           const void* dk, void* E, void* ok, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return e5::on_device(device, [&] {
    return dtype == 0
               ? e5::launch_solve<float>(x1, x2, S, start, dk, E, ok, s)
               : e5::launch_solve<double>(x1, x2, S, start, dk, E, ok, s);
  });
}

#endif  // __CUDACC__
