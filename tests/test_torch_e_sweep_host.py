"""The E-sweep kernel's arithmetic, compiled for the host.

``csrc/essential5.cu`` keeps a draw's Nistér solve, the epipolar residual
and the (score, index) order of its winners in ``__host__ __device__``
functions; outside nvcc the file is plain C++ without its kernels. Here g++
builds those functions behind a small C interface and they are held
against the plain sweep on the CPU: the solve draw by draw, and a host
loop that scores and selects in the kernel's (draw, slot) order, a block
of 64 draws at a time (a block with a NaN score offers nothing). The
kernels themselves run only on the card
(``tests/test_torch_e_sweep_kernel.py``).
"""

import ctypes
import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from regard3d_tpu_torch.kernels import _build, geometry, ransac
from tests.test_torch_e_sweep_kernel import _draws, _scenes, _views

torch.set_num_threads(min(2, torch.get_num_threads()))

SHIM = r"""
#include "essential5.cu"

template <typename T>
static void solve_all(const T* x1, const T* x2, int S, const T* start,
                      const float* dk, T* E, bool* ok) {
  for (int s = 0; s < S; ++s) {
    T u1[5], v1[5], u2[5], v2[5], e[e5::SOL][9];
    bool o[e5::SOL];
    for (int m = 0; m < 5; ++m) {
      u1[m] = x1[(s * 5 + m) * 2];
      v1[m] = x1[(s * 5 + m) * 2 + 1];
      u2[m] = x2[(s * 5 + m) * 2];
      v2[m] = x2[(s * 5 + m) * 2 + 1];
    }
    e5::solve5<T>(u1, v1, u2, v2, start, dk, e, o);
    for (int k = 0; k < e5::SOL; ++k) {
      ok[s * e5::SOL + k] = o[k];
      for (int r = 0; r < 9; ++r) E[(s * e5::SOL + k) * 9 + r] = e[k][r];
    }
  }
}

template <typename T>
static void sweep(const T* x1, const T* x2, const bool* mask, const T* me,
                  const long long* idx, int P, int cap, int D,
                  const T* start, const float* dk, T* model, bool* ok) {
  for (int p = 0; p < P; ++p) {
    const T* a = x1 + size_t(p) * cap * 2;
    const T* b = x2 + size_t(p) * cap * 2;
    T bs = T(INFINITY);
    int bi = 0x7fffffff;
    for (int r = 0; r < 9; ++r) model[p * 9 + r] = T(0);
    ok[p] = false;
    for (int d0 = 0; d0 < D; d0 += e5::DRAWS) {     // the kernel's blocks
      T cs = T(INFINITY), cm[9];
      int ci = 0x7fffffff;
      bool co = false, has_nan = false;
      for (int d = d0; d < D && d < d0 + e5::DRAWS; ++d) {
        T u1[5], v1[5], u2[5], v2[5], e[e5::SOL][9];
        bool o[e5::SOL];
        for (int m = 0; m < 5; ++m) {
          const long long k = idx[(size_t(p) * D + d) * 5 + m];
          u1[m] = a[2 * k];
          v1[m] = a[2 * k + 1];
          u2[m] = b[2 * k];
          v2[m] = b[2 * k + 1];
        }
        e5::solve5<T>(u1, v1, u2, v2, start, dk, e, o);
        for (int s = 0; s < e5::SOL; ++s) {
          T score = T(0);
          for (int i = 0; i < cap; ++i) {
            T r = e5::epi_resid(e[s], a[2 * i], a[2 * i + 1], b[2 * i],
                                b[2 * i + 1]);
            r = mask[size_t(p) * cap + i] && o[s] ? r : T(1e30);
            score += e5::truncated(r, me[p]);
          }
          has_nan |= score != score;
          if (e5::before(score, d * e5::SOL + s, cs, ci)) {
            cs = score;
            ci = d * e5::SOL + s;
            co = o[s];
            for (int r = 0; r < 9; ++r) cm[r] = e[s][r];
          }
        }
      }
      if (!has_nan && e5::before(cs, ci, bs, bi)) {
        bs = cs;
        bi = ci;
        ok[p] = co;
        for (int r = 0; r < 9; ++r) model[p * 9 + r] = cm[r];
      }
    }
  }
}

extern "C" void e5h_solve(int dtype, const void* x1, const void* x2, int S,
                          const void* start, const float* dk, void* E,
                          bool* ok) {
  if (dtype == 0)
    solve_all<float>((const float*)x1, (const float*)x2, S,
                     (const float*)start, dk, (float*)E, ok);
  else
    solve_all<double>((const double*)x1, (const double*)x2, S,
                      (const double*)start, dk, (double*)E, ok);
}

extern "C" void e5h_sweep(int dtype, const void* x1, const void* x2,
                          const bool* mask, const void* me,
                          const long long* idx, int P, int cap, int D,
                          const void* start, const float* dk, void* model,
                          bool* ok) {
  if (dtype == 0)
    sweep<float>((const float*)x1, (const float*)x2, mask, (const float*)me,
                 idx, P, cap, D, (const float*)start, dk, (float*)model, ok);
  else
    sweep<double>((const double*)x1, (const double*)x2, mask,
                  (const double*)me, idx, P, cap, D, (const double*)start,
                  dk, (double*)model, ok);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The shim built by g++ against csrc/essential5.cu (its hash in the
    shim, so an edited kernel source is built again)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ compiler to build the kernel source for the host")
    src_cu = os.path.join(_build.CSRC, ransac._E_SOURCE)
    with open(src_cu, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()
    shim = tmp_path_factory.mktemp("e5") / "e5_host.cpp"
    shim.write_text(f"// {ransac._E_SOURCE} {tag}\n{SHIM}")
    lib = ctypes.CDLL(_build.compile_library(
        gxx, ["-O2", "-std=c++17", "-shared", "-fPIC", "-I", _build.CSRC],
        str(shim)))
    lib.e5h_solve.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                              + [ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.e5h_sweep.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                              + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _tables(dtype):
    start = np.ascontiguousarray(geometry._NULL4_START, dtype)
    dk = torch.view_as_real(geometry.dk_start(10, "cpu")).numpy().copy()
    return start, dk


@pytest.mark.parametrize("dtype,tol,share,ok_share", [
    (np.float32, 1e-2, 0.9, 0.95),
    (np.float64, 1e-6, 0.95, 0.99)])
@pytest.mark.parametrize("kind", ["exact", "random"])
def test_host_solve_matches_plain(host, kind, dtype, tol, share, ok_share):
    """The kernel source's solve finds the plain ``fit_essential_5pt``'s
    real candidates, up to sign, and agrees on ``ok`` (the card test's
    tolerances: the solve amplifies rounding in ill-conditioned draws)."""
    rng = np.random.default_rng(7)
    S = 1024
    if kind == "exact":
        pts = [_views(rng, 5) for _ in range(S)]
        x1 = np.stack([a for a, _ in pts]).astype(dtype)
        x2 = np.stack([b for _, b in pts]).astype(dtype)
    else:
        x1, x2 = (rng.normal(size=(2, S, 5, 2)) * 0.5).astype(dtype)
    x1, x2 = np.ascontiguousarray(x1), np.ascontiguousarray(x2)
    start, dk = _tables(dtype)
    E = np.zeros((S, 10, 9), dtype)
    ok = np.zeros((S, 10), bool)
    host.e5h_solve(int(dtype == np.float64), _ptr(x1), _ptr(x2), S,
                   _ptr(start), _ptr(dk), _ptr(E), _ptr(ok))
    Ep, okp = geometry.fit_essential_5pt(torch.from_numpy(x1),
                                         torch.from_numpy(x2))
    Ep, okp = Ep.reshape(S, 10, 9).numpy(), okp.numpy()
    assert okp.sum() > S and (okp == ok).mean() >= ok_share
    d = np.minimum(np.abs(Ep[:, :, None] - E[:, None]).max(-1),
                   np.abs(Ep[:, :, None] + E[:, None]).max(-1))
    d = np.where(ok[:, None, :], d, np.inf).min(-1)
    assert (d[okp] < tol).mean() >= share


@pytest.mark.parametrize("dtype,noise,tol", [(np.float32, 0.0, 1e-3),
                                             (np.float64, 3e-4, 1e-9)])
def test_host_sweep_selects_the_plain_winner(host, dtype, noise, tol):
    """Solve, score and select in the kernel's order: per pair the plain
    sweep's model (up to sign) and ok, with outliers and a ragged number of
    draws. Exact matches in float32 (with noise, float32 rounding reorders
    the all-inlier draws' near ties); noisy ones in float64 (on exact
    matches the good candidates differ by the solve's own error, ~1e-3,
    and tie within float64 rounding)."""
    rng = np.random.default_rng(5)
    P, cap, D = 4, 256, 100
    x1, x2, mask = _scenes(rng, P, cap, noise=noise)
    x1, x2 = (np.ascontiguousarray(a, dtype) for a in (x1, x2))
    me = np.full(P, (4.0 / 1000.0) ** 2, dtype)
    idx = _draws(mask, D, 3)
    start, dk = _tables(dtype)
    model = np.zeros((P, 3, 3), dtype)
    ok = np.zeros(P, bool)
    idx_np = np.ascontiguousarray(idx.numpy())
    host.e5h_sweep(int(dtype == np.float64), _ptr(x1), _ptr(x2),
                   _ptr(np.ascontiguousarray(mask)), _ptr(me), _ptr(idx_np),
                   P, cap, D, _ptr(start), _ptr(dk), _ptr(model), _ptr(ok))
    Mp, okp = ransac.e_sweep_plain(torch.from_numpy(x1),
                                   torch.from_numpy(x2),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(me), idx)
    Mp = Mp.numpy()
    err = np.minimum(np.abs(model - Mp).max((1, 2)),
                     np.abs(model + Mp).max((1, 2)))
    assert ok.tolist() == okp.tolist() and ok.all()
    assert err.max() < tol, err


def _host_sweep(host, x1, x2, mask, me, idx):
    dtype = x1.dtype
    start, dk = _tables(dtype)
    P = len(mask)
    model = np.zeros((P, 3, 3), dtype)
    ok = np.zeros(P, bool)
    idx_np = np.ascontiguousarray(idx.numpy())
    host.e5h_sweep(int(dtype == np.float64), _ptr(x1), _ptr(x2),
                   _ptr(np.ascontiguousarray(mask)), _ptr(me), _ptr(idx_np),
                   P, mask.shape[1], idx_np.shape[1], _ptr(start), _ptr(dk),
                   _ptr(model), _ptr(ok))
    return model, ok


def test_host_sweep_nan_in_a_live_slot(host):
    """A NaN point in a live slot makes every ok candidate's score NaN: the
    plain loop's argmin takes the NaN and its strict '<' rejects the chunk,
    so the pair keeps the loop's start (a zero model, not ok); a NaN in a
    masked slot changes nothing. The kernel's blocks of 64 draws are the
    loop's chunks, with a ragged last one."""
    rng = np.random.default_rng(8)
    P, cap, D = 3, 128, 100
    x1, x2, mask = _scenes(rng, P, cap)
    mask[2, -1] = False
    x1[0, 7, 1] = np.nan                  # live
    x2[2, -1, 0] = np.nan                 # masked
    x1, x2 = (np.ascontiguousarray(a, np.float32) for a in (x1, x2))
    me = np.full(P, (4.0 / 1000.0) ** 2, np.float32)
    idx = _draws(mask, D, 6)
    model, ok = _host_sweep(host, x1, x2, mask, me, idx)
    Mp, okp = ransac.e_sweep_plain(torch.from_numpy(x1),
                                   torch.from_numpy(x2),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(me), idx)
    Mp = Mp.numpy()
    assert ok.tolist() == okp.tolist() == [False, True, True]
    assert (model[0] == 0).all() and (Mp[0] == 0).all()
    err = np.minimum(np.abs(model - Mp).max((1, 2)),
                     np.abs(model + Mp).max((1, 2)))
    assert err[1:].max() < 1e-3, err
