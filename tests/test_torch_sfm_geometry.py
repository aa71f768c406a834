"""Port parity: the SfM geometry (``kernels/geometry.py``), resection
AC-RANSAC (``kernels/ransac.py``) and whole-scene triangulation
(``sfm/triangulate.py``) against the JAX package, on the CPU.

Tolerances, each stated where it is used: closed-form solvers on the same
f32 inputs agree to 1e-5 (XLA and PyTorch order the sums of their 3x3
products differently), except where the system is ill-conditioned (two
nearly parallel rays); the P3P quartic and the DLT nullspace are
ill-conditioned in f32: P3P solutions lie a median 1e-3 apart and are as
accurate against the true pose as the reference's, DLT poses agree to 1e-3
on 95% of samples;
resection with the reference's draws injected gives the same validity, the
same inliers except rows within 4x of the threshold, and R, C within 1e-4;
triangulation gives X within 1e-4 relative and ``ok`` on >= 99.5% of
tracks, each disagreement next to the angle or reprojection threshold.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.core import cameras as jc
from regard3d_tpu.kernels import geometry as jg
from regard3d_tpu.kernels import ransac as jr
from regard3d_tpu.sfm import triangulate as jtri
from regard3d_tpu_torch.core import cameras as tc
from regard3d_tpu_torch.kernels import geometry as tg
from regard3d_tpu_torch.kernels import ransac as tr
from regard3d_tpu_torch.sfm import triangulate as ttri

torch.set_num_threads(min(2, torch.get_num_threads()))

T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: a.numpy() if torch.is_tensor(a) else np.asarray(a)


def rot(rng, n, scale=0.3):
    return np.asarray(jc.exp_so3(jnp.asarray(
        (rng.normal(size=(n, 3)) * scale).astype(np.float32))))


def views_of_points(rng, S, n, noise=0.0):
    """S cameras looking at n points each: (R, C, X, xn normalized)."""
    R = rot(rng, S)
    C = rng.normal(size=(S, 3)).astype(np.float32)
    Xc = np.concatenate([rng.uniform(-2, 2, (S, n, 2)),
                         rng.uniform(4, 9, (S, n, 1))], -1)
    X = (np.einsum("sji,snj->sni", R, Xc) + C[:, None]).astype(np.float32)
    xn = (Xc[..., :2] / Xc[..., 2:]
          + rng.normal(size=(S, n, 2)) * noise).astype(np.float32)
    return R, C, X, xn


def test_decompose_essential_matches_reference(rng):
    """R within 1e-5, t within 1e-5, ngood equal."""
    S, n = 32, 60
    R = rot(rng, S, 0.2)
    t = rng.normal(size=(S, 3)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    X = np.concatenate([rng.uniform(-2, 2, (S, n, 2)),
                        rng.uniform(4, 9, (S, n, 1))], -1)
    X2 = np.einsum("sij,snj->sni", R, X) + t[:, None]
    x1 = (X[..., :2] / X[..., 2:]).astype(np.float32)
    x2 = (X2[..., :2] / X2[..., 2:]).astype(np.float32)
    tx = np.asarray(jc.hat(jnp.asarray(t)))
    E = (tx @ R).astype(np.float32)
    mask = rng.uniform(size=(S, n)) < 0.9
    for m in (None, mask):
        args = (E, x1, x2)
        rj = jax.jit(jg.decompose_essential)(
            *map(jnp.asarray, args), mask=None if m is None else jnp.asarray(m))
        rt = tg.decompose_essential(*map(T, args),
                                    mask=None if m is None else T(m))
        np.testing.assert_allclose(N(rt[0]), N(rj[0]), atol=1e-5)
        np.testing.assert_allclose(N(rt[1]), N(rj[1]), atol=1e-5)
        np.testing.assert_array_equal(N(rt[2]), N(rj[2]))
    np.testing.assert_allclose(N(rt[0]), R, atol=1e-4)


def test_kabsch_triangulate_and_reprojection_match_reference(rng):
    """kabsch, triangulate_2view / _nview and reprojection_err_normalized
    within 1e-5 (relative for X)."""
    R, C, X, xn = views_of_points(rng, 16, 12)
    Pc = np.einsum("sij,snj->sni", R, X - C[:, None]).astype(np.float32)
    for a, b in zip(jax.jit(jg.kabsch)(jnp.asarray(X), jnp.asarray(Pc)),
                    tg.kabsch(T(X), T(Pc))):
        np.testing.assert_allclose(N(b), N(a), atol=1e-5)
    ej = jax.jit(jg.reprojection_err_normalized)(
        *map(jnp.asarray, (R, C, X, xn)))
    et = tg.reprojection_err_normalized(*map(T, (R, C, X, xn)))
    np.testing.assert_allclose(N(et), N(ej), rtol=1e-5, atol=1e-9)
    # two views of the same points
    b = np.concatenate([xn, np.ones_like(xn[..., :1])], -1)
    b = (b / np.linalg.norm(b, axis=-1, keepdims=True)).astype(np.float32)
    R2, C2 = rot(rng, 16, 0.1), (C + rng.normal(size=C.shape)).astype(
        np.float32)
    Xc2 = np.einsum("sij,snj->sni", R2, X - C2[:, None])
    b2 = (Xc2 / np.linalg.norm(Xc2, axis=-1, keepdims=True)).astype(
        np.float32)
    a = N(jax.jit(jg.triangulate_2view)(
        *map(jnp.asarray, (R, C, R2, C2, b, b2))))
    c = N(tg.triangulate_2view(*map(T, (R, C, R2, C2, b, b2))))
    # the 3x3 normal matrix of two nearly parallel rays is ill-conditioned
    # (condition ~1e4 here): f32 rounding moves X by up to 0.5% there
    rel = np.abs(c - a).max(-1) / np.abs(a).max(-1)
    assert (rel < 1e-4).mean() >= 0.95 and rel.max() < 1e-2, rel.max()
    # one point seen by 5 of 6 views
    Rv, Cv = rot(rng, 6), rng.normal(size=(6, 3)).astype(np.float32)
    P = np.array([0.3, -0.2, 7.0], np.float32)
    bv = np.einsum("vij,vj->vi", Rv, P - Cv)
    bv = (bv / np.linalg.norm(bv, axis=1, keepdims=True)).astype(np.float32)
    mv = np.array([1, 1, 0, 1, 1, 1], bool)
    (xj, okj), (xt, okt) = (jg.triangulate_nview(*map(jnp.asarray,
                                                      (Rv, Cv, bv, mv))),
                            tg.triangulate_nview(*map(T, (Rv, Cv, bv, mv))))
    np.testing.assert_allclose(N(xt), N(xj), rtol=1e-5)
    assert bool(okt) == bool(okj)


def test_p3p_grunert_matches_reference(rng):
    """Up to 4 poses a sample: ok agrees on >= 98% of slots (the root's
    realness and sign tests flip with f32 rounding)."""
    R, C, X, xn = views_of_points(rng, 256, 3)
    (Rj, Cj, okj) = (N(a) for a in jax.jit(jg.p3p_grunert)(
        jnp.asarray(X), jnp.asarray(xn)))
    (Rt, Ct, okt) = (N(a) for a in tg.p3p_grunert(T(X), T(xn)))
    assert (okj == okt).mean() >= 0.98
    # Durand-Kerner may hand the same roots out in another slot order (the
    # port builds z^k by products, the reference by powers): match each of
    # the reference's solutions to the nearest one of the port's. The f32
    # quartic plus 3 Newton steps is rounding-bound in both packages: the
    # reference compiled by XLA and run op by op differ at the same level,
    # so the gate is on accuracy against the true pose, not on bits
    d = (np.abs(Rj[:, :, None] - Rt[:, None]).max((-1, -2))
         + np.abs(Cj[:, :, None] - Ct[:, None]).max(-1)
         + np.where(okt[:, None, :], 0.0, 1e9)).min(-1)[okj]
    assert np.median(d) < 1e-3, np.median(d)

    def best(Cs, ok):          # each sample's solution nearest the truth
        return (np.abs(Cs - C[:, None]).max(-1)
                + np.where(ok, 0, 1e9)).min(1)
    bj, bt = best(Cj, okj), best(Ct, okt)
    assert (bt < 1e-2).mean() >= (bj < 1e-2).mean() - 0.02
    for q in (50, 75):
        assert np.percentile(bt, q) <= 1.5 * np.percentile(bj, q) + 1e-4, q


def test_resection_dlt_matches_reference(rng):
    """6+ point DLT (12x12 nullspace by inverse iteration in f32): ok
    equal; R and C within 1e-3 on >= 95% of samples and within 1e-2 on all
    (one sample of 64 here is near-degenerate: both packages land 0.82 off
    the true center and 4e-3 apart)."""
    R, C, X, xn = views_of_points(rng, 64, 10)
    (Rj, Cj, okj) = (N(a) for a in jax.jit(jg.resection_dlt)(
        jnp.asarray(X), jnp.asarray(xn)))
    (Rt, Ct, okt) = (N(a) for a in tg.resection_dlt(T(X), T(xn)))
    np.testing.assert_array_equal(okt, okj)
    err = np.maximum(np.abs(Rt - Rj).max((-1, -2)), np.abs(Ct - Cj).max(-1))
    assert (err < 1e-3).mean() >= 0.95 and err.max() < 1e-2, err.max()
    assert np.median(np.abs(Ct - C).max(-1)) < 1e-2


def test_refine_pose_matches_reference(rng):
    """Gauss-Newton polish from a perturbed pose, one view and a batch:
    R and C within 1e-5 of the reference's."""
    R, C, X, xn = views_of_points(rng, 4, 80, noise=1e-3)
    w = (rng.uniform(size=(4, 80)) < 0.8).astype(np.float32)
    R0 = (np.asarray(jc.exp_so3(jnp.asarray(
        rng.normal(size=(4, 3)).astype(np.float32) * 0.02))) @ R)
    C0 = (C + rng.normal(size=C.shape) * 0.05).astype(np.float32)
    Rb, Cb = tg.refine_pose(*map(T, (R0, C0, X, xn, w)), iters=10)
    refine = jax.jit(lambda *a: jg.refine_pose(*a, iters=10))
    for p in range(4):
        Rj, Cj = refine(*map(jnp.asarray, (R0[p], C0[p], X[p], xn[p],
                                           w[p])))
        Rt, Ct = tg.refine_pose(*map(T, (R0[p], C0[p], X[p], xn[p], w[p])),
                                iters=10)
        np.testing.assert_allclose(N(Rt), N(Rj), atol=1e-5)
        np.testing.assert_allclose(N(Ct), N(Cj), atol=1e-5)
        np.testing.assert_allclose(N(Rb[p]), N(Rt), atol=1e-6)
        np.testing.assert_allclose(N(Cb[p]), N(Ct), atol=1e-6)
    np.testing.assert_allclose(N(Cb), C, atol=1e-2)


# ---------------------------------------------------------------------------
# resection AC-RANSAC with the reference's draws
# ---------------------------------------------------------------------------

ITERS = 128


def resection_group(rng, P=6, cap=256, f=800.0):
    """P views, each with 60..cap correspondences (25% outliers), padded."""
    R, C, X, xn = views_of_points(rng, P, cap, noise=0.3 / f)
    mask = np.zeros((P, cap), bool)
    for p in range(P):
        n = int(rng.integers(60, cap + 1))
        mask[p, :n] = True
        out = rng.uniform(size=cap) < 0.25
        xn[p, out] = rng.uniform(-0.4, 0.4, (int(out.sum()), 2))
    X = np.where(mask[..., None], X, 0).astype(np.float32)
    xn = np.where(mask[..., None], xn, 0).astype(np.float32)
    max_err = np.full((P,), (4.0 / f) ** 2, np.float32)
    return X, xn, mask, max_err


def test_resection_batch_with_reference_draws(rng):
    """Same validity; inliers equal except rows within 4x of the squared
    threshold; R and C within 1e-4."""
    X, xn, mask, max_err = resection_group(rng)
    P = len(mask)
    keys = jax.random.split(jax.random.PRNGKey(3), P)
    rj = jr.acransac_resection_batch(keys, *map(jnp.asarray,
                                                (X, xn, mask, max_err)),
                                     iters=ITERS)
    idx = np.stack([np.asarray(jr._draw_samples(keys[p], jnp.asarray(mask[p]),
                                                ITERS, 3)) for p in range(P)])
    rt = tr.acransac_resection_batch(None, *map(T, (X, xn, mask, max_err)),
                                     iters=ITERS, idx=T(idx))
    np.testing.assert_array_equal(N(rt.valid), N(rj.valid))
    assert N(rt.valid).all()
    np.testing.assert_allclose(N(rt.R), N(rj.R), atol=1e-4)
    np.testing.assert_allclose(N(rt.C), N(rj.C), atol=1e-4)
    r = N(tg.reprojection_err_normalized(T(N(rj.R))[:, None],
                                         T(N(rj.C))[:, None], T(X)[:, None],
                                         T(xn)[:, None]))[:, 0]
    diff = N(rt.inliers) != N(rj.inliers)
    thr = max_err[:, None]
    assert np.all((r[diff] >= thr.repeat(mask.shape[1], 1)[diff] / 4)
                  & (r[diff] <= thr.repeat(mask.shape[1], 1)[diff] * 4))
    assert diff.sum() <= 0.01 * mask.sum()
    # the single-view entry point is the batch of one
    one = tr.acransac_resection(None, T(X[0]), T(xn[0]), T(mask[0]),
                                focal_px=800.0, iters=ITERS, idx=T(idx[0]))
    np.testing.assert_array_equal(N(one.inliers), N(rt.inliers)[0])


def test_resection_port_draws_are_valid_samples(rng):
    """The port's own draws (a generator per view): distinct valid rows,
    and a valid pose on a clean group."""
    X, xn, mask, max_err = resection_group(rng, P=3)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    idx = tr._draw_samples_batch(gens, T(mask), ITERS, 3).numpy()
    for p in range(3):
        assert mask[p][idx[p]].all()
        assert all(len(set(r)) == 3 for r in idx[p].tolist())
    res = tr.acransac_resection_batch(
        [torch.Generator().manual_seed(s) for s in range(3)],
        *map(T, (X, xn, mask, max_err)), iters=ITERS)
    assert N(res.valid).all()


# ---------------------------------------------------------------------------
# whole-scene triangulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tri_scene():
    return make_tri_scene()


def make_tri_scene():
    """8 noisy views of 400 points (a few behind a camera or nearly
    parallel), observations with drops and gross outliers."""
    rng = np.random.default_rng(5)
    V, L = 8, 400
    X = (rng.normal(size=(L, 3)) * [3, 2, 1.2] + [0, 0, 10]).astype(
        np.float32)
    a = np.linspace(-0.4, 0.4, V)
    w = np.stack([np.zeros(V), a, 0.02 * np.arange(V)], -1).astype(np.float32)
    R = np.asarray(jc.exp_so3(jnp.asarray(w)))
    C = np.stack([-10 * np.sin(a), 0.2 * rng.normal(size=V),
                  10 - 10 * np.cos(a)], -1).astype(np.float32)
    intr = np.array([[900, 640, 480, -0.05, 0, 0, 0, 0, 0]], np.float32)
    models = np.array([2], np.int32)
    tid, vid, xy = [], [], []
    for v in range(V):
        uv, d = jc.project(jnp.asarray(R[v]), jnp.asarray(C[v]),
                           jnp.int32(2), jnp.asarray(intr[0]), jnp.asarray(X))
        uv = np.asarray(uv) + rng.normal(size=(L, 2)) * 0.5
        seen = rng.uniform(size=L) < 0.7
        bad = rng.uniform(size=L) < 0.03
        uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
        ids = np.nonzero(seen)[0]
        tid += ids.tolist()
        vid += [v] * len(ids)
        xy.append(uv[ids])
    tid, vid = np.asarray(tid), np.asarray(vid)
    order = np.argsort(tid, kind="stable")
    pose_mask = np.ones(V, bool)
    pose_mask[5] = False
    Rn = np.asarray(jc.exp_so3(jnp.asarray(
        rng.normal(size=(V, 3)).astype(np.float32) * 1e-3))) @ R
    return dict(R=Rn.astype(np.float32), C=C, X=X, intr=intr, models=models,
                tid=tid[order].astype(np.int32),
                vid=vid[order].astype(np.int32),
                xy=np.concatenate(xy)[order].astype(np.float32),
                active=rng.uniform(size=len(tid)) < 0.95,
                pose_mask=pose_mask, T=L)


def test_triangulate_tracks_matches_reference(tri_scene):
    s = tri_scene
    iid = np.zeros(len(s["tid"]), np.int32)
    bj = jc.bearing(jnp.asarray(s["models"][iid]), jnp.asarray(s["intr"][iid]),
                    jnp.asarray(s["xy"]))
    rj = jtri.triangulate_tracks(
        jnp.asarray(s["R"]), jnp.asarray(s["C"]), jnp.asarray(s["pose_mask"]),
        jnp.asarray(s["tid"]), jnp.asarray(s["vid"]),
        jnp.asarray(s["active"]), bj, s["T"], 2.0, 4.0, 900.0)
    bt = tc.bearing(T(s["models"][iid]), T(s["intr"][iid]), T(s["xy"]))
    tid, vid = T(s["tid"]).long(), T(s["vid"]).long()
    rt = ttri.triangulate_tracks(T(s["R"]), T(s["C"]), T(s["pose_mask"]),
                                 tid, vid, T(s["active"]), bt, s["T"], 2.0,
                                 4.0, 900.0)
    okj, okt = N(rj.ok), N(rt.ok)
    np.testing.assert_array_equal(N(rt.nviews), N(rj.nviews))
    assert 0.3 < okj.mean() < 0.95          # the gates cut real tracks here
    assert (okj == okt).mean() >= 0.995
    Xj, Xt = N(rj.X), N(rt.X)
    # a gross outlier at the image border sends the fixed-point
    # undistortion of its bearing to NaN in both packages
    bad = np.isnan(Xj).any(1)
    np.testing.assert_array_equal(np.isnan(Xt).any(1), bad)
    live = (N(rj.nviews) >= 2) & ~bad
    rel = np.abs(Xt - Xj).max(1) / np.maximum(np.abs(Xj).max(1), 1.0)
    assert rel[live].max() < 1e-4, rel[live].max()
    # every disagreement sits next to a threshold: the smallest eigenvalue
    # of A or the worst angular error within 5% of its bound
    for t_ in np.nonzero(okj != okt)[0]:
        rows = (s["tid"] == t_) & s["active"] & s["pose_mask"][s["vid"]]
        d = np.einsum("oji,oj->oi", s["R"][s["vid"][rows]],
                      np.asarray(bj)[rows])
        A = (np.eye(3) * rows.sum() - d.T @ d).astype(np.float64)
        lam = np.linalg.eigvalsh(A)[0]
        need = (1 - math.cos(math.radians(2.0))) * rows.sum() * 0.5
        xc = np.einsum("oij,oj->oi", s["R"][s["vid"][rows]],
                       Xj[t_] - s["C"][s["vid"][rows]])
        bb = np.asarray(bj)[rows]
        err = ((xc[:, :2] / xc[:, 2:] - bb[:, :2] / bb[:, 2:]) ** 2).sum(1)
        near = (abs(lam / need - 1) < 0.05
                or abs(err.max() / (4.0 / 900.0) ** 2 - 1) < 0.05)
        assert near, (t_, lam / need, err.max() / (4.0 / 900.0) ** 2)
    # the reduction table built once gives the same bits as one per call
    table = ttri.track_table(tid, s["T"])
    again = ttri.triangulate_tracks(T(s["R"]), T(s["C"]), T(s["pose_mask"]),
                                    tid, vid, T(s["active"]), bt, s["T"],
                                    2.0, 4.0, 900.0, table=table)
    assert torch.equal(again.X.nan_to_num(7.0), rt.X.nan_to_num(7.0))
    assert torch.equal(again.ok, rt.ok)


def test_reprojection_residuals_px_match_reference(tri_scene):
    s = tri_scene
    iid = np.zeros(len(s["tid"]), np.int32)
    rj = jtri.reprojection_residuals_px(
        *map(jnp.asarray, (s["R"], s["C"], s["intr"], s["models"], iid,
                           s["vid"], s["tid"], s["X"], s["xy"])))
    rt = ttri.reprojection_residuals_px(
        T(s["R"]), T(s["C"]), T(s["intr"]), T(s["models"]).long(),
        T(iid).long(), T(s["vid"]).long(), T(s["tid"]).long(), T(s["X"]),
        T(s["xy"]))
    # rtol 1e-3: a point close to the image plane of a camera amplifies
    # f32 rounding of its depth
    np.testing.assert_allclose(N(rt), N(rj), rtol=1e-3, atol=1e-3)
