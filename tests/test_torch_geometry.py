"""Port parity: ``regard3d_tpu_torch.kernels.geometry`` (the F/E/H subset) and
the a-contrario threshold of ``kernels.ransac`` against the JAX package.

Batches of random well-posed problems are made with numpy from a seed and
handed to both packages as float32 arrays. The JAX side runs jitted on the
CPU at "highest" matmul precision (tests/conftest.py), the port on CPU
tensors. Tolerances are f32 ones, stated per check: both sides run the same
unrolled algorithms, so they differ only by summation order and by the
libm of each framework (a few ulps), amplified by the conditioning of each
problem.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.kernels import geometry as jg
from regard3d_tpu.kernels import ransac as jr
from regard3d_tpu_torch.kernels import geometry as tg
from regard3d_tpu_torch.kernels import ransac as tr

# several pytest workers share the host: a small intra-op pool per worker
# keeps torch from oversubscribing the cores
torch.set_num_threads(min(2, torch.get_num_threads()))


def _t(a):
    return torch.from_numpy(np.array(a))      # a writable copy


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_up_to_sign(a, b):
    """Flip each of b's leading-batch items to a's sign (models are defined
    up to sign; both are unit-norm or h22-normalised)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    axes = tuple(range(1, a.ndim))
    s = np.sign(np.sum(a * b, axis=axes, keepdims=True))
    return a, b * np.where(s == 0, 1.0, s)


def rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def two_view(rng, n, noise_px=0.0, f=300.0, c=128.0, planar=False):
    """n correspondences of a random two-view scene: pixel coords (f, c)
    and normalized coords. Returns (uv1, uv2, xn1, xn2, E)."""
    R = rodrigues(rng.normal(size=3) * 0.15)
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    if planar:
        X = np.concatenate([rng.uniform(-3, 3, (n, 2)), np.full((n, 1), 7.0)],
                           1)
    else:
        X = rng.normal(size=(n, 3)) * [2.5, 2.0, 1.5] + [0, 0, 7]
    xn1 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    xn2 = Xc[:, :2] / Xc[:, 2:]
    uv1 = xn1 * f + c + rng.normal(size=(n, 2)) * noise_px
    uv2 = xn2 * f + c + rng.normal(size=(n, 2)) * noise_px
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    return (uv1.astype(np.float32), uv2.astype(np.float32),
            ((uv1 - c) / f).astype(np.float32),
            ((uv2 - c) / f).astype(np.float32), E / np.linalg.norm(E))


def batch(rng, S, n, **kw):
    out = [two_view(rng, n, **kw) for _ in range(S)]
    return [np.stack([o[k] for o in out]) for k in range(5)]


def design_gap(x1, x2, kind):
    """Relative gap between the two smallest eigenvalues of the normalized
    design matrix's A^T A, in float64: a sample is well posed when its
    solution (the smallest eigenvector) is well separated."""
    def norm(x):
        x = x.astype(np.float64)
        c = x - x.mean(1, keepdims=True)
        d = np.sqrt((c ** 2).sum(-1).mean(1))[:, None, None]
        return c * np.sqrt(2.0) / d
    a, b = norm(x1), norm(x2)
    u1, v1, u2, v2 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    o, z = np.ones_like(u1), np.zeros_like(u1)
    if kind == "f":
        A = np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o],
                     -1)
    else:
        A = np.concatenate([
            np.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], -1),
            np.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)], 1)
    ev = np.linalg.eigvalsh(np.swapaxes(A, 1, 2) @ A)
    return ev[:, 1] / ev.sum(1)


def spd(rng, S, n):
    A = rng.normal(size=(S, n, n))
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# small linear algebra
# ---------------------------------------------------------------------------

def test_normalize_points_masked(rng):
    x = rng.uniform(0, 640, size=(8, 50, 2)).astype(np.float32)
    mask = rng.uniform(size=(8, 50)) > 0.3
    xj, Tj = jg.normalize_points(jnp.asarray(x), jnp.asarray(mask))
    xt, Tt = tg.normalize_points(_t(x), _t(mask))
    np.testing.assert_allclose(_np(xt), _np(xj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(Tt), _np(Tj), rtol=1e-5, atol=1e-6)
    xj, Tj = jg.normalize_points(jnp.asarray(x))
    xt, Tt = tg.normalize_points(_t(x))
    np.testing.assert_allclose(_np(Tt), _np(Tj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [3, 9])
def test_chol_solve_and_smallest_eigvec(rng, n):
    A = spd(rng, 16, n)
    b = rng.normal(size=(16, n)).astype(np.float32)
    xj = jax.jit(jg.chol_solve)(jnp.asarray(A), jnp.asarray(b))
    xt = tg.chol_solve(_t(A), _t(b))
    np.testing.assert_allclose(_np(xt), _np(xj), rtol=1e-4, atol=1e-6)
    # PSD with a clear smallest eigenvalue: A = Q diag(0.01, 1..n) Q^T
    Q = np.linalg.qr(rng.normal(size=(16, n, n)))[0]
    w = np.concatenate([[0.01], np.arange(1, n)]).astype(np.float64)
    P = (Q * w[None, None, :]) @ Q.transpose(0, 2, 1)
    P = P.astype(np.float32)
    vj, vt = _same_up_to_sign(jax.jit(jg.smallest_eigvec)(jnp.asarray(P)),
                              tg.smallest_eigvec(_t(P)))
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_allclose(np.abs(np.sum(vt * Q[:, :, 0], -1)), 1.0,
                               atol=1e-3)


def test_inv_solve_lu_3x3(rng):
    A = (rng.normal(size=(32, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tg.inv3x3(_t(A))),
                               _np(jg.inv3x3(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tg.solve3x3(_t(A), _t(b))),
                               _np(jg.solve3x3(jnp.asarray(A),
                                               jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)
    A10 = (rng.normal(size=(8, 10, 10))).astype(np.float32)
    B10 = rng.normal(size=(8, 10, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(tg.lu_solve(_t(A10), _t(B10))),
                               _np(jax.jit(jg.lu_solve)(jnp.asarray(A10),
                                               jnp.asarray(B10))),
                               rtol=1e-3, atol=1e-4)


def test_eigh3x3_and_svd3x3(rng):
    M = rng.normal(size=(64, 3, 3)).astype(np.float32)
    S = (M @ M.transpose(0, 2, 1)).astype(np.float32)
    wj, Vj = jax.jit(jg.eigh3x3)(jnp.asarray(S))
    wt, Vt = tg.eigh3x3(_t(S))
    np.testing.assert_allclose(_np(wt), _np(wj), rtol=1e-4, atol=1e-5)
    a, b = _same_up_to_sign(np.swapaxes(_np(Vj), 1, 2).reshape(-1, 3),
                            np.swapaxes(_np(Vt), 1, 2).reshape(-1, 3))
    np.testing.assert_allclose(b, a, atol=2e-4)
    Uj, sj, Vtj = jax.jit(jg.svd3x3)(jnp.asarray(M))
    Ut, st, Vtt = tg.svd3x3(_t(M))
    np.testing.assert_allclose(_np(st), _np(sj), rtol=1e-4, atol=1e-5)
    # the first two singular triples define the rank-2 part every caller uses
    r2 = lambda U, s, Vt: (_np(U)[:, :, :2] * _np(s)[:, None, :2]) \
        @ _np(Vt)[:, :2, :]
    np.testing.assert_allclose(r2(Ut, st, Vtt), r2(Uj, sj, Vtj),
                               rtol=1e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# minimal / least-squares solvers and residuals
# ---------------------------------------------------------------------------

# A minimal sample is well posed when the second-smallest eigenvalue of its
# design matrix is at least this share of the trace. f32 rounding of A^T A
# moves the solution by about eps / gap in either package, and below the
# gate the two unrolled inverse-iteration steps also stop at a mix of the
# two smallest eigenvectors (measured on these scenes: model differences up
# to 2e-2 below the gates, within the stated tolerances above them).
WELL_POSED_GAP = {"f": 1e-5, "h": 1e-3}


@pytest.mark.parametrize("n", [8, 16])
def test_fit_fundamental_and_essential_8pt(rng, n):
    uv1, uv2, xn1, xn2, E = batch(rng, 96, n)
    Fj, Ft = _same_up_to_sign(
        jax.jit(jg.fit_fundamental_8pt)(jnp.asarray(uv1), jnp.asarray(uv2)),
        tg.fit_fundamental_8pt(_t(uv1), _t(uv2)))
    Ej, Et = _same_up_to_sign(
        jax.jit(jg.fit_essential_8pt)(jnp.asarray(xn1), jnp.asarray(xn2)),
        tg.fit_essential_8pt(_t(xn1), _t(xn2)))
    # the rank-2 and essential projections go through eigh3x3 of F^T F,
    # whose trigonometric method resolves two (nearly) equal eigenvalues
    # only to about sqrt(f32 eps) ~ 3.5e-4 in either package (E always has
    # them: singular values 1, 1, 0)
    good = design_gap(uv1, uv2, "f") > WELL_POSED_GAP["f"]
    assert good.sum() >= 8, good.sum()
    np.testing.assert_allclose(Ft[good], Fj[good], atol=1e-3)
    good_e = design_gap(xn1, xn2, "f") > WELL_POSED_GAP["f"]
    assert good_e.sum() >= 8, good_e.sum()
    np.testing.assert_allclose(Et[good_e], Ej[good_e], atol=2e-3)
    # every sample, well posed or not, is solved by both: its points lie on
    # the epipolar lines of either model
    for F in (Fj, Ft):
        r = _np(tg.epipolar_dist_f(_t(F.astype(np.float32))[:, None],
                                   _t(uv1)[:, None], _t(uv2)[:, None]))
        assert np.median(r) < 1e-2
    # noise-free well-posed samples: the port recovers the true E
    _, Et2 = _same_up_to_sign(E, Et / np.linalg.norm(Et, axis=(1, 2),
                                                      keepdims=True))
    assert np.median(np.abs(Et2 - E).max((1, 2))[good_e]) < 1e-2


def test_weighted_refit_and_residuals(rng):
    """The masked least-squares refit (weights = inlier mask) and the F/H
    residuals on noisy correspondences."""
    uv1, uv2, _, _, _ = batch(rng, 6, 96, noise_px=0.5)
    w = (rng.uniform(size=(6, 96)) > 0.25).astype(np.float32)
    Fj = jax.jit(jg.fit_fundamental_8pt)(jnp.asarray(uv1), jnp.asarray(uv2),
                                jnp.asarray(w))
    Ft = tg.fit_fundamental_8pt(_t(uv1), _t(uv2), _t(w))
    a, b = _same_up_to_sign(Fj, Ft)
    np.testing.assert_allclose(b, a, atol=2e-4)
    # residuals of the SAME model (the reference's) on both sides
    for name in ("sampson_f", "epipolar_dist_f"):
        rj = getattr(jg, name)(Fj[:, None], jnp.asarray(uv1)[:, None],
                               jnp.asarray(uv2)[:, None])
        rt = getattr(tg, name)(_t(Fj)[:, None], _t(uv1)[:, None],
                               _t(uv2)[:, None])
        np.testing.assert_allclose(_np(rt), _np(rj), rtol=1e-3, atol=1e-5)
    p1, p2, _, _, _ = batch(rng, 6, 64, noise_px=0.5, planar=True)
    Hj = jax.jit(jg.fit_homography_4pt)(jnp.asarray(p1), jnp.asarray(p2),
                               jnp.asarray(w[:, :64]))
    Ht = tg.fit_homography_4pt(_t(p1), _t(p2), _t(w[:, :64]))
    np.testing.assert_allclose(_np(Ht), _np(Hj), rtol=1e-3, atol=1e-4)
    rj = jg.sym_transfer_h(Hj[:, None], jnp.asarray(p1)[:, None],
                           jnp.asarray(p2)[:, None])
    rt = tg.sym_transfer_h(_t(Hj)[:, None], _t(p1)[:, None], _t(p2)[:, None])
    np.testing.assert_allclose(_np(rt), _np(rj), rtol=1e-3, atol=1e-5)


def test_fit_homography_4pt_minimal(rng):
    p1, p2, _, _, _ = batch(rng, 96, 4, planar=True)
    Hj = _np(jax.jit(jg.fit_homography_4pt)(jnp.asarray(p1), jnp.asarray(p2)))
    Ht = _np(tg.fit_homography_4pt(_t(p1), _t(p2)))
    good = design_gap(p1, p2, "h") > WELL_POSED_GAP["h"]
    assert good.sum() >= 16, good.sum()
    unit = lambda H: H / np.linalg.norm(H, axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(unit(Ht)[good], unit(Hj)[good], atol=2e-4)
    # every sample maps its four points onto their partners under both
    for H in (Hj, Ht):
        r = _np(tg.sym_transfer_h(_t(H)[:, None], _t(p1)[:, None],
                                  _t(p2)[:, None]))
        assert np.median(r) < 1e-2


def test_poly_helpers_and_roots(rng):
    a4 = rng.normal(size=(5, 4)).astype(np.float32)
    b4 = rng.normal(size=(5, 4)).astype(np.float32)
    q10 = rng.normal(size=(5, 10)).astype(np.float32)
    for fn, args in (("_mul_ll", (a4, b4)), ("_mul_ql", (q10, a4)),
                     ("_polymul", (a4, q10))):
        want = _np(getattr(jg, fn)(*(jnp.asarray(x) for x in args)))
        got = _np(getattr(tg, fn)(*(_t(x) for x in args)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tg._padd((1, 0, 2), (0, 1, 1)) == jg._padd((1, 0, 2), (0, 1, 1))
    # degree-10 polynomials with known, well-separated real roots
    roots = (np.linspace(-2.0, 2.0, 10)[None]
             + rng.uniform(-0.1, 0.1, size=(16, 10)))
    coeffs = np.stack([np.polynomial.polynomial.polyfromroots(r)
                       for r in roots]).astype(np.float32)
    zj = np.sort_complex(_np(jax.jit(jg.poly_roots, static_argnums=1)(
        jnp.asarray(coeffs), 80)))
    zt = np.sort_complex(_np(tg.poly_roots(_t(coeffs), iters=80)))
    np.testing.assert_allclose(zt, zj, atol=5e-3)
    np.testing.assert_allclose(zt.real, roots, atol=5e-2)


def test_nullspace4(rng):
    A = rng.normal(size=(16, 5, 9)).astype(np.float32)
    AtA = np.einsum("smi,smj->sij", A, A).astype(np.float32)
    Nj = _np(jax.jit(jg._nullspace4)(jnp.asarray(AtA)))
    Nt = _np(tg._nullspace4(_t(AtA)))
    # the same subspace: equal projectors
    Pj = Nj @ np.swapaxes(Nj, 1, 2)
    Pt = Nt @ np.swapaxes(Nt, 1, 2)
    # (the basis inside the 4-D null space is not determined: inverse
    # iteration on four zero eigenvalues keeps a rounding-dependent
    # rotation of the start vectors, so only the projector is compared)
    np.testing.assert_allclose(Pt, Pj, atol=1e-5)
    np.testing.assert_allclose(np.swapaxes(Nt, 1, 2) @ Nt,
                               np.broadcast_to(np.eye(4), (16, 4, 4)),
                               atol=1e-5)


def test_fit_essential_5pt(rng):
    """Clean 5-point samples. Every candidate the reference finds (valid,
    solving the sample) is found by the port as well, up to sign; and both
    recover the true E on the same share of samples (f32 solves about 60%
    of minimal problems to 1e-2, tests/test_minimal_solvers.py)."""
    S = 32
    _, _, xn1, xn2, E = batch(rng, S, 5)
    Ej, okj = (_np(v) for v in jax.jit(jg.fit_essential_5pt)(
        jnp.asarray(xn1), jnp.asarray(xn2)))
    Et, okt = (_np(v) for v in tg.fit_essential_5pt(_t(xn1), _t(xn2)))

    def best(Es, ok, s):
        return min((min(np.abs(Es[s, k] - E[s]).max(),
                        np.abs(Es[s, k] + E[s]).max())
                    for k in range(10) if ok[s, k]), default=2.0)

    rec_j = np.array([best(Ej, okj, s) < 1e-2 for s in range(S)])
    rec_t = np.array([best(Et, okt, s) < 1e-2 for s in range(S)])
    assert rec_j.sum() >= S // 2 and rec_t.sum() >= S // 2
    assert abs(int(rec_j.sum()) - int(rec_t.sum())) <= 2
    # candidate-for-candidate agreement where the reference solve is exact
    matched = 0
    for s in np.where(rec_j)[0]:
        for k in np.where(okj[s])[0]:
            d = min(np.abs(Et[s][okt[s]] - Ej[s, k]).max((1, 2)).min(),
                    np.abs(Et[s][okt[s]] + Ej[s, k]).max((1, 2)).min()) \
                if okt[s].any() else 2.0
            matched += d < 1e-2
    total = int(sum(okj[s].sum() for s in np.where(rec_j)[0]))
    assert matched >= 0.9 * total, (matched, total)


# ---------------------------------------------------------------------------
# a-contrario threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sample_size,err_dim", [(8, 1.0), (4, 2.0),
                                                 (5, 1.0)])
def test_nfa_threshold(rng, sample_size, err_dim):
    P, n = 6, 128
    # inliers: small residuals, outliers: large; varying counts per pair
    resid = np.where(rng.uniform(size=(P, n)) < np.linspace(0.3, 0.9, P)[:,
                                                                         None],
                     rng.uniform(0, 1.0, (P, n)) ** 2,
                     rng.uniform(3.0, 40.0, (P, n)) ** 2).astype(np.float32)
    mask = np.ones((P, n), bool)
    mask[:, 100:] = np.arange(P)[:, None] % 2 == 0
    la = np.float32(jr._logalpha0_line(640.0, 480.0) if err_dim == 1.0
                    else jr._logalpha0_point(640.0, 480.0))
    me = np.float32(16.0)
    f = jax.vmap(lambda r, m: jr._nfa_threshold(r, m, sample_size, la,
                                                err_dim, me))
    thr_j, nfa_j, k_j = (_np(v) for v in f(jnp.asarray(resid),
                                           jnp.asarray(mask)))
    thr_t, nfa_t, k_t = (_np(v) for v in tr._nfa_threshold(
        _t(resid), _t(mask), sample_size, torch.full((P,), float(la)),
        err_dim, torch.full((P,), float(me))))
    np.testing.assert_array_equal(k_t, k_j)
    np.testing.assert_array_equal(thr_t, thr_j)
    np.testing.assert_allclose(nfa_t, nfa_j, rtol=1e-5, atol=1e-3)
    # log-comb and the alpha0 helpers
    n_, k_ = np.arange(10, 200, 7, dtype=np.float32), np.float32(5)
    np.testing.assert_allclose(
        _np(tr._log10_comb(_t(n_), k_)),
        _np(jr._log10_comb(jnp.asarray(n_), jnp.float32(k_))),
        rtol=1e-5, atol=1e-4)
    for w, h in itertools.product((320.0, 1024.0), (240.0, 1024.0)):
        assert tr._logalpha0_line(w, h) == jr._logalpha0_line(w, h)
        assert tr._logalpha0_point(w, h) == jr._logalpha0_point(w, h)
        np.testing.assert_allclose(tr._logalpha0_e(w, h, 800.0),
                                   float(jr._logalpha0_e(w, h, 800.0)),
                                   rtol=1e-6)
