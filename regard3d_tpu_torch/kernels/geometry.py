"""Multi-view geometry solvers (F / E / H, resection, triangulation).

Counterpart of ``regard3d_tpu/kernels/geometry.py``: Hartley normalization,
the unrolled small linear algebra (Cholesky, shifted inverse iteration,
analytic 3x3 eigen/SVD, pivoted LU), the 8-point F/E and 4-point H solvers,
the Nistér 5-point E solver with Durand–Kerner root finding, the F/H
residuals, and the SfM part: two-view and N-view triangulation, the
cheirality-voting E decomposition, Kabsch, Grunert's P3P, the 6-point DLT
resection, the normalized reprojection error and the Gauss-Newton pose
polish. Same formulas, same constants, same batch layouts: solvers take a
leading batch of samples (S, n, 2) -> (S, ...) and residual functions
broadcast over leading dimensions. Dense solves use the ``_ex`` forms
(no host synchronisation on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def to_h(x):
    """(..., 2) -> homogeneous (..., 3)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _safe_den(d, eps):
    """d where |d| > eps, else +-eps with d's sign (>= 0 -> +eps)."""
    return torch.where(d.abs() > eps, d,
                       torch.where(d >= 0, torch.full_like(d, eps),
                                   torch.full_like(d, -eps)))


# ---------------------------------------------------------------------------
# Hartley normalization
# ---------------------------------------------------------------------------

def normalize_points(x, mask=None):
    """Similarity-normalize points to zero mean / sqrt(2) RMS.
    x: (..., N, 2), mask: (..., N) optional. Returns (xn, T) with
    xh_n = T @ xh."""
    if mask is None:
        mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    w = mask.to(x.dtype)[..., None]
    n = torch.clamp_min(torch.sum(w, -2), 1.0)
    mean = torch.sum(x * w, -2, keepdim=True) / n[..., None, :]
    d = torch.sqrt(torch.sum(torch.sum((x - mean) ** 2 * w, -1), -1)
                   / n[..., 0])
    s = math.sqrt(2.0) / torch.clamp_min(d, 1e-12)
    xn = (x - mean) * s[..., None, None] * w
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zeros, -s * mean[..., 0, 0]], -1),
        torch.stack([zeros, s, -s * mean[..., 0, 1]], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], -2)
    return xn, T


# ---------------------------------------------------------------------------
# Small batched linear algebra (unrolled, no LAPACK)
# ---------------------------------------------------------------------------

def chol_solve(A, b):
    """Solve SPD systems by unrolled Cholesky. A: (S, n, n), b: (S, n)."""
    S, n, _ = A.shape
    L = torch.zeros_like(A)
    ar = torch.arange(n, device=A.device)
    for j in range(n):
        if j > 0:
            accum = torch.einsum("si,sji->sj", L[:, j, :j], L[:, :, :j])
        else:
            accum = torch.zeros_like(A[:, :, 0])
        cj = A[:, :, j] - accum                        # (S, n)
        d = torch.sqrt(torch.clamp_min(cj[:, j], 1e-30))
        colj = cj / d[:, None]
        colj = torch.where(ar[None, :] >= j, colj, 0.0)
        L[:, :, j] = colj
    y = torch.zeros_like(b)
    for i in range(n):
        yi = (b[:, i] - torch.einsum("sk,sk->s", L[:, i, :i], y[:, :i])) \
            / L[:, i, i]
        y[:, i] = yi
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        xi = (y[:, i] - torch.einsum("sk,sk->s", L[:, i + 1:, i],
                                     x[:, i + 1:])) / L[:, i, i]
        x[:, i] = xi
    return x


def smallest_eigvec(AtA, iters: int = 2):
    """Eigenvector of the smallest eigenvalue of a PSD batch (S, n, n) by
    shifted inverse iteration with the unrolled Cholesky."""
    S, n, _ = AtA.shape
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    eps = 3e-7 * tr + 1e-30
    eye = torch.eye(n, dtype=AtA.dtype, device=AtA.device)
    M = AtA + eps[:, None, None] * eye
    v0 = torch.cos(torch.arange(1, n + 1, dtype=AtA.dtype, device=AtA.device)
                   * 1.6180339887)
    v0 = (v0 / torch.linalg.norm(v0)).expand(S, n)
    v = v0
    for _ in range(iters):
        v = chol_solve(M, v)
        m = torch.amax(v.abs(), -1, keepdim=True)
        v = v / torch.clamp_min(m, 1e-30)
        v = torch.where(torch.isfinite(v), v, 0.0)
        nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
        v = torch.where(nrm > 1e-20, v / torch.clamp_min(nrm, 1e-30), v0)
    return v


def inv3x3(A):
    """Closed-form (adjugate) inverse of a 3x3 batch (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / _safe_den(det, 1e-30)
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def solve3x3(A, b):
    """Closed-form 3x3 solve. A: (..., 3, 3), b: (..., 3)."""
    return (inv3x3(A) @ b[..., None])[..., 0]


def _det3(M):
    """3x3 determinant by cofactor expansion (batched)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def eigh3x3(A):
    """Analytic symmetric 3x3 eigendecomposition (trigonometric method) +
    one cyclic Jacobi polish. A: (..., 3, 3) symmetric. Returns (w (..., 3)
    DESCENDING, V (..., 3, 3) columns = eigenvectors)."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, (-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    degenerate = p2 < 1e-24
    psafe = torch.where(degenerate, torch.ones_like(p), p)
    detB = _det3(B / psafe[..., None, None])
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w0 = q + 2.0 * psafe * torch.cos(phi)                       # largest
    w2 = q + 2.0 * psafe * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    w1 = 3.0 * q - w0 - w2
    w0 = torch.where(degenerate, q, w0)
    w1 = torch.where(degenerate, q, w1)
    w2 = torch.where(degenerate, q, w2)

    def eigvec(lmbda):
        C = A - lmbda[..., None, None] * eye
        r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
        c01 = _cross(r0, r1)
        c02 = _cross(r0, r2)
        c12 = _cross(r1, r2)
        n01 = torch.sum(c01 * c01, -1)
        n02 = torch.sum(c02 * c02, -1)
        n12 = torch.sum(c12 * c12, -1)
        best = torch.argmax(torch.stack([n01, n02, n12], -1), -1)
        cands = torch.stack([c01, c02, c12], -2)
        v = torch.gather(cands, -2,
                         best[..., None, None].expand(*best.shape, 1, 3))
        v = v[..., 0, :]
        nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
        fallback = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype,
                                device=A.device).expand(v.shape)
        return torch.where(nrm > 1e-20, v / torch.clamp_min(nrm, 1e-30),
                           fallback)

    vmax = eigvec(w0)
    vmin = eigvec(w2)
    vmin = vmin - torch.sum(vmin * vmax, -1, keepdim=True) * vmax
    nmin = torch.linalg.norm(vmin, dim=-1, keepdim=True)
    alt = _cross(vmax, torch.tensor([0.0, 1.0, 0.0], dtype=A.dtype,
                                    device=A.device).expand(vmax.shape))
    alt = alt / torch.clamp_min(torch.linalg.norm(alt, dim=-1, keepdim=True),
                                1e-30)
    vmin = torch.where(nmin > 1e-12, vmin / torch.clamp_min(nmin, 1e-30), alt)
    vmid = _cross(vmin, vmax)
    cols = [vmax, vmid, vmin]

    # one cyclic Jacobi sweep (repeated eigenvalues mix the degenerate
    # subspace in the cross-product method; essential matrices have s1 = s2)
    for (pi, qi) in ((0, 1), (0, 2), (1, 2)):
        vp = cols[pi]
        vq = cols[qi]
        Avp = (A @ vp[..., None])[..., 0]
        Avq = (A @ vq[..., None])[..., 0]
        app = torch.sum(vp * Avp, -1)
        aqq = torch.sum(vq * Avq, -1)
        apq = torch.sum(vp * Avq, -1)
        theta = 0.5 * torch.atan2(2.0 * apq, app - aqq)
        c = torch.cos(theta)[..., None]
        s = torch.sin(theta)[..., None]
        cols[pi] = c * vp + s * vq
        cols[qi] = c * vq - s * vp
    V = torch.stack(cols, -1)
    AV = A @ V
    w = torch.sum(V * AV, -2)
    order = torch.argsort(-w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def svd3x3(F):
    """Analytic 3x3 SVD from eigh3x3 of F^T F. F: (..., 3, 3).
    Returns (U, s, Vt) with s descending; U and V proper rotations (third
    column = cross product); the sign of a full-rank third singular triple
    is not recovered — every caller zeroes s3."""
    w, V = eigh3x3(F.transpose(-1, -2) @ F)
    detV = _det3(V)
    sign = torch.where(detV < 0, -1.0, 1.0)
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * sign[..., None, None]], -1)
    s = torch.sqrt(torch.clamp_min(w, 0.0))
    FV = F @ V
    u0 = FV[..., :, 0] / torch.clamp_min(s[..., 0:1], 1e-30)
    u1 = FV[..., :, 1] / torch.clamp_min(s[..., 1:2], 1e-30)
    u1 = u1 - torch.sum(u1 * u0, -1, keepdim=True) * u0
    n1 = torch.linalg.norm(u1, dim=-1, keepdim=True)
    alt = _cross(u0, torch.tensor([0.0, 1.0, 0.0], dtype=F.dtype,
                                  device=F.device).expand(u0.shape))
    alt = alt / torch.clamp_min(torch.linalg.norm(alt, dim=-1, keepdim=True),
                                1e-30)
    u1 = torch.where(n1 > 1e-12, u1 / torch.clamp_min(n1, 1e-30), alt)
    u2 = _cross(u0, u1)
    U = torch.stack([u0, u1, u2], -1)
    return U, s, V.transpose(-1, -2)


def _smallest_singular_vector(A):
    """Right singular vector of the smallest singular value. A: (S, m, n)."""
    AtA = torch.einsum("smi,smj->sij", A, A)
    return smallest_eigvec(AtA)


def _rank2(F):
    """Zero the smallest singular value: U diag(s1, s2, 0) Vt."""
    U, s, Vt = svd3x3(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return U @ (s[..., None] * Vt)


def fit_fundamental_8pt(x1, x2, w=None):
    """Normalized 8-point fundamental. x1, x2: (S, n>=8, 2) pixel coords;
    w: optional (S, n) row weights (masked least-squares refit).
    Returns F: (S, 3, 3) with x2^T F x1 = 0, rank-2 enforced."""
    m = None if w is None else w > 0
    x1n, T1 = normalize_points(x1, m)
    x2n, T2 = normalize_points(x2, m)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     ones], -1)                                # (S, n, 9)
    if w is not None:
        A = A * w[..., None]
    f = _smallest_singular_vector(A)
    F = _rank2(f.reshape(-1, 3, 3))
    F = T2.transpose(-1, -2) @ F @ T1
    nrm = torch.linalg.norm(F.reshape(F.shape[0], 9), dim=-1, keepdim=True)
    return F / torch.clamp_min(nrm, 1e-12)[..., None]


def fit_essential_8pt(x1, x2, w=None):
    """8-point essential on normalized camera coords (S, n, 2); projects to
    the essential manifold (singular values 1, 1, 0)."""
    F = fit_fundamental_8pt(x1, x2, w)
    U, s, Vt = svd3x3(F)
    d = torch.ones_like(s)
    d = torch.cat([d[..., :2], torch.zeros_like(d[..., 2:])], -1)
    return U @ (d[..., None] * Vt)


def fit_homography_4pt(x1, x2, w=None):
    """DLT homography. x1, x2: (S, n>=4, 2). Returns H: (S, 3, 3),
    x2 ~ H x1."""
    m = None if w is None else w > 0
    x1n, T1 = normalize_points(x1, m)
    x2n, T2 = normalize_points(x2, m)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], -1)
    r2 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    A = torch.cat([r1, r2], -2)                                # (S, 2n, 9)
    if w is not None:
        A = A * torch.cat([w, w], -1)[..., None]
    h = _smallest_singular_vector(A)
    H = h.reshape(-1, 3, 3)
    Hd = inv3x3(T2) @ H @ T1
    h22 = Hd[..., 2:3, 2:3]
    return Hd / torch.where(h22.abs() > 1e-12, h22, 1e-12)


# ---------------------------------------------------------------------------
# Residuals — F/H: (..., 3, 3) models against (..., N, 2) points
# ---------------------------------------------------------------------------

def _apply(M, xh):
    """rows of xh (..., N, 3) mapped by M (..., 3, 3): (..., N, 3)."""
    return xh @ M.transpose(-1, -2)


def sampson_f(F, x1, x2):
    """Sampson distance (squared, px^2)."""
    x1h = to_h(x1)
    x2h = to_h(x2)
    Fx1 = _apply(F, x1h)
    Ftx2 = x2h @ F
    num = torch.sum(x2h * Fx1, -1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 \
        + Ftx2[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-12)


def epipolar_dist_f(F, x1, x2):
    """Point-to-epipolar-line distance in image 2 (squared px^2) — the
    residual AC-RANSAC uses for F (and E, in normalized coords)."""
    x1h = to_h(x1)
    x2h = to_h(x2)
    l2 = _apply(F, x1h)
    num = torch.sum(x2h * l2, -1) ** 2
    den = l2[..., 0] ** 2 + l2[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-12)


def sym_transfer_h(H, x1, x2):
    """Symmetric transfer error for homography (squared)."""
    def fwd(H, a, b):
        p = _apply(H, to_h(a))
        pz = p[..., 2:]
        p = p[..., :2] / torch.where(pz.abs() > 1e-12, pz, 1e-12)
        return torch.sum((p - b) ** 2, -1)
    Hinv = inv3x3(H)
    return 0.5 * (fwd(H, x1, x2) + fwd(Hinv, x2, x1))


# ---------------------------------------------------------------------------
# Pivoted solves + polynomial root finding (minimal-solver support)
# ---------------------------------------------------------------------------

def lu_solve(A, B):
    """Unrolled partial-pivot Gaussian elimination, batched.
    A: (S, n, n), B: (S, n, m) -> X with A @ X = B."""
    S, n, _ = A.shape
    M = torch.cat([A, B], -1)                          # (S, n, n+m)
    ar = torch.arange(n, device=A.device)
    for k in range(n):
        col = M[:, :, k].abs()
        col = torch.where(ar[None, :] < k, -1.0, col)
        p = torch.argmax(col, dim=1)
        rows = ar[None, :].expand(S, n)
        rk = torch.where(rows == k, p[:, None],
                         torch.where(rows == p[:, None], k, rows))
        M = torch.gather(M, 1, rk[:, :, None].expand(M.shape))
        piv = M[:, k:k + 1, :]
        den = _safe_den(piv[:, :, k:k + 1], 1e-20)
        fac = M[:, :, k:k + 1] / den
        keep = (ar[None, :, None] != k)
        M = M - torch.where(keep, fac * piv, 0.0)
    den = torch.diagonal(M[:, :, :n], dim1=1, dim2=2)[..., None]
    den = _safe_den(den, 1e-20)
    return M[:, :, n:] / den


def dk_start(D: int, dev) -> torch.Tensor:
    """Durand-Kerner's start before scaling: (0.4 + 0.9i)^(k + 1), k < D,
    complex64 on ``dev``."""
    k = torch.arange(D, device=dev)
    return torch.tensor(0.4 + 0.9j, dtype=torch.complex64, device=dev) \
        ** (k + 1)


def poly_roots(coeffs, iters: int = 60):
    """All complex roots of polynomials by Durand–Kerner iteration.
    coeffs: (S, D+1) ASCENDING, real or complex. Returns (S, D) complex64."""
    coeffs = coeffs.to(torch.complex64)
    S, D1 = coeffs.shape
    D = D1 - 1
    dev = coeffs.device
    lead = coeffs[:, -1:]
    tiny = torch.full_like(lead, 1e-25)
    lead = torch.where(lead.abs() > 1e-25, lead, tiny)
    c = coeffs / lead                                   # monic
    bound = 1.0 + torch.amax(c[:, :-1].abs(), dim=1, keepdim=True)
    z = dk_start(D, dev)[None, :] * bound.to(torch.complex64)
    eye = torch.eye(D, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.complex64, device=dev)
    for _ in range(iters):
        # z^0..z^D by repeated multiplication: the reference's complex
        # ``z ** k`` goes through exp/log, several times slower and no more
        # accurate (about 6e-7 relative at k = 10, against 1e-7 here)
        zk = torch.cat([torch.ones_like(z[..., None]),
                        z[..., None].expand(S, D, D).cumprod(-1)], -1)
        pz = torch.sum(c[:, None, :] * zk, -1)
        diff = z[:, :, None] - z[:, None, :]
        diff = torch.where(eye, one, diff)
        denom = torch.prod(diff, dim=-1)
        denom = torch.where(denom.abs() > 1e-30, denom,
                            torch.full_like(denom, 1e-30))
        z = z - pz / denom
    return z


# ---------------------------------------------------------------------------
# Nistér 5-point essential solver, batched
# ---------------------------------------------------------------------------

# monomial power tuples; order follows Nistér's elimination grouping
_MON3 = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
         (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0), (1, 0, 2), (1, 0, 1),
         (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0), (0, 0, 3), (0, 0, 2),
         (0, 0, 1), (0, 0, 0)]
_LIN = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_QUAD = [(2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1),
         (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_M3IDX = {m: i for i, m in enumerate(_MON3)}
_QIDX = {m: i for i, m in enumerate(_QUAD)}


def _padd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _stack_terms(out, like):
    return torch.stack([t if torch.is_tensor(t)
                        else torch.full_like(like, t) for t in out], -1)


def _mul_ll(a, b):
    """(..., 4) x (..., 4) linear forms -> (..., 10) quadratic coeffs."""
    out = [0.0] * 10
    for i, pi in enumerate(_LIN):
        for j, pj in enumerate(_LIN):
            q = _QIDX[_padd(pi, pj)]
            out[q] = out[q] + a[..., i] * b[..., j]
    return _stack_terms(out, a[..., 0])


def _mul_ql(a, b):
    """(..., 10) quadratic x (..., 4) linear -> (..., 20) cubic coeffs."""
    out = [0.0] * 20
    for i, pi in enumerate(_QUAD):
        for j, pj in enumerate(_LIN):
            q = _M3IDX[_padd(pi, pj)]
            out[q] = out[q] + a[..., i] * b[..., j]
    return _stack_terms(out, a[..., 0])


def _polymul(a, b):
    """1-D polynomial product over the last axis (ascending coeffs)."""
    la = a.shape[-1]
    lb = b.shape[-1]
    out = [0.0] * (la + lb - 1)
    for i in range(la):
        for j in range(lb):
            out[i + j] = out[i + j] + a[..., i] * b[..., j]
    return _stack_terms(out, a[..., 0])


_NULL4_START = np.random.default_rng(7).normal(size=(9, 4))


def _nullspace4(AtA, iters: int = 3):
    """4 smallest-eigenvalue eigenvectors of PSD (S, 9, 9) by subspace
    inverse iteration + unrolled Gram-Schmidt."""
    S = AtA.shape[0]
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-6 * tr + 1e-30
    eye = torch.eye(9, dtype=AtA.dtype, device=AtA.device)
    M = AtA + eps[:, None, None] * eye
    V = torch.as_tensor(_NULL4_START, dtype=AtA.dtype,
                        device=AtA.device).expand(S, 9, 4)

    def orthonormalize(V):
        cols = []
        for c in range(4):
            v = V[..., c]
            for u in cols:
                v = v - torch.sum(v * u, -1, keepdim=True) * u
            m = torch.amax(v.abs(), -1, keepdim=True)
            v = v / torch.clamp_min(m, 1e-30)
            v = torch.where(torch.isfinite(v), v, 0.0)
            n = torch.linalg.norm(v, dim=-1, keepdim=True)
            fallback = eye[c].expand(v.shape)
            v = torch.where(n > 1e-12, v / torch.clamp_min(n, 1e-30),
                            fallback)
            cols.append(v)
        return torch.stack(cols, -1)

    for _ in range(iters):
        V = torch.stack([chol_solve(M, V[..., c]) for c in range(4)], -1)
        V = orthonormalize(V)
    return V                                            # (S, 9, 4)


def fit_essential_5pt(x1, x2):
    """Nistér 5-point essential. x1, x2: (S, 5, 2) normalized camera
    coords. Returns (E (S, 10, 3, 3), ok (S, 10)) — up to 10 real
    solutions per sample; invalid slots masked."""
    S = x1.shape[0]
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, ones], -1)                  # (S, 5, 9)
    A = A / torch.clamp_min(torch.linalg.norm(A, dim=-1, keepdim=True), 1e-12)
    AtA = torch.einsum("smi,smj->sij", A, A)
    N4 = _nullspace4(AtA)                                # (S, 9, 4)
    e = N4.reshape(S, 3, 3, 4)

    def lin(i, j):
        return e[:, i, j]

    def det3():
        terms = []
        for (i0, i1, i2, sgn) in (((0, 0), (1, 1), (2, 2), 1.0),
                                  ((0, 1), (1, 2), (2, 0), 1.0),
                                  ((0, 2), (1, 0), (2, 1), 1.0),
                                  ((0, 2), (1, 1), (2, 0), -1.0),
                                  ((0, 0), (1, 2), (2, 1), -1.0),
                                  ((0, 1), (1, 0), (2, 2), -1.0)):
            q = _mul_ll(lin(*i0), lin(*i1))
            terms.append(sgn * _mul_ql(q, lin(*i2)))
        return sum(terms)

    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            s = None
            for k in range(3):
                q = _mul_ll(lin(i, k), lin(j, k))
                s = q if s is None else s + q
            EEt[i][j] = s
    trEEt = EEt[0][0] + EEt[1][1] + EEt[2][2]            # (S, 10)

    rows = [det3()]
    for i in range(3):
        for j in range(3):
            s = None
            for k in range(3):
                c = _mul_ql(EEt[i][k], lin(k, j))
                s = c if s is None else s + c
            rows.append(2.0 * s - _mul_ql(trEEt, lin(i, j)))
    M = torch.stack(rows, 1)                             # (S, 10, 20)

    # Gauss-Jordan on the 10 leading monomials + one refinement pass
    A10 = M[:, :, :10]
    B10 = M[:, :, 10:]
    C10 = lu_solve(A10, B10)                             # (S, 10, 10)
    C10 = C10 + lu_solve(A10, B10 - torch.einsum("sij,sjk->sik", A10, C10))
    ce, cf, cg, ch, ci, cj = (C10[:, r] for r in range(4, 10))

    def row_polys(c_hi, c_lo):
        """<hi> - z*<lo>: (alpha deg3, beta deg3, gamma deg4) ascending."""
        def shift(p):
            return torch.cat([torch.zeros_like(p[..., :1]), p], -1)
        ax = torch.stack([c_hi[:, 2], c_hi[:, 1], c_hi[:, 0]], -1)
        bx = torch.stack([c_hi[:, 5], c_hi[:, 4], c_hi[:, 3]], -1)
        gx = torch.stack([c_hi[:, 9], c_hi[:, 8], c_hi[:, 7],
                          c_hi[:, 6]], -1)
        al = torch.stack([c_lo[:, 2], c_lo[:, 1], c_lo[:, 0]], -1)
        bl = torch.stack([c_lo[:, 5], c_lo[:, 4], c_lo[:, 3]], -1)
        gl = torch.stack([c_lo[:, 9], c_lo[:, 8], c_lo[:, 7],
                          c_lo[:, 6]], -1)
        pad1 = lambda p: torch.cat([p, torch.zeros_like(p[..., :1])], -1)
        return (pad1(ax) - shift(al), pad1(bx) - shift(bl),
                pad1(gx) - shift(gl))

    a1, b1, g1 = row_polys(ce, cf)
    a2, b2, g2 = row_polys(cg, ch)
    a3, b3, g3 = row_polys(ci, cj)

    m1 = _polymul(b2, g3) - _polymul(b3, g2)
    m2 = _polymul(a2, g3) - _polymul(a3, g2)
    m3 = _polymul(a2, b3) - _polymul(a3, b2)
    n10 = _polymul(a1, m1) - _polymul(b1, m2) + _polymul(g1, m3)  # (S, 11)

    roots = poly_roots(n10, iters=80)                    # (S, 10) complex
    z = roots.real
    real = roots.imag.abs() < 1e-2 * (1.0 + z.abs())

    # Newton polish on the real polynomial
    powers = torch.arange(11, dtype=x1.dtype, device=x1.device)
    dcoef = n10[:, 1:] * torch.arange(1, 11, dtype=x1.dtype,
                                      device=x1.device)
    for _ in range(3):
        pz = torch.sum(n10[:, None, :] * z[..., None] ** powers, -1)
        dz = torch.sum(dcoef[:, None, :] * z[..., None] ** powers[:10], -1)
        dz = _safe_den(dz, 1e-25)
        z = z - pz / dz

    def peval(p, zz):
        pw = torch.arange(p.shape[-1], dtype=zz.dtype, device=zz.device)
        return torch.sum(p[:, None, :] * zz[..., None] ** pw, -1)

    A1 = peval(a1, z); B1 = peval(b1, z); G1 = peval(g1, z)
    A2 = peval(a2, z); B2 = peval(b2, z); G2 = peval(g2, z)
    A3 = peval(a3, z); B3 = peval(b3, z); G3 = peval(g3, z)
    dets = torch.stack([A1 * B2 - A2 * B1, A1 * B3 - A3 * B1,
                        A2 * B3 - A3 * B2], -1)          # (S, 10, 3)
    pick = torch.argmax(dets.abs(), -1, keepdim=True)
    d = _safe_den(torch.gather(dets, -1, pick)[..., 0], 1e-20)
    xs = torch.stack([(-G1 * B2 + G2 * B1), (-G1 * B3 + G3 * B1),
                      (-G2 * B3 + G3 * B2)], -1)
    ys = torch.stack([(-A1 * G2 + A2 * G1), (-A1 * G3 + A3 * G1),
                      (-A2 * G3 + A3 * G2)], -1)
    xv = torch.gather(xs, -1, pick)[..., 0] / d
    yv = torch.gather(ys, -1, pick)[..., 0] / d

    basis = N4.reshape(S, 1, 3, 3, 4)
    E = (xv[..., None, None] * basis[..., 0]
         + yv[..., None, None] * basis[..., 1]
         + z[..., None, None] * basis[..., 2]
         + basis[..., 3])                                # (S, 10, 3, 3)
    nrm = torch.linalg.norm(E.reshape(S, 10, 9), dim=-1)
    ok = real & (nrm > 1e-12) & torch.isfinite(E).all(-1).all(-1)
    E = E / torch.clamp_min(nrm, 1e-12)[..., None, None]
    return E, ok


# ---------------------------------------------------------------------------
# Essential decomposition & relative pose
# ---------------------------------------------------------------------------

def _rt_apply(R, v):
    """R^T applied to rows: v (..., N, 3), R (..., 3, 3) -> (..., N, 3)."""
    return v @ R


def triangulate_2view(R1, C1, R2, C2, b1, b2):
    """Linear two-view triangulation from unit bearings in camera frames
    (x_cam = R (X - C)). b1, b2: (..., N, 3). Returns X: (..., N, 3)."""
    d1 = _rt_apply(R1, b1)                           # world rays R^T b
    d2 = _rt_apply(R2, b2)
    eye = torch.eye(3, dtype=b1.dtype, device=b1.device)

    def nmat(d):
        return eye - d[..., :, None] * d[..., None, :]
    A1 = nmat(d1)
    A2 = nmat(d2)
    A = A1 + A2
    b = (A1 @ C1[..., None, :, None])[..., 0] + \
        (A2 @ C2[..., None, :, None])[..., 0]
    return solve3x3(A + 1e-12 * eye, b)


def decompose_essential(E, x1, x2, mask=None):
    """Four-way decomposition of E with cheirality voting.

    E: (S, 3, 3); x1, x2: (S, N, 2) normalized camera coords; ``mask``
    (S, N) optional — only masked points vote. Returns (R (S,3,3),
    t (S,3), ngood (S,)): camera 2 with x_cam2 = R (X - C2), C1 = 0, and
    t = -R C2 (unit norm)."""
    U, _, Vt = svd3x3(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    b1 = to_h(x1)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = to_h(x2)
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    eye = torch.eye(3, dtype=E.dtype, device=E.device).expand(Ra.shape)
    C0 = torch.zeros_like(t)

    def count_good(R, tt):
        C2 = -(R.transpose(-1, -2) @ tt[..., None])[..., 0]
        X = triangulate_2view(eye, C0, R, C2, b1, b2)
        z1 = X[..., 2]
        xc2 = (X - C2[..., None, :]) @ R.transpose(-1, -2)
        good = (z1 > 0) & (xc2[..., 2] > 0)
        if mask is not None:
            good = good & mask
        return good.sum(-1)

    cands = [(Ra, t), (Ra, -t), (Rb, t), (Rb, -t)]
    counts = torch.stack([count_good(R, tt) for R, tt in cands], -1)
    best = torch.argmax(counts, -1)
    Rs = torch.stack([c[0] for c in cands], -3)
    ts = torch.stack([c[1] for c in cands], -2)
    ar = torch.arange(E.shape[0], device=E.device)
    return Rs[ar, best], ts[ar, best], counts[ar, best]


def kabsch(Pw, Pc):
    """Rigid transform world->camera from point pairs: (R, C) with
    Pc ~ R (Pw - C). Pw, Pc: (S, n, 3) (n >= 3)."""
    mw = Pw.mean(-2, keepdim=True)
    mc = Pc.mean(-2, keepdim=True)
    H = (Pc - mc).transpose(-1, -2) @ (Pw - mw)
    U, _, Vt = svd3x3(H)
    R = U @ Vt                      # proper rotation by construction
    C = mw[:, 0] - (R.transpose(-1, -2) @ mc[:, 0, :, None])[..., 0]
    return R, C


# ---------------------------------------------------------------------------
# P3P (Grunert's quartic), DLT resection
# ---------------------------------------------------------------------------

def p3p_grunert(X, x):
    """Poses from 3 world points + 3 normalized image points.

    X: (S, 3, 3) world points; x: (S, 3, 2) normalized camera coords.
    Returns (R (S, 4, 3, 3), C (S, 4, 3), ok (S, 4)): up to 4 solutions per
    sample (Grunert's law-of-cosines quartic, Durand–Kerner roots)."""
    S = X.shape[0]
    f = to_h(x)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)   # (S, 3, 3) bearings
    P1, P2, P3 = X[:, 0], X[:, 1], X[:, 2]
    a2 = torch.sum((P2 - P3) ** 2, -1)
    b2 = torch.sum((P1 - P3) ** 2, -1)
    c2 = torch.sum((P1 - P2) ** 2, -1)
    b2s = torch.clamp_min(b2, 1e-20)
    ca = torch.sum(f[:, 1] * f[:, 2], -1)                # cos(alpha)
    cb = torch.sum(f[:, 0] * f[:, 2], -1)                # cos(beta)
    cg = torch.sum(f[:, 0] * f[:, 1], -1)                # cos(gamma)

    p = (a2 - c2) / b2s
    q = (a2 + c2) / b2s
    A4 = (p - 1.0) ** 2 - 4.0 * (c2 / b2s) * ca ** 2
    A3 = 4.0 * (p * (1.0 - p) * cb - (1.0 - q) * ca * cg
                + 2.0 * (c2 / b2s) * ca ** 2 * cb)
    A2 = 2.0 * (p ** 2 - 1.0 + 2.0 * p ** 2 * cb ** 2
                + 2.0 * ((b2 - c2) / b2s) * ca ** 2
                - 4.0 * q * ca * cb * cg
                + 2.0 * ((b2 - a2) / b2s) * cg ** 2)
    A1 = 4.0 * (-p * (1.0 + p) * cb + 2.0 * (a2 / b2s) * cg ** 2 * cb
                - (1.0 - q) * ca * cg)
    A0 = (1.0 + p) ** 2 - 4.0 * (a2 / b2s) * cg ** 2

    coeffs = torch.stack([A0, A1, A2, A3, A4], -1)        # ascending
    roots = poly_roots(coeffs)                            # (S, 4) complex
    v = roots.real
    real = roots.imag.abs() < 1e-3 * (1.0 + v.abs())
    # Newton polish in real arithmetic (f32 quartics are ill-conditioned)
    for _ in range(3):
        qv = (((A4[:, None] * v + A3[:, None]) * v + A2[:, None]) * v
              + A1[:, None]) * v + A0[:, None]
        dq = ((4.0 * A4[:, None] * v + 3.0 * A3[:, None]) * v
              + 2.0 * A2[:, None]) * v + A1[:, None]
        v = v - qv / _safe_den(dq, 1e-12)

    den_u = _safe_den(2.0 * (cg[:, None] - v * ca[:, None]), 1e-12)
    u = ((-1.0 + p[:, None]) * v ** 2
         - 2.0 * p[:, None] * cb[:, None] * v + 1.0 + p[:, None]) / den_u
    s1sq = b2s[:, None] / torch.clamp_min(
        1.0 + v ** 2 - 2.0 * v * cb[:, None], 1e-12)
    ok = real & (s1sq > 0) & (u > 0) & (v > 0)
    s1 = torch.sqrt(torch.clamp_min(s1sq, 0.0))
    s2 = u * s1
    s3 = v * s1

    Pc = torch.stack([s1[..., None] * f[:, None, 0],
                      s2[..., None] * f[:, None, 1],
                      s3[..., None] * f[:, None, 2]], -2)  # (S, 4, 3pts, 3)
    Pw = X[:, None].expand(Pc.shape)
    R, C = kabsch(Pw.reshape(-1, 3, 3), Pc.reshape(-1, 3, 3))
    R = R.reshape(S, 4, 3, 3)
    C = C.reshape(S, 4, 3)
    ok = ok & torch.isfinite(R).all(-1).all(-1) & torch.isfinite(C).all(-1)
    return R, C, ok


def resection_dlt(X, x):
    """Camera pose from 3D-2D correspondences in normalized camera coords.
    X: (S, n>=6, 3); x: (S, n, 2). Returns (R (S,3,3), C (S,3), ok (S,))."""
    from regard3d_tpu_torch.core import cameras
    u, v = x[..., 0], x[..., 1]
    o = torch.ones_like(u)
    Xh = torch.cat([X, o[..., None]], -1)              # (S, n, 4)
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -u[..., None] * Xh], -1)
    r2 = torch.cat([z, Xh, -v[..., None] * Xh], -1)
    A = torch.cat([r1, r2], -2)                        # (S, 2n, 12)
    P = _smallest_singular_vector(A).reshape(-1, 3, 4)
    M = P[..., :3]
    depths = (X @ M[..., 2, :, None])[..., 0] + P[..., 2, 3][..., None]
    sign = torch.where(torch.sign(depths).sum(-1) >= 0, 1.0, -1.0)
    P = P * sign[..., None, None]
    M = P[..., :3]
    scale = torch.clamp_min(_det3(M).abs(), 1e-20) ** (1.0 / 3.0)
    M = M / scale[..., None, None]
    tvec = P[..., 3] / scale[..., None]
    R = cameras.project_so3(M)
    C = -(R.transpose(-1, -2) @ tvec[..., None])[..., 0]
    ok = torch.isfinite(R).all(-1).all(-1) & torch.isfinite(C).all(-1)
    return R, C, ok


def reprojection_err_normalized(R, C, X, x):
    """Squared residual in normalized coords for resection scoring.
    R: (..., 3, 3), C: (..., 3), X: (..., N, 3), x: (..., N, 2); leading
    dimensions broadcast. Behind the camera: 1e12."""
    xc = (X - C[..., None, :]) @ R.transpose(-1, -2)
    z = xc[..., 2]
    proj = xc[..., :2] / torch.where(z.abs() > 1e-12, z, 1e-12)[..., None]
    err = torch.sum((proj - x) ** 2, -1)
    return torch.where(z > 0, err, 1e12)


# ---------------------------------------------------------------------------
# N-view triangulation (masked) and the pose polish
# ---------------------------------------------------------------------------

def triangulate_nview(R, C, b, mask):
    """Triangulate one point from up to V views. R: (V,3,3), C: (V,3),
    b: (V,3) unit bearings in the camera frames, mask: (V,). Returns
    (X (3,), ok)."""
    d = (R.transpose(-1, -2) @ b[..., None])[..., 0]   # rays in world frame
    w = mask.to(R.dtype)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Ai = (eye[None] - d[:, :, None] * d[:, None, :]) * w[:, None, None]
    A = Ai.sum(0)
    rhs = (Ai @ C[..., None])[..., 0].sum(0)
    X = solve3x3(A + 1e-9 * eye, rhs)
    return X, mask.sum() >= 2


def _pose_residual(dw, dC, R, C, X, xn, w):
    from regard3d_tpu_torch.core import cameras
    Rn = cameras.exp_so3(dw) @ R
    Cn = C + dC
    xc = (X - Cn) @ Rn.T
    z = torch.where(xc[:, 2].abs() > 1e-9, xc[:, 2], 1e-9)
    return (xc[:, :2] / z[:, None] - xn) * w[:, None]


def refine_pose(R, C, X, xn, w, iters: int = 10, damping: float = 1e-6):
    """Gauss–Newton pose polish on weighted 3D-2D correspondences in
    normalized coords. R: (..., 3, 3), C: (..., 3), X: (..., N, 3),
    xn: (..., N, 2), w: (..., N) weights, with one optional leading batch
    dimension. Jacobians by forward mode (``jacfwd``). Returns (R, C)."""
    from regard3d_tpu_torch.core import cameras
    single = R.dim() == 2
    if single:
        R, C, X, xn, w = R[None], C[None], X[None], xn[None], w[None]
    z3 = torch.zeros(3, dtype=X.dtype, device=X.device)
    jac = torch.func.vmap(torch.func.jacfwd(_pose_residual, argnums=(0, 1)),
                          in_dims=(None, None, 0, 0, 0, 0, 0))
    res = torch.func.vmap(_pose_residual, in_dims=(None, None, 0, 0, 0, 0, 0))
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        Jw, JC = jac(z3, z3, R, C, X, xn, w)          # (B, N, 2, 3) each
        B = R.shape[0]
        Jm = torch.cat([Jw.reshape(B, -1, 3), JC.reshape(B, -1, 3)], -1)
        r = res(z3, z3, R, C, X, xn, w).reshape(B, -1)
        H = Jm.transpose(-1, -2) @ Jm + damping * eye6
        g = (Jm.transpose(-1, -2) @ r[..., None])[..., 0]
        d = -torch.linalg.solve_ex(H, g)[0]
        R = cameras.exp_so3(d[:, :3]) @ R
        C = C + d[:, 3:]
    return (R[0], C[0]) if single else (R, C)
