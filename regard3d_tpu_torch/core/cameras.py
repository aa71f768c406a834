"""Camera models and SO(3) utilities as batched torch functions.

Counterpart of ``regard3d_tpu/core/cameras.py``: the five OpenMVG camera
models of the reference (pinhole, radial-K1, radial-K3, Brown-T2, fisheye)
with distortion and its inverse, projection and bearings, and the SO(3)
helpers every SfM stage needs.

Distortion is a masked blend over the model menu (every polynomial is
evaluated, the model code selects one), so a batch of mixed models — and
``torch.func.vmap`` over one — takes a single code path. Undistortion is a
fixed 10-step fixed-point iteration. Near-zero guards use ``torch.where``
on both branches, as the reference does: forward-mode derivatives
(``torch.func.jacfwd``) take the tangent of the kept branch only.
"""

from __future__ import annotations

import torch

from regard3d_tpu_torch.core.types import (BROWN_T2, FISHEYE, PINHOLE,
                                           RADIAL_K1, RADIAL_K3)

# ---------------------------------------------------------------------------
# SO(3) utilities
# ---------------------------------------------------------------------------


def hat(w):
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def exp_so3(w):
    """Rodrigues: angle-axis (..., 3) -> rotation matrices (..., 3, 3),
    with a series branch near zero."""
    # theta2 keeps a trailing axis: forward-mode AD promotes the tangent of
    # a 0-dim tensor times a Python float to float64
    theta2 = torch.sum(w * w, -1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None] * W + b[..., None] * W2


def rot_to_quat(R):
    """Rotation (..., 3, 3) -> unit quaternion (w, x, y, z), w >= 0
    (Shepperd's method, branch-free)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    sq = lambda v: torch.sqrt(torch.clamp_min(v, 1e-12)) * 2.0
    s0 = sq(1.0 + tr)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = sq(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = sq(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = sq(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q_diag = torch.where(cond1[..., None], q1,
                         torch.where(cond2[..., None], q2, q3))
    q = torch.where((tr > 0.0)[..., None], q0, q_diag)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def log_so3(R):
    """Rotation matrices (..., 3, 3) -> angle-axis (..., 3), via the
    quaternion."""
    q = rot_to_quat(R)
    w = q[..., 0]
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-8, 2.0 / torch.clamp_min(w, 1e-8),
                        theta / torch.clamp_min(vn, 1e-32))
    return v * scale[..., None]


def quat_to_rot(q):
    """Unit quaternion (w, x, y, z) (..., 4) -> rotation (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def project_so3(M):
    """Nearest rotation matrix via SVD (orthogonal Procrustes)."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (U * D[..., None, :]) @ Vt


# ---------------------------------------------------------------------------
# Distortion — normalized camera coordinates in/out
# ---------------------------------------------------------------------------

def _disto_all_models(params, xu):
    """Distorted coords under every model. xu: (..., 2); params (..., 9)
    broadcastable against xu's batch dims. Returns {model: (..., 2)}."""
    d = params[..., 3:]
    x, y = xu[..., 0], xu[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    out = {PINHOLE: xu,
           RADIAL_K1: xu * (1.0 + d[..., 0] * r2)[..., None]}
    radial3 = 1.0 + d[..., 0] * r2 + d[..., 1] * r4 + d[..., 2] * r6
    out[RADIAL_K3] = xu * radial3[..., None]
    # Brown T2: radial K3 + tangential (t1=d3, t2=d4)
    t1, t2 = d[..., 3], d[..., 4]
    tx = 2.0 * t1 * x * y + t2 * (r2 + 2.0 * x * x)
    ty = t1 * (r2 + 2.0 * y * y) + 2.0 * t2 * x * y
    out[BROWN_T2] = torch.stack([x * radial3 + tx, y * radial3 + ty], -1)
    # Fisheye: theta polynomial (k1..k4)
    r = torch.sqrt(r2 + 1e-32)
    theta = torch.atan(r)
    th2 = theta * theta
    theta_d = theta * (1.0 + d[..., 0] * th2 + d[..., 1] * th2 ** 2
                       + d[..., 2] * th2 ** 3 + d[..., 3] * th2 ** 4)
    inv_r = torch.where(r > 1e-8, 1.0 / r, 1.0)
    cdist = torch.where(r > 1e-8, theta_d * inv_r, 1.0)
    out[FISHEYE] = xu * cdist[..., None]
    return out


def add_disto(model, params, xu):
    """Apply distortion. model: (...,) int (broadcast), params (..., 9),
    xu (..., 2) normalized undistorted -> distorted."""
    outs = _disto_all_models(params, xu)
    res = outs[PINHOLE]
    for code in (RADIAL_K1, RADIAL_K3, BROWN_T2, FISHEYE):
        res = torch.where((model == code)[..., None], outs[code], res)
    return res


def remove_disto(model, params, xd, iters: int = 10):
    """Invert distortion by fixed-point iteration: xd (..., 2) distorted ->
    undistorted."""
    xu = xd
    for _ in range(iters):
        xu = xu + (xd - add_disto(model, params, xu))
    return xu


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def cam_to_image(params, xn):
    """Normalized (distorted) coords -> pixels. params (..., 9)."""
    return xn * params[..., 0:1] + params[..., 1:3]


def image_to_cam(params, uv):
    return (uv - params[..., 1:3]) / params[..., 0:1]


def undistort_pixel(model, params, uv, iters: int = 10):
    """Pixel -> undistorted pixel."""
    xn = image_to_cam(params, uv)
    return cam_to_image(params, remove_disto(model, params, xn, iters))


def distort_pixel(model, params, uv):
    xn = image_to_cam(params, uv)
    return cam_to_image(params, add_disto(model, params, xn))


def world_to_cam(R, C, X):
    """x_cam = R @ (X - C). R: (..., 3, 3), C: (..., 3), X: (..., 3)."""
    return (R @ (X - C)[..., None])[..., 0]


def project(R, C, model, params, X):
    """World point -> pixel. Returns (uv, depth)."""
    xc = world_to_cam(R, C, X)
    depth = xc[..., 2]
    den = torch.where(depth.abs() > 1e-12, depth, 1e-12)
    xn = xc[..., :2] / den[..., None]
    xd = add_disto(model, params, xn)
    return cam_to_image(params, xd), depth


def reprojection_residual(R, C, model, params, X, uv):
    """Residual in pixels (..., 2)."""
    proj, _ = project(R, C, model, params, X)
    return proj - uv


def bearing(model, params, uv, iters: int = 10):
    """Pixel -> unit bearing vector in the camera frame."""
    xn = image_to_cam(params, uv)
    xu = remove_disto(model, params, xn, iters)
    v = torch.cat([xu, torch.ones_like(xu[..., :1])], -1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)
