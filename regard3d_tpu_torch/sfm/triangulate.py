"""Track triangulation over the whole scene in one shot.

Counterpart of ``regard3d_tpu/sfm/triangulate.py``: every active
observation adds its ray's projector (I - d d^T) to its track's 3x3 normal
matrix, one batched 3x3 solve gives every track position, and the
minimum-angle test is a spectral test on the accumulated matrix (nearly
parallel rays make it nearly singular along the mean ray).

The per-track sums go through a ``core.segments`` table built once per run
(``track_id`` never changes), so they are the same bits on every call; pass
it as ``table`` (built from ``track_id`` here when omitted).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from regard3d_tpu_torch.core import cameras
from regard3d_tpu_torch.core.segments import (SegmentTable, make_table,
                                              segment_sum)
from regard3d_tpu_torch.kernels.geometry import eigh3x3


class TriangulationResult(NamedTuple):
    X: torch.Tensor          # (T, 3)
    ok: torch.Tensor         # (T,) bool — >=2 views, conditioned, cheirality
    nviews: torch.Tensor     # (T,) int32 — contributing observations


def track_table(track_id, num_tracks: int, device=None) -> SegmentTable:
    """The per-track reduction table of an observation table."""
    dev = track_id.device if device is None else device
    return make_table(track_id.cpu().numpy(), num_tracks, device=dev)


def triangulate_tracks(R, C, pose_mask, track_id, view_id, obs_active,
                       bearings, num_tracks: int,
                       min_angle_deg: float = 2.0,
                       max_reproj_err: float = 4.0,
                       focal: float = 1000.0,
                       table: Optional[SegmentTable] = None
                       ) -> TriangulationResult:
    """R: (V,3,3), C: (V,3), pose_mask: (V,); per-observation track_id /
    view_id / obs_active: (O,); bearings: (O, 3) unit bearings in their
    camera frame. max_reproj_err in pixels, converted with ``focal``."""
    T = num_tracks
    if table is None:
        table = track_table(track_id, T)
    red = lambda x: segment_sum(x, table)
    act = (obs_active & pose_mask[view_id]).to(R.dtype)           # (O,)
    Rv = R[view_id]
    Cv = C[view_id]
    d = (Rv.transpose(-1, -2) @ bearings[..., None])[..., 0]      # world rays
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P = (eye[None] - d[:, :, None] * d[:, None, :]) * act[:, None, None]
    rhs = (P @ Cv[..., None])[..., 0]

    A = red(P)                                                     # (T, 3, 3)
    b = red(rhs)
    n = red(act)

    X = torch.linalg.solve_ex(A + 1e-9 * eye[None], b)[0]

    # parallax test: for rays spanning angle theta the smallest eigenvalue
    # of A/n is ~ (1 - cos theta); parallel rays give 0
    evals = eigh3x3(A + 1e-12 * eye[None])[0]
    min_eig_needed = 1.0 - math.cos(math.radians(min_angle_deg))
    conditioned = evals.amin(-1) >= min_eig_needed * torch.clamp_min(n, 1.0) \
        * 0.5

    # cheirality + reprojection: every active observation must see X in
    # front and within the angular bound
    xc = ((X[track_id] - Cv)[:, None, :] @ Rv.transpose(-1, -2))[:, 0]
    depth_ok = xc[..., 2] > 1e-6
    proj = xc[..., :2] / torch.where(depth_ok, xc[..., 2], 1.0)[..., None]
    bproj = bearings[..., :2] / torch.clamp_min(bearings[..., 2:], 1e-9)
    err = torch.sum((proj - bproj) ** 2, -1)
    err_ok = err <= (max_reproj_err / focal) ** 2
    obs_ok = torch.where(act > 0, depth_ok & err_ok, True)
    all_ok = red((~obs_ok).to(R.dtype)) == 0

    ok = (n >= 2) & conditioned & all_ok
    return TriangulationResult(X, ok, n.to(torch.int32))


def reprojection_residuals_px(R, C, intr, models, intr_id, view_id, track_id,
                              X, xy):
    """(O,) squared pixel residuals of each observation against its track;
    1e12 behind the camera."""
    params = intr[intr_id]
    model = models[intr_id]
    uv, depth = cameras.project(R[view_id], C[view_id], model, params,
                                X[track_id])
    r2 = torch.sum((uv - xy) ** 2, -1)
    return torch.where(depth > 0, r2, 1e12)
