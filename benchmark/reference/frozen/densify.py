"""Frozen copy of the host side of ``regard3d_tpu_torch/mvs/driver.py``
(commit d22fc76), kept as the benchmark's reference for what the dense step
derives from its inputs before it sweeps: the posed views, each view's
level-scaled intrinsics, its ranked source views, its depth range and
planes, and its gray image at the sweep's level.

It reads a ``scene.npz``'s arrays as saved (``{"<group>.<field>": array}``)
and keeps the program's arithmetic and dtypes wherever the result is a
choice (which views are sources, where the planes lie, which source pixel
an undistorted pixel takes), so that a float64 sweep on these inputs is the
program's sweep in higher precision and nothing else. Only the pinhole
camera model is kept (the configurations state it).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

PINHOLE = 0


def posed_views(z: Dict[str, np.ndarray]) -> List[int]:
    vm = np.asarray(z["views.mask"], bool)
    pm = np.asarray(z["poses.mask"], bool)
    pid = np.asarray(z["views.pose_id"])
    return [int(v) for v in np.nonzero(vm)[0] if pm[pid[v]]]


def pose(z: Dict[str, np.ndarray], view: int):
    """(R, C) of ``view``: x_cam = R (X - C)."""
    p = int(np.asarray(z["views.pose_id"])[view])
    return np.asarray(z["poses.R"])[p], np.asarray(z["poses.C"])[p]


def K_for(z: Dict[str, np.ndarray], view: int, level: int) -> np.ndarray:
    k = int(np.asarray(z["views.intrinsic_id"])[view])
    p = np.asarray(z["intrinsics.params"])[k]
    s = 1.0 / (2 ** level)
    return np.array([[p[0] * s, 0.0, (p[1] + 0.5) * s - 0.5],
                     [0.0, p[0] * s, (p[2] + 0.5) * s - 0.5],
                     [0.0, 0.0, 1.0]])


def select_sources(z: Dict[str, np.ndarray], num_sources: int,
                   min_angle_deg: float = 2.0) -> Dict[int, List[int]]:
    """Per-view source ranking by shared-landmark count x angle weight."""
    obs_l = np.asarray(z["observations.landmark_id"])
    obs_v = np.asarray(z["observations.view_id"])
    obs_m = np.asarray(z["observations.mask"])
    lm_X = np.asarray(z["landmarks.X"])
    lm_m = np.asarray(z["landmarks.mask"])
    pid = np.asarray(z["views.pose_id"])
    C = np.asarray(z["poses.C"])

    live = obs_m & lm_m[obs_l]
    obs_l, obs_v = obs_l[live], obs_v[live]
    views = posed_views(z)
    nv = len(views)
    compact = np.full(len(np.asarray(z["views.mask"])), -1, np.int64)
    compact[views] = np.arange(nv)
    Cv = C[pid[views]]

    cidx_all = compact[obs_v]
    keep = cidx_all >= 0
    obs_l, cidx = obs_l[keep], cidx_all[keep]
    order = np.argsort(obs_l, kind="stable")
    obs_l, cidx = obs_l[order], cidx[order]

    score = np.zeros((nv, nv))
    if len(obs_l):
        max_k = int(np.bincount(obs_l).max())
        for d in range(1, max_k):
            sel = np.nonzero(obs_l[:-d] == obs_l[d:])[0] if d < len(obs_l) \
                else np.zeros(0, np.int64)
            if len(sel) == 0:
                continue
            a, b = cidx[sel], cidx[sel + d]
            X = lm_X[obs_l[sel]]
            r1 = Cv[a] - X
            r2 = Cv[b] - X
            denom = np.maximum(np.linalg.norm(r1, axis=1)
                               * np.linalg.norm(r2, axis=1), 1e-12)
            cosang = np.clip(np.sum(r1 * r2, 1) / denom, -1.0, 1.0)
            ang = np.degrees(np.arccos(cosang))
            w = np.minimum(ang / min_angle_deg, 1.0)
            np.add.at(score, (a, b), w)
            np.add.at(score, (b, a), w)

    out = {}
    for i, v in enumerate(views):
        ranked = np.argsort(-score[i])
        out[v] = [views[j] for j in ranked if score[i, j] > 0][:num_sources]
    return out


def depth_range(z: Dict[str, np.ndarray], view: int) -> Optional[tuple]:
    """Near and far of the view's sweep from the sparse landmarks it sees
    (the 2nd and 98th percentiles of their depths, widened 4x and 2x)."""
    obs_v = np.asarray(z["observations.view_id"])
    obs_l = np.asarray(z["observations.landmark_id"])
    obs_m = np.asarray(z["observations.mask"])
    lm_m = np.asarray(z["landmarks.mask"])
    sel = obs_m & (obs_v == view) & lm_m[obs_l]
    if sel.sum() < 5:
        return None
    X = np.asarray(z["landmarks.X"])[obs_l[sel]]
    R, C = pose(z, view)
    depth = (X - C) @ R[2]
    depth = depth[depth > 1e-6]
    if len(depth) < 5:
        return None
    lo, hi = np.percentile(depth, [2, 98])
    return max(0.25 * lo, 1e-3), 2.0 * hi


def undistort_index(z: Dict[str, np.ndarray], view: int, h: int, w: int,
                    device):
    """(row index, column index, inside) of the source pixel each output
    pixel takes (nearest), in the program's arithmetic: the pixel mapped to
    normalised coordinates and back through the view's pinhole."""
    iid = int(np.asarray(z["views.intrinsic_id"])[view])
    if int(np.asarray(z["intrinsics.model"])[iid]) != PINHOLE:
        raise ValueError("the reference keeps the pinhole model only")
    params = torch.as_tensor(np.asarray(z["intrinsics.params"])[iid],
                             device=device)
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    uv = torch.stack([xx, yy], -1).reshape(-1, 2)
    xn = (uv - params[1:3]) / params[0:1]
    src = (xn * params[0:1] + params[1:3]).cpu().numpy().reshape(h, w, 2)
    x0 = np.clip(np.round(src[..., 0]).astype(int), 0, w - 1)
    y0 = np.clip(np.round(src[..., 1]).astype(int), 0, h - 1)
    inside = ((src[..., 0] >= 0) & (src[..., 0] <= w - 1)
              & (src[..., 1] >= 0) & (src[..., 1] <= h - 1))
    return y0, x0, inside


def gray_at_level(z: Dict[str, np.ndarray], view: int, rgb: np.ndarray,
                  level: int, device, dtype=np.float64) -> np.ndarray:
    """The view's gray image as the sweep takes it: ``rgb`` (H, W, 3) in
    [0, 1] undistorted (nearest), box-halved ``level`` times, then
    luma-weighted, padded to a multiple of 32, in ``dtype``."""
    h, w = rgb.shape[:2]
    y0, x0, inside = undistort_index(z, view, h, w, device)
    und = np.asarray(rgb, dtype)[y0, x0]
    und[~inside] = 0
    for _ in range(level):
        h2, w2 = und.shape[0] // 2 * 2, und.shape[1] // 2 * 2
        und = 0.25 * (und[0:h2:2, 0:w2:2] + und[1:h2:2, 0:w2:2]
                      + und[0:h2:2, 1:w2:2] + und[1:h2:2, 1:w2:2])
    g = 0.299 * und[..., 0] + 0.587 * und[..., 1] + 0.114 * und[..., 2]
    H = -(-g.shape[0] // 32) * 32
    W = -(-g.shape[1] // 32) * 32
    return np.pad(g, ((0, H - g.shape[0]), (0, W - g.shape[1])))
