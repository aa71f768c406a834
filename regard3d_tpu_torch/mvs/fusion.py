"""Depth-map consistency filtering and fusion into a dense colored cloud.

Counterpart of ``regard3d_tpu/mvs/fusion.py``. Plays the role of PMVS's
patch filtering + the reference's cluster-cloud combine step
(``src/R3DModelOperations.cpp:53-168``): a depth-map pixel survives only if
its 3D point reprojects into at least ``min_consistent`` source views whose
own plane-sweep depths agree (relative inverse-depth tolerance), mirroring
PMVS's ``minImageNum`` visibility rule (src/R3DProject.h:208). Survivors are
back-projected on the ``csize`` grid into a colored, normal-oriented point
cloud. The per-source check runs over a batched source axis; each function
runs on the device of its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from regard3d_tpu_torch.mvs.planesweep import bilinear_sample, box_sum


def backproject_grid(idepth: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                     C: torch.Tensor) -> torch.Tensor:
    """Back-project a full depth map to world points. Returns (H, W, 3)."""
    H, W = idepth.shape
    dev = idepth.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    d = 1.0 / torch.clamp_min(idepth, 1e-9)
    Kinv = torch.linalg.inv(K)
    pix = torch.stack([xs.float(), ys.float(),
                       torch.ones((H, W), device=dev)], -1)
    ray = torch.einsum("ij,hwj->hwi", Kinv, pix)
    return C + torch.einsum("ji,hwj->hwi", R, ray * d[..., None])


def consistency_mask(idepth: torch.Tensor, valid: torch.Tensor,
                     K: torch.Tensor, R: torch.Tensor, C: torch.Tensor,
                     src_idepths: torch.Tensor, src_valids: torch.Tensor,
                     src_Ks: torch.Tensor, src_Rs: torch.Tensor,
                     src_Cs: torch.Tensor, src_live: torch.Tensor,
                     tol: float = 0.01, min_consistent: int = 2):
    """Geometric cross-view check for one reference depth map.

    Args:
      idepth/valid: (H, W) reference inverse depth + photometric mask.
      src_idepths/src_valids: (S, H, W) source depth maps.
      src_Ks/src_Rs/src_Cs: (S, 3, 3) / (S, 3, 3) / (S, 3) source cameras.
      src_live: (S,) bool — live sources.
    Returns (accept, X): (H, W) bool and (H, W, 3) world points.
    """
    X = backproject_grid(idepth, K, R, C)
    xc = torch.einsum("sij,shwj->shwi", src_Rs,
                      X[None] - src_Cs[:, None, None])     # (S, H, W, 3)
    z = xc[..., 2]
    uvw = torch.einsum("sij,shwj->shwi", src_Ks, xc)
    w = torch.where(torch.abs(uvw[..., 2]) > 1e-9, uvw[..., 2], 1e-9)
    u = uvw[..., 0] / w
    v = uvw[..., 1] / w
    s_id, ok = bilinear_sample(src_idepths, u, v)
    s_ok, _ = bilinear_sample(src_valids.float(), u, v)
    pid = 1.0 / torch.clamp_min(z, 1e-9)
    agree = torch.abs(s_id - pid) < tol * torch.maximum(s_id, pid)
    votes = (ok & (z > 1e-6) & (s_ok > 0.99) & agree
             & src_live.reshape(-1, 1, 1))
    accept = valid & (torch.sum(votes.int(), 0) >= min_consistent)
    return accept, X


def grid_normals(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Per-pixel normals from the back-projected point grid (H, W, 3),
    oriented toward the camera center (PMVS patch-normal convention).
    Central differences inside, one-sided at the edges (numpy's rule)."""
    dXu = torch.gradient(X, dim=1, edge_order=1)[0]
    dXv = torch.gradient(X, dim=0, edge_order=1)[0]
    n = torch.linalg.cross(dXv, dXu, dim=-1)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True),
                            1e-12)
    flip = torch.sum(n * (C - X), -1, keepdim=True) < 0
    return torch.where(flip, -n, n)


def smoothed_normals(idepth: torch.Tensor, valid: torch.Tensor,
                     K: torch.Tensor, R: torch.Tensor, C: torch.Tensor,
                     w: int = 7) -> torch.Tensor:
    """Normals from a validity-weighted box-smoothed depth map — the
    sub-plane refinement noise of the sweep is at the single-plane scale,
    far above what raw 1-px finite differences tolerate (PMVS fits a patch
    plane over wsize² samples for the same reason)."""
    vf = valid.float()
    num = box_sum(idepth * vf, w)
    den = torch.clamp_min(box_sum(vf, w), 1.0)
    id_s = torch.where(den > 0.5, num / den, idepth)
    return grid_normals(backproject_grid(id_s, K, R, C), C)


def fuse_points(accept: np.ndarray, X: np.ndarray, normals: np.ndarray,
                rgb: np.ndarray, csize: int = 2):
    """Host-side assembly: accepted pixels on the csize grid ->
    (xyz, normal, color) arrays."""
    acc = np.asarray(accept)[::csize, ::csize]
    Xg = np.asarray(X)[::csize, ::csize]
    Ng = np.asarray(normals)[::csize, ::csize]
    Cg = np.asarray(rgb)[::csize, ::csize]
    m = acc.reshape(-1)
    return (Xg.reshape(-1, 3)[m], Ng.reshape(-1, 3)[m],
            Cg.reshape(-1, 3)[m])
