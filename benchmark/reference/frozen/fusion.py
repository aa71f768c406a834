"""Frozen copy of the cross-view check of ``regard3d_tpu_torch/mvs/fusion.py``
and of how ``mvs/driver.fuse_depth_maps`` calls it (commit d22fc76), kept as
the benchmark's reference for which depth-map pixels the dense step's
fusion keeps. Its arithmetic follows the dtype of its inputs (float64 for
the reference): the pixel grid and the constants take the dtype of the
inverse-depth map. Same formulas, same order of operations.

A reference pixel survives where it passed the sweep's score threshold and
its point, back-projected from the view's own inverse depth, lands inside
at least ``min_consistent`` live source views whose own maps agree within
``DEPTH_TOL`` (relative, in inverse depth), on a source pixel whose four
bilinear taps passed the threshold too. The survivors on the ``csize``
grid are the points the view adds to the cloud.
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen.planesweep import bilinear_sample

DEPTH_TOL = 0.01   # densify_scene's depth_tol: fixed, no option sets it


def backproject_grid(idepth: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                     C: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) world points of a whole inverse-depth map."""
    H, W = idepth.shape
    dev, dt = idepth.device, idepth.dtype
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    d = 1.0 / torch.clamp_min(idepth, 1e-9)
    Kinv = torch.linalg.inv(K)
    pix = torch.stack([xs.to(dt), ys.to(dt),
                       torch.ones((H, W), dtype=dt, device=dev)], -1)
    ray = torch.einsum("ij,hwj->hwi", Kinv, pix)
    return C + torch.einsum("ji,hwj->hwi", R, ray * d[..., None])


def consistency_mask(idepth, valid, K, R, C, src_idepths, src_valids,
                     src_Ks, src_Rs, src_Cs, src_live,
                     tol: float = DEPTH_TOL, min_consistent: int = 2):
    """(H, W) bool: the pixels of one reference map that pass the check.
    ``src_*`` stack the ``S`` source views (padded; ``src_live`` marks the
    real ones)."""
    X = backproject_grid(idepth, K, R, C)
    xc = torch.einsum("sij,shwj->shwi", src_Rs,
                      X[None] - src_Cs[:, None, None])     # (S, H, W, 3)
    z = xc[..., 2]
    uvw = torch.einsum("sij,shwj->shwi", src_Ks, xc)
    w = torch.where(torch.abs(uvw[..., 2]) > 1e-9, uvw[..., 2], 1e-9)
    u = uvw[..., 0] / w
    v = uvw[..., 1] / w
    s_id, ok = bilinear_sample(src_idepths, u, v)
    s_ok, _ = bilinear_sample(src_valids.to(idepth.dtype), u, v)
    pid = 1.0 / torch.clamp_min(z, 1e-9)
    agree = torch.abs(s_id - pid) < tol * torch.maximum(s_id, pid)
    votes = (ok & (z > 1e-6) & (s_ok > 0.99) & agree
             & src_live.reshape(-1, 1, 1))
    return valid & (torch.sum(votes.int(), 0) >= min_consistent)
