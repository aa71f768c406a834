"""Frozen copy of ``regard3d_tpu_torch/mvs/planesweep.py`` (commit d22fc76),
kept as the benchmark's reference for the dense step's sweep. Its
arithmetic follows the dtype of its inputs (float64 for the reference,
float32 for the control): the pixel grid, the masks and the constants take
the dtype of the reference image. Same formulas, same order of operations,
same chunked layout of the plane axis; the parameter dataclass is cut.

Plane-sweep depth maps: per reference view a cost volume is built by
homography-warping the source views onto a stack of fronto-parallel,
inverse-depth-uniform planes, scoring ZNCC over a window, averaging the
best ``top_k`` source costs, and taking the winner with sub-plane parabolic
refinement. The warp is an explicit four-tap bilinear gather; the ZNCC
windows are SAME-padded, zero-filled separable box sums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

AGG_TOP_K = 3    # PlaneSweepParams.agg_top_k: fixed, no option sets it


def box_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Windowed sum with SAME zero padding over the last two axes: a
    vertical then a horizontal pass, each summing the ``w`` taps."""
    p = w // 2
    y = F.pad(x, (0, 0, p, p)).unfold(-2, w, 1).sum(-1)
    return F.pad(y, (p, p)).unfold(-1, w, 1).sum(-1)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample ``img`` at float pixel coords; returns (values, in-bounds).
    ``img`` is (H, W) with coords of any shape, or (B, H, W) with coords
    (B, ...) sampling image b at row b. Out-of-bounds samples are masked;
    indices are clipped before the gather."""
    H, W = img.shape[-2:]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(torch.nan_to_num(x0), 0, W - 2).long()
    y0i = torch.clamp(torch.nan_to_num(y0), 0, H - 2).long()
    idx = y0i * W + x0i
    if img.dim() == 2:
        flat = img.reshape(-1)
        tap = lambda o: flat[idx + o]
    else:
        B = img.shape[0]
        flat = img.reshape(B, -1)
        tap = lambda o: torch.gather(flat, 1, (idx + o).reshape(B, -1)
                                     ).reshape(idx.shape)
    v00, v01, v10, v11 = tap(0), tap(1), tap(W), tap(W + 1)
    val = ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v01
           + (1 - fx) * fy * v10 + fx * fy * v11)
    ok = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return val, ok


def plane_homographies(K_ref, R_ref, C_ref, K_src, R_src, C_src,
                       depths) -> np.ndarray:
    """(S, D, 3, 3) float64 homographies from reference pixels to source
    pixels for the planes z = d of the reference camera (x_cam = R (X - C):
    ``K_s (R_rel + t_rel n^T / d) K_r^{-1}``, normalised to H[2, 2] = 1)."""
    R_src = np.atleast_3d(R_src).reshape(-1, 3, 3)
    C_src = np.asarray(C_src).reshape(-1, 3)
    K_src = np.asarray(K_src).reshape(-1, 3, 3)
    S = R_src.shape[0]
    D = len(depths)
    Kri = np.linalg.inv(K_ref)
    out = np.zeros((S, D, 3, 3))
    for s in range(S):
        R_rel = R_src[s] @ R_ref.T
        t_rel = R_src[s] @ (C_ref - C_src[s])
        for k, d in enumerate(depths):
            Hm = K_src[s] @ (R_rel + np.outer(t_rel, [0.0, 0.0, 1.0]) / d) @ Kri
            out[s, k] = Hm / Hm[2, 2]
    return out


def inverse_depth_planes(dmin: float, dmax: float, n: int) -> np.ndarray:
    """Inverse-depth-uniform depth hypotheses, nearest first."""
    return 1.0 / np.linspace(1.0 / dmax, 1.0 / dmin, n)[::-1]


def sweep(ref: torch.Tensor, srcs: torch.Tensor, src_valid: torch.Tensor,
          homos: torch.Tensor, idepths: torch.Tensor,
          wsize: int = 7, top_k: int = AGG_TOP_K, chunk: int = 8):
    """Plane-sweep one reference view on the device of its inputs.

    ref (H, W), srcs (S, H, W), src_valid (S,) bool, homos (S, D, 3, 3),
    idepths (D,), all floating inputs in one dtype. Returns (idepth, ncc):
    (H, W) refined inverse depth and best aggregated NCC score."""
    H, W = ref.shape
    S, D = homos.shape[0], homos.shape[1]
    if D % chunk:
        raise ValueError("num_planes must be divisible by plane_chunk")
    dt = ref.dtype

    norm = torch.rsqrt(torch.mean(torch.square(ref - torch.mean(ref)))
                       + 1e-20)
    ref = ref * norm
    srcs = srcs * norm

    dev = ref.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs.to(dt), ys.to(dt),
                       torch.ones((H, W), dtype=dt, device=dev)],
                      0).reshape(3, H * W)            # (3, HW)

    w2 = float(wsize * wsize)
    s_r = box_sum(ref, wsize)
    s_rr = box_sum(ref * ref, wsize)
    var_r = torch.clamp_min(s_rr - s_r * s_r / w2, 0.0)
    textured = var_r > 1e-8 * w2
    live = src_valid.reshape(S, 1, 1, 1)

    def chunk_costs(hs):
        q = hs @ pix                                  # (S, chunk, 3, HW)
        zs = q[:, :, 2]
        sx = (q[:, :, 0] / zs).reshape(S, -1, H, W)
        sy = (q[:, :, 1] / zs).reshape(S, -1, H, W)
        warped, ok = bilinear_sample(srcs, sx, sy)
        ok = ok & (zs.reshape(S, -1, H, W) > 1e-6) & live
        warped = torch.where(ok, warped, 0.0)
        okf = ok.to(dt)
        n = box_sum(okf, wsize)
        s_s = box_sum(warped, wsize)
        s_ss = box_sum(warped * warped, wsize)
        s_rs = box_sum(ref * okf * warped, wsize)
        sr_loc = box_sum(ref * okf, wsize)
        srr_loc = box_sum(ref * ref * okf, wsize)
        nn = torch.clamp_min(n, 1.0)
        cov = s_rs - sr_loc * s_s / nn
        var_rl = torch.clamp_min(srr_loc - sr_loc * sr_loc / nn, 0.0)
        var_s = torch.clamp_min(s_ss - s_s * s_s / nn, 0.0)
        ncc = cov * torch.rsqrt(var_rl * var_s + 1e-9)
        enough = n >= 0.75 * w2
        costs = torch.where(enough & textured, 1.0 - ncc, 2.0)
        best = torch.topk(costs, top_k, dim=0, largest=False).values
        return torch.mean(best, 0)

    vol = torch.cat([chunk_costs(homos[:, c:c + chunk])
                     for c in range(0, D, chunk)])    # (D, H, W)

    best = torch.argmin(vol, 0)
    c1 = torch.amin(vol, 0)
    c0 = torch.gather(vol, 0, torch.clamp_min(best - 1, 0)[None])[0]
    c2 = torch.gather(vol, 0, torch.clamp_max(best + 1, D - 1)[None])[0]
    denom = c0 - 2.0 * c1 + c2
    big = torch.abs(denom) > 1e-9
    offset = torch.where(big, 0.5 * (c0 - c2)
                         / torch.where(big, denom, 1.0), 0.0)
    offset = torch.clamp(offset, -0.5, 0.5)
    did = idepths[1] - idepths[0]
    idepth = idepths[best] + offset * did
    return idepth, 1.0 - c1
