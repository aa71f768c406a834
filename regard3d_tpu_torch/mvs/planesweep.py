"""Dense multi-view stereo: plane-sweep depth maps.

Counterpart of ``regard3d_tpu/mvs/planesweep.py``. The reference replaces
the external CMVS/PMVS2 densifier (``src/R3DDensificationProcess.cpp:
105-183``) with an in-process sweep: per reference view, a cost volume is
built by homography-warping the source views onto a stack of
fronto-parallel (inverse-depth-uniform) planes, scoring ZNCC over a window,
aggregating the best-k source costs, and taking the winner with sub-plane
parabolic refinement.

As batched torch ops:

* the warp is an explicit four-tap bilinear gather over a ``(sources,
  planes)`` batch (not ``grid_sample``: its border and ``align_corners``
  rules differ from the reference's clip-and-mask);
* ZNCC windows are SAME-padded, zero-filled separable box sums (two
  windowed passes; a prefix-sum difference would cancel catastrophically
  in f32 on large images, and the ZNCC variances are differences of such
  sums);
* the depth axis runs in chunks of ``(sources, chunk, H, W)`` work in a
  host loop (the reference's ``lax.scan``) to bound device memory.

Parameter parity with the PMVS option file written by the reference
(``src/utils/OpenMVGHelper.cpp:489-952``): ``level``, ``csize``,
``threshold``, ``wsize``, ``minImageNum`` (enforced in
:mod:`regard3d_tpu_torch.mvs.fusion`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PlaneSweepParams:
    """Knobs, mirroring the reference's PMVS parameter surface
    (src/R3DProject.h:201-213 pmvs* members)."""

    level: int = 1            # pyramid level: images downsampled 2^level
    num_planes: int = 96      # depth hypotheses (inverse-depth uniform)
    wsize: int = 7            # ZNCC window (PMVS wsize default 7)
    threshold: float = 0.7    # NCC acceptance (PMVS threshold default 0.7)
    num_sources: int = 6      # source views per reference view
    agg_top_k: int = 3        # best-k source aggregation per pixel
    plane_chunk: int = 8      # depth planes warped per step (memory bound)


def box_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Windowed sum with SAME zero padding over the last two axes: a
    vertical then a horizontal pass, each summing the ``w`` taps of a
    window (``lax.reduce_window`` in the reference)."""
    p = w // 2
    y = F.pad(x, (0, 0, p, p)).unfold(-2, w, 1).sum(-1)
    return F.pad(y, (p, p)).unfold(-1, w, 1).sum(-1)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample ``img`` at float pixel coords; returns (values, in-bounds).

    ``img`` is (H, W) with coords of any shape, or (B, H, W) with coords
    (B, ...) sampling image b at row b. Out-of-bounds samples are masked,
    not clamped-and-trusted. Indices are clipped before the gather, so
    non-finite coords read a valid texel (and are masked by ``ok``)."""
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


def plane_homographies(K_ref: np.ndarray, R_ref: np.ndarray,
                       C_ref: np.ndarray, K_src: np.ndarray,
                       R_src: np.ndarray, C_src: np.ndarray,
                       depths: np.ndarray) -> np.ndarray:
    """Homographies mapping reference pixels to source pixels for the
    fronto-parallel plane z=d in the reference camera frame.

    With the OpenMVG pose convention x_cam = R (X - C):
    ``x_s = R_rel x_r + t_rel`` where ``R_rel = R_s R_r^T`` and
    ``t_rel = R_s (C_r - C_s)``; for the plane n=[0,0,1], n.x_r = d the
    induced homography is ``K_s (R_rel + t_rel n^T / d) K_r^{-1}``.

    Shapes: R_src/C_src/K_src may carry a leading source axis S;
    depths (D,).  Returns (S, D, 3, 3) float64 (host-side tiny math)."""
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
    """Inverse-depth-uniform hypotheses (near planes denser — matching the
    pixel-displacement metric of the sweep)."""
    return 1.0 / np.linspace(1.0 / dmax, 1.0 / dmin, n)[::-1]


def sweep(ref: torch.Tensor, srcs: torch.Tensor, src_valid: torch.Tensor,
          homos: torch.Tensor, idepths: torch.Tensor,
          wsize: int = 7, top_k: int = 3, chunk: int = 8):
    """Plane-sweep one reference view, on the device of its inputs.

    Args:
      ref: (H, W) float32 grayscale reference image.
      srcs: (S, H, W) float32 source images (padded; see src_valid).
      src_valid: (S,) bool — live sources (padding rows scored out).
      homos: (S, D, 3, 3) float32 ref-pixel -> src-pixel homographies.
      idepths: (D,) float32 inverse depths of the planes (uniform grid).
      wsize/top_k/chunk: window, best-k aggregation, planes per step.

    Returns (idepth, ncc): (H, W) refined inverse depth and best aggregated
    NCC score in [-1, 1] (confidence; threshold outside).
    """
    H, W = ref.shape
    S, D = homos.shape[0], homos.shape[1]
    if D % chunk:
        raise ValueError("num_planes must be divisible by plane_chunk")

    # scale-invariance guard: normalize photometry so the small epsilons in
    # the ZNCC denominators and the texturedness gate are meaningful for any
    # input range (uint8-scaled, [0,1] floats, raw sensor values, ...)
    norm = torch.rsqrt(torch.mean(torch.square(ref - torch.mean(ref)))
                       + 1e-20)
    ref = ref * norm
    srcs = srcs * norm

    dev = ref.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs.float(), ys.float(), torch.ones((H, W), device=dev)
                       ], 0).reshape(3, H * W)        # (3, HW)

    w2 = float(wsize * wsize)
    s_r = box_sum(ref, wsize)
    s_rr = box_sum(ref * ref, wsize)
    var_r = torch.clamp_min(s_rr - s_r * s_r / w2, 0.0)
    textured = var_r > 1e-8 * w2
    live = src_valid.reshape(S, 1, 1, 1)

    def chunk_costs(hs):
        """Aggregated cost (chunk, H, W) over sources for planes ``hs``
        (S, chunk, 3, 3): the ZNCC cost of every (source, plane) pair."""
        q = hs @ pix                                  # (S, chunk, 3, HW)
        zs = q[:, :, 2]
        sx = (q[:, :, 0] / zs).reshape(S, -1, H, W)
        sy = (q[:, :, 1] / zs).reshape(S, -1, H, W)
        warped, ok = bilinear_sample(srcs, sx, sy)
        ok = ok & (zs.reshape(S, -1, H, W) > 1e-6) & live
        warped = torch.where(ok, warped, 0.0)
        okf = ok.float()
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
        costs = torch.where(enough & textured, 1.0 - ncc, 2.0)  # [0, 2]
        # best-k mean over the source axis (ascending, so the sum runs in
        # the reference's order; ties do not change the values)
        best = torch.topk(costs, top_k, dim=0, largest=False).values
        return torch.mean(best, 0)

    vol = torch.cat([chunk_costs(homos[:, c:c + chunk])
                     for c in range(0, D, chunk)])    # (D, H, W)

    best = torch.argmin(vol, 0)                       # first minimum
    c1 = torch.amin(vol, 0)
    c0 = torch.gather(vol, 0, torch.clamp_min(best - 1, 0)[None])[0]
    c2 = torch.gather(vol, 0, torch.clamp_max(best + 1, D - 1)[None])[0]
    denom = c0 - 2.0 * c1 + c2
    big = torch.abs(denom) > 1e-9
    offset = torch.where(big, 0.5 * (c0 - c2)
                         / torch.where(big, denom, 1.0), 0.0)
    offset = torch.clamp(offset, -0.5, 0.5)
    did = idepths[1] - idepths[0]                     # uniform grid step
    idepth = idepths[best] + offset * did
    return idepth, 1.0 - c1
