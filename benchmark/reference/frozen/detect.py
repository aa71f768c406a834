"""Frozen copy of ``regard3d_tpu_torch/kernels/detect.py`` (commit 794b6e4),
the plain PyTorch path, kept as the benchmark's reference: imports redirected to this folder.
Its arithmetic follows the dtype of its inputs (float64 for the
reference, float32 for the control).

AKAZE (Fast-AKAZE path) feature detection on the nonlinear scale space.

Counterpart of ``regard3d_tpu/kernels/detect.py``: determinant-of-Hessian
responses, strict 3x3 NMS, cross-level suppression by circular max over
candidate maps, per-octave keypoint extraction with a static capacity,
subpixel refinement and the gauss25-weighted orientation.

``lax.top_k`` keeps the lower index on ties; ``torch.topk`` promises no tie
order, so every top-k here is a stable descending sort, sliced.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.frozen.types import Keypoints
from benchmark.reference.frozen import scale_space as ss

# gauss25 weight table (AKAZEConfig.h:38-46)
GAUSS25 = np.array([
    [0.02546481, 0.02350698, 0.01849125, 0.01239505, 0.00708017, 0.00344629, 0.00142946],
    [0.02350698, 0.02169968, 0.01706957, 0.01144208, 0.00653582, 0.00318132, 0.00131956],
    [0.01849125, 0.01706957, 0.01342740, 0.00900066, 0.00514126, 0.00250252, 0.00103800],
    [0.01239505, 0.01144208, 0.00900066, 0.00603332, 0.00344629, 0.00167749, 0.00069579],
    [0.00708017, 0.00653582, 0.00514126, 0.00344629, 0.00196855, 0.00095820, 0.00039744],
    [0.00344629, 0.00318132, 0.00250252, 0.00167749, 0.00095820, 0.00046640, 0.00019346],
    [0.00142946, 0.00131956, 0.00103800, 0.00069579, 0.00039744, 0.00019346, 0.00008024],
], np.float32)

SMAX_MLDB = 10.0 * math.sqrt(2.0)   # descriptor-border margin


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis; ties keep
    the lower index (lax.top_k semantics)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def det_hessian(levels: List[ss.Evolution]):
    """Per-level determinant-of-Hessian responses + the scaled first
    derivatives used for orientation. Returns (ldet, lx, ly) lists."""
    ldets, lxs, lys = [], [], []
    for lv in levels:
        s = max(lv.meta.sigma_size, 1)
        lx = ss.scharr(lv.Lsmooth, 1, 0, s)
        ly = ss.scharr(lv.Lsmooth, 0, 1, s)
        lxx = ss.scharr(lx, 1, 0, s)
        lxy = ss.scharr(lx, 0, 1, s)
        lyy = ss.scharr(ly, 0, 1, s)
        s2 = float(s * s)
        ldets.append((lxx * lyy - lxy * lxy) * (s2 * s2))
        lxs.append(lx * float(s))
        lys.append(ly * float(s))
    return ldets, lxs, lys


def _nms3x3(r, threshold: float, min_threshold: float):
    """Strict 3x3 local max above threshold; 1-px border excluded."""
    B, H, W = r.shape
    p = F.pad(r, (1, 1, 1, 1), value=-math.inf)
    nmax = None
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            s = p[:, dy:dy + H, dx:dx + W]
            nmax = s if nmax is None else torch.maximum(nmax, s)
    mask = (r > nmax) & (r > threshold) & (r >= min_threshold)
    border = torch.zeros((H, W), dtype=torch.bool, device=r.device)
    border[1:-1, 1:-1] = True
    return mask & border[None]


def _window_max(r, radius: int):
    """Square-window max with -inf outside."""
    if radius <= 0:
        return r
    k = 2 * radius + 1
    return F.max_pool2d(r[:, None], k, stride=1, padding=radius)[:, 0]


def _row_max(r, lo: int, hi: int):
    """out[x] = max_{d in [lo, hi]} r[x + d] (inclusive), -inf outside."""
    if lo > hi:
        return torch.full_like(r, -math.inf)
    k = hi - lo + 1
    p = F.pad(r, (-lo, hi), value=-math.inf)
    return F.max_pool2d(p[:, None], (1, k), stride=1)[:, 0]


def _shift_rows(r, dy: int):
    """out[y] = r[y + dy], -inf fill."""
    if dy == 0:
        return r
    B, H, W = r.shape
    pad = torch.full((B, abs(dy), W), -math.inf, dtype=r.dtype,
                     device=r.device)
    if dy > 0:
        return torch.cat([r[:, dy:], pad], dim=1)
    return torch.cat([pad, r[:, :dy]], dim=1)


def _circular_max(r, radius: float):
    """Max over the disc of offsets dy^2 + dx^2 <= radius^2."""
    R = int(math.floor(radius))
    out = None
    for dy in range(-R, R + 1):
        rem = radius * radius - dy * dy
        if rem < 0:
            continue
        kx = int(math.floor(math.sqrt(rem)))
        row = _shift_rows(_row_max(r, -kx, kx), dy)
        out = row if out is None else torch.maximum(out, row)
    if out is None:
        out = torch.full_like(r, -math.inf)
    return out


def _upsample2_nearest(r):
    return r.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _downsample2_max(r):
    B, H, W = r.shape
    return r.reshape(B, H // 2, 2, W // 2, 2).amax((2, 4))


def find_extrema(levels: List[ss.Evolution], ldets,
                 cfg: ss.ScaleSpaceConfig):
    """Scale-space extrema with cross-level suppression (the reference's
    vectorized restatement of AKAZE's greedy keypoint-list duels).
    Returns per-level boolean masks of surviving candidates."""
    nlev = len(levels)
    cand = []
    for ldet in ldets:
        m = _nms3x3(ldet, cfg.dthreshold, cfg.min_dthreshold)
        cand.append(torch.where(m, ldet, 0.0))

    def radius_of(i):
        m = levels[i].meta
        return max(m.esigma * cfg.derivative_factor / m.ratio, 1.0)

    def align(src_i, dst_i, r):
        if levels[src_i].meta.octave < levels[dst_i].meta.octave:
            return _downsample2_max(r)
        if levels[src_i].meta.octave > levels[dst_i].meta.octave:
            return _upsample2_nearest(r)
        return r

    # pass 1, ascending: duel the survivor map of the previous class
    surv = [None] * nlev
    for i in range(nlev):
        me = cand[i]
        r_i = radius_of(i)
        ok = (me > 0) & (me >= _circular_max(me, r_i))
        if i > 0:
            rival = _circular_max(align(i - 1, i, surv[i - 1]), r_i)
            ok = ok & ~(rival >= me)          # ties favor the list point
        surv[i] = torch.where(ok, me, 0.0)
        if i > 0:
            # an accepted class-i point replaces weaker class-(i-1)
            # survivors within its radius
            m_lo = levels[i - 1].meta
            r_on_lower = max(levels[i].meta.esigma * cfg.derivative_factor
                             / m_lo.ratio, 1.0)
            beat = _circular_max(align(i, i - 1, surv[i]), r_on_lower)
            surv[i - 1] = torch.where(beat > surv[i - 1], 0.0, surv[i - 1])

    # pass 2: drop a survivor iff a class-(i+1) survivor within radius is
    # strictly stronger
    keep_masks = []
    for i in range(nlev):
        me = surv[i]
        keep = me > 0
        if i + 1 < nlev:
            rival = _circular_max(align(i + 1, i, surv[i + 1]), radius_of(i))
            keep = keep & ~(rival > me)
        keep_masks.append(keep)
    return keep_masks


def _subpixel_maps(ldet):
    """Dense spatial subpixel offsets per pixel (2D quadratic fit on the
    3x3 response neighbourhood). Returns (dx, dy, ok) maps."""
    r = F.pad(ldet[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    c = r[:, 1:-1, 1:-1]
    xm = r[:, 1:-1, :-2]; xp = r[:, 1:-1, 2:]
    ym = r[:, :-2, 1:-1]; yp = r[:, 2:, 1:-1]
    xmym = r[:, :-2, :-2]; xpym = r[:, :-2, 2:]
    xmyp = r[:, 2:, :-2]; xpyp = r[:, 2:, 2:]
    gx = 0.5 * (xp - xm)
    gy = 0.5 * (yp - ym)
    hxx = xp + xm - 2.0 * c
    hyy = yp + ym - 2.0 * c
    hxy = 0.25 * (xpyp - xpym - xmyp + xmym)
    det = hxx * hyy - hxy * hxy
    safe = det.abs() > 1e-20
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, 1.0), 0.0)
    dx = -(hyy * gx - hxy * gy) * inv_det
    dy = -(hxx * gy - hxy * gx) * inv_det
    ok = safe & (dx.abs() <= 1.0) & (dy.abs() <= 1.0)
    return dx, dy, ok


_OFFS = [(i, j) for i in range(-6, 7) for j in range(-6, 7)
         if i * i + j * j < 36]
_IDTAB = np.array([6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 6])
_ORI_W = GAUSS25[_IDTAB[[o[0] + 6 for o in _OFFS]],
                 _IDTAB[[o[1] + 6 for o in _OFFS]]]          # (109,)


def _orientation(kp_x, kp_y, kp_scale, lx, ly, kp_sub, valid):
    """Main orientation per keypoint (Compute_Main_Orientation parity).
    kp_x/kp_y: (B, K) level-frame coords; kp_scale: (B, K) sampling step;
    lx/ly: (B, S, H, W) stacked per-sublevel derivative maps; kp_sub:
    (B, K) sublevel index. Returns angles (B, K)."""
    B, S, H, W = lx.shape
    dev = lx.device
    oi = torch.tensor([o[0] for o in _OFFS], dtype=torch.float32, device=dev)
    oj = torch.tensor([o[1] for o in _OFFS], dtype=torch.float32, device=dev)
    w = torch.as_tensor(_ORI_W, device=dev)

    ix = torch.round(kp_x[..., None] + oi * kp_scale[..., None])
    iy = torch.round(kp_y[..., None] + oj * kp_scale[..., None])
    ix = torch.clamp(ix, 0, W - 1).long()                     # (B, K, 109)
    iy = torch.clamp(iy, 0, H - 1).long()
    idx = (kp_sub.long()[..., None] * (H * W) + iy * W + ix).reshape(B, -1)
    resx = torch.gather(lx.reshape(B, -1), 1, idx).reshape(ix.shape) * w
    resy = torch.gather(ly.reshape(B, -1), 1, idx).reshape(ix.shape) * w
    ang = torch.atan2(resy, resx)
    ang = torch.where(ang < 0, ang + 2.0 * math.pi, ang)     # (B, K, 109)

    # 42 sliding windows of width pi/3, step 0.15 rad (f32 like the
    # reference's arange)
    starts = torch.arange(0.0, 2.0 * math.pi, 0.15, dtype=torch.float32,
                          device=dev)
    ends = torch.where(starts + math.pi / 3 > 2 * math.pi,
                       starts - 5.0 * math.pi / 3.0, starts + math.pi / 3.0)
    a = ang[..., None]                                       # (B, K, 109, 1)
    inside_fwd = (starts < ends) & (starts < a) & (a < ends)
    inside_wrap = (ends < starts) & (((a > 0) & (a < ends))
                                     | ((a > starts) & (a < 2 * math.pi)))
    inside = inside_fwd | inside_wrap                        # (B,K,109,42)
    sx = torch.sum(torch.where(inside, resx[..., None], 0.0), dim=2)
    sy = torch.sum(torch.where(inside, resy[..., None], 0.0), dim=2)
    mag = sx * sx + sy * sy                                  # (B, K, 42)
    best = torch.argmax(mag, dim=-1, keepdim=True)
    bx = torch.gather(sx, -1, best)[..., 0]
    by = torch.gather(sy, -1, best)[..., 0]
    theta = torch.atan2(by, bx)
    theta = torch.where(theta < 0, theta + 2.0 * math.pi, theta)
    return torch.where(valid, theta, 0.0)


def detect(levels: List[ss.Evolution], cfg: ss.ScaleSpaceConfig,
           image_width, image_height, max_keypoints: int = 4096) -> Keypoints:
    """Full detection pass. image_width/height: (B,) true sizes (border
    filtering of batch padding). Returns Keypoints (B, max_keypoints) in
    original image coordinates."""
    ldets, lxs, lys = det_hessian(levels)
    keeps = find_extrema(levels, ldets, cfg)

    B = ldets[0].shape[0]
    dev = ldets[0].device
    octaves = sorted({lv.meta.octave for lv in levels})
    per_oct = max_keypoints
    all_x, all_y, all_size, all_angle, all_resp, all_valid = (
        [] for _ in range(6))

    for o in octaves:
        lv_ids = [i for i, lv in enumerate(levels) if lv.meta.octave == o]
        ratio = float(1 << o)
        H, W = ldets[lv_ids[0]].shape[1:]
        resp = torch.stack([torch.where(keeps[i], ldets[i], 0.0)
                            for i in lv_ids], 1)              # (B, S, H, W)
        vals, idx = _top_k(resp.reshape(B, -1), per_oct)      # (B, per_oct)
        sub = idx // (H * W)
        rem = idx % (H * W)
        iy = rem // W
        ix = rem % W
        valid = vals > 0

        sp = [_subpixel_maps(ldets[i]) for i in lv_ids]
        dxs = torch.stack([s[0] for s in sp], 1).reshape(B, -1)
        dys = torch.stack([s[1] for s in sp], 1).reshape(B, -1)
        oks = torch.stack([s[2] for s in sp], 1).reshape(B, -1)
        dx = torch.gather(dxs, 1, idx)
        dy = torch.gather(dys, 1, idx)
        valid = valid & torch.gather(oks, 1, idx)             # non-converged
        esigmas = torch.tensor([levels[i].meta.esigma for i in lv_ids],
                               dtype=torch.float32, device=dev)
        sizes = esigmas[sub] * cfg.derivative_factor          # (B, per_oct)
        ixf = ix.to(torch.float32)
        iyf = iy.to(torch.float32)
        xf = (ixf + dx) * ratio + 0.5 * (ratio - 1.0)
        yf = (iyf + dy) * ratio + 0.5 * (ratio - 1.0)

        # descriptor-border check against the true image size
        marg = SMAX_MLDB * torch.round(sizes / ratio)
        lvl_w = image_width.to(torch.float32)[:, None] / ratio
        lvl_h = image_height.to(torch.float32)[:, None] / ratio
        in_img = ((ixf - marg - 1 >= 0) & (ixf + marg + 1 < lvl_w)
                  & (iyf - marg - 1 >= 0) & (iyf + marg + 1 < lvl_h))
        valid = valid & in_img

        lx = torch.stack([lxs[i] for i in lv_ids], 1)
        ly = torch.stack([lys[i] for i in lv_ids], 1)
        s_step = torch.clamp_min(torch.round(0.5 * sizes / ratio), 1.0)
        angle = _orientation(ixf + dx, iyf + dy, s_step, lx, ly, sub, valid)

        all_x.append(xf)
        all_y.append(yf)
        all_size.append(sizes * 2.0)                          # AKAZE:444
        all_angle.append(angle)
        all_resp.append(torch.where(valid, vals, -math.inf))
        all_valid.append(valid)

    x = torch.cat(all_x, 1)
    y = torch.cat(all_y, 1)
    size = torch.cat(all_size, 1)
    angle = torch.cat(all_angle, 1)
    resp = torch.cat(all_resp, 1)
    valid = torch.cat(all_valid, 1)

    k = min(max_keypoints, resp.shape[1])
    vals, order = _top_k(resp, k)
    take = lambda a: torch.gather(a, 1, order)
    tv = take(valid)
    return Keypoints(
        xy=torch.stack([take(x), take(y)], -1),
        scale=take(size),
        angle=take(angle),
        score=torch.where(tv, vals, 0.0),
        mask=tv & torch.isfinite(vals),
    )


def detect_akaze(img, image_width=None, image_height=None,
                 cfg: ss.ScaleSpaceConfig = ss.ScaleSpaceConfig(),
                 max_keypoints: int = 4096) -> Keypoints:
    """(B, H, W) float image batch -> Keypoints (Fast-AKAZE path)."""
    B, H, W = img.shape
    if image_width is None:
        image_width = torch.full((B,), W, dtype=torch.int32,
                                 device=img.device)
    if image_height is None:
        image_height = torch.full((B,), H, dtype=torch.int32,
                                  device=img.device)
    levels, _ = ss.build_scale_space(img, cfg)
    return detect(levels, cfg, image_width, image_height, max_keypoints)
