"""Secondary keypoint detectors: GFTT, ORB (oFAST) and BRISK-style corners.

Counterpart of ``regard3d_tpu/kernels/corners.py``: the same detectors
(``Regard3DFeatures::detectKeypoints``' OpenCV defaults) as batched torch
ops over (B, H, W) on the images' device.

* ``detect_gftt``: Shi–Tomasi min-eigenvalue corners (qualityLevel 0.01,
  minDistance 1, blockSize 3, Sobel aperture 3).
* ``detect_orb``: FAST-9/16 per pyramid level (threshold 20, 8 levels,
  scale 1.2), Harris ranking (k 0.04, block 7), intensity-centroid angle
  (radius-15 disc).
* ``detect_brisk``: segment-test corners on the BRISK layer ladder
  (threshold 30, 3 octaves plus intra-octaves at x1.5), cross-layer and
  spatial maximum suppression.

Where the two frameworks differ by default, the port follows the
reference's semantics:

* ``lax.top_k`` keeps the lower index on ties (FAST scores of 8-bit content
  tie often); every top-k here is a stable descending sort, sliced;
* ``jax.image.resize(method="linear")`` antialiases when it downsamples:
  ``F.interpolate(..., antialias=True)`` is the same triangle filter;
* box sums pad with zeros and add the window's taps in row-major order, as
  ``lax.reduce_window`` does; 3x3 maxima pad with -inf (``max_pool2d``).

Angle convention: ``angle = cv_angle_rad - pi/2`` (the LIOP warp's), and
detectors that leave the OpenCV angle undefined (GFTT, BRISK: -1 deg) store
that constant mapped the same way.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from regard3d_tpu_torch.core.types import Keypoints

# cv::KeyPoint angle of -1 deg (undefined), in the internal convention
CV_UNDEFINED_ANGLE = -1.0 * math.pi / 180.0 - math.pi / 2.0


def _cv_angle_to_internal(angle_rad):
    return angle_rad - math.pi / 2.0


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _pad2d(img, r: int, mode: str):
    """Pad the last two axes of (..., H, W) by r (``F.pad``'s reflect and
    replicate modes take a 4-D view)."""
    lead = img.shape[:-2]
    p = F.pad(img.reshape(-1, 1, *img.shape[-2:]), (r, r, r, r), mode=mode)
    return p.reshape(*lead, *p.shape[-2:])


def _sobel(img):
    """3x3 Sobel derivatives on (B, H, W), reflect-padded."""
    p = _pad2d(img, 1, "reflect")
    dx = (p[:, 1:-1, 2:] - p[:, 1:-1, :-2]) * 2.0 \
        + (p[:, :-2, 2:] - p[:, :-2, :-2]) \
        + (p[:, 2:, 2:] - p[:, 2:, :-2])
    dy = (p[:, 2:, 1:-1] - p[:, :-2, 1:-1]) * 2.0 \
        + (p[:, 2:, :-2] - p[:, :-2, :-2]) \
        + (p[:, 2:, 2:] - p[:, :-2, 2:])
    return dx, dy


def _box(img, k: int):
    """k x k box sum over the last two axes of (..., H, W) with zero
    padding: the taps added in row-major order."""
    r = k // 2
    H, W = img.shape[-2:]
    p = F.pad(img, (r, r, r, r))
    out = torch.zeros_like(img)
    for dy in range(k):
        for dx in range(k):
            out = out + p[..., dy:dy + H, dx:dx + W]
    return out


def _max3x3(r):
    """3x3 maximum of (B, H, W) with -inf padding."""
    return F.max_pool2d(r[:, None], 3, stride=1, padding=1)[:, 0]


def _nms3x3_mask(r):
    return r >= _max3x3(r)


def _valid_area(shape, widths, heights, border: int):
    """(B, H, W) bool mask of pixels inside each image's true extent minus a
    border (batch padding + detector border exclusion); float extents are
    truncated, as the reference's int32 cast does."""
    B, H, W = shape
    dev = widths.device
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    w = widths.to(torch.int32)[:, None, None]
    h = heights.to(torch.int32)[:, None, None]
    return ((xs >= border) & (xs < w - border)
            & (ys >= border) & (ys < h - border))


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis; ties keep
    the lower index (lax.top_k semantics)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_points(score, k: int):
    """Per-image top-k of a (B, H, W) score map. Returns (x, y, val, valid)
    each (B, k); valid where val > 0."""
    B, H, W = score.shape
    vals, idx = _top_k(score.reshape(B, H * W), k)
    return ((idx % W).to(torch.float32), (idx // W).to(torch.float32),
            vals, vals > 0.0)


def _full_sizes(img, widths, heights):
    B, H, W = img.shape
    if widths is None:
        widths = torch.full((B,), W, dtype=torch.int32, device=img.device)
    if heights is None:
        heights = torch.full((B,), H, dtype=torch.int32, device=img.device)
    return widths, heights


# ---------------------------------------------------------------------------
# GFTT (Shi–Tomasi "good features to track")
# ---------------------------------------------------------------------------

def min_eig_response(img):
    """Min eigenvalue of the 3x3-windowed structure tensor (cv::
    cornerMinEigenVal up to a constant scale: GFTT thresholds relative to
    the per-image max)."""
    dx, dy = _sobel(img)
    a, b, c = _box(torch.stack([dx * dx, dx * dy, dy * dy]), 3)
    a = a * 0.5
    c = c * 0.5
    return (a + c) - torch.sqrt((a - c) * (a - c) + b * b)


def detect_gftt(img, widths=None, heights=None, max_keypoints: int = 4096,
                quality_level: float = 0.01) -> Keypoints:
    """Shi–Tomasi corners. img: (B, H, W) float in [0, 1]. Keypoint size =
    blockSize = 3, angle undefined."""
    B, H, W = img.shape
    widths, heights = _full_sizes(img, widths, heights)
    r = min_eig_response(img)
    area = _valid_area(img.shape, widths, heights, 1)
    r = torch.where(area, r, 0.0)
    rmax = torch.amax(r.reshape(B, -1), dim=1)
    thr = (quality_level * rmax)[:, None, None]
    score = torch.where(_nms3x3_mask(r) & (r > thr) & (r > 0), r, 0.0)
    x, y, vals, ok = _topk_points(score, min(max_keypoints, H * W))
    K = x.shape[1]
    return Keypoints(
        xy=torch.stack([x, y], -1),
        scale=torch.full((B, K), 3.0, device=img.device),
        angle=torch.full((B, K), CV_UNDEFINED_ANGLE, device=img.device),
        score=torch.where(ok, vals, 0.0),
        mask=ok)


# ---------------------------------------------------------------------------
# FAST segment test (shared by ORB and BRISK layers)
# ---------------------------------------------------------------------------

# Bresenham circle of radius 3, clockwise from 12 o'clock (OpenCV fast.cpp)
FAST_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)                                    # (16, 2) as (dx, dy)


def _circle_neighbours(img):
    """Stack the 16 FAST circle neighbours: (B, H, W) -> (16, B, H, W),
    edge-padded."""
    p = _pad2d(img, 3, "replicate")
    H, W = img.shape[1:]
    return torch.stack([p[:, 3 + int(dy):3 + int(dy) + H,
                          3 + int(dx):3 + int(dx) + W]
                        for dx, dy in FAST_CIRCLE], 0)


def _roll(a, s: int):
    return torch.roll(a, -s, 0)


def _run9_any(m):
    """m: (16, ...) bool circle masks -> any 9-contiguous (circular) run."""
    a2 = m & _roll(m, 1)
    a4 = a2 & _roll(a2, 2)
    a8 = a4 & _roll(a4, 4)          # 8-runs starting at each position
    a9 = a8 & _roll(m, 8)           # extend to 9
    return torch.any(a9, dim=0)


def _arcmin9_max(d):
    """d: (16, ...) float. Max over the 16 circular arcs of the min of 9
    consecutive values: the exact FAST score for one polarity (the largest
    threshold at which the segment test still passes)."""
    a2 = torch.minimum(d, _roll(d, 1))
    a4 = torch.minimum(a2, _roll(a2, 2))
    a8 = torch.minimum(a4, _roll(a4, 4))
    a9 = torch.minimum(a8, _roll(d, 8))
    return torch.amax(a9, dim=0)


def fast_score(img, threshold: float):
    """FAST-9/16 segment test on (B, H, W): the per-pixel corner score (0
    where not a corner), in the input's float range."""
    diff = _circle_neighbours(img) - img[None]
    bright = _arcmin9_max(diff)            # max-min over arcs of (p_i - p)
    dark = _arcmin9_max(-diff)
    score = torch.maximum(bright, dark)
    return torch.where(score > threshold, score, 0.0)


def harris_response(img, block: int = 7, k: float = 0.04):
    """Harris cornerness (cv::ORB HarrisResponses: Sobel derivatives,
    7x7 block sums, k = 0.04)."""
    dx, dy = _sobel(img)
    a, b, c = _box(torch.stack([dx * dx, dx * dy, dy * dy]), block)
    return a * c - b * b - k * (a + c) * (a + c)


# intensity-centroid disc: radius 15 (cv::ORB u_max)
_IC_RADIUS = 15


def _ic_offsets():
    offs = []
    r2 = _IC_RADIUS * _IC_RADIUS
    for y in range(-_IC_RADIUS, _IC_RADIUS + 1):
        for x in range(-_IC_RADIUS, _IC_RADIUS + 1):
            if x * x + y * y <= r2:
                offs.append((x, y))
    return np.asarray(offs, np.int64)


_IC_OFFS = _ic_offsets()


def ic_angle(img, x, y, valid):
    """Intensity-centroid orientation (cv::IC_Angle) at integer keypoint
    locations, batched: img (B, H, W); x, y, valid (B, K). Returns (B, K)
    radians (0 where not valid)."""
    B, H, W = img.shape
    offs = torch.as_tensor(_IC_OFFS, device=img.device)
    ox, oy = offs[:, 0], offs[:, 1]
    ix = torch.clamp(x.to(torch.int64)[..., None] + ox, 0, W - 1)
    iy = torch.clamp(y.to(torch.int64)[..., None] + oy, 0, H - 1)
    flat = img.reshape(B, H * W)
    v = torch.gather(flat, 1, (iy * W + ix).reshape(B, -1)).reshape(
        iy.shape)                                          # (B, K, P)
    m10 = torch.sum(v * ox.to(img.dtype), -1)
    m01 = torch.sum(v * oy.to(img.dtype), -1)
    return torch.where(valid, torch.atan2(m01, m10), 0.0)


def _resize_bilinear(img, new_h: int, new_w: int):
    """(B, H, W) bilinear resize with half-pixel centres, antialiased when
    downsampling (``jax.image.resize(method="linear")``)."""
    return F.interpolate(img[:, None], size=(new_h, new_w), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


def orb_levels_distribution(n_features: int, n_levels: int,
                            scale_factor: float) -> List[int]:
    """Per-level feature budget (cv::ORB computeKeyPoints)."""
    factor = 1.0 / scale_factor
    ndesired = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    counts = []
    total = 0
    for _ in range(n_levels - 1):
        c = int(round(ndesired))
        counts.append(c)
        total += c
        ndesired *= factor
    counts.append(max(n_features - total, 0))
    return counts


def _global_top_k(score, valid, k: int):
    """Top-k over concatenated levels: (order, ok) with ok where the slot
    holds a live keypoint."""
    svals, order = _top_k(torch.where(valid, score, -math.inf), k)
    return order, torch.isfinite(svals) & torch.gather(valid, 1, order)


def detect_orb(img, widths=None, heights=None, max_keypoints: int = 4096,
               n_levels: int = 8, scale_factor: float = 1.2,
               fast_threshold: float = 20.0 / 255.0,
               edge_threshold: int = 31) -> Keypoints:
    """oFAST detector (cv::ORB::create(nFeatures); LIOP re-describes).
    img: (B, H, W) float in [0, 1]. Keypoint size = 31 * 1.2^level; angle
    from the intensity centroid."""
    B, H, W = img.shape
    widths, heights = _full_sizes(img, widths, heights)
    budgets = orb_levels_distribution(max_keypoints, n_levels, scale_factor)

    xs, ys, sizes, angles, scores, valids = ([] for _ in range(6))
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        lh, lw = max(int(round(H / s)), 32), max(int(round(W / s)), 32)
        lim = _resize_bilinear(img, lh, lw) if lvl else img
        lws = torch.clamp(widths.to(torch.float32) / s, min=32.0)
        lhs = torch.clamp(heights.to(torch.float32) / s, min=32.0)

        fscore = fast_score(lim, fast_threshold)
        # border: ORB removes keypoints within edgeThreshold of the level edge
        area = _valid_area(lim.shape, lws, lhs, edge_threshold)
        fscore = torch.where(area & _nms3x3_mask(fscore), fscore, 0.0)
        # rank survivors by Harris response, shifted positive so
        # _topk_points' "val > 0 is live" convention holds
        harris = harris_response(lim)
        cand = fscore > 0
        hmin = torch.amin(torch.where(cand, harris, math.inf), dim=(1, 2),
                          keepdim=True)
        hmin = torch.where(torch.isfinite(hmin), hmin, 0.0)
        rank = torch.where(cand, harris - hmin + 1e-6, 0.0)
        k = min(max(budgets[lvl], 1), lh * lw)
        x, y, hval, ok = _topk_points(rank, k)

        ang = ic_angle(lim, x, y, ok)
        xs.append(x * s)
        ys.append(y * s)
        sizes.append(torch.full_like(x, 31.0 * s))
        angles.append(_cv_angle_to_internal(ang))
        scores.append(torch.where(ok, hval, 0.0))
        valids.append(ok)

    x, y, size, angle, score, valid = (torch.cat(a, 1) for a in (
        xs, ys, sizes, angles, scores, valids))
    # global top-K by score, capacity max_keypoints
    order, ok = _global_top_k(score, valid, min(max_keypoints,
                                                score.shape[1]))
    take = lambda a: torch.gather(a, 1, order)
    return Keypoints(xy=torch.stack([take(x), take(y)], -1),
                     scale=take(size), angle=take(angle),
                     score=torch.where(ok, take(score), 0.0), mask=ok)


# ---------------------------------------------------------------------------
# BRISK-style scale-space segment-test corners
# ---------------------------------------------------------------------------

def detect_brisk(img, widths=None, heights=None, max_keypoints: int = 4096,
                 threshold: float = 30.0 / 255.0, octaves: int = 3,
                 basic_size: float = 12.0) -> Keypoints:
    """Scale-space corners in the BRISK layer layout (cv::BRISK::create()
    defaults: layers c_i at scale 2^i and d_i at 1.5 * 2^i). A corner passes
    the 9-of-16 segment test, is a spatial 3x3 maximum and beats both
    neighbouring layers resampled to its own. Keypoint size = 12 * layer
    scale; angle undefined."""
    B, H, W = img.shape
    widths, heights = _full_sizes(img, widths, heights)

    layer_scales = []
    for i in range(octaves):
        layer_scales.append(2.0 ** i)
        layer_scales.append(1.5 * 2.0 ** i)

    smaps, sizes_hw = [], []
    for s in layer_scales:
        lh, lw = max(int(round(H / s)), 16), max(int(round(W / s)), 16)
        lim = _resize_bilinear(img, lh, lw) if s != 1.0 else img
        lws = torch.clamp(widths.to(torch.float32) / s, min=16.0)
        lhs = torch.clamp(heights.to(torch.float32) / s, min=16.0)
        sc = fast_score(lim, threshold)
        area = _valid_area(lim.shape, lws, lhs, 4)
        smaps.append(torch.where(area, sc, 0.0))
        sizes_hw.append((lh, lw))

    per_layer = max(max_keypoints // len(layer_scales), 64)
    xs, ys, sizes, scores, valids = ([] for _ in range(5))
    for li, s in enumerate(layer_scales):
        sc = smaps[li]
        cand = torch.where(_nms3x3_mask(sc), sc, 0.0)
        lh, lw = sizes_hw[li]
        rival = cand
        for lj in (li - 1, li + 1):
            if 0 <= lj < len(layer_scales):
                other = _resize_bilinear(smaps[lj], lh, lw)
                rival = torch.maximum(rival, _max3x3(other))
        keep = torch.where((cand > 0) & (cand >= rival), cand, 0.0)
        x, y, vals, ok = _topk_points(keep, min(per_layer, lh * lw))
        xs.append(x * s)
        ys.append(y * s)
        sizes.append(torch.full_like(x, basic_size * s))
        scores.append(torch.where(ok, vals, 0.0))
        valids.append(ok)

    x, y, size, score, valid = (torch.cat(a, 1) for a in (
        xs, ys, sizes, scores, valids))
    k = min(max_keypoints, score.shape[1])
    order, ok = _global_top_k(score, valid, k)
    take = lambda a: torch.gather(a, 1, order)
    return Keypoints(xy=torch.stack([take(x), take(y)], -1),
                     scale=take(size),
                     angle=torch.full((B, k), CV_UNDEFINED_ANGLE,
                                      device=img.device),
                     score=torch.where(ok, take(score), 0.0), mask=ok)
