"""Frozen copy of ``regard3d_tpu_torch/kernels/liop.py`` (commit 794b6e4),
the plain PyTorch path, kept as the benchmark's reference: imports redirected to this folder.
Its arithmetic follows the dtype of its inputs (float64 for the
reference, float32 for the control).

LIOP-144 descriptor — batched patch warp + intensity-order binning.

Counterpart of ``regard3d_tpu/kernels/liop.py`` (the reference's descriptor
of record, VLFeat LIOP): a 41x41 patch warped from the image by the inverse
affine map ``src = kp + scale*R(theta) @ (patch_xy - 20)`` with
``scale = size/41 * kpSizeFactor`` and ``theta = -pi - angle``, Gaussian
smoothing sigma=1.2, n=4 neighbours on a radius-6 circle, 6 ordinal bins,
adaptive threshold 5/255*(max-min), 4!*6 = 144 dims, L2 norm.

The circular pixel list, the neighbour positions and their bilinear taps are
static tables computed on the host. The per-pixel rank order is one sort +
five quantile comparisons, the 4-neighbour permutation index comes from
stable pairwise-comparison ranks, and the histogram is an einsum over
one-hots (exact in f32: small integer weights).

Two warps: the direct per-tap bilinear warp (``warp_patches``, the default
on every device — gathers are cheap on the card) and the reference's
windowed pyramid warp (``warp_patches_pyramid``, a TPU formulation kept for
parity, selected with ``use_pyramid=True``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.frozen.types import Descriptors, Keypoints
from benchmark.reference.frozen.scale_space import conv_sep, gaussian_kernel1d

PATCH_RESOLUTION = 20
PATCH_SIZE = 2 * PATCH_RESOLUTION + 1          # 41
PATCH_SMOOTH_SIGMA = 1.2
NUM_NEIGHBOURS = 4
NUM_SPATIAL_BINS = 6
NEIGH_RADIUS = 6.0
INTENSITY_THRESHOLD = 5.0 / 255.0
LIOP_DIM = 144                                  # 4! * 6
PADDED_DIM = 256                                # the reference's storage width

# Per-detector patch scale factors (src/Regard3DFeatures.cpp:691-717)
KP_SIZE_FACTORS = {
    "AKAZE": 8.0, "Fast-AKAZE": 8.0, "DOG": 0.25, "MSER": 0.08,
    "ORB": 0.025, "BRISK": 0.15, "GFTT": 0.13, "HARRIS": 0.25, "TBMR": 1.0,
}


def _liop_tables():
    """Static LIOP geometry: circular pixel list and per-pixel neighbour
    sample coords."""
    c = PATCH_RESOLUTION
    t = c - NEIGH_RADIUS + 0.6
    t2 = int(t * t)
    xs, ys = [], []
    for y in range(PATCH_SIZE):
        for x in range(PATCH_SIZE):
            dx, dy = x - c, y - c
            if x == 0 and y == 0:
                continue  # quirk kept for parity (outside circle anyway)
            if dx * dx + dy * dy <= t2:
                xs.append(x)
                ys.append(y)
    px = np.asarray(xs, np.int32)
    py = np.asarray(ys, np.int32)
    angle0 = np.arctan2(py - c, px - c)
    dangle = 2.0 * math.pi / NUM_NEIGHBOURS
    tt = np.arange(NUM_NEIGHBOURS)
    nx = px[:, None] - c + NEIGH_RADIUS * np.cos(angle0[:, None]
                                                 + dangle * tt) + c
    ny = py[:, None] - c + NEIGH_RADIUS * np.sin(angle0[:, None]
                                                 + dangle * tt) + c
    return px, py, nx.astype(np.float64), ny.astype(np.float64)


_PX, _PY, _NX, _NY = _liop_tables()
PATCH_NPIX = len(_PX)


def _bilinear_taps(nx, ny):
    """Static bilinear taps for the neighbour samples with the reference's
    zero-outside-border rule. Returns (idx (P,4,4), w (P,4,4)) into the flat
    41*41 patch."""
    L = PATCH_SIZE
    ix = np.floor(nx).astype(np.int64)
    iy = np.floor(ny).astype(np.int64)
    wx = nx - ix
    wy = ny - iy
    taps_idx = np.zeros(nx.shape + (4,), np.int64)
    taps_w = np.zeros(nx.shape + (4,), np.float32)
    corners = [(0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
               (0, 1, (1 - wx) * wy), (1, 1, wx * wy)]
    for k, (ox, oy, w) in enumerate(corners):
        cx, cy = ix + ox, iy + oy
        ok = (cx >= 0) & (cx <= L - 1) & (cy >= 0) & (cy <= L - 1)
        taps_idx[..., k] = np.where(ok, cx + cy * L, 0)
        taps_w[..., k] = np.where(ok, w, 0.0)
    return taps_idx, taps_w.astype(np.float32)


_TAPS_IDX, _TAPS_W = _bilinear_taps(_NX, _NY)
_BIN_AREA = PATCH_NPIX // NUM_SPATIAL_BINS
_PIX_IDX = (_PX + _PY * PATCH_SIZE).astype(np.int64)
_BOUND_RANKS = [t * _BIN_AREA - 1 for t in range(1, NUM_SPATIAL_BINS)]
_IU = np.triu_indices(NUM_NEIGHBOURS, k=1)


def liop_from_patches(patches):
    """Batched LIOP descriptors. patches: (K, 41, 41) -> (K, 144)."""
    K = patches.shape[0]
    dev = patches.device
    flat = patches.reshape(K, -1)
    p_int = flat[:, torch.as_tensor(_PIX_IDX, device=dev)]         # (K, P)
    n_int = torch.sum(flat[:, torch.as_tensor(_TAPS_IDX, device=dev)]
                      * torch.as_tensor(_TAPS_W, device=dev), -1)  # (K, P, 4)

    thr = INTENSITY_THRESHOLD * (torch.amax(p_int, 1) - torch.amin(p_int, 1))

    # ordinal spatial bin: number of bin-boundary order statistics strictly
    # below the value
    srt = torch.sort(p_int, dim=1).values
    bounds = srt[:, _BOUND_RANKS]                                  # (K, 5)
    sbin = torch.sum(p_int[:, :, None] > bounds[:, None, :], -1)   # (K, P)

    # permutation (Lehmer) index from stable comparison ranks
    ai = n_int[..., :, None]
    aj = n_int[..., None, :]
    ar4 = torch.arange(4, device=dev)
    jlti = ar4[None, :] < ar4[:, None]                             # [i,j]: j<i
    r = torch.sum((aj < ai) | ((aj == ai) & jlti), -1)             # (K, P, 4)
    p0 = torch.sum(ar4 * (r == 0), -1)
    p1 = torch.sum(ar4 * (r == 1), -1)
    p2 = torch.sum(ar4 * (r == 2), -1)
    d1 = p1 - (p1 > p0).long()
    d2 = p2 - (p2 > p0).long() - (p2 > p1).long()
    perm_idx = (p0 * 3 + d1) * 2 + d2                              # (K, P)

    # weight: number of neighbour pairs differing by more than the threshold
    diffs = (n_int[:, :, :, None] - n_int[:, :, None, :]).abs()
    w = torch.sum((diffs[:, :, _IU[0], _IU[1]]
                   > thr[:, None, None]).to(torch.float32), -1)     # (K, P)

    oh_s = ((sbin[..., None] == torch.arange(NUM_SPATIAL_BINS, device=dev))
            .to(torch.float32) * w[..., None])
    oh_q = (perm_idx[..., None] == torch.arange(24, device=dev)).to(
        torch.float32)
    hist = torch.einsum("kps,kpq->ksq", oh_s, oh_q).reshape(K, LIOP_DIM)
    norm = torch.clamp_min(torch.linalg.norm(hist, dim=-1, keepdim=True),
                           1e-12)
    return hist / norm


def liop_from_patch(patch):
    """LIOP descriptor of one smoothed 41x41 patch -> (144,) float32."""
    return liop_from_patches(patch[None])[0]


def warp_patches(img, xy, size, angle, kp_size_factor: float = 8.0):
    """41x41 patches (bilinear, zero border) for all keypoints of one image.
    img: (H, W); xy: (K, 2); size: (K,) diameter; angle: (K,) radians."""
    H, W = img.shape
    scale = size / PATCH_SIZE * kp_size_factor                 # (K,)
    theta = -math.pi - angle
    ca = scale * torch.cos(theta)
    sa = scale * torch.sin(theta)
    u = torch.arange(PATCH_SIZE, dtype=img.dtype,
                     device=img.device) - PATCH_RESOLUTION
    vv, uu = torch.meshgrid(u, u, indexing="ij")               # (41, 41)
    sx = xy[:, 0, None, None] + ca[:, None, None] * uu + sa[:, None, None] * vv
    sy = xy[:, 1, None, None] - sa[:, None, None] * uu + ca[:, None, None] * vv

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    flat = img.reshape(-1)

    def tap(xi, yi):
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xi = torch.clamp(xi, 0, W - 1).long()
        yi = torch.clamp(yi, 0, H - 1).long()
        return torch.where(ok, flat[yi * W + xi], 0.0)

    return ((1 - wx) * (1 - wy) * tap(x0, y0)
            + wx * (1 - wy) * tap(x0 + 1, y0)
            + (1 - wx) * wy * tap(x0, y0 + 1)
            + wx * wy * tap(x0 + 1, y0 + 1))                   # (K, 41, 41)


_WIN = 128                  # pyramid-window side
_MAX_STEP = 2.19            # max sampling step a window covers


def _area_half(img):
    """2x2 area downsample of (B, H, W)."""
    B, H, W = img.shape
    return img[:, :H - H % 2, :W - W % 2].reshape(
        B, H // 2, 2, W // 2, 2).mean((2, 4))


def warp_patches_pyramid(imgs, img_id, xy, size, angle,
                         kp_size_factor: float = 8.0, chunk: int = 1024,
                         process_fn=None):
    """41x41 patch extraction for many keypoints across an image batch from
    one (128, 128) window of an area pyramid level per keypoint, with the
    bilinear interpolation as a separable hat-weight contraction (the
    reference's TPU formulation; same sampling contract as
    ``warp_patches`` for keypoints whose step is <= ~2.2 px).

    imgs: (B, H, W); img_id: (N,) image of each keypoint; xy/size/angle:
    (N, ...). Returns (N, 41, 41), or process_fn applied per chunk."""
    B, H, W = imgs.shape
    dev, dt = imgs.device, imgs.dtype
    L = 1
    while (min(H, W) >> L) >= _WIN and L < 5:
        L += 1
    levels = [imgs]
    for _ in range(1, L):
        levels.append(_area_half(levels[-1]))
    stack = torch.zeros((B, L, H, W), dtype=dt, device=dev)
    for l, lv in enumerate(levels):
        stack[:, l, :lv.shape[1], :lv.shape[2]] = lv

    N = xy.shape[0]
    scale = size / PATCH_SIZE * kp_size_factor
    theta = -math.pi - angle
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(scale, 1e-6)
                                            / _MAX_STEP)), 0, L - 1).long()
    inv = torch.exp2(-lvl.to(dt))
    cx = (xy[:, 0] + 0.5) * inv - 0.5
    cy = (xy[:, 1] + 0.5) * inv - 0.5
    ca = scale * inv * torch.cos(theta)
    sa = scale * inv * torch.sin(theta)
    Wl = (W * inv).long()
    Hl = (H * inv).long()
    x0 = torch.minimum(torch.clamp_min(torch.round(cx).long() - _WIN // 2, 0),
                       torch.clamp_min(Wl - _WIN, 0))
    y0 = torch.minimum(torch.clamp_min(torch.round(cy).long() - _WIN // 2, 0),
                       torch.clamp_min(Hl - _WIN, 0))

    u = torch.arange(PATCH_SIZE, dtype=dt, device=dev) - PATCH_RESOLUTION
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    uu = uu.reshape(-1)
    vv = vv.reshape(-1)                                        # (1681,)
    iota = torch.arange(_WIN, dtype=dt, device=dev)
    win_r = torch.arange(_WIN, device=dev)

    outs = []
    for s0 in range(0, N, chunk):
        sl = slice(s0, s0 + chunk)
        # window gather: rows y0..y0+WIN, cols x0..x0+WIN of the level
        # (clipped into the padded stack like the reference's CLIP gather)
        yy = torch.clamp(y0[sl, None] + win_r, 0, H - 1)       # (c, WIN)
        xx = torch.clamp(x0[sl, None] + win_r, 0, W - 1)
        win = stack[img_id[sl, None, None], lvl[sl, None, None],
                    yy[:, :, None], xx[:, None, :]]            # (c, WIN, WIN)
        sx = (cx[sl] - x0[sl].to(dt))[:, None] + ca[sl, None] * uu \
            + sa[sl, None] * vv
        sy = (cy[sl] - y0[sl].to(dt))[:, None] - sa[sl, None] * uu \
            + ca[sl, None] * vv
        sxi = cx[sl, None] + ca[sl, None] * uu + sa[sl, None] * vv
        syi = cy[sl, None] - sa[sl, None] * uu + ca[sl, None] * vv
        inside = ((sxi > -1.0) & (sxi < Wl[sl, None].to(dt))
                  & (syi > -1.0) & (syi < Hl[sl, None].to(dt)))
        A = torch.clamp_min(1.0 - (sy[..., None] - iota).abs(), 0.0)
        Bm = torch.clamp_min(1.0 - (sx[..., None] - iota).abs(), 0.0)
        M = torch.einsum("kpx,kyx->kpy", Bm, win)
        out = torch.sum(A * M, -1) * inside
        patches = out.reshape(-1, PATCH_SIZE, PATCH_SIZE)
        outs.append(patches if process_fn is None else process_fn(patches))
    return torch.cat(outs)


def describe_liop(img, kps: Keypoints, kp_size_factor: float = 8.0,
                  padded_dim: int = PADDED_DIM,
                  use_pyramid: bool = False) -> Descriptors:
    """Descriptors for a batch of images. img: (B, H, W); kps: Keypoints
    with (B, K) fields. Returns Descriptors (B, K, padded_dim). Images are
    described one at a time (the reference's vmap over images) to bound the
    per-keypoint temporaries."""
    B, K = kps.scale.shape
    k1 = gaussian_kernel1d(PATCH_SMOOTH_SIGMA, 11)

    def proc(patches):
        return liop_from_patches(conv_sep(patches, k1, k1))

    if use_pyramid:
        img_id = torch.arange(B, device=img.device).repeat_interleave(K)
        desc = warp_patches_pyramid(
            img, img_id, kps.xy.reshape(B * K, 2), kps.scale.reshape(-1),
            kps.angle.reshape(-1), kp_size_factor, process_fn=proc)
        desc = desc.reshape(B, K, LIOP_DIM)
    else:
        desc = torch.stack([
            proc(warp_patches(img[b], kps.xy[b], kps.scale[b], kps.angle[b],
                              kp_size_factor)) for b in range(B)])
    desc = desc * kps.mask.to(img.dtype)[..., None]
    pad = padded_dim - LIOP_DIM
    if pad > 0:
        desc = torch.nn.functional.pad(desc, (0, pad))
    return Descriptors(data=desc, mask=kps.mask)
