"""Plain reference of the compute-matches step, and the numbers that judge a
step's artifacts against it.

The step is features (Fast-AKAZE + LIOP) -> ratio-test matching -> the
AC-RANSAC F / E / H filter. The reference computes each stage in float64:

* features: the frozen copy of the detector and LIOP (``frozen/``) from the
  image itself, on a sample of views;
* matching: the exact two nearest neighbours and the ratio test, on the
  descriptors the step wrote, for every pair;
* filter: the frozen AC-RANSAC with the step's own per-pair draws (the
  same seeded generators), on the keypoints and putative matches the step
  wrote, for a sample of pairs.

Matching and filtering are judged on the step's own inputs (its
descriptors, its putative matches): the reference follows the step stage by
stage, and the features stage is judged by itself from the image. Nothing
here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.frozen import detect, liop, ransac
from benchmark.reference.frozen import scale_space as ss

KP_SIZE_FACTOR = 8.0          # Fast-AKAZE's patch scale (LIOP)
POS_TOL_PX = 0.02             # the .feat text keeps 6 significant digits
SCALE_RTOL = 1e-3
DESC_TOL = 0.05               # L2 gap of unit-norm descriptors
SAMPLE = {"f": 8, "e": 5, "h": 4}
SALT = {"f": 0, "e": 1, "h": 2}
MIN_FILTER_MATCHES = 16       # pairs with fewer putative matches are skipped
E_MIN_MATCHES = 50            # E's overlap prune: inliers, and their share
E_MIN_SURVIVAL = 0.3          # of the putative matches


# --------------------------------------------------------------------------
# Features
# --------------------------------------------------------------------------

def features(image: np.ndarray, threshold: float, max_keypoints: int,
             dtype, device) -> Dict[str, np.ndarray]:
    """Keypoints and LIOP descriptors of one image, computed in ``dtype``."""
    with torch.no_grad():
        img = torch.as_tensor(image, dtype=dtype, device=device)[None]
        cfg = ss.ScaleSpaceConfig(dthreshold=threshold)
        kps = detect.detect_akaze(img, cfg=cfg, max_keypoints=max_keypoints)
        desc = liop.describe_liop(img, kps, KP_SIZE_FACTOR,
                                  padded_dim=liop.LIOP_DIM)
        m = kps.mask[0]
        return {"xy": kps.xy[0][m].double().cpu().numpy(),
                "scale": kps.scale[0][m].double().cpu().numpy(),
                "angle": kps.angle[0][m].double().cpu().numpy(),
                "desc": desc.data[0][m].double().cpu().numpy()}


def feature_miss(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                 device) -> Tuple[int, int]:
    """(keypoints not reproduced, keypoints compared) of one view: a
    keypoint of either side with no partner of the same scale within
    ``POS_TOL_PX``, or whose descriptor lies more than ``DESC_TOL`` from its
    partner's, is a miss."""
    a = torch.as_tensor(got["xy"], dtype=torch.float64, device=device)
    b = torch.as_tensor(ref["xy"], dtype=torch.float64, device=device)
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return max(n, m), max(n, m, 1)
    sa = torch.as_tensor(got["scale"], dtype=torch.float64, device=device)
    sb = torch.as_tensor(ref["scale"], dtype=torch.float64, device=device)
    d = torch.cdist(a, b)
    d = torch.where((sa[:, None] - sb[None, :]).abs()
                    <= SCALE_RTOL * sb[None, :], d, math.inf)
    da, ia = d.min(1)
    db, _ = d.min(0)
    ok_a = da <= POS_TOL_PX
    da_desc = torch.as_tensor(got["desc"], dtype=torch.float64, device=device)
    db_desc = torch.as_tensor(ref["desc"], dtype=torch.float64, device=device)
    gap = torch.linalg.norm(da_desc - db_desc[ia], dim=-1)
    good = ok_a & (gap <= DESC_TOL)
    miss = int((~good).sum()) + int((db > POS_TOL_PX).sum())
    return miss, max(n, m)


# --------------------------------------------------------------------------
# Matching
# --------------------------------------------------------------------------

def top2(da: torch.Tensor, db: torch.Tensor):
    """(d1, i1, d2) of every row of ``da`` against ``db`` under squared L2;
    the lowest index wins a tie, and an equal second value gives d2 == d1."""
    aa = (da * da).sum(-1, keepdim=True)
    bb = (db * db).sum(-1)[None, :]
    d = torch.clamp_min(aa + bb - 2.0 * (da @ db.T), 0.0)
    i1 = torch.argmin(d, dim=-1)
    d1 = torch.gather(d, -1, i1[:, None])[:, 0]
    d2 = d.scatter(-1, i1[:, None], math.inf).min(-1).values
    return d1, i1, d2


def ratio_match(da, db, ratio: float) -> np.ndarray:
    """(K, 2) rows (a, b) that pass the ratio test d1 < ratio^2 d2."""
    d1, i1, d2 = top2(da, db)
    ok = d1 < (ratio * ratio) * d2
    a = torch.nonzero(ok)[:, 0]
    return torch.stack([a, i1[a]], -1).cpu().numpy().astype(np.int64)


def match_gap(desc_i: np.ndarray, desc_j: np.ndarray, got: np.ndarray,
              ratio: float, device) -> float:
    """The widest gap, as a share of the second distance, by which the
    step's decisions for the rows of image i depart from the exact ratio
    test: a kept row whose match is not the nearest neighbour, a kept row
    that fails the ratio, a dropped row that passes it."""
    da = torch.as_tensor(desc_i, dtype=torch.float64, device=device)
    db = torch.as_tensor(desc_j, dtype=torch.float64, device=device)
    if len(da) == 0 or len(db) < 2:
        return 0.0 if len(got) == 0 else math.inf
    d1, _, d2 = top2(da, db)
    zero = d2 <= 0                       # duplicate rows: the test fails
    den = torch.where(zero, 1.0, d2)
    q = torch.where(zero, 1.0, d1 / den)
    r2 = ratio * ratio
    kept = torch.zeros(len(da), dtype=torch.bool, device=device)
    gap = torch.zeros(len(da), dtype=torch.float64, device=device)
    if len(got):
        g = torch.as_tensor(got, device=device)
        if (g[:, 0] >= len(da)).any() or (g[:, 1] >= len(db)).any() \
                or len(torch.unique(g[:, 0])) != len(g):
            return math.inf
        a, b = g[:, 0], g[:, 1]
        kept[a] = True
        dab = ((da[a] - db[b]) ** 2).sum(-1)
        gap[a] = torch.maximum((dab - d1[a]) / den[a],
                               torch.clamp_min(dab / den[a] - r2, 0.0))
    drop = ~kept
    gap[drop] = torch.clamp_min(r2 - q[drop], 0.0)
    return float(gap.max())


# --------------------------------------------------------------------------
# Geometric filter
# --------------------------------------------------------------------------

def pair_generator(seed: int, i: int, j: int, kind: str) -> torch.Generator:
    """One pair's draws for filter ``kind``, seeded from (seed, i, j, kind)."""
    ss_ = np.random.SeedSequence([seed, i, j, SALT[kind]])
    g = torch.Generator()
    g.manual_seed(int(ss_.generate_state(1, np.uint64)[0] >> 1))
    return g


def _logalpha0_line(w, h):
    return math.log10(2.0 * math.sqrt(w * w + h * h) / (w * h))


def _logalpha0_point(w, h):
    return math.log10(math.pi / (w * h))


FILTER_BATCH = 16            # pairs a reference call filters together


def filter_pairs(items, xy, sizes, focals, seed, iters, max_err_px, dtype,
                 device) -> List[Dict[str, np.ndarray]]:
    """The F, E and H inlier rows of each pair (i, j, putative matches m) of
    ``items`` (a kind left out where the filter rejects the pair). Pairs
    are filtered in batches padded to the batch's largest match count; a
    pair's result does not depend on its batch (its draws are its own)."""
    out = []
    for b0 in range(0, len(items), FILTER_BATCH):
        out += _filter_batch(items[b0:b0 + FILTER_BATCH], xy, sizes, focals,
                             seed, iters, max_err_px, dtype, device)
    return out


def _filter_batch(items, xy, sizes, focals, seed, iters, max_err_px, dtype,
                  device):
    P = len(items)
    cap = max(len(m) for _, _, m in items)
    arr = lambda: np.zeros((P, cap, 2), np.float64)
    x1, x2, x1n, x2n = arr(), arr(), arr(), arr()
    mask = np.zeros((P, cap), bool)
    la_f, la_h, la_e, me_e = (np.zeros(P) for _ in range(4))
    for p, (i, j, m) in enumerate(items):
        n = len(m)
        x1[p, :n] = np.asarray(xy[i], np.float64)[m[:, 0]]
        x2[p, :n] = np.asarray(xy[j], np.float64)[m[:, 1]]
        mask[p, :n] = True
        w = float(max(sizes[i][0], sizes[j][0]))
        h = float(max(sizes[i][1], sizes[j][1]))
        la_f[p] = _logalpha0_line(w, h)
        la_h[p] = _logalpha0_point(w, h)
        x1n[p, :n] = (x1[p, :n] - np.asarray(sizes[i]) / 2.0) / focals[i]
        x2n[p, :n] = (x2[p, :n] - np.asarray(sizes[j]) / 2.0) / focals[j]
        fmean = math.sqrt(focals[i] * focals[j])
        la_e[p] = math.log10(2.0 * math.sqrt(w * w + h * h) / (w * h) * fmean)
        me_e[p] = (max_err_px / fmean) ** 2
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    mk = torch.as_tensor(mask, device=device)
    me_f = t(np.full(P, max_err_px ** 2))
    draws = lambda kind: ransac._draw_samples_batch(
        [pair_generator(seed, i, j, kind) for i, j, _ in items], mk, iters,
        SAMPLE[kind])
    with torch.no_grad():
        rf = ransac.acransac_f_batch(None, t(x1), t(x2), mk, t(la_f), me_f,
                                     iters=iters, idx=draws("f"))
        re = ransac.acransac_e_batch(None, t(x1n), t(x2n), mk, t(la_e),
                                     t(me_e), iters=iters, idx=draws("e"))
        rh = ransac.acransac_h_batch(None, t(x1), t(x2), mk, t(la_h), me_f,
                                     iters=iters, idx=draws("h"))
    res = {k: (r.valid.cpu().numpy(), r.inliers.cpu().numpy())
           for k, r in (("f", rf), ("e", re), ("h", rh))}
    out = []
    for p, (_, _, m) in enumerate(items):
        n = len(m)
        got = {}
        for kind, (valid, inl) in res.items():
            if not valid[p]:
                continue
            keep = inl[p, :n]
            if kind == "e" and not (keep.sum() >= E_MIN_MATCHES
                                    and keep.sum() >= E_MIN_SURVIVAL * n):
                continue
            got[kind] = m[keep]
        out.append(got)
    return out


def set_distance(a: np.ndarray, b: np.ndarray) -> float:
    """1 - |a & b| / |a | b| of two sets of match rows (0 for two empty)."""
    sa = {tuple(r) for r in np.asarray(a).reshape(-1, 2).tolist()}
    sb = {tuple(r) for r in np.asarray(b).reshape(-1, 2).tolist()}
    union = len(sa | sb)
    return 0.0 if union == 0 else 1.0 - len(sa & sb) / union


def sample(rng: np.random.Generator, items: Sequence, k: int) -> List:
    """``k`` items drawn without replacement, in their original order."""
    if k >= len(items):
        return list(items)
    return [items[i] for i in sorted(rng.choice(len(items), k,
                                                replace=False))]
