"""Incremental SfM engine (incremental2 with the MaxPair or the stellar
initializer, and v1 with a user-chosen initial pair).

Counterpart of ``regard3d_tpu/sfm/incremental.py`` (OpenMVG's
``SequentialSfMReconstructionEngine2`` as the reference drives it):

  initial pair (batched E/H AC-RANSAC over the most covisible pairs,
  cheirality vote, parallax gate, scored scan; or the user's pair with a
  serial robust pose), or a stellar pod (a hub view and up to six
  neighbours, each hub edge a robust relative pose, the edges' baselines
  reconciled by a log least squares over shared-track depths) -> triangulate
  -> { resect the group of best-covered views (batched P3P AC-RANSAC)
       -> retriangulate -> bundle adjust every ``ba_every`` views
       -> reject outlier observations } until no view is left
  -> final BA (+ intrinsic refinement) and polish
  -> with center priors (GPS in a local metric frame): Sim3 onto the
     priors, then a BA with the center-prior term.

The which-view-next loop stays on the host; every step inside it runs on
the engine's device. Each phase opens a ``torch.profiler`` span
(``triangulation.init``, ``.resection``, ``.triangulation``, ``.ba``,
``.outlier``) that ends in a device synchronize, so a trace attributes every
device operation to its phase; ``.resection`` counts the views of each
group it tries (``views``); ``stats["profile"]`` holds the same keys as
the reference's.

Random draws: the reference draws its initializer and resection samples
from a ``jax.random`` key chain. Here every batched AC-RANSAC call asks a
``sample_provider(kind, mask, iters, s) -> (B, iters, s)`` for its sample
indices, with ``kind`` one of ``"init_e"``, ``"init_h"`` (MaxPair),
``"init_pair"``, ``"init_pair_retry"`` (the user's pair: four attempts,
then one last attempt that takes any decomposition), ``"stellar_h"``,
``"stellar_e"`` (the stellar pod's hub edges: planarity tests and
relative-pose attempts), ``"resection"``, and ``mask`` the (B, N) numpy
mask of the call's rows, in the reference's call order. Calls whose rows
the reference draws one key per row for add ``ids``, one tuple per row:
(b,) and (b, attempt) for hub edge b of the stellar pod, (i, j, attempt)
for a pair of the global engine (``sfm/global_sfm.py``), so the draws do
not depend on how rows are grouped. The default provider draws from one
CPU ``torch.Generator`` per call, seeded from (seed, call index), or per
row from (seed, *ids); parity tests replay the reference's key chain
instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from regard3d_tpu_torch import runtime, spans
from regard3d_tpu_torch.ba import lm
from regard3d_tpu_torch.core import cameras, metrics
from regard3d_tpu_torch.kernels import geometry, ransac
from regard3d_tpu_torch.sfm import tracks as tracks_mod
from regard3d_tpu_torch.sfm.triangulate import (reprojection_residuals_px,
                                                track_table,
                                                triangulate_tracks)

# (kind, mask, iters, s[, ids]) -> (B, iters, s) sample indices
SampleProvider = Callable[..., np.ndarray]


@dataclasses.dataclass(frozen=True)
class IncrementalConfig:
    max_err_px: float = 4.0            # ACRANSAC bound (reference: 4.0)
    ransac_iters: int = 1024
    resection_iters: int = 512
    min_resection_points: int = 12
    min_track_len: int = 2
    min_angle_deg: float = 2.0
    ba_every: int = 3                  # bundle adjust after this many views
    ba_iterations: int = 20
    final_ba_iterations: int = 40
    refine_intrinsics: bool = True     # ADJUST_ALL parity default
    huber_delta_px: float = 2.0
    min_initial_inliers: int = 50
    initializer: str = "maxpair"       # "maxpair" | "stellar"
    resection_group: int = 16          # max views resected per round
    resection_group_frac: float = 0.5  # group admits views with >= frac of
                                       # the best candidate's visible count


class SfMInputs(NamedTuple):
    """Scene inputs (built by the pipeline layer), on the engine's device."""
    xy: torch.Tensor          # (O, 2) pixel coords per observation
    track_id: torch.Tensor    # (O,) int64
    view_id: torch.Tensor     # (O,) int64
    feature_id: torch.Tensor  # (O,) int64
    num_tracks: int
    intr_id: torch.Tensor     # (V,) int64 per-view intrinsic group
    intr: torch.Tensor        # (K, 9)
    models: torch.Tensor      # (K,) int64 camera model codes
    image_sizes: np.ndarray   # (V, 2) width, height


class SfMResult(NamedTuple):
    R: torch.Tensor           # (V, 3, 3)
    C: torch.Tensor           # (V, 3)
    pose_mask: np.ndarray     # (V,)
    X: torch.Tensor           # (T, 3)
    track_ok: np.ndarray      # (T,)
    obs_active: np.ndarray    # (O,)
    intr: torch.Tensor        # (K, 9)
    stats: Dict


def _bearings(inputs: SfMInputs, intr) -> torch.Tensor:
    g = inputs.intr_id[inputs.view_id]
    return cameras.bearing(inputs.models[g], intr[g], inputs.xy)


def _normalized_xy(inputs: SfMInputs, intr) -> torch.Tensor:
    b = _bearings(inputs, intr)
    return b[:, :2] / b[:, 2:]


def _pair_obs(vid: np.ndarray, tid: np.ndarray, i: int, j: int):
    """Aligned observation rows of the tracks shared by views i and j."""
    rows_i = np.where(vid == i)[0]
    rows_j = np.where(vid == j)[0]
    _, ii, jj = np.intersect1d(tid[rows_i], tid[rows_j], return_indices=True)
    return rows_i[ii], rows_j[jj]


def _generator(*entropy) -> torch.Generator:
    g = torch.Generator()
    ss = np.random.SeedSequence(list(entropy))
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
    return g


def default_provider(seed: int) -> SampleProvider:
    """Draws from one CPU generator per call, seeded from (seed, call), or
    with ``ids`` from one generator per row, seeded from (seed, *row)."""
    calls = [0]

    def provider(kind, mask, iters, s, ids=None):
        if ids is None:
            gens = [_generator(seed, calls[0])] * mask.shape[0]
            calls[0] += 1
        else:
            gens = [_generator(seed, *map(int, row)) for row in ids]
        return ransac._draw_samples_batch(gens, torch.as_tensor(mask), iters,
                                          s).numpy()
    return provider


def _select_initial_pose(inputs: SfMInputs, table: tracks_mod.TrackTable,
                         draws: SampleProvider, cfg: IncrementalConfig,
                         num_views: int, xn: np.ndarray, host: Dict,
                         top_k: int = 200, attempts: int = 2):
    """Batched MaxPair initializer: the ``top_k`` most covisible candidate
    pairs are validated by E and H AC-RANSAC in blocks of 16, every
    surviving E is decomposed with a cheirality vote, and the parallax gate
    and the inliers x angle score pick the pair. The scan stops at the
    first block that holds a solidly wide pair.

    A candidate's inliers are those of its E that the decomposed pose
    explains within ``max_err_px``, and a pose that explains, or has in
    front of both cameras, under 70% of E's inliers counts as twisted. The
    sweep's winner need not lie on the essential manifold: on the 200-view
    synthetic corridor an off-manifold winner of a nearly planar adjacent
    pair decomposed into a pose 2.5 degrees off that fit 89 of its 258
    inliers, read a spurious 3.9 degrees of parallax (0.9 true), won the
    scan, and seeded a reconstruction with a 15% scale break (ATE 0.9-1.1%
    of the extent, against 0.15-0.21% from a wider pair).

    Returns (i, j, Rrel, trel, oi, oj, inl) or None."""
    vid, tid, intr_np, iid = (host["vid"], host["tid"], host["intr"],
                              host["iid"])
    dev = inputs.xy.device
    cand, counts = tracks_mod.covisibility_pairs(table, num_views,
                                                 min_count=30)
    pairs = [(int(c), int(i), int(j)) for c, (i, j) in zip(counts, cand)]
    # coincident revisits (near-zero image displacement) go to the back
    promoted, demoted = [], []
    for cnt, i, j in pairs[:top_k * 4]:
        oi, oj = _pair_obs(vid, tid, i, j)
        if len(oi) < 16:
            continue
        f = float(intr_np[iid[i], 0])
        disp_px = f * np.median(np.linalg.norm(xn[oi] - xn[oj], axis=1))
        (demoted if disp_px < 2.0 * cfg.max_err_px else promoted).append(
            (i, j, oi, oj))
    items = (promoted + demoted)[:top_k]
    if not items:
        return None
    P = len(items)
    cap = max(64, 1 << int(np.ceil(np.log2(max(len(g[2]) for g in items)))))
    x1 = np.zeros((P, cap, 2), np.float32)
    x2 = np.zeros((P, cap, 2), np.float32)
    mask = np.zeros((P, cap), bool)
    fs = np.zeros((P,), np.float32)
    la_e = np.zeros((P,), np.float32)
    me_e = np.zeros((P,), np.float32)
    la_h = np.zeros((P,), np.float32)
    for bi, (i, j, oi, oj) in enumerate(items):
        n = len(oi)
        f = float(intr_np[iid[i], 0])
        x1[bi, :n] = xn[oi]
        x2[bi, :n] = xn[oj]
        mask[bi, :n] = True
        fs[bi] = f
        w = float(inputs.image_sizes[i][0]) or 2.0 * f
        h = float(inputs.image_sizes[i][1]) or 2.0 * f
        la_e[bi] = np.log10(2.0 * np.hypot(w, h) / (w * h) * f)
        me_e[bi] = (cfg.max_err_px / f) ** 2
        la_h[bi] = ransac._logalpha0_point(2.0 * f, 2.0 * f)
    x1h = (x1 * fs[:, None, None]).astype(np.float32)
    x2h = (x2 * fs[:, None, None]).astype(np.float32)
    me_h = np.full((P,), np.float32(cfg.max_err_px ** 2), np.float32)

    h_ratio_threshold = 0.92
    best_low_parallax = None
    best_any = None
    best_scored = None     # (score, med_deg, out) over all viable candidates
    BLOCK = 16
    t = lambda a: torch.as_tensor(a, device=dev)
    for s0 in range(0, P, BLOCK):
        sl = slice(s0, min(s0 + BLOCK, P))
        Pb = sl.stop - sl.start
        x1b, x2b, maskb = t(x1[sl]), t(x2[sl]), t(mask[sl])
        h_valid = h_num = None
        for attempt in range(attempts):
            idx_e = draws("init_e", mask[sl], cfg.ransac_iters, 5)
            re = ransac.acransac_e_batch(None, x1b, x2b, maskb, t(la_e[sl]),
                                         t(me_e[sl]), iters=cfg.ransac_iters,
                                         idx=t(idx_e))
            if attempt == 0:
                h_iters = min(cfg.ransac_iters, 512)
                idx_h = draws("init_h", mask[sl], h_iters, 4)
                rh = ransac.acransac_h_batch(
                    None, t(x1h[sl]), t(x2h[sl]), maskb, t(la_h[sl]),
                    t(me_h[sl]), iters=h_iters, idx=t(idx_h))
                h_valid = rh.valid.cpu().numpy()
                h_num = rh.num_inliers.cpu().numpy()
            # one batched decomposition of every candidate's best E; only
            # inlier correspondences vote cheirality
            inl_dev = re.inliers & maskb
            Rb, tb, nval = geometry.decompose_essential(re.model, x1b, x2b,
                                                        mask=inl_dev)
            e_valid = re.valid.cpu().numpy()
            e_all = np.maximum(re.num_inliers.cpu().numpy(), 1)
            # the pose's own inliers: those of E's that the decomposed pose
            # explains within the bound. The sweep's winner need not be an
            # essential matrix (a float32 5-point candidate off the
            # manifold), and on a nearly planar pair such a matrix can
            # outscore every true E; its decomposition is then a pose that
            # most inliers do not fit, with a spurious parallax.
            E_pose = cameras.hat(tb) @ Rb
            r_pose = ransac._epi_resid(E_pose[:, None],
                                       {"x1": x1b, "x2": x2b})[:, 0]
            inl_dev = inl_dev & (r_pose <= t(me_e[sl])[:, None])
            e_num = inl_dev.sum(-1).cpu().numpy()
            inl_np = inl_dev.cpu().numpy()
            Rb_np, tb_np = Rb.cpu().numpy(), tb.cpu().numpy()
            # the share of E's inliers in front of both cameras, and (no
            # more than) the share the pose explains
            frac = np.minimum(nval.cpu().numpy(), e_num) / e_all

            for bi in range(Pb):
                i, j, oi, oj = items[s0 + bi]
                if not e_valid[bi] or e_num[bi] < cfg.min_initial_inliers:
                    continue
                if frac[bi] < 0.7:
                    cand_t = (frac[bi], s0 + bi, Rb_np[bi], tb_np[bi],
                              inl_np[bi][:len(oi)])
                    if best_any is None or frac[bi] > best_any[0]:
                        best_any = cand_t
                    continue
                inl = inl_np[bi][:len(oi)]
                # parallax gate: median triangulation angle of the inliers
                r1 = np.concatenate([xn[oi[inl]],
                                     np.ones((int(inl.sum()), 1))], 1)
                r2 = np.concatenate([xn[oj[inl]],
                                     np.ones((int(inl.sum()), 1))], 1)
                r1 /= np.linalg.norm(r1, axis=1, keepdims=True)
                r2w = r2 @ Rb_np[bi]
                r2w /= np.linalg.norm(r2w, axis=1, keepdims=True)
                cosang = np.clip((r1 * r2w).sum(1), -1.0, 1.0)
                med_deg = float(np.degrees(np.median(np.arccos(cosang))))
                out = (i, j, Rb_np[bi], tb_np[bi], oi, oj, inl)
                if med_deg < cfg.min_angle_deg:
                    if (best_low_parallax is None
                            or med_deg > best_low_parallax[0]):
                        best_low_parallax = (med_deg, out)
                    continue
                # viable: inliers x clamped median angle, planar-dominated
                # pairs (H explains >= 92% of matches) heavily penalized
                planar = (h_valid[bi]
                          and h_num[bi] >= h_ratio_threshold
                          * mask[s0 + bi].sum())
                score = (e_num[bi] * np.radians(min(med_deg, 10.0))
                         * (0.1 if planar else 1.0))
                if best_scored is None or score > best_scored[0]:
                    best_scored = (score, med_deg, out)
            if best_scored is not None:
                # further attempts on this block only re-draw RANSAC noise
                break
        # stop once a solidly wide viable pair is in hand
        if (best_scored is not None
                and best_scored[1] >= 1.5 * cfg.min_angle_deg):
            break
    if best_scored is not None:
        return best_scored[2]
    if best_low_parallax is not None:
        return best_low_parallax[1]
    if best_any is not None:
        _, bi, Rb_b, tb_b, inl = best_any
        i, j, oi, oj = items[bi]
        return (i, j, Rb_b, tb_b, oi, oj, inl)
    return None


def _host_columns(inputs: SfMInputs, intr) -> Dict:
    """Host copies of the index columns and of the intrinsics."""
    return {"vid": inputs.view_id.cpu().numpy(),
            "tid": inputs.track_id.cpu().numpy(),
            "iid": inputs.intr_id.cpu().numpy(), "intr": intr.cpu().numpy()}


def select_initial_pair(inputs: SfMInputs, table: tracks_mod.TrackTable,
                        draws: SampleProvider, cfg: IncrementalConfig,
                        num_views: int) -> Optional[Tuple[int, int]]:
    """The pair the MaxPair initializer picks (the reference takes a key
    where this takes a ``sample_provider``)."""
    with torch.no_grad():
        xn = _normalized_xy(inputs, inputs.intr).cpu().numpy()
        sel = _select_initial_pose(inputs, table, draws, cfg, num_views, xn,
                                   _host_columns(inputs, inputs.intr))
    return (sel[0], sel[1]) if sel else None


def _relative_pose(inputs: SfMInputs, xn: np.ndarray, i: int, j: int,
                   draws: SampleProvider, cfg: IncrementalConfig, host: Dict,
                   kind: str = "init_pair", attempts: int = 4,
                   min_valid_frac: float = 0.7):
    """Robust relative pose for a pair: AC-RANSAC E + decomposition, with a
    cheirality acceptance gate. An E model can score well a-contrario yet
    decompose into a twisted pose where only ~half the inliers sit in
    front of both cameras; such draws are retried with fresh draws.

    Returns (Rrel, trel, oi, oj, inl) with view j's pose in i's frame, or
    None."""
    oi, oj = _pair_obs(host["vid"], host["tid"], i, j)
    n = len(oi)
    if n < 16:
        return None
    cap = max(64, 1 << int(np.ceil(np.log2(n))))
    x1 = np.zeros((1, cap, 2), xn.dtype)
    x2 = np.zeros((1, cap, 2), xn.dtype)
    x1[0, :n] = xn[oi]
    x2[0, :n] = xn[oj]
    mask = np.zeros((1, cap), bool)
    mask[0, :n] = True
    f = float(host["intr"][host["iid"][i], 0])
    dev = inputs.xy.device
    t = lambda a: torch.as_tensor(a, device=dev)
    la = np.full((1,), math.log10(2.0), np.float32)
    me = np.full((1,), (cfg.max_err_px / f) ** 2, np.float32)
    best = None
    for _ in range(attempts):
        idx = draws(kind, mask, cfg.ransac_iters, 5)
        re = ransac.acransac_e_batch(None, t(x1), t(x2), t(mask), t(la),
                                     t(me), iters=cfg.ransac_iters,
                                     idx=t(idx))
        if not bool(re.valid[0]):
            continue
        inl = re.inliers[0].cpu().numpy()[:n]
        Rrel, trel, nval = geometry.decompose_essential(
            re.model, t(xn[oi[inl]])[None], t(xn[oj[inl]])[None])
        frac = float(nval[0]) / max(int(re.num_inliers[0]), 1)
        if best is None or frac > best[0]:
            best = (frac, Rrel[0].cpu().numpy(), trel[0].cpu().numpy(), oi,
                    oj, inl)
        if frac >= min_valid_frac:
            break
    if best is None or best[0] < min_valid_frac:
        return None
    return best[1:]


def _hub_edges(inputs: SfMInputs, xn: np.ndarray, hub: int, branches,
               draws: SampleProvider, cfg: IncrementalConfig, host: Dict,
               attempts: int = 4, min_valid_frac: float = 0.7,
               h_ratio_threshold: float = 0.92):
    """The stellar pod's hub edges, batched over the branches: for edge b
    = (hub, branches[b]), the planarity test (a robust homography that
    explains >= 92% of the pair's correspondences: planar scene or pure
    rotation, a degenerate E) and the robust relative pose (AC-RANSAC E +
    decomposition with the cheirality gate, up to ``attempts`` draws, the
    first with >= ``min_valid_frac`` consistent inliers wins, else the
    best). The reference takes the edges one at a time with one key per
    edge; here each batched call's rows carry ``ids`` (b,) for the
    planarity test and (b, attempt) for the poses, and rows are grouped by
    the reference's per-pair padding. Returns {b: (Rrel, trel, oi, oj,
    inl)} for the edges with a pose (j = max(hub, v) in i = min's frame);
    planar edges have none."""
    vid, tid, intr_np, iid = (host["vid"], host["tid"], host["intr"],
                              host["iid"])
    t = lambda a: torch.as_tensor(a, device=inputs.xy.device)
    live = []
    for b, v in enumerate(branches):
        i, j = min(hub, v), max(hub, v)
        oi, oj = _pair_obs(vid, tid, i, j)
        if len(oi) >= 16:
            live.append((b, oi, oj, float(intr_np[iid[i], 0])))

    def buckets(rows, pixels):
        """Rows by padded capacity, as packed (x1, x2, mask) arrays."""
        caps = {}
        for r in rows:
            caps.setdefault(max(64, 1 << int(np.ceil(np.log2(len(r[1]))))),
                            []).append(r)
        for cap, grp in sorted(caps.items()):
            x1 = np.zeros((len(grp), cap, 2), xn.dtype)
            x2 = np.zeros((len(grp), cap, 2), xn.dtype)
            mask = np.zeros((len(grp), cap), bool)
            for k, (_, oi, oj, f) in enumerate(grp):
                s = f if pixels else 1.0
                x1[k, :len(oi)] = xn[oi] * s
                x2[k, :len(oi)] = xn[oj] * s
                mask[k, :len(oi)] = True
            yield grp, x1, x2, mask

    planar = set()
    h_iters = min(cfg.ransac_iters, 512)
    for grp, x1, x2, mask in buckets(live, True):
        fs = np.array([r[3] for r in grp])
        idx = draws("stellar_h", mask, h_iters, 4,
                    ids=[(r[0],) for r in grp])
        res = ransac.acransac_h_batch(
            None, t(x1), t(x2), t(mask),
            t(np.array([ransac._logalpha0_point(2.0 * f, 2.0 * f)
                        for f in fs], np.float32)),
            t(np.full(len(grp), cfg.max_err_px ** 2, np.float32)),
            iters=h_iters, idx=t(idx))
        valid, num = res.valid.cpu().numpy(), res.num_inliers.cpu().numpy()
        for k, r in enumerate(grp):
            if valid[k] and num[k] >= h_ratio_threshold * len(r[1]):
                planar.add(r[0])

    best = {}
    pending = [r for r in live if r[0] not in planar]
    for attempt in range(attempts):
        retry = []
        for grp, x1, x2, mask in buckets(pending, False):
            fs = np.array([r[3] for r in grp])
            idx = draws("stellar_e", mask, cfg.ransac_iters, 5,
                        ids=[(r[0], attempt) for r in grp])
            x1b, x2b, maskb = t(x1), t(x2), t(mask)
            re = ransac.acransac_e_batch(
                None, x1b, x2b, maskb,
                t(np.full(len(grp), math.log10(2.0), np.float32)),
                t(((cfg.max_err_px / fs) ** 2).astype(np.float32)),
                iters=cfg.ransac_iters, idx=t(idx))
            Rb, tb, nval = geometry.decompose_essential(
                re.model, x1b, x2b, mask=re.inliers & maskb)
            valid = re.valid.cpu().numpy()
            n_inl = re.num_inliers.cpu().numpy()
            inl = re.inliers.cpu().numpy()
            Rb, tb, nval = Rb.cpu().numpy(), tb.cpu().numpy(), \
                nval.cpu().numpy()
            for k, (b, oi, oj, _) in enumerate(grp):
                if not valid[k]:
                    retry.append(grp[k])
                    continue
                frac = float(nval[k]) / max(int(n_inl[k]), 1)
                if b not in best or frac > best[b][0]:
                    best[b] = (frac, Rb[k], tb[k], oi, oj, inl[k, :len(oi)])
                if frac < min_valid_frac:
                    retry.append(grp[k])
        pending = retry
    return {b: v[1:] for b, v in best.items() if v[0] >= min_valid_frac}


def _midpoint_hub_depths(xh: np.ndarray, xv: np.ndarray,
                         Rj: np.ndarray, Cj: np.ndarray) -> np.ndarray:
    """Hub-frame depths of two-ray midpoints. ``xh``/``xv``: (N, 2)
    normalized coords in the hub / neighbour cameras; ``Rj``, ``Cj``: the
    neighbour pose in the hub frame (x_cam = Rj (X - Cj)). Negative or
    ill-conditioned rows come back <= 0."""
    dh = np.concatenate([xh, np.ones((len(xh), 1))], 1)
    dh /= np.linalg.norm(dh, axis=1, keepdims=True)
    dv = np.concatenate([xv, np.ones((len(xv), 1))], 1) @ Rj  # R^T x
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    dhv = np.sum(dh * dv, 1)
    det = 1.0 - dhv * dhv
    t = (dh @ Cj - dhv * (dv @ Cj)) / np.maximum(det, 1e-9)
    t = np.where(det > 1e-9, t, -1.0)
    return t * dh[:, 2]


def _stellar_seed(inputs: SfMInputs, table: tracks_mod.TrackTable,
                  draws: SampleProvider, cfg: IncrementalConfig,
                  num_views: int, xn: np.ndarray, host: Dict,
                  max_branches: int = 6):
    """Stellar initializer: a local reconstruction around the
    best-connected hub view (OpenMVG's SfMSceneInitializerStellar, the v2
    engine's menu entry).

    1. hub = the view with the largest summed co-visibility;
    2. each hub edge gets a robust relative pose (unit baseline) and
       hub-ray depths of its inlier tracks; an edge that a homography
       explains is left to resection (``_hub_edges``, batched);
    3. the edges' baseline scales are reconciled by a log least squares
       over the depth ratios of tracks shared between edges;
    4. every edge connected to the first one becomes a seeded pose.

    Returns (hub, {view: (R, C)}, deactivate_rows) or None when fewer than
    two edges survive (the caller falls back to MaxPair)."""
    cand, counts = tracks_mod.covisibility_pairs(table, num_views,
                                                 min_count=30)
    if len(cand) == 0:
        return None
    strength = np.zeros(num_views, np.int64)
    np.add.at(strength, cand[:, 0], counts)
    np.add.at(strength, cand[:, 1], counts)
    hub = int(np.argmax(strength))
    on_hub = (cand[:, 0] == hub) | (cand[:, 1] == hub)
    branches = [int(a if b == hub else b)
                for a, b in cand[on_hub][:2 * max_branches]]

    tid_np = host["tid"]
    poses_e = _hub_edges(inputs, xn, hub, branches, draws, cfg, host)
    edges = []    # (view, R, C_unit, {track: depth}, deact rows, hub in/out)
    for b, v in enumerate(branches):
        if len(edges) >= max_branches:
            break
        i = min(hub, v)
        if b not in poses_e:
            # no robust pose, or H-degenerate (its E would poison the pod's
            # scale graph): the view is left to resection
            continue
        rel = poses_e[b]
        # estimation frame: view i at identity; x_j = Rrel (X - Cj') with
        # Cj' = -Rrel^T trel
        Rrel, trel, oi, oj, inl = rel
        if int(inl.sum()) < cfg.min_initial_inliers:
            continue
        if hub == i:
            Rj, Cj = Rrel, -Rrel.T @ trel            # v's pose in hub frame
            oh, ov = oi, oj
        else:
            # estimated hub-in-v; inverted to v-in-hub: R_v = Rrel^T, C_v = t
            Rj, Cj = Rrel.T, trel
            oh, ov = oj, oi
        depths = _midpoint_hub_depths(xn[oh[inl]], xn[ov[inl]], Rj, Cj)
        good = depths > 1e-6
        if good.sum() < cfg.min_initial_inliers // 2:
            continue
        dmap = dict(zip(tid_np[oh[inl]][good].tolist(),
                        depths[good].tolist()))
        # a neighbour's rows are tested by one hub edge only, so its
        # outliers go; a hub row goes only if every edge that tested it
        # found it an outlier
        edges.append((v, Rj, Cj, dmap, ov[~inl], oh[inl], oh[~inl]))

    if len(edges) < 2:
        return None

    # --- reconcile the edges' baseline scales (log least squares) ---------
    k_e = len(edges)
    rows, rhs = [], []
    for a in range(k_e):
        for b in range(a + 1, k_e):
            da, db = edges[a][3], edges[b][3]
            common = set(da) & set(db)
            if len(common) < 5:
                continue
            logr = np.log([da[t] / db[t] for t in common
                           if da[t] > 0 and db[t] > 0])
            if len(logr) < 5:
                continue
            row = np.zeros(k_e)
            row[a], row[b] = 1.0, -1.0
            rows.append(row)
            rhs.append(-float(np.median(logr)))   # s_a d_a = s_b d_b
    if not rows:
        return None
    # keep the edges reachable from edge 0 through the constraints
    adj = [set() for _ in range(k_e)]
    for row in rows:
        a, b = int(np.argmax(row)), int(np.argmin(row))
        adj[a].add(b)
        adj[b].add(a)
    seen = {0}
    stack = [0]
    while stack:
        n = stack.pop()
        for m in adj[n]:
            if m not in seen:
                seen.add(m)
                stack.append(m)
    keep = sorted(seen)
    if len(keep) < 2:
        return None
    remap = {e: i for i, e in enumerate(keep)}
    A = np.zeros((len(rows) + 1, len(keep)))
    bvec = np.zeros(len(rows) + 1)
    nrow = 0
    for row, r in zip(rows, rhs):
        a, b = int(np.argmax(row)), int(np.argmin(row))
        if a in remap and b in remap:
            A[nrow, remap[a]] = 1.0
            A[nrow, remap[b]] = -1.0
            bvec[nrow] = r
            nrow += 1
    A[nrow, 0] = 1.0          # anchor: the first edge's scale is 1
    logs = np.linalg.lstsq(A[:nrow + 1], bvec[:nrow + 1], rcond=None)[0]
    scales = np.exp(logs)

    poses = {hub: (np.eye(3), np.zeros(3))}
    deact_nbr, hub_in, hub_out = [], [], []
    for i, e in enumerate(keep):
        v, Rj, Cj, _, deact_v, oh_in, oh_out = edges[e]
        poses[v] = (Rj, Cj * scales[i])
        deact_nbr.append(deact_v)
        hub_in.append(oh_in)
        hub_out.append(oh_out)
    hub_deact = np.setdiff1d(np.concatenate(hub_out),
                             np.concatenate(hub_in))
    return hub, poses, np.concatenate(deact_nbr + [hub_deact])


def run_incremental(inputs: SfMInputs,
                    initial_pair: Optional[Tuple[int, int]] = None,
                    cfg: IncrementalConfig = IncrementalConfig(),
                    seed: int = 0,
                    verbose: bool = False,
                    center_priors=None,
                    prior_weight: float = 1.0,
                    device=None,
                    sample_provider: Optional[SampleProvider] = None
                    ) -> SfMResult:
    """Run the incremental pipeline on ``device`` (default cuda; raises with
    no card unless the CPU is asked for). ``initial_pair=None`` seeds from
    ``cfg.initializer`` (v2: MaxPair, or a stellar pod that falls back to
    MaxPair when fewer than two hub edges survive); passing a pair
    reproduces v1 and ignores the initializer. ``sample_provider``: see the
    module docstring.

    ``center_priors``: optional (V, 3) camera-center priors in a local
    metric frame (GPS -> ENU; NaN rows for views without one). The
    reconstruction runs in a free gauge and is Sim3-aligned to the priors
    before a final BA with the center-prior term at ``prior_weight``."""
    dev = runtime.resolve_device(device)
    draws = sample_provider or default_provider(seed)
    inputs = inputs._replace(**{k: getattr(inputs, k).to(dev) for k in (
        "xy", "track_id", "view_id", "feature_id", "intr_id", "intr",
        "models")})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    V = inputs.intr_id.shape[0]
    T = inputs.num_tracks
    O = inputs.xy.shape[0]
    dtype = inputs.xy.dtype

    intr = inputs.intr.to(dtype)
    R = torch.eye(3, dtype=dtype, device=dev).expand(V, 3, 3).clone()
    C = torch.zeros((V, 3), dtype=dtype, device=dev)
    pose_mask = np.zeros(V, bool)
    obs_active = np.ones(O, bool)
    track_ok = np.zeros(T, bool)
    X = torch.zeros((T, 3), dtype=dtype, device=dev)

    host = _host_columns(inputs, intr)          # read once
    vid_np, tid_np, iid_np = host["vid"], host["tid"], host["iid"]
    table = tracks_mod.TrackTable(tid_np, vid_np,
                                  inputs.feature_id.cpu().numpy(), T)

    # --- initialization: a stellar pod, the user's pair (v1) or MaxPair ---
    pod_size = 0
    with spans.span("triangulation.init") as sp_init, torch.no_grad():
        xn = _normalized_xy(inputs, intr).cpu().numpy()
        if initial_pair is None and cfg.initializer == "stellar":
            pod = _stellar_seed(inputs, table, draws, cfg, V, xn, host)
            if pod is not None:
                i0, poses, deact = pod
                for v, (Rv, Cv) in poses.items():
                    R[v] = torch.as_tensor(Rv, dtype=dtype, device=dev)
                    C[v] = torch.as_tensor(Cv, dtype=dtype, device=dev)
                    pose_mask[v] = True
                obs_active[deact] = False
                pod_size = len(poses)
        if pod_size == 0:
            if initial_pair is not None:
                # v1: the user's pair, a serial robust pose with retries
                i0, j0 = initial_pair
                rel = (_relative_pose(inputs, xn, i0, j0, draws, cfg, host)
                       or _relative_pose(inputs, xn, i0, j0, draws, cfg,
                                         host, kind="init_pair_retry",
                                         attempts=1, min_valid_frac=0.0))
                if rel is None:
                    raise ValueError(
                        f"initial pair {initial_pair} has no robust E")
                Rrel, trel, oi, oj, inl = rel
            else:
                sel = _select_initial_pose(inputs, table, draws, cfg, V, xn,
                                           host)
                if sel is None:
                    raise ValueError(
                        "no initial pair with a cheirality-consistent pose")
                i0, j0, Rrel, trel, oi, oj, inl = sel
            R[j0] = torch.as_tensor(Rrel, dtype=dtype, device=dev)
            C[j0] = torch.as_tensor(-Rrel.T @ trel, dtype=dtype, device=dev)
            pose_mask[[i0, j0]] = True
            # deactivate pair observations that failed the E filter
            obs_active[oi[~inl]] = False
            obs_active[oj[~inl]] = False
        sync()

    tid, vid = inputs.track_id, inputs.view_id
    g_obs = inputs.intr_id[vid]
    mean_focal = float(np.mean(host["intr"][:, 0]))
    tri_table = track_table(tid, T)

    prof = {"resection_s": 0.0, "triangulation_s": 0.0, "ba_s": 0.0,
            "outlier_s": 0.0, "host_s": 0.0, "init_s": sp_init.seconds,
            "resection_rounds": 0, "ba_rounds": 0, "ba_iters": 0}

    def residuals_px():
        return reprojection_residuals_px(R, C, intr, inputs.models, g_obs,
                                         vid, tid, X, inputs.xy)

    def retriangulate():
        nonlocal X, track_ok
        with spans.span("triangulation.triangulation") as sp, \
                torch.no_grad():
            tri = triangulate_tracks(
                R, C, torch.as_tensor(pose_mask, device=dev), tid, vid,
                torch.as_tensor(obs_active, device=dev),
                _bearings(inputs, intr), T, cfg.min_angle_deg,
                cfg.max_err_px, mean_focal, table=tri_table)
            X = tri.X
            track_ok = tri.ok.cpu().numpy()
        prof["triangulation_s"] += sp.seconds

    retriangulate()

    ba_layout = []     # built once: the index tables never change

    def run_ba(iterations, refine):
        nonlocal R, C, X, intr
        with spans.span("triangulation.ba") as sp:
            w = obs_active & track_ok[tid_np] & pose_mask[vid_np]
            obs_ba = lm.BAObservations(
                view_id=vid, intr_id=g_obs, point_id=tid,
                model=inputs.models[g_obs], xy=inputs.xy,
                weight=torch.as_tensor(w, dtype=dtype, device=dev))
            if not ba_layout:
                ba_layout.append(lm.make_layout(obs_ba, V, T,
                                                int(intr.shape[0])))
            fixed = torch.as_tensor(~pose_mask | (np.arange(V) == i0),
                                    device=dev)
            state = lm.BAState(R=R, C=C, intr=intr, X=X)
            opts = lm.BAOptions(max_iterations=iterations,
                                refine_intrinsics=refine,
                                huber_delta_px=cfg.huber_delta_px)
            out, stats = lm.bundle_adjust(state, obs_ba, opts,
                                          fixed_pose_mask=fixed,
                                          layout=ba_layout[0], device=dev)
            R, C, intr, X = out.R, out.C, out.intr, out.X
            sync()
        prof["ba_s"] += sp.seconds
        prof["ba_rounds"] += 1
        prof["ba_iters"] += stats.iterations
        return stats

    def reject_outliers():
        nonlocal obs_active
        with spans.span("triangulation.outlier") as sp:
            with torch.no_grad():
                r2 = residuals_px().cpu().numpy()
            live = obs_active & track_ok[tid_np] & pose_mask[vid_np]
            bad = live & (r2 > cfg.max_err_px ** 2)
            obs_active &= ~bad
        prof["outlier_s"] += sp.seconds
        return int(bad.sum())

    run_ba(cfg.ba_iterations, False)
    retriangulate()

    # --- grow: views resected in batched groups ---------------------------
    order_v = np.argsort(vid_np, kind="stable")
    v_starts = np.searchsorted(vid_np[order_v], np.arange(V + 1))
    rows_of_view = lambda v: order_v[v_starts[v]:v_starts[v + 1]]
    # one padded row capacity for every round (row counts only shrink), as
    # the reference: the padding enters each draw's truncated score
    counts0 = np.bincount(vid_np, minlength=V)
    cap_res = max(64, 1 << int(np.ceil(np.log2(max(int(counts0.max()), 1)))))

    added_since_ba = 0
    order_added = [int(v) for v in np.nonzero(pose_mask)[0]]
    failed_at: Dict[int, int] = {}     # view -> score when resection failed
    while True:
        with spans.span("triangulation.select") as sp:
            vis_rows = obs_active & track_ok[tid_np]
            scores = np.bincount(vid_np[vis_rows], minlength=V)
            cand_scores = {}
            for v in np.nonzero(~pose_mask)[0]:
                vis = int(scores[v])
                if vis < cfg.min_resection_points:
                    continue
                if v in failed_at and vis < 1.2 * failed_at[v]:
                    continue
                cand_scores[int(v)] = vis
            if not cand_scores:
                break
            best_score = max(cand_scores.values())
            thresh = max(cfg.min_resection_points,
                         int(cfg.resection_group_frac * best_score))
            group = sorted((v for v, s in cand_scores.items() if s >= thresh),
                           key=lambda v: -cand_scores[v])
            group = group[:max(1, cfg.resection_group)]

            g_rows = []
            for v in group:
                rows = rows_of_view(v)
                rows = rows[obs_active[rows]]
                rows = rows[track_ok[tid_np[rows]]]
                g_rows.append(rows)
            P = len(group)
            Xh = X.cpu().numpy()
            Xv = np.zeros((P, cap_res, 3), Xh.dtype)
            xv = np.zeros((P, cap_res, 2), xn.dtype)
            maskv = np.zeros((P, cap_res), bool)
            max_err = np.full((P,), 1.0, np.float32)
            for bi, (v, rows) in enumerate(zip(group, g_rows)):
                n = len(rows)
                Xv[bi, :n] = Xh[tid_np[rows]]
                xv[bi, :n] = xn[rows]
                maskv[bi, :n] = True
                max_err[bi] = (cfg.max_err_px
                               / float(host["intr"][iid_np[v], 0])) ** 2
            idx = draws("resection", maskv, cfg.resection_iters, 3)
        prof["host_s"] += sp.seconds

        with spans.span("triangulation.resection", views=P) as sp, \
                torch.no_grad():
            t = lambda a: torch.as_tensor(a, device=dev)
            rr = ransac.acransac_resection_batch(
                None, t(Xv), t(xv), t(maskv), t(max_err).to(dtype),
                iters=cfg.resection_iters, idx=t(idx))
            valid = rr.valid.cpu().numpy()
            inl_all = rr.inliers.cpu().numpy()
        prof["resection_s"] += sp.seconds
        prof["resection_rounds"] += 1

        with spans.span("triangulation.select") as sp:
            accepted = [bi for bi in range(P) if valid[bi]]
            for bi in range(P):
                v = group[bi]
                if valid[bi]:
                    failed_at.pop(v, None)
                else:
                    failed_at[v] = cand_scores[v]
            if accepted:
                acc_views = torch.as_tensor([group[bi] for bi in accepted],
                                            device=dev)
                acc_idx = torch.as_tensor(accepted, device=dev)
                R = R.clone()
                C = C.clone()
                R[acc_views] = rr.R[acc_idx]
                C[acc_views] = rr.C[acc_idx]
                pose_mask[[group[bi] for bi in accepted]] = True
                order_added.extend(group[bi] for bi in accepted)
                for bi in accepted:
                    rows = g_rows[bi]
                    obs_active[rows[~inl_all[bi, :len(rows)]]] = False
        prof["host_s"] += sp.seconds
        if accepted:
            retriangulate()
            added_since_ba += len(accepted)
        if added_since_ba >= cfg.ba_every:
            run_ba(cfg.ba_iterations, False)
            reject_outliers()
            retriangulate()
            added_since_ba = 0
        if verbose and accepted:
            print(f"added {len(accepted)} views (group {P}): "
                  f"{int(track_ok.sum())} tracks, "
                  f"{int(pose_mask.sum())}/{V} cams")

    # --- final polish -----------------------------------------------------
    run_ba(cfg.final_ba_iterations, cfg.refine_intrinsics)
    reject_outliers()
    retriangulate()
    run_ba(cfg.ba_iterations, cfg.refine_intrinsics)
    retriangulate()

    # --- GPS anchoring (the use-GPS option) --------------------------------
    if center_priors is not None:
        pri = np.asarray(center_priors, np.float64)
        pm = pose_mask & np.isfinite(pri).all(axis=1)
        if pm.sum() >= 3:
            with spans.span("triangulation.ba"):
                C_np = C.cpu().numpy()
                sim = metrics.umeyama(C_np[pm], pri[pm])
                # x_cam = R_v (X - C_v); world transform X' = s R X + t:
                # R'_v = R_v R^T, C'_v = s R C_v + t, X' likewise
                Cn = sim.apply(C_np)
                f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
                R = f(np.einsum("vij,kj->vik", R.cpu().numpy(), sim.R))
                C = f(Cn)
                X = f(sim.apply(X.cpu().numpy()))
                w = obs_active & track_ok[tid_np] & pose_mask[vid_np]
                obs_ba = lm.BAObservations(
                    view_id=vid, intr_id=g_obs, point_id=tid,
                    model=inputs.models[g_obs], xy=inputs.xy,
                    weight=f(w))
                opts = lm.BAOptions(max_iterations=cfg.ba_iterations,
                                    refine_intrinsics=cfg.refine_intrinsics,
                                    huber_delta_px=cfg.huber_delta_px,
                                    center_prior_weight=prior_weight)
                out, _ = lm.bundle_adjust(
                    lm.BAState(R=R, C=C, intr=intr, X=X), obs_ba, opts,
                    fixed_pose_mask=torch.as_tensor(~pose_mask, device=dev),
                    center_prior=f(np.where(pm[:, None], pri, Cn)),
                    layout=ba_layout[0], device=dev)
                R, C, intr, X = out.R, out.C, out.intr, out.X
                sync()
            retriangulate()

    with torch.no_grad():
        r2 = residuals_px().cpu().numpy()
    live = obs_active & track_ok[tid_np] & pose_mask[vid_np]
    rms = float(np.sqrt(r2[live].mean())) if live.any() else float("nan")
    resid = np.sqrt(r2[live]) if live.any() else np.zeros(1)
    stats = {
        "num_cameras": int(pose_mask.sum()),
        "num_tracks": int(track_ok.sum()),
        "num_observations": int(live.sum()),
        "rms_px": rms,
        "residual_min": float(resid.min()),
        "residual_max": float(resid.max()),
        "residual_mean": float(resid.mean()),
        "residual_median": float(np.median(resid)),
        "order_added": order_added,
        "profile": dict(prof),
        "init_hub": int(i0),
    }
    if pod_size:
        stats["stellar_pod_size"] = pod_size
    else:
        stats["init_pair"] = (int(i0), int(j0))
    return SfMResult(R, C, pose_mask, X, track_ok, obs_active, intr, stats)
