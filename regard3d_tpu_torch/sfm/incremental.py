"""Incremental SfM engine (the incremental2 engine with the MaxPair
initializer).

Counterpart of ``regard3d_tpu/sfm/incremental.py`` (OpenMVG's
``SequentialSfMReconstructionEngine2`` as the reference drives it):

  initial pair (batched E/H AC-RANSAC over the most covisible pairs,
  cheirality vote, parallax gate, scored scan) -> triangulate
  -> { resect the group of best-covered views (batched P3P AC-RANSAC)
       -> retriangulate -> bundle adjust every ``ba_every`` views
       -> reject outlier observations } until no view is left
  -> final BA (+ intrinsic refinement) and polish.

The which-view-next loop stays on the host; every step inside it runs on
the engine's device. Each phase opens a ``torch.profiler`` span
(``triangulation.init``, ``.resection``, ``.triangulation``, ``.ba``,
``.outlier``) that ends in a device synchronize, so a trace attributes every
device operation to its phase; ``stats["profile"]`` holds the same keys as
the reference's.

Random draws: the reference draws its initializer and resection samples
from a ``jax.random`` key chain. Here every batched AC-RANSAC call asks a
``sample_provider(kind, mask, iters, s) -> (B, iters, s)`` for its sample
indices, with ``kind`` one of ``"init_e"``, ``"init_h"``, ``"resection"``
and ``mask`` the (B, N) numpy mask of the call's rows, in the reference's
call order. The default provider draws from one CPU ``torch.Generator`` per
call, seeded from (seed, call index); parity tests replay the reference's
key chain instead.

Waiting for a later slice (each raises ``NotImplementedError``): the
stellar initializer, the v1 user-chosen initial pair and center priors
(ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.ba import lm
from regard3d_tpu_torch.core import cameras
from regard3d_tpu_torch.kernels import geometry, ransac
from regard3d_tpu_torch.sfm import tracks as tracks_mod
from regard3d_tpu_torch.sfm.triangulate import (reprojection_residuals_px,
                                                track_table,
                                                triangulate_tracks)

SampleProvider = Callable[[str, np.ndarray, int, int], np.ndarray]


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
    initializer: str = "maxpair"       # "maxpair" | "stellar" (stellar
                                       # waits for a later slice)
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


def default_provider(seed: int) -> SampleProvider:
    """Draws from one CPU generator per call, seeded from (seed, call)."""
    calls = [0]

    def provider(kind, mask, iters, s):
        ss = np.random.SeedSequence([seed, calls[0]])
        calls[0] += 1
        g = torch.Generator()
        g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
        return ransac._draw_samples_batch([g] * mask.shape[0],
                                          torch.as_tensor(mask), iters,
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
            e_num = re.num_inliers.cpu().numpy()
            inl_np = inl_dev.cpu().numpy()
            Rb_np, tb_np = Rb.cpu().numpy(), tb.cpu().numpy()
            frac = nval.cpu().numpy() / np.maximum(e_num, 1)

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


def run_incremental(inputs: SfMInputs,
                    initial_pair: Optional[Tuple[int, int]] = None,
                    cfg: IncrementalConfig = IncrementalConfig(),
                    seed: int = 0,
                    verbose: bool = False,
                    center_priors=None,
                    device=None,
                    sample_provider: Optional[SampleProvider] = None
                    ) -> SfMResult:
    """Run the incremental pipeline with the MaxPair initializer on
    ``device`` (default cuda; raises with no card unless the CPU is asked
    for). ``sample_provider``: see the module docstring."""
    if initial_pair is not None:
        raise NotImplementedError(
            "the v1 user-chosen initial pair waits for a later slice "
            "(ROADMAP §1 item 7)")
    if cfg.initializer != "maxpair":
        raise NotImplementedError(
            f"initializer {cfg.initializer!r}: only maxpair is ported; the "
            "stellar initializer waits for a later slice (ROADMAP §1 item 6)")
    if center_priors is not None:
        raise NotImplementedError(
            "center priors (GPS anchoring) wait for a later slice "
            "(ROADMAP §1 item 8)")
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

    # host copies of the index columns and of the intrinsics, read once
    vid_np = inputs.view_id.cpu().numpy()
    tid_np = inputs.track_id.cpu().numpy()
    iid_np = inputs.intr_id.cpu().numpy()
    host = {"vid": vid_np, "tid": tid_np, "iid": iid_np,
            "intr": intr.cpu().numpy()}
    table = tracks_mod.TrackTable(tid_np, vid_np,
                                  inputs.feature_id.cpu().numpy(), T)

    # --- initialization: the MaxPair initial pair -------------------------
    t_init0 = time.perf_counter()
    with record_function("triangulation.init"), torch.no_grad():
        xn = _normalized_xy(inputs, intr).cpu().numpy()
        sel = _select_initial_pose(inputs, table, draws, cfg, V, xn, host)
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
    init_elapsed = time.perf_counter() - t_init0

    tid, vid = inputs.track_id, inputs.view_id
    g_obs = inputs.intr_id[vid]
    mean_focal = float(np.mean(host["intr"][:, 0]))
    tri_table = track_table(tid, T)

    prof = {"resection_s": 0.0, "triangulation_s": 0.0, "ba_s": 0.0,
            "outlier_s": 0.0, "host_s": 0.0, "init_s": init_elapsed,
            "resection_rounds": 0, "ba_rounds": 0, "ba_iters": 0}

    def residuals_px():
        return reprojection_residuals_px(R, C, intr, inputs.models, g_obs,
                                         vid, tid, X, inputs.xy)

    def retriangulate():
        nonlocal X, track_ok
        t0 = time.perf_counter()
        with record_function("triangulation.triangulation"), torch.no_grad():
            tri = triangulate_tracks(
                R, C, torch.as_tensor(pose_mask, device=dev), tid, vid,
                torch.as_tensor(obs_active, device=dev),
                _bearings(inputs, intr), T, cfg.min_angle_deg,
                cfg.max_err_px, mean_focal, table=tri_table)
            X = tri.X
            track_ok = tri.ok.cpu().numpy()
        prof["triangulation_s"] += time.perf_counter() - t0

    retriangulate()

    ba_layout = []     # built once: the index tables never change

    def run_ba(iterations, refine):
        nonlocal R, C, X, intr
        t0 = time.perf_counter()
        with record_function("triangulation.ba"):
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
        prof["ba_s"] += time.perf_counter() - t0
        prof["ba_rounds"] += 1
        prof["ba_iters"] += stats.iterations
        return stats

    def reject_outliers():
        nonlocal obs_active
        t0 = time.perf_counter()
        with record_function("triangulation.outlier"), torch.no_grad():
            r2 = residuals_px().cpu().numpy()
        live = obs_active & track_ok[tid_np] & pose_mask[vid_np]
        bad = live & (r2 > cfg.max_err_px ** 2)
        obs_active &= ~bad
        prof["outlier_s"] += time.perf_counter() - t0
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
        t_host = time.perf_counter()
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
            max_err[bi] = (cfg.max_err_px / float(host["intr"][iid_np[v], 0])
                           ) ** 2
        idx = draws("resection", maskv, cfg.resection_iters, 3)
        prof["host_s"] += time.perf_counter() - t_host

        t_res = time.perf_counter()
        with record_function("triangulation.resection"), torch.no_grad():
            t = lambda a: torch.as_tensor(a, device=dev)
            rr = ransac.acransac_resection_batch(
                None, t(Xv), t(xv), t(maskv), t(max_err).to(dtype),
                iters=cfg.resection_iters, idx=t(idx))
            valid = rr.valid.cpu().numpy()
            inl_all = rr.inliers.cpu().numpy()
        prof["resection_s"] += time.perf_counter() - t_res
        prof["resection_rounds"] += 1

        t_host = time.perf_counter()
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
            prof["host_s"] += time.perf_counter() - t_host
            retriangulate()
            added_since_ba += len(accepted)
        else:
            prof["host_s"] += time.perf_counter() - t_host
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
        "init_pair": (int(i0), int(j0)),
    }
    return SfMResult(R, C, pose_mask, X, track_ok, obs_active, intr, stats)
