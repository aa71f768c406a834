"""Triangulation (SfM) stage driver.

Counterpart of ``regard3d_tpu/pipeline/triangulation_step.py``: features +
filtered matches -> tracks -> the incremental2 engine with the MaxPair
initializer -> artifacts: ``scene.npz`` (the ``sfm_data.bin`` role),
``sfm_data.json``, ``cloud_and_poses.ply``, ``FinalColorized.ply``,
``Reconstruction_Report.html``, with the reference's residual statistics.

Runs on ``device`` (default cuda; raises with no card unless the CPU is
asked for). Waiting for later slices, each raising ``NotImplementedError``:
the global engine, the v1 engine (user initial pair), the stellar
initializer, GPS center priors, the sharded BA polish and float64 engines
(ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.core import sfm_data
from regard3d_tpu_torch.core.types import Scene
from regard3d_tpu_torch.export import ply as ply_mod
from regard3d_tpu_torch.pipeline import compute_matches as cm
from regard3d_tpu_torch.pipeline import features as feat_mod
from regard3d_tpu_torch.pipeline.report import (scene_snapshots_svg,
                                                write_html_report)
from regard3d_tpu_torch.sfm import incremental, tracks as tracks_mod
from regard3d_tpu_torch.sfm.triangulate import reprojection_residuals_px


@dataclasses.dataclass(frozen=True)
class TriangulationParams:
    """Engine menu parity (src/R3DProject.h:258-266)."""
    engine: str = "incremental2"      # incremental | incremental2 | global
    initial_pair: Optional[Tuple[int, int]] = None     # incremental v1
    initializer: str = "maxpair"      # incremental2: maxpair | stellar
    rotation_averaging: str = "l2"                     # global: l1 | l2
    translation_averaging: str = "softl1"  # l1 | l2_chordal | softl1
    refine_intrinsics: bool = True
    use_gps: bool = False
    matches_kind: str = "f"           # global engine requires "e"
    min_pair_matches: int = 30        # global: pair-support gate
    f64: bool = False                 # float64 engines
    dist_ba: bool = False             # final BA sharded over all devices
    dist_ba_iterations: int = 30
    ba_every: int = 3                 # incremental: local BA cadence
    ba_iterations: int = 20
    final_ba_iterations: int = 40     # the post-growth polish


def build_sfm_inputs(matches_dir: str, num_images: int,
                     intr_id: np.ndarray, intr: np.ndarray,
                     models: np.ndarray, image_sizes: np.ndarray,
                     matches_kind: str = "f", dtype=np.float32,
                     device="cpu"):
    """Features + match files -> tracks -> SfMInputs on ``device``."""
    matches = cm.load_matches_txt(
        os.path.join(matches_dir, f"matches.{matches_kind}.txt"))
    table = tracks_mod.build_tracks(matches)
    xy = np.zeros((len(table.track_id), 2), dtype)
    vid = np.asarray(table.view_id)
    fid = np.asarray(table.feature_id)
    order = np.argsort(vid, kind="stable")
    starts = np.searchsorted(vid[order], np.arange(num_images + 1))
    for v in range(num_images):
        rows = order[starts[v]:starts[v + 1]]
        if len(rows):
            xy[rows] = feat_mod.load_features(matches_dir, v)[0][fid[rows]]
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return incremental.SfMInputs(
        xy=t(xy, torch.float32),
        track_id=t(table.track_id, torch.int64),
        view_id=t(table.view_id, torch.int64),
        feature_id=t(table.feature_id, torch.int64),
        num_tracks=table.num_tracks,
        intr_id=t(intr_id, torch.int64),
        intr=t(np.asarray(intr, dtype), torch.float32),
        models=t(models, torch.int64),
        image_sizes=image_sizes,
    ), table


def result_to_scene(result: incremental.SfMResult,
                    inputs: incremental.SfMInputs,
                    image_sizes: np.ndarray,
                    colors: Optional[np.ndarray] = None) -> Scene:
    """Pack an engine result into the persistent Scene container (CPU)."""
    V = len(image_sizes)
    T = inputs.num_tracks
    O = inputs.xy.shape[0]
    K = inputs.intr.shape[0]
    s = Scene.empty(V, K, T, O)
    cpu = lambda x: x.detach().cpu()
    i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32))
    tid = cpu(inputs.track_id).numpy()
    vid = cpu(inputs.view_id).numpy()
    live = result.obs_active & result.track_ok[tid] & result.pose_mask[vid]
    return s.replace(
        views=s.views.replace(
            width=i32(image_sizes[:, 0]), height=i32(image_sizes[:, 1]),
            intrinsic_id=i32(cpu(inputs.intr_id)),
            mask=torch.ones((V,), dtype=torch.bool)),
        intrinsics=s.intrinsics.replace(
            model=i32(cpu(inputs.models)), params=cpu(result.intr),
            mask=torch.ones((K,), dtype=torch.bool)),
        poses=s.poses.replace(R=cpu(result.R), C=cpu(result.C),
                              mask=torch.as_tensor(result.pose_mask)),
        landmarks=s.landmarks.replace(
            X=cpu(result.X),
            color=(torch.as_tensor(colors, dtype=torch.float32)
                   if colors is not None else torch.full((T, 3), 0.8)),
            mask=torch.as_tensor(result.track_ok)),
        observations=s.observations.replace(
            landmark_id=i32(tid), view_id=i32(vid), xy=cpu(inputs.xy),
            feature_id=i32(cpu(inputs.feature_id)),
            mask=torch.as_tensor(live)),
    )


def colorize_tracks(inputs, result, images: Sequence[np.ndarray]
                    ) -> np.ndarray:
    """Track colors from the first observing image (ColorizeTracks parity).
    images: gray or RGB float arrays."""
    T = inputs.num_tracks
    colors = np.full((T, 3), 0.8, np.float32)
    tid = inputs.track_id.cpu().numpy()
    vid = inputs.view_id.cpu().numpy()
    xy = inputs.xy.cpu().numpy()
    order = np.argsort(tid, kind="stable")
    uniq, first = np.unique(tid[order], return_index=True)
    rows = order[first]
    live = np.asarray(result.track_ok)[uniq]
    uniq, rows = uniq[live], rows[live]
    vorder = np.argsort(vid[rows], kind="stable")
    uniq, rows = uniq[vorder], rows[vorder]
    bounds = np.searchsorted(vid[rows], np.arange(len(images) + 1))
    for v in range(len(images)):
        sel = slice(bounds[v], bounds[v + 1])
        if sel.start == sel.stop:
            continue
        img = np.asarray(images[v])
        x = np.clip(np.rint(xy[rows[sel], 0]), 0,
                    img.shape[1] - 1).astype(np.int64)
        y = np.clip(np.rint(xy[rows[sel], 1]), 0,
                    img.shape[0] - 1).astype(np.int64)
        c = img[y, x]
        colors[uniq[sel]] = c[:, None] if c.ndim == 1 else c[:, :3]
    return colors


def _check_params(params: TriangulationParams):
    if params.engine == "global":
        raise NotImplementedError(
            "engine='global' waits for a later slice (ROADMAP §1 item 10)")
    if params.engine == "incremental":
        raise NotImplementedError(
            "engine='incremental' (v1, user initial pair) waits for a later "
            "slice (ROADMAP §1 item 7)")
    if params.dist_ba:
        raise NotImplementedError(
            "dist_ba=True (sharded BA) waits for a later slice (ROADMAP §1 "
            "item 11)")
    if params.f64:
        raise NotImplementedError(
            "f64=True (float64 engines) waits for a later slice "
            "(ROADMAP §1 item 9)")
    if params.use_gps:
        raise NotImplementedError(
            "use_gps=True (center priors) waits for a later slice "
            "(ROADMAP §1 item 8)")


def run_triangulation(matches_dir: str, out_dir: str,
                      images: Sequence[np.ndarray],
                      intr_id: np.ndarray, intr: np.ndarray,
                      models: np.ndarray,
                      params: TriangulationParams = TriangulationParams(),
                      image_names: Optional[List[str]] = None,
                      seed: int = 0, device=None,
                      sample_provider: Optional[
                          incremental.SampleProvider] = None) -> Dict:
    """Full triangulation step; writes the artifacts; returns stats.
    ``sample_provider``: the engine's draws (``sfm/incremental.py``)."""
    _check_params(params)
    dev = runtime.resolve_device(device)
    t0 = time.time()
    os.makedirs(out_dir, exist_ok=True)
    image_sizes = np.asarray([[im.shape[1], im.shape[0]] for im in images])

    inputs, table = build_sfm_inputs(matches_dir, len(images), intr_id, intr,
                                     models, image_sizes, params.matches_kind,
                                     device=dev)
    result = incremental.run_incremental(
        inputs, cfg=incremental.IncrementalConfig(
            refine_intrinsics=params.refine_intrinsics,
            initializer=params.initializer,
            ba_every=params.ba_every,
            ba_iterations=params.ba_iterations,
            final_ba_iterations=params.final_ba_iterations),
        seed=seed, device=dev, sample_provider=sample_provider)

    colors = colorize_tracks(inputs, result, images)
    scene = result_to_scene(result, inputs, image_sizes, colors)
    ok = np.asarray(result.track_ok)
    X_np = result.X.cpu().numpy()
    C_np = result.C.cpu().numpy()
    sfm_data.save_npz(os.path.join(out_dir, "scene.npz"), scene)
    sfm_data.save_json(os.path.join(out_dir, "sfm_data.json"), scene,
                       image_names)
    rgb = np.clip(colors[ok] * 255, 0, 255).astype(np.uint8)
    ply_mod.export_cloud_and_poses(
        os.path.join(out_dir, "cloud_and_poses.ply"), X_np[ok], rgb,
        C_np[result.pose_mask])
    ply_mod.write_ply(os.path.join(out_dir, "FinalColorized.ply"),
                      ply_mod.PlyData(xyz=X_np[ok], rgb=rgb))
    stats = dict(result.stats)
    stats["elapsed_s"] = time.time() - t0

    # per-view residual tables + histogram (Generate_SfM_Report parity)
    tid = inputs.track_id.cpu().numpy()
    vid = inputs.view_id.cpu().numpy()
    with torch.no_grad():
        r2 = reprojection_residuals_px(
            result.R, result.C, result.intr, inputs.models,
            inputs.intr_id[inputs.view_id], inputs.view_id, inputs.track_id,
            result.X, inputs.xy).cpu().numpy()
    live = result.obs_active & result.track_ok[tid] & result.pose_mask[vid]
    r = np.sqrt(r2[live])
    vlive = vid[live]
    V = len(images)
    n_obs = np.bincount(vlive, minlength=V)
    sums = np.bincount(vlive, weights=r, minlength=V)
    vorder = np.argsort(vlive, kind="stable")
    vbounds = np.searchsorted(vlive[vorder], np.arange(V + 1))
    views_rows = []
    for v in range(V):
        rv = r[vorder[vbounds[v]:vbounds[v + 1]]]
        views_rows.append({
            "id": v,
            "name": image_names[v] if image_names else "",
            "width": int(image_sizes[v, 0]),
            "height": int(image_sizes[v, 1]),
            "posed": bool(result.pose_mask[v]),
            "n_obs": int(n_obs[v]),
            "mean_px": float(sums[v] / n_obs[v]) if n_obs[v] else float("nan"),
            "median_px": float(np.median(rv)) if len(rv) else float("nan"),
        })
    if len(r):
        counts, edges = np.histogram(r, bins=20,
                                     range=(0.0, max(4.0, float(r.max()))))
        hist = (edges, counts)
    else:
        hist = None
    snaps = scene_snapshots_svg(C_np, result.R.cpu().numpy(),
                                result.pose_mask, X_np, ok, colors=colors)
    write_html_report(os.path.join(out_dir, "Reconstruction_Report.html"),
                      stats, params, views=views_rows, histogram=hist,
                      snapshots=snaps)
    return stats
