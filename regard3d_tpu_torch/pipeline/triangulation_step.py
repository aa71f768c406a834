"""Triangulation (SfM) stage driver.

Counterpart of ``regard3d_tpu/pipeline/triangulation_step.py``: features +
filtered matches -> tracks -> an engine of the menu (incremental2 with
the MaxPair or the stellar initializer, v1 from the user's initial pair,
optional GPS center priors; or the global engine on the E-filtered
matches, with its averaging menus) -> artifacts: ``scene.npz`` (the
``sfm_data.bin`` role), ``sfm_data.json``, ``cloud_and_poses.ply``,
``FinalColorized.ply``, ``Reconstruction_Report.html``, with the
reference's residual statistics.

Runs on ``device`` (default cuda; raises with no card unless the CPU is
asked for). ``f64=True`` runs the float64 engines: the inputs, the engine
state, triangulation and BA in float64, the minimal-solver sweeps in
float32 as in the reference. ``dist_ba=True`` adds a final BA polish
sharded over every card of the process (point blocks) or over the ranks of
a multi-process job (observations; ``ba/sharded.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from regard3d_tpu_torch import runtime, spans
from regard3d_tpu_torch.core import sfm_data
from regard3d_tpu_torch.core.types import Scene
from regard3d_tpu_torch.export import ply as ply_mod
from regard3d_tpu_torch.pipeline import compute_matches as cm
from regard3d_tpu_torch.pipeline import features as feat_mod
from regard3d_tpu_torch.pipeline.report import (scene_snapshots_svg,
                                                write_html_report)
from regard3d_tpu_torch.sfm import global_sfm, incremental
from regard3d_tpu_torch.sfm import tracks as tracks_mod
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
    dist_ba: bool = False             # final BA polish sharded over every
                                      # card, or every rank of a multi-
                                      # process job (`r3d launch`), which
                                      # all call it collectively
    dist_ba_iterations: int = 30
    ba_every: int = 3                 # incremental: local BA cadence
    ba_iterations: int = 20
    final_ba_iterations: int = 40     # the post-growth polish


def build_sfm_inputs(matches_dir: str, num_images: int,
                     intr_id: np.ndarray, intr: np.ndarray,
                     models: np.ndarray, image_sizes: np.ndarray,
                     matches_kind: str = "f", dtype=np.float32,
                     device="cpu"):
    """Features + match files -> tracks -> SfMInputs on ``device``, the
    coordinates and intrinsics in ``dtype`` (float32, or float64 for the
    f64 engines)."""
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
        xy=t(xy, None),                  # None keeps numpy's ``dtype``
        track_id=t(table.track_id, torch.int64),
        view_id=t(table.view_id, torch.int64),
        feature_id=t(table.feature_id, torch.int64),
        num_tracks=table.num_tracks,
        intr_id=t(intr_id, torch.int64),
        intr=t(np.asarray(intr, dtype), None),
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


def run_triangulation(matches_dir: str, out_dir: str,
                      images: Sequence[np.ndarray],
                      intr_id: np.ndarray, intr: np.ndarray,
                      models: np.ndarray,
                      params: TriangulationParams = TriangulationParams(),
                      image_names: Optional[List[str]] = None,
                      center_priors: Optional[np.ndarray] = None,
                      seed: int = 0, device=None,
                      sample_provider: Optional[
                          incremental.SampleProvider] = None,
                      write_artifacts: bool = True) -> Dict:
    """Full triangulation step; writes the artifacts; returns stats.
    ``engine="incremental"`` starts from ``params.initial_pair`` (None:
    MaxPair, as the reference); ``center_priors`` (V, 3) anchor the result
    when ``params.use_gps``. ``engine="global"`` reads ``matches.e.txt``.
    ``sample_provider``: the engine's draws (``sfm/incremental.py``).
    ``write_artifacts=False`` computes everything but touches no file: the
    secondary processes of a multi-process job, so only the primary writes
    (``dist/launch.py`` ``is_primary``)."""
    dev = runtime.resolve_device(device)
    with spans.collect() as col:
        # every span of the step carries its prefix: the profiler mirrors a
        # span onto the device's timeline, where a reader that keeps the
        # step's spans by prefix must not take it for device work
        with spans.span("triangulation.step") as step:
            stats = _triangulation(
                step, matches_dir, out_dir, images, intr_id, intr, models,
                params, image_names, center_priors, seed, dev,
                sample_provider, write_artifacts)
        stats["spans"] = col.summary()
    return stats


def _triangulation(step, matches_dir, out_dir, images, intr_id, intr,
                   models, params, image_names, center_priors, seed, dev,
                   sample_provider, write_artifacts) -> Dict:
    """``run_triangulation`` inside its step span ``step``."""
    os.makedirs(out_dir, exist_ok=True)
    image_sizes = np.asarray([[im.shape[1], im.shape[0]] for im in images])

    kind = "e" if params.engine == "global" else params.matches_kind
    dtype = np.float64 if params.f64 else np.float32
    with spans.span("triangulation.inputs"):
        inputs, table = build_sfm_inputs(matches_dir, len(images), intr_id,
                                         intr, models, image_sizes, kind,
                                         dtype=dtype, device=dev)
    if params.engine == "global":
        result = global_sfm.run_global(
            inputs, global_sfm.GlobalConfig(
                rotation_loss=params.rotation_averaging,
                translation_loss=params.translation_averaging,
                refine_intrinsics=params.refine_intrinsics,
                min_pair_inliers=params.min_pair_matches),
            seed=seed, device=dev, sample_provider=sample_provider)
    else:
        init = params.initial_pair if params.engine == "incremental" else None
        result = incremental.run_incremental(
            inputs, initial_pair=init, cfg=incremental.IncrementalConfig(
                refine_intrinsics=params.refine_intrinsics,
                initializer=params.initializer,
                ba_every=params.ba_every,
                ba_iterations=params.ba_iterations,
                final_ba_iterations=params.final_ba_iterations),
            seed=seed, device=dev, sample_provider=sample_provider,
            center_priors=(center_priors if params.use_gps else None))
    if params.dist_ba:
        with spans.span("triangulation.dist_ba"):
            result = _dist_ba_polish(result, inputs, params, dev)

    with spans.span("triangulation.artifacts"):
        stats = _write_artifacts(step, out_dir, images, inputs, result,
                                 image_sizes, params, image_names,
                                 write_artifacts)
    return stats


def _write_artifacts(step, out_dir, images, inputs, result, image_sizes,
                     params, image_names, write_artifacts) -> Dict:
    """Colours, the scene, its files and the report; the engine's stats
    with ``elapsed_s`` (the step so far, before the report)."""
    colors = colorize_tracks(inputs, result, images)
    scene = result_to_scene(result, inputs, image_sizes, colors)
    ok = np.asarray(result.track_ok)
    X_np = result.X.cpu().numpy()
    C_np = result.C.cpu().numpy()
    if write_artifacts:
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
    stats["elapsed_s"] = step.seconds

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
    if params.dist_ba and len(r):
        # the sharded polish changed the state after the engine computed
        # its stats: the residual summary comes from the final state
        stats.update({
            "rms_px": float(np.sqrt((r ** 2).mean())),
            "residual_min": float(r.min()),
            "residual_max": float(r.max()),
            "residual_mean": float(r.mean()),
            "residual_median": float(np.median(r)),
        })
    if len(r):
        counts, edges = np.histogram(r, bins=20,
                                     range=(0.0, max(4.0, float(r.max()))))
        hist = (edges, counts)
    else:
        hist = None
    if write_artifacts:
        snaps = scene_snapshots_svg(C_np, result.R.cpu().numpy(),
                                    result.pose_mask, X_np, ok,
                                    colors=colors)
        write_html_report(os.path.join(out_dir,
                                       "Reconstruction_Report.html"),
                          stats, params, views=views_rows, histogram=hist,
                          snapshots=snaps)
    return stats


def _dist_ba_polish(result: incremental.SfMResult,
                    inputs: incremental.SfMInputs,
                    params: TriangulationParams,
                    dev: torch.device) -> incremental.SfMResult:
    """Final BA refinement, sharded. In one process the landmark blocks
    shard over every card (``bundle_adjust_point_sharded``; on the CPU,
    one shard); in a multi-process job the observations shard over the
    ranks (``bundle_adjust_sharded``), and every rank must call this
    (``r3d sfm --dist-ba`` under ``r3d launch``)."""
    from regard3d_tpu_torch.ba import lm as lm_mod, sharded
    from regard3d_tpu_torch.dist import mesh as meshlib
    tid = inputs.track_id
    vid = inputs.view_id
    live = (result.obs_active & result.track_ok[tid.cpu().numpy()]
            & result.pose_mask[vid.cpu().numpy()])
    g = inputs.intr_id[vid]
    obs = lm_mod.BAObservations(
        view_id=vid, intr_id=g, point_id=tid, model=inputs.models[g],
        xy=inputs.xy,
        weight=torch.as_tensor(live, dtype=inputs.xy.dtype, device=dev))
    # gauge: unposed cameras stay fixed, plus the first posed camera
    fixed = ~result.pose_mask.copy()
    posed = np.nonzero(result.pose_mask)[0]
    if len(posed):
        fixed[posed[0]] = True
    state = lm_mod.BAState(R=result.R, C=result.C, intr=result.intr,
                           X=result.X)
    opts = lm_mod.BAOptions(max_iterations=params.dist_ba_iterations,
                            refine_intrinsics=params.refine_intrinsics)
    fixed = torch.as_tensor(fixed, device=dev)
    if torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        out, _ = sharded.bundle_adjust_sharded(
            state, obs, None, opts, fixed_pose_mask=fixed, device=dev)
    else:
        mesh = (meshlib.make_mesh("obs") if dev.type == "cuda"
                else meshlib.make_mesh("obs", [dev]))
        out, _ = sharded.bundle_adjust_point_sharded(
            state, obs, mesh, opts, fixed_pose_mask=fixed)
    out = lm_mod._to(out, dev)
    return result._replace(R=out.R, C=out.C, intr=out.intr, X=out.X)
