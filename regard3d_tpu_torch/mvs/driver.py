"""Host orchestration of the densifier.

Counterpart of ``regard3d_tpu/mvs/driver.py``. Replaces the reference's
external CMVS -> genOption -> pmvs2 chain
(``src/R3DDensificationProcess.cpp:105-183``) with an in-process pipeline:

  scene.npz + images -> undistort -> pyramid level -> per-view source
  selection (shared-landmark scores, CMVS's view-graph role) -> plane-sweep
  depth maps (views looped on the host, each swept on the device) ->
  cross-view consistency fusion -> dense colored+normal cloud.

Source selection mirrors what CMVS extracts from the SfM result: views are
ranked per reference view by shared-track count, weighted by triangulation
angle so near-identical baselines don't win (CMVS clusters on the same
co-visibility signal, ``src/R3DDensificationProcess.cpp:113-130``).

Profiler spans: ``densify.sweep`` (one per view) and ``densify.fusion``
(one per view). ``run_native_densification`` is the project-store entry
point (``densify --method tpu``); with more than one card visible it
sweeps the views over all of them (``compute_depth_maps_sharded``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from regard3d_tpu_torch import runtime, spans
from regard3d_tpu_torch.core.sfm_data import _np
from regard3d_tpu_torch.core.types import Scene
from regard3d_tpu_torch.dist import mesh as meshlib
from regard3d_tpu_torch.mvs import fusion, planesweep
from regard3d_tpu_torch.mvs.planesweep import PlaneSweepParams


@dataclasses.dataclass
class DepthMapResult:
    view_id: int
    idepth: np.ndarray      # (H, W) inverse depth at the sweep level
    ncc: np.ndarray         # (H, W) photometric confidence
    valid: np.ndarray       # (H, W) bool (ncc >= threshold)
    K: np.ndarray           # (3, 3) level-scaled intrinsics
    sources: List[int]


def _posed_views(scene: Scene) -> List[int]:
    vm = _np(scene.views.mask)
    pm = _np(scene.poses.mask)
    pid = _np(scene.views.pose_id)
    return [int(v) for v in np.nonzero(vm)[0] if pm[pid[v]]]


def _K_for(scene: Scene, view: int, level: int) -> np.ndarray:
    k = int(_np(scene.views.intrinsic_id)[view])
    p = _np(scene.intrinsics.params)[k]
    s = 1.0 / (2 ** level)
    # pixel-center-consistent scaling: u_l = (u + 0.5) * s - 0.5
    return np.array([[p[0] * s, 0.0, (p[1] + 0.5) * s - 0.5],
                     [0.0, p[0] * s, (p[2] + 0.5) * s - 0.5],
                     [0.0, 0.0, 1.0]])


def select_sources(scene: Scene, num_sources: int,
                   min_angle_deg: float = 2.0) -> Dict[int, List[int]]:
    """Per-view source ranking by shared-landmark count x angle weight."""
    obs_l = _np(scene.observations.landmark_id)
    obs_v = _np(scene.observations.view_id)
    obs_m = _np(scene.observations.mask)
    lm_X = _np(scene.landmarks.X)
    lm_m = _np(scene.landmarks.mask)
    pid = _np(scene.views.pose_id)
    C = _np(scene.poses.C)

    live = obs_m & lm_m[obs_l]
    obs_l, obs_v = obs_l[live], obs_v[live]
    views = _posed_views(scene)
    nv = len(views)
    compact = np.full(len(_np(scene.views.mask)), -1, np.int64)
    compact[views] = np.arange(nv)
    Cv = C[pid[views]]                                 # (nv, 3) centers

    # drop observations of unposed views, sort by landmark
    cidx_all = compact[obs_v]
    keep = cidx_all >= 0
    obs_l, cidx = obs_l[keep], cidx_all[keep]
    order = np.argsort(obs_l, kind="stable")
    obs_l, cidx = obs_l[order], cidx[order]

    # pair co-visibility scores, vectorized: within each landmark segment
    # enumerate view pairs as (row, row+d) offsets — total work
    # sum_l k_l^2 with no per-landmark Python loop (city-scale safe)
    score = np.zeros((nv, nv))
    if len(obs_l):
        max_k = int(np.bincount(obs_l).max())
        for d in range(1, max_k):
            sel = np.nonzero(obs_l[:-d] == obs_l[d:])[0] if d < len(obs_l) \
                else np.zeros(0, np.int64)
            if len(sel) == 0:
                continue
            a, b = cidx[sel], cidx[sel + d]
            X = lm_X[obs_l[sel]]
            r1 = Cv[a] - X
            r2 = Cv[b] - X
            denom = np.maximum(np.linalg.norm(r1, axis=1)
                               * np.linalg.norm(r2, axis=1), 1e-12)
            cosang = np.clip(np.sum(r1 * r2, 1) / denom, -1.0, 1.0)
            ang = np.degrees(np.arccos(cosang))
            w = np.minimum(ang / min_angle_deg, 1.0)   # tiny baselines down
            np.add.at(score, (a, b), w)
            np.add.at(score, (b, a), w)

    out = {}
    for i, v in enumerate(views):
        ranked = np.argsort(-score[i])
        out[v] = [views[j] for j in ranked if score[i, j] > 0][:num_sources]
    return out


def depth_range(scene: Scene, view: int) -> Optional[tuple]:
    """Robust near/far from the sparse landmarks seen by this view
    (PMVS derives its sweep range from the SfM points the same way)."""
    obs_v = _np(scene.observations.view_id)
    obs_l = _np(scene.observations.landmark_id)
    obs_m = _np(scene.observations.mask)
    lm_m = _np(scene.landmarks.mask)
    sel = obs_m & (obs_v == view) & lm_m[obs_l]
    if sel.sum() < 5:
        return None
    X = _np(scene.landmarks.X)[obs_l[sel]]
    p = int(_np(scene.views.pose_id)[view])
    R = _np(scene.poses.R)[p]
    C = _np(scene.poses.C)[p]
    z = (X - C) @ R[2]
    z = z[z > 1e-6]
    if len(z) < 5:
        return None
    lo, hi = np.percentile(z, [2, 98])
    return max(0.25 * lo, 1e-3), 2.0 * hi


def _prep_images(images: Sequence[np.ndarray], scene: Scene,
                 views: List[int], level: int,
                 target_hw: Optional[tuple] = None, device=None):
    """Undistort + downsample + pad to one static (H, W); returns
    (gray stack dict, rgb dict, (H, W))."""
    from regard3d_tpu_torch.export.formats import undistort_image

    H = W = 0
    gray, rgb = {}, {}
    for v in views:
        img = np.asarray(images[v])
        und = undistort_image(img, scene, v, device).astype(np.float32)
        if np.issubdtype(np.asarray(images[v]).dtype, np.integer):
            und = und / 255.0      # float inputs are already in [0, 1]
        for _ in range(level):
            h2, w2 = und.shape[0] // 2 * 2, und.shape[1] // 2 * 2
            und = 0.25 * (und[0:h2:2, 0:w2:2] + und[1:h2:2, 0:w2:2]
                          + und[0:h2:2, 1:w2:2] + und[1:h2:2, 1:w2:2])
        rgb[v] = und
        g = und if und.ndim == 2 else (0.299 * und[..., 0]
                                       + 0.587 * und[..., 1]
                                       + 0.114 * und[..., 2])
        gray[v] = g.astype(np.float32)
        H = max(H, g.shape[0])
        W = max(W, g.shape[1])
    # pad to a multiple of 32 (one shape shared by all views)
    H = -(-H // 32) * 32
    W = -(-W // 32) * 32
    if target_hw is not None:
        H, W = max(H, target_hw[0]), max(W, target_hw[1])
    for v in views:
        g = gray[v]
        gray[v] = np.pad(g, ((0, H - g.shape[0]), (0, W - g.shape[1])))
        r = rgb[v]
        pad = ((0, H - r.shape[0]), (0, W - r.shape[1]))
        rgb[v] = np.pad(r, pad + ((0, 0),) * (r.ndim - 2))
    return gray, rgb, (H, W)


def compute_depth_maps(scene: Scene, images: Sequence[np.ndarray],
                       params: PlaneSweepParams,
                       device=None) -> Dict[int, DepthMapResult]:
    """Plane-sweep every posed view, views looped on the host — the
    analogue of the per-cluster pmvs2 loop."""
    dev = runtime.resolve_device(device)
    views = _posed_views(scene)
    if len(views) < 2:
        return {}
    sources = select_sources(scene, params.num_sources)
    gray, _rgb, _hw = _prep_images(images, scene, views, params.level,
                                   device=dev)
    pid = _np(scene.views.pose_id)
    Rs = _np(scene.poses.R)
    Cs = _np(scene.poses.C)
    f32 = dict(dtype=torch.float32, device=dev)

    S = params.num_sources
    out: Dict[int, DepthMapResult] = {}
    for v in views:
        srcs = sources.get(v, [])
        rng = depth_range(scene, v)
        if not srcs or rng is None:
            continue
        depths = planesweep.inverse_depth_planes(rng[0], rng[1],
                                                 params.num_planes)
        K_ref = _K_for(scene, v, params.level)
        src_ids = (srcs + [srcs[0]] * S)[:S]
        live = np.array([i < len(srcs) for i in range(S)])
        homos = planesweep.plane_homographies(
            K_ref, Rs[pid[v]], Cs[pid[v]],
            np.stack([_K_for(scene, s, params.level) for s in src_ids]),
            Rs[pid[src_ids]], Cs[pid[src_ids]], depths)
        with spans.span("densify.sweep"), torch.no_grad():
            idepth, ncc = planesweep.sweep(
                torch.as_tensor(gray[v], **f32),
                torch.as_tensor(np.stack([gray[s] for s in src_ids]), **f32),
                torch.as_tensor(live, device=dev),
                torch.as_tensor(homos.astype(np.float32), **f32),
                torch.as_tensor((1.0 / depths).astype(np.float32), **f32),
                wsize=params.wsize,
                top_k=min(params.agg_top_k, len(srcs)),
                chunk=params.plane_chunk)
            idepth = _np(idepth)
            ncc = _np(ncc)
        out[v] = DepthMapResult(
            view_id=v, idepth=idepth, ncc=ncc,
            valid=ncc >= params.threshold, K=K_ref, sources=srcs)
    return out


def compute_depth_maps_sharded(scene: Scene, images: Sequence[np.ndarray],
                               params: PlaneSweepParams,
                               mesh: meshlib.Mesh
                               ) -> Dict[int, DepthMapResult]:
    """Mesh-sharded plane sweep: reference views go round-robin over the
    devices of ``mesh`` (axis ``views``), one thread per device (the
    counterpart of CMVS farming PMVS clusters to processes).

    The reference runs one batched sweep program over the views, so it
    aggregates every view with ONE ``top_k``: the fewest live sources in
    the batch. So does this. It matches :func:`compute_depth_maps` only
    when every view has its full set of sources."""
    devs = mesh.device_list
    views = _posed_views(scene)
    if len(views) < 2:
        return {}
    sources = select_sources(scene, params.num_sources)
    gray, _rgb, _hw = _prep_images(images, scene, views, params.level,
                                   device=devs[0])
    pid = _np(scene.views.pose_id)
    Rs = _np(scene.poses.R)
    Cs = _np(scene.poses.C)

    S = params.num_sources
    problems = []
    for v in views:
        srcs = sources.get(v, [])
        rng = depth_range(scene, v)
        if not srcs or rng is None:
            continue
        depths = planesweep.inverse_depth_planes(rng[0], rng[1],
                                                 params.num_planes)
        K_ref = _K_for(scene, v, params.level)
        src_ids = (srcs + [srcs[0]] * S)[:S]
        homos = planesweep.plane_homographies(
            K_ref, Rs[pid[v]], Cs[pid[v]],
            np.stack([_K_for(scene, s, params.level) for s in src_ids]),
            Rs[pid[src_ids]], Cs[pid[src_ids]], depths)
        problems.append((v, src_ids, np.array([i < len(srcs)
                                               for i in range(S)]),
                         homos.astype(np.float32),
                         (1.0 / depths).astype(np.float32)))
    if not problems:
        return {}
    top_k = min(params.agg_top_k, min(int(p[2].sum()) for p in problems))

    def sweep(prob, dev):
        v, src_ids, live, homos, idep = prob
        f32 = dict(dtype=torch.float32, device=dev)
        with spans.span("densify.sweep"), torch.no_grad():
            idepth, ncc = planesweep.sweep(
                torch.as_tensor(gray[v], **f32),
                torch.as_tensor(np.stack([gray[s] for s in src_ids]), **f32),
                torch.as_tensor(live, device=dev),
                torch.as_tensor(homos, **f32), torch.as_tensor(idep, **f32),
                wsize=params.wsize, top_k=top_k, chunk=params.plane_chunk)
            return _np(idepth), _np(ncc)

    out: Dict[int, DepthMapResult] = {}
    for prob, (idepth, ncc) in zip(problems,
                                   meshlib.run_on_mesh(sweep, problems,
                                                       mesh)):
        v = prob[0]
        out[v] = DepthMapResult(
            view_id=v, idepth=idepth, ncc=ncc,
            valid=ncc >= params.threshold, K=_K_for(scene, v, params.level),
            sources=sources[v])
    return out


def fuse_depth_maps(scene: Scene, images: Sequence[np.ndarray],
                    dmaps: Dict[int, DepthMapResult],
                    params: PlaneSweepParams, csize: int = 2,
                    min_consistent: int = 2, tol: float = 0.01,
                    device=None):
    """Consistency-filter + fuse all depth maps; returns (xyz, nrm, rgb)."""
    dev = runtime.resolve_device(device)
    views = sorted(dmaps.keys())
    hw0 = dmaps[views[0]].idepth.shape if views else None
    _gray, rgb, _hw = _prep_images(images, scene, views, params.level,
                                   target_hw=hw0, device=dev)
    pid = _np(scene.views.pose_id)
    Rs = _np(scene.poses.R)
    Cs = _np(scene.poses.C)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    all_xyz, all_nrm, all_rgb = [], [], []
    S = params.num_sources
    for v in views:
        dm = dmaps[v]
        srcs = [s for s in dm.sources if s in dmaps]
        if not srcs:
            continue
        src_ids = (srcs + [srcs[0]] * S)[:S]
        live = np.array([i < len(srcs) for i in range(S)])
        with spans.span("densify.fusion"), torch.no_grad():
            idepth, valid = t32(dm.idepth), torch.as_tensor(dm.valid,
                                                            device=dev)
            K, R, C = t32(dm.K), t32(Rs[pid[v]]), t32(Cs[pid[v]])
            accept, X = fusion.consistency_mask(
                idepth, valid, K, R, C,
                t32(np.stack([dmaps[s].idepth for s in src_ids])),
                torch.as_tensor(np.stack([dmaps[s].valid for s in src_ids]),
                                device=dev),
                t32(np.stack([dmaps[s].K for s in src_ids])),
                t32(Rs[pid[src_ids]]), t32(Cs[pid[src_ids]]),
                torch.as_tensor(live, device=dev), tol=tol,
                min_consistent=min(min_consistent, len(srcs)))
            nrm = fusion.smoothed_normals(idepth, valid, K, R, C)
            accept, X, nrm = _np(accept), _np(X), _np(nrm)
        rgb_v = rgb[v]
        if rgb_v.ndim == 2:
            rgb_v = np.repeat(rgb_v[..., None], 3, -1)
        xyz, n, c = fusion.fuse_points(accept, X, nrm, rgb_v, csize)
        all_xyz.append(xyz)
        all_nrm.append(n)
        all_rgb.append(c)
    if not all_xyz:
        z = np.zeros((0, 3))
        return z, z.copy(), z.copy()
    return (np.concatenate(all_xyz), np.concatenate(all_nrm),
            np.concatenate(all_rgb))


def densify_scene(scene: Scene, images: Sequence[np.ndarray],
                  level: int = 1, num_planes: int = 96, wsize: int = 7,
                  threshold: float = 0.7, num_sources: int = 6,
                  csize: int = 2, min_image_num: int = 3,
                  depth_tol: float = 0.01, device=None,
                  mesh: Optional[meshlib.Mesh] = None):
    """End-to-end native densification: scene + images -> point cloud
    (xyz, normals, rgb in [0, 1], depth maps), on ``cuda`` unless
    ``device="cpu"``. With ``mesh`` the sweep shards its views over the
    mesh's devices (``compute_depth_maps_sharded``) and the fusion runs on
    its first device.

    ``min_image_num`` counts the reference view itself (PMVS semantics),
    so the cross-view vote needs ``min_image_num - 1`` agreeing sources."""
    dev = (mesh.device_list[0] if mesh is not None
           else runtime.resolve_device(device))
    params = PlaneSweepParams(level=level, num_planes=num_planes,
                              wsize=wsize, threshold=threshold,
                              num_sources=num_sources)
    if mesh is not None:
        dmaps = compute_depth_maps_sharded(scene, images, params, mesh)
    else:
        dmaps = compute_depth_maps(scene, images, params, device=dev)
    xyz, nrm, rgb = fuse_depth_maps(
        scene, images, dmaps, params, csize=csize,
        min_consistent=max(min_image_num - 1, 1), tol=depth_tol, device=dev)
    return xyz, nrm, rgb, dmaps


def run_native_densification(project, triangulation_id: int, out_dir: str,
                             args, device=None) -> Dict:
    """Project-store entry point (dispatch target of ``densify --method
    tpu``) on ``cuda`` unless ``device="cpu"``, its sweep over every card
    when more than one is visible; returns the same result dict as the
    external runners and writes the reference's ``depth_maps.npz`` and
    ``dense.ply``."""
    import os

    from regard3d_tpu_torch.core import sfm_data
    from regard3d_tpu_torch.export.ply import PlyData, write_ply
    from regard3d_tpu_torch.ingest import image_io

    scene = sfm_data.load_npz(project.paths(triangulation_id).scene_npz)
    ps_obj = project.objects[project.objects[triangulation_id].parent_id]
    infos = project.objects[ps_obj.parent_id].params["image_info"]
    images = [image_io.load_rgb(i["path"]) for i in infos]

    xyz, nrm, rgb, dmaps = densify_scene(
        scene, images,
        level=getattr(args, "level", 1),
        num_planes=getattr(args, "num_planes", 96),
        wsize=getattr(args, "wsize", 7),
        threshold=getattr(args, "threshold", 0.7),
        num_sources=getattr(args, "num_sources", 6),
        csize=getattr(args, "csize", 2),
        min_image_num=getattr(args, "min_image_num", 3),
        device=device,
        mesh=meshlib.local_mesh("views", None,
                                runtime.resolve_device(device)))

    np.savez_compressed(
        os.path.join(out_dir, "depth_maps.npz"),
        **{f"idepth_{v}": d.idepth for v, d in dmaps.items()},
        **{f"ncc_{v}": d.ncc for v, d in dmaps.items()})
    dense = os.path.join(out_dir, "dense.ply")
    write_ply(dense, PlyData(xyz=xyz, rgb=(rgb * 255).astype(np.uint8),
                             normals=nrm))
    return {"method": "tpu", "dense_cloud": dense, "num_points": len(xyz),
            "num_depth_maps": len(dmaps)}
