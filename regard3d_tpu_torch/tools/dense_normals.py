"""Dense normals against the truth on the synthetic fountain.

How far the dense cloud's normals follow the fountain's surfaces (the
median |cos| between each point's normal and the normal of its nearest
quad), for three inputs of the dense slice's ``mvs.driver.densify_scene``
at the command line's ``--method tpu`` defaults:

* ``scene_level1``: the scene the port reconstructs itself
  (``run_compute_matches`` -> ``run_triangulation`` on 11 views at 1024²,
  4096 keypoints, focal prior 1.03x the truth), 512² depth maps;
* ``exact_level1``: that scene with the dataset's exact poses and focal
  (its landmarks moved into the truth frame), 512² depth maps;
* ``exact_level2``: the same at 256² depth maps.

The normals come from 7x7-smoothed depth maps, a window fixed in pixels,
so the finer the map the more of the sweep's depth noise reaches them;
the first two inputs separate the scene's own error from that. The
geometry helpers (``dense_geometry`` and the fountain's quads) are the
ones ``chip_smoke.py`` gates its dense phases with.

Run: ``python -m regard3d_tpu_torch.tools.dense_normals [--hw 1024]
[--device cpu]``. Runs on cuda unless ``--device cpu`` (raises with no
card). The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

# the CLI's defaults for densify --method tpu
# (regard3d_tpu/pipeline/external.py:135-138)
DENSE_KW = dict(level=1, num_planes=96, wsize=7, threshold=0.7,
                num_sources=6, csize=2, min_image_num=3)
# the fountain stand-in's three quads (origin, u, v), copied from
# ingest/synth.py's ``make_dataset("fountain")`` (each a rectangle)
FOUNTAIN_QUADS = np.array([
    [[-5, -3, 2], [10, 0, 0], [0, 6, 0]],               # back wall
    [[-1.2, -1.2, 0.6], [2.4, 0, 0], [0, 2.4, 0.9]],    # slab
    [[-5, 3, -4], [10, 0, 0], [0, 0, 6]],               # ground
], np.float64)


def quad_distances(P):
    """Distance of each point (N, 3) to each fountain quad: (N, 3)."""
    out = []
    for o, u, v in FOUNTAIN_QUADS:
        rel = P - o
        s = np.clip(rel @ u / (u @ u), 0.0, 1.0)
        t = np.clip(rel @ v / (v @ v), 0.0, 1.0)
        out.append(np.linalg.norm(rel - s[:, None] * u - t[:, None] * v,
                                  axis=1))
    return np.stack(out, 1)


def scene_extent() -> float:
    """The diagonal of the quads' bounding box."""
    o, u, v = FOUNTAIN_QUADS[:, 0], FOUNTAIN_QUADS[:, 1], FOUNTAIN_QUADS[:, 2]
    corners = np.concatenate([o, o + u, o + v, o + u + v])
    return float(np.linalg.norm(corners.max(0) - corners.min(0)))


def dense_geometry(scene, Cs_true, xyz, nrm, verts=None,
                   cloud_tol: float = 0.01, surface_tol: float = 0.02):
    """The dense cloud and the mesh vertices in the truth frame (the Sim3
    that ``umeyama`` fits from the estimated camera centres to the true
    ones) against the fountain's quads: the share of points within
    ``cloud_tol`` of the extent of a quad, the median |cos| between each
    point's normal and its nearest quad's, the share of mesh vertices
    within ``surface_tol``."""
    from regard3d_tpu_torch.core import metrics
    pm = scene.poses.mask.numpy()
    sim = metrics.umeyama(scene.poses.C.numpy()[pm], Cs_true[pm])
    ext = scene_extent()
    X = sim.apply(xyz)
    N = np.asarray(nrm, np.float64) @ sim.R.T
    N /= np.maximum(np.linalg.norm(N, axis=1, keepdims=True), 1e-12)
    d = quad_distances(X)
    qn = np.cross(FOUNTAIN_QUADS[:, 1], FOUNTAIN_QUADS[:, 2])
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    cos = np.abs(np.sum(N * qn[d.argmin(1)], 1))
    geo = {"extent": ext, "sim3_scale": sim.scale,
           "cloud_near_frac": float((d.min(1) <= cloud_tol * ext).mean()),
           "cloud_dist_median": float(np.median(d.min(1))),
           "cloud_dist_p90": float(np.percentile(d.min(1), 90)),
           "normal_cos_median": float(np.median(cos))}
    if verts is not None:
        dv = quad_distances(sim.apply(verts)).min(1)
        geo["surface_near_frac"] = float((dv <= surface_tol * ext).mean())
        geo["surface_dist_median"] = float(np.median(dv))
    return geo


def exact_scene(scene, ds):
    """``scene`` with the dataset's exact poses and focal, its landmarks
    mapped into the truth frame (so the sweep keeps its sources and depth
    ranges): what the dense slice gives without the scene's own error."""
    from regard3d_tpu_torch.core import metrics
    pm = scene.poses.mask.numpy()
    sim = metrics.umeyama(scene.poses.C.numpy()[pm], ds["Cs"][pm])
    params = scene.intrinsics.params.clone()
    params[:, :3] = torch.tensor([ds["f"], ds["hw"] / 2.0, ds["hw"] / 2.0])
    params[:, 3:] = 0.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return scene.replace(
        intrinsics=scene.intrinsics.replace(params=params),
        poses=scene.poses.replace(R=f32(ds["Rs"]), C=f32(ds["Cs"])),
        landmarks=scene.landmarks.replace(
            X=f32(sim.apply(scene.landmarks.X.numpy()))))


def run_normals(views: int = 11, hw: int = 1024, max_keypoints: int = 4096,
                ransac_iters: int = 1024, device=None) -> dict:
    """The three readings of the module docstring; returns a dict."""
    from regard3d_tpu_torch import runtime
    from regard3d_tpu_torch.core.sfm_data import load_npz
    from regard3d_tpu_torch.core.types import PINHOLE
    from regard3d_tpu_torch.ingest import synth
    from regard3d_tpu_torch.mvs import driver
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import triangulation_step as ts

    dev = runtime.resolve_device(device)
    t0 = time.time()
    ds = synth.make_dataset("fountain", n_cams=views, hw=hw, seed=0)
    f_prior = 1.03 * ds["f"]
    with tempfile.TemporaryDirectory() as tmp:
        matches = os.path.join(tmp, "matches")
        cm.run_compute_matches(ds["images"], matches,
                               cfg=cm.MatchConfig(ransac_iters=ransac_iters),
                               focals=np.full(views, f_prior),
                               max_keypoints=max_keypoints, device=dev)
        intr = np.zeros((1, 9), np.float32)
        intr[0, :3] = [f_prior, hw / 2.0, hw / 2.0]
        tri = os.path.join(tmp, "sfm")
        tstats = ts.run_triangulation(
            matches, tri, ds["images"], intr_id=np.zeros(views, np.int32),
            intr=intr, models=np.asarray([PINHOLE], np.int32), device=dev)
        scene = load_npz(os.path.join(tri, "scene.npz"))
    exact = exact_scene(scene, ds)
    rows = {}
    for name, sc, level in (("scene_level1", scene, 1),
                            ("exact_level1", exact, 1),
                            ("exact_level2", exact, 2)):
        t1 = time.time()
        xyz, nrm, _, dmaps = driver.densify_scene(
            sc, ds["images"], device=dev, **dict(DENSE_KW, level=level))
        rows[name] = dict(dense_geometry(sc, ds["Cs"], xyz, nrm),
                          points=len(xyz), depth_maps=len(dmaps),
                          densify_s=time.time() - t1)
        print(f"{name}: median |cos| "
              f"{rows[name]['normal_cos_median']:.4f}, {len(xyz)} points",
              flush=True)
    return {"views": views, "hw": hw, "cameras": tstats["num_cameras"],
            "densify": DENSE_KW, "readings": rows,
            "elapsed_s": time.time() - t0,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=11)
    ap.add_argument("--hw", type=int, default=1024)
    ap.add_argument("--max-keypoints", type=int, default=4096)
    ap.add_argument("--ransac-iters", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    print(json.dumps(run_normals(args.views, args.hw, args.max_keypoints,
                                 args.ransac_iters, device=args.device)))


if __name__ == "__main__":
    main()
