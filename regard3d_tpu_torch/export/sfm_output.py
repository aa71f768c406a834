"""Legacy ``SfM_output/`` export tree (old OpenMVG format, MVE import path).

Parity with ``OpenMVGHelper::exportOldSfM_output``
(src/utils/OpenMVGHelper.cpp:2592-2927), which the reference runs after
every triangulation (src/threads/R3DTriangulationThread.cpp:576):

    SfM_output/
      cameras/<image>.bin        3x4 projective matrix, 12 doubles,
                                 column-major (Eigen Mat34 memory order)
      cameras_disto/<image>.txt  focal ppx ppy k1 k2 k3 / R rows / t
      clouds/calib.ply           ascii cloud with confidence + visibility
      clouds/visibility.txt      "X Y Z N (cam feat)..." per landmark
      views.txt                  "images\\ncameras\\nN" + per-view line with
                                 znear/2, zfar*2 clipping planes
      images/<image>.png         undistorted calibrated views

Counterpart of ``regard3d_tpu/export/sfm_output.py`` on the port's
``Scene``; the files are byte-identical to the reference's. The image
undistortion runs on ``device`` (``cuda`` unless ``device="cpu"``).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image

from regard3d_tpu_torch.core.sfm_data import _np
from regard3d_tpu_torch.core.types import Scene
from regard3d_tpu_torch.export.formats import _K_of, _Rt_of, _posed_view_ids, \
    undistort_image


def export_sfm_output(out_dir: str, scene: Scene,
                      images: Sequence[np.ndarray],
                      image_names: Sequence[str], device=None):
    for sub in ("cameras", "cameras_disto", "clouds", "images"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    ids = _posed_view_ids(scene)
    cam_index = {v: n for n, v in enumerate(ids)}
    iid = _np(scene.views.intrinsic_id)
    params = _np(scene.intrinsics.params)

    # cameras/<name>.bin + cameras_disto/<name>.txt
    for v in ids:
        base = os.path.splitext(os.path.basename(image_names[v]))[0]
        K = _K_of(scene, v)
        R, t = _Rt_of(scene, v)
        P = K @ np.concatenate([R, t[:, None]], 1)
        with open(os.path.join(out_dir, "cameras", base + ".bin"), "wb") as f:
            f.write(np.asarray(P, np.float64).flatten(order="F").tobytes())
        p = params[iid[v]]
        with open(os.path.join(out_dir, "cameras_disto",
                               base + ".txt"), "w") as f:
            f.write(f"{p[0]} {p[1]} {p[2]} {p[3]} {p[4]} {p[5]}\n")
            for row in R:
                f.write(f"{row[0]} {row[1]} {row[2]}\n")
            f.write(f"{t[0]} {t[1]} {t[2]}\n")

    # landmarks + visibility
    lm_mask = _np(scene.landmarks.mask)
    lm_ids = np.where(lm_mask)[0]
    X = _np(scene.landmarks.X)
    obs_lid = _np(scene.observations.landmark_id)
    obs_vid = _np(scene.observations.view_id)
    obs_fid = _np(scene.observations.feature_id)
    obs_ok = _np(scene.observations.mask)

    V = scene.views.capacity
    znear = np.full(len(ids), np.finfo(np.float64).max)
    zfar = np.zeros(len(ids))

    vis_lines = []
    ply_lines = []
    for li in lm_ids:
        rows = np.where((obs_lid == li) & obs_ok)[0]
        cams = []
        svis = []
        for o in rows:
            v = int(obs_vid[o])
            if v not in cam_index:
                continue
            ci = cam_index[v]
            cams.append(ci)
            svis.append(f"{ci} {int(obs_fid[o])}")
            R, t = _Rt_of(scene, v)
            z = float((R @ X[li] + t)[2])
            znear[ci] = min(znear[ci], z)
            zfar[ci] = max(zfar[ci], z)
        cams = sorted(set(cams))
        x, y, z3 = X[li]
        ply_lines.append(f"{x} {y} {z3} 255 255 255 3.14 {len(cams)} "
                         + " ".join(str(c) for c in cams))
        vis_lines.append(f"{x} {y} {z3} {len(cams)} " + " ".join(svis))

    with open(os.path.join(out_dir, "clouds", "calib.ply"), "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                "comment Generated by regard3d_tpu\n"
                f"element vertex {len(lm_ids)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n"
                "property float confidence\n"
                "property list uchar int visibility\n"
                "element face 0\nproperty list uchar int vertex_index\n"
                "end_header\n")
        f.write("\n".join(ply_lines) + "\n")
    with open(os.path.join(out_dir, "clouds", "visibility.txt"), "w") as f:
        f.write("\n".join(vis_lines) + "\n")

    # views.txt
    with open(os.path.join(out_dir, "views.txt"), "w") as f:
        f.write(f"images\ncameras\n{len(ids)}\n")
        for n, v in enumerate(ids):
            base = os.path.splitext(os.path.basename(image_names[v]))[0]
            w = int(_np(scene.views.width)[v])
            h = int(_np(scene.views.height)[v])
            f.write(f"{os.path.basename(image_names[v])} {w} {h} "
                    f"{base}.bin {znear[n] / 2} {zfar[n] * 2}\n")

    # undistorted images
    for v in ids:
        und = undistort_image(np.asarray(images[v]), scene, v, device)
        if und.dtype != np.uint8:
            und = (np.clip(und, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(und).save(os.path.join(
            out_dir, "images", os.path.basename(image_names[v])))
