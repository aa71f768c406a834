"""External-MVS bundle exporter: CMPMVS + MeshRecon + SURE + MVMPR.

Parity with ``OpenMVGHelper::exportToExternalMVS`` / ``exportToMVMPR``
(src/utils/OpenMVGHelper.cpp:1487-2452): one output directory containing

    CMPMVS/%05d_P.txt      "CONTOUR" + 3 rows of P  (1-based numbering)
    CMPMVS/%05d.jpg        undistorted images
    CMPMVS/mvs_firstRun.ini / _OcclusionDepthmaps.ini   CMPMVS configs
    meshrecon/output.sfm   N, per-view "../CMPMVS/%05d.jpg R(9) t(3)
                           fx fy cx cy", bbox line, per-view neighbour lists
    SURE/%05d.ori          ORI_Ver_1.0 camera files + images
    MVMPR/{images,data,models}: undistorted images, %05d.cam (K,R,t,C),
                           %05d.txt (P rows)

Counterpart of ``regard3d_tpu/export/external_mvs.py`` on the port's
``Scene``; the files are byte-identical to the reference's. The image
undistortion runs on ``device`` (``cuda`` unless ``device="cpu"``); the
quaternions come from ``cameras.rot_to_quat`` in f32 on the host, as the
reference's.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
from PIL import Image

from regard3d_tpu_torch.core import cameras as cam_mod
from regard3d_tpu_torch.core.sfm_data import _np
from regard3d_tpu_torch.core.types import Scene
from regard3d_tpu_torch.export.formats import _K_of, _Rt_of, _posed_view_ids, \
    undistort_image


def _save_jpg(arr: np.ndarray, path: str):
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path, quality=95)


def export_external_mvs(out_dir: str, scene: Scene,
                        images: Sequence[np.ndarray],
                        image_names: Sequence[str], device=None):
    ids = _posed_view_ids(scene)
    cmp_dir = os.path.join(out_dir, "CMPMVS")
    mr_dir = os.path.join(out_dir, "meshrecon")
    sure_dir = os.path.join(out_dir, "SURE")
    mv_img = os.path.join(out_dir, "MVMPR", "images")
    mv_data = os.path.join(out_dir, "MVMPR", "data")
    mv_models = os.path.join(out_dir, "MVMPR", "models")
    for d in (cmp_dir, mr_dir, sure_dir, mv_img, mv_data, mv_models):
        os.makedirs(d, exist_ok=True)

    lm_mask = _np(scene.landmarks.mask)
    X = _np(scene.landmarks.X)[lm_mask]
    obs_lid = _np(scene.observations.landmark_id)
    obs_vid = _np(scene.observations.view_id)
    obs_ok = _np(scene.observations.mask)

    mr_lines = [str(len(ids)), ""]
    cam_index = {}

    for count, v in enumerate(ids, start=1):
        cam_index[v] = count - 1
        K = _K_of(scene, v)
        R, t = _Rt_of(scene, v)
        P = K @ np.concatenate([R, t[:, None]], 1)
        w = int(_np(scene.views.width)[v])
        h = int(_np(scene.views.height)[v])
        und = undistort_image(np.asarray(images[v]), scene, v, device)

        # --- CMPMVS ---
        with open(os.path.join(cmp_dir, f"{count:05d}_P.txt"), "w") as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(f"{row[0]} {row[1]} {row[2]} {row[3]}\n")
        _save_jpg(und, os.path.join(cmp_dir, f"{count:05d}.jpg"))

        # --- MeshRecon view line ---
        mr_lines.append(
            f"../CMPMVS/{count:05d}.jpg "
            + " ".join(f"{x}" for x in R.flatten()) + " "
            + " ".join(f"{x}" for x in t)
            + f" {K[0,0]} {K[1,1]} {w / 2.0} {h / 2.0}")

        # --- SURE .ori ---
        q = _np(cam_mod.rot_to_quat(torch.as_tensor(R)))  # (w,x,y,z)
        C = _np(scene.poses.C)[v]
        with open(os.path.join(sure_dir, f"{count:05d}.ori"), "w") as f:
            f.write(
                "$ImageID___________________________________________________"
                "(ORI_Ver_1.0)\n"
                f"\t    {count:05d}.jpg\n"
                "$IntOri_FocalLength_________________________________________"
                "________[mm]\n"
                f"\t      {K[0,0]}\n"
                "$IntOri_PixelSize______(x|y)________________________________"
                "________[mm]\n"
                "        0.001000\t        0.001000\n"
                "$IntOri_SensorSize_____(x|y)________________________________"
                "_____[pixel]\n"
                f"\t            {w}\t            {h}\n"
                "$IntOri_PrincipalPoint_(x|y)________________________________"
                "_____[pixel]\n"
                f"\t   {K[0,2]}\t   {K[1,2]}\n"
                "$IntOri_CameraMatrix_____________________________"
                "(ImageCoordinateSystem)\n"
                f"\t   {K[0,0]} {K[0,1]} {K[0,2]} \n"
                f"\t   {K[1,0]} {K[1,1]} {K[1,2]} \n"
                f"\t   {K[2,0]} {K[2,1]} {K[2,2]} \n"
                "$ExtOri_RotationMatrix____________________"
                "(World->ImageCoordinateSystem)\n"
                f"\t   {R[0,0]} {R[0,1]} {R[0,2]} \n"
                f"\t   {R[1,0]} {R[1,1]} {R[1,2]} \n"
                f"\t   {R[2,0]} {R[2,1]} {R[2,2]} \n"
                "$ExtOri_TranslationVector________________________________"
                "[mm|m|...]\n"
                f"\t   {C[0]} {C[1]} {C[2]}\n"
                "$ExtOri_RotationQuaternion_______________________(x|y|z|w)\n"
                f"\t   {q[1]} {q[2]} {q[3]} {q[0]}\n"
                "$IntOri_Distortion______(Model|NumberOfParameters|"
                "Parameters)\n"
                "\t    NONE\t  0\n")
        _save_jpg(und, os.path.join(sure_dir, f"{count:05d}.jpg"))

        # --- MVMPR ---
        _save_jpg(und, os.path.join(mv_img, f"{count:05d}.jpg"))
        with open(os.path.join(mv_data, f"{count:05d}.cam"), "w") as f:
            for row in K:
                f.write(f"{row[0]} {row[1]} {row[2]} \n")
            for row in R:
                f.write(f"{row[0]} {row[1]} {row[2]} \n")
            f.write(f"{t[0]} {t[1]} {t[2]}\n")
            f.write(f"{C[0]} {C[1]} {C[2]}\n")
        with open(os.path.join(mv_data, f"{count:05d}.txt"), "w") as f:
            for row in P:
                f.write(f"{row[0]} {row[1]} {row[2]} {row[3]}\n")

    # MeshRecon: bbox + co-visibility neighbours
    mr_lines.append("")
    if len(X):
        mr_lines.append(f"{X[:,0].min()} {X[:,0].max()} {X[:,1].min()} "
                        f"{X[:,1].max()} {X[:,2].min()} {X[:,2].max()}")
    else:
        mr_lines.append("0 0 0 0 0 0")
    mr_lines.append("")

    neighbours = [set() for _ in ids]
    lm_ids = np.where(lm_mask)[0]
    for li in lm_ids:
        rows = np.where((obs_lid == li) & obs_ok)[0]
        cams = sorted({cam_index[int(obs_vid[o])] for o in rows
                       if int(obs_vid[o]) in cam_index})
        for a in cams:
            for b in cams:
                if a != b:
                    neighbours[a].add(b)
    for i, ns in enumerate(neighbours):
        mr_lines.append(f"{i} {len(ns)}" +
                        "".join(f" {n}" for n in sorted(ns)))
    mr_lines.append("")
    with open(os.path.join(mr_dir, "output.sfm"), "w") as f:
        f.write("\n".join(mr_lines))

    # CMPMVS ini configs (parity: :1887-1960)
    wmax = max(int(_np(scene.views.width)[v]) for v in ids)
    hmax = max(int(_np(scene.views.height)[v]) for v in ids)
    for name, extra in (("mvs_firstRun.ini", "doPrepareData=TRUE\n"
                         "doPrematchSifts=TRUE\ndoPlaneSweepingSGM=TRUE\n"
                         "doFuse=TRUE\n"),
                        ("mvs_secondRun_OcclusionDepthmaps.ini",
                         "doRemoveOcclusions=TRUE\n")):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("[global]\n"
                    f"dirName=\"CMPMVS\\\"\n"
                    "prefix=\"\"\n"
                    f"imgExt=\"jpg\"\n"
                    f"ncams={len(ids)}\n"
                    f"width={wmax}\nheight={hmax}\n"
                    "scale=2\nworkDirName=\"_tmp\"\n"
                    "doPrepareData=TRUE\n[firstRun]\n" + extra)
