"""Interchange exporters — Bundler, PMVS, NVM, MeshLab, MVE2 scenes.

Counterpart of ``regard3d_tpu/export/formats.py``: host-side sinks mirroring
``OpenMVGHelper``'s export menu (src/utils/OpenMVGHelper.cpp: PMVS/Bundler
:489-952, MeshLab :1006, NVM :1287, MVE2 :2928-3151) so downstream
MVS/texturing tools (CMVS/PMVS, MVE, VisualSFM, MeshLab) consume the
reconstructions directly. The files are byte-identical to the reference's
for the same scene.

All functions take the flat Scene + image path list; undistortion of the
exported images runs through the port's camera models on the device (the
one device-side step in this module: ``cuda`` unless ``device="cpu"``).
"""

from __future__ import annotations

import configparser
import os
from typing import List, Sequence

import numpy as np
import torch
from PIL import Image

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.core import cameras
from regard3d_tpu_torch.core.sfm_data import _np
from regard3d_tpu_torch.core.types import Scene


def _posed_view_ids(scene: Scene) -> List[int]:
    pm = _np(scene.poses.mask)
    vm = _np(scene.views.mask)
    return [i for i in range(len(pm)) if pm[i] and vm[i]]


def _K_of(scene: Scene, view: int) -> np.ndarray:
    iid = int(_np(scene.views.intrinsic_id)[view])
    p = _np(scene.intrinsics.params)[iid]
    return np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])


def _Rt_of(scene: Scene, view: int):
    R = _np(scene.poses.R)[view]
    C = _np(scene.poses.C)[view]
    t = -R @ C
    return R, t


def undistort_image(img: np.ndarray, scene: Scene, view: int,
                    device=None) -> np.ndarray:
    """Remove lens distortion (UndistortImage parity,
    src/utils/OpenMVGHelper.cpp:3020-3042): for each output pixel sample the
    distorted source location (nearest pixel)."""
    dev = runtime.resolve_device(device)
    iid = int(_np(scene.views.intrinsic_id)[view])
    params = torch.as_tensor(_np(scene.intrinsics.params)[iid], device=dev)
    model = torch.as_tensor(_np(scene.intrinsics.model)[iid], device=dev)
    h, w = img.shape[:2]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    uv = torch.stack([xx, yy], -1).reshape(-1, 2)
    src = _np(cameras.distort_pixel(model, params, uv)).reshape(h, w, 2)
    x0 = np.clip(np.round(src[..., 0]).astype(int), 0, w - 1)
    y0 = np.clip(np.round(src[..., 1]).astype(int), 0, h - 1)
    inside = ((src[..., 0] >= 0) & (src[..., 0] <= w - 1)
              & (src[..., 1] >= 0) & (src[..., 1] <= h - 1))
    out = img[y0, x0]
    out[~inside] = 0
    return out


# ---------------------------------------------------------------------------
# Bundler + PMVS
# ---------------------------------------------------------------------------

def export_bundler(out_dir: str, scene: Scene, image_names: Sequence[str]):
    """bundle.rd.out + list.txt (Bundler v0.3 convention: y/z flipped
    relative to ours, t = -R C)."""
    os.makedirs(out_dir, exist_ok=True)
    ids = _posed_view_ids(scene)
    D = np.diag([1.0, -1.0, -1.0])

    lm_mask = _np(scene.landmarks.mask)
    X = _np(scene.landmarks.X)[lm_mask]
    col = (_np(scene.landmarks.color)[lm_mask] * 255).astype(int)

    with open(os.path.join(out_dir, "list.txt"), "w") as f:
        for v in ids:
            f.write(f"{image_names[v]}\n")

    # per-landmark view lists (reference writes `<n> <cam> <key> <px> <py>`
    # per observation, projecting the 3D point — OpenMVGHelper.cpp:882-903)
    cam_pos = {v: k for k, v in enumerate(ids)}
    lm_ids = np.nonzero(lm_mask)[0]
    lm_pos = {int(l): k for k, l in enumerate(lm_ids)}
    obs_by_lm: dict = {k: [] for k in range(len(lm_ids))}
    om = _np(scene.observations.mask)
    o_lm = _np(scene.observations.landmark_id)
    o_view = _np(scene.observations.view_id)
    o_feat = _np(scene.observations.feature_id)
    for o in np.nonzero(om)[0]:
        li = lm_pos.get(int(o_lm[o]))
        ci = cam_pos.get(int(o_view[o]))
        if li is None or ci is None:
            continue
        v = ids[ci]
        R, t = _Rt_of(scene, v)
        K = _K_of(scene, v)
        xc = R @ X[li] + t
        px = K[0, 0] * xc[0] / xc[2] + K[0, 2]
        py = K[1, 1] * xc[1] / xc[2] + K[1, 2]
        obs_by_lm[li].append((ci, int(o_feat[o]), px, py))

    with open(os.path.join(out_dir, "bundle.rd.out"), "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(ids)} {len(X)}\n")
        for v in ids:
            K = _K_of(scene, v)
            R, t = _Rt_of(scene, v)
            Rb = D @ R
            tb = D @ t
            f.write(f"{K[0,0]:.8g} 0 0\n")
            for row in Rb:
                f.write(f"{row[0]:.8g} {row[1]:.8g} {row[2]:.8g}\n")
            f.write(f"{tb[0]:.8g} {tb[1]:.8g} {tb[2]:.8g}\n")
        for k, (p, c) in enumerate(zip(X, col)):
            f.write(f"{p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n")
            f.write(f"{c[0]} {c[1]} {c[2]}\n")
            lst = obs_by_lm[k]
            f.write(f"{len(lst)}")
            for ci, fi, px, py in lst:
                f.write(f" {ci} {fi} {px:.4g} {py:.4g}")
            f.write("\n")


def export_pmvs(out_dir: str, scene: Scene, images: Sequence[np.ndarray],
                level: int = 1, csize: int = 2, threshold: float = 0.7,
                wsize: int = 7, min_image_num: int = 3, cpu: int = 8,
                device=None):
    """pmvs/ tree: txt/%08d.txt P-matrices, visualize/%08d.jpg undistorted
    images, models/, pmvs_options.txt (parameter parity with the reference's
    densification params, src/R3DProject.h:201-213)."""
    root = os.path.join(out_dir, "PMVS")
    for sub in ("txt", "visualize", "models"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ids = _posed_view_ids(scene)
    for n, v in enumerate(ids):
        K = _K_of(scene, v)
        R, t = _Rt_of(scene, v)
        P = K @ np.concatenate([R, t[:, None]], 1)
        with open(os.path.join(root, "txt", f"{n:08d}.txt"), "w") as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(f"{row[0]:.8g} {row[1]:.8g} {row[2]:.8g} {row[3]:.8g}\n")
        und = undistort_image(np.asarray(images[v]), scene, v, device)
        if und.dtype != np.uint8:
            und = (np.clip(und, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(und).save(
            os.path.join(root, "visualize", f"{n:08d}.jpg"), quality=95)
    with open(os.path.join(root, "pmvs_options.txt"), "w") as f:
        f.write(f"level {level}\ncsize {csize}\nthreshold {threshold}\n"
                f"wsize {wsize}\nminImageNum {min_image_num}\nCPU {cpu}\n"
                f"setEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                f"timages -1 0 {len(ids)}\noimages 0\n")


# ---------------------------------------------------------------------------
# NVM (VisualSFM)
# ---------------------------------------------------------------------------

def export_mvs_texturing(out_dir: str, scene: Scene,
                         image_names: Sequence[str]) -> int:
    """MVSTexturing ``.cam`` files, one per posed pinhole view
    (``OpenMVGHelper::exportToMVSTexturing``,
    src/utils/OpenMVGHelper.cpp:3152-3218):

    line 1: ``tx ty tz R00 .. R22`` (world->cam, t = -R C);
    line 2: ``f/max(w,h) 0 0 1 ppx/w ppy/h``.

    Returns the number of cam files written."""
    os.makedirs(out_dir, exist_ok=True)
    n_written = 0
    for v in _posed_view_ids(scene):
        # reference skips non-pinhole-family intrinsics (:3178); all five
        # supported models here are pinhole + distortion, matching
        # openMVG::cameras::isPinhole
        K = _K_of(scene, v)
        R, t = _Rt_of(scene, v)
        w = int(_np(scene.views.width)[v])
        h = int(_np(scene.views.height)[v])
        larger = max(w, h)
        base = os.path.splitext(os.path.basename(image_names[v]))[0]
        with open(os.path.join(out_dir, base + ".cam"), "w") as f:
            f.write(f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                    f"{R[0,0]:.9g} {R[0,1]:.9g} {R[0,2]:.9g} "
                    f"{R[1,0]:.9g} {R[1,1]:.9g} {R[1,2]:.9g} "
                    f"{R[2,0]:.9g} {R[2,1]:.9g} {R[2,2]:.9g}\n")
            f.write(f"{K[0,0]/larger:.9g} 0 0 1 "
                    f"{K[0,2]/w:.9g} {K[1,2]/h:.9g}")
        n_written += 1
    return n_written


def export_nvm(path: str, scene: Scene, image_names: Sequence[str]):
    """NVM_V3 (src/utils/OpenMVGHelper.cpp:1287 parity). The quaternions
    come from ``cameras.rot_to_quat`` in f32 on the host, as the
    reference's."""
    ids = _posed_view_ids(scene)
    id_map = {v: n for n, v in enumerate(ids)}
    lm_mask = _np(scene.landmarks.mask)
    lm_ids = np.where(lm_mask)[0]
    X = _np(scene.landmarks.X)
    col = (_np(scene.landmarks.color) * 255).astype(int)

    obs_lid = _np(scene.observations.landmark_id)
    obs_vid = _np(scene.observations.view_id)
    obs_fid = _np(scene.observations.feature_id)
    obs_xy = _np(scene.observations.xy)
    obs_ok = _np(scene.observations.mask)

    with open(path, "w") as f:
        f.write("NVM_V3\n\n")
        f.write(f"{len(ids)}\n")
        for v in ids:
            K = _K_of(scene, v)
            R = _np(scene.poses.R)[v]
            C = _np(scene.poses.C)[v]
            q = _np(cameras.rot_to_quat(torch.as_tensor(R)))
            iid = int(_np(scene.views.intrinsic_id)[v])
            k1 = float(_np(scene.intrinsics.params)[iid][3])
            f.write(f"{image_names[v]} {K[0,0]:.8g} "
                    f"{q[0]:.8g} {q[1]:.8g} {q[2]:.8g} {q[3]:.8g} "
                    f"{C[0]:.8g} {C[1]:.8g} {C[2]:.8g} {k1:.8g} 0\n")
        f.write(f"\n{len(lm_ids)}\n")
        for li in lm_ids:
            rows = np.where((obs_lid == li) & obs_ok
                            & np.isin(obs_vid, ids))[0]
            f.write(f"{X[li,0]:.8g} {X[li,1]:.8g} {X[li,2]:.8g} "
                    f"{col[li,0]} {col[li,1]} {col[li,2]} {len(rows)}")
            for r in rows:
                f.write(f" {id_map[int(obs_vid[r])]} {int(obs_fid[r])} "
                        f"{obs_xy[r,0]:.4g} {obs_xy[r,1]:.4g}")
            f.write("\n")


# ---------------------------------------------------------------------------
# MeshLab project
# ---------------------------------------------------------------------------

def export_meshlab(out_dir: str, scene: Scene, image_names: Sequence[str],
                   mesh_relpath: str = "scene_dense.ply"):
    """MeshLab .mlp with VCG raster cameras (OpenMVGHelper :1006 parity)."""
    os.makedirs(out_dir, exist_ok=True)
    ids = _posed_view_ids(scene)
    lines = ['<!DOCTYPE MeshLabDocument>', "<MeshLabProject>", " <MeshGroup>",
             f'  <MLMesh label="{mesh_relpath}" filename="{mesh_relpath}">',
             "   <MLMatrix44>", "1 0 0 0 ", "0 1 0 0 ", "0 0 1 0 ",
             "0 0 0 1 ", "</MLMatrix44>", "  </MLMesh>", " </MeshGroup>",
             " <RasterGroup>"]
    for v in ids:
        K = _K_of(scene, v)
        R, t = _Rt_of(scene, v)
        w = int(_np(scene.views.width)[v])
        h = int(_np(scene.views.height)[v])
        C = _np(scene.poses.C)[v]
        rot = np.eye(4)
        rot[:3, :3] = np.diag([1, -1, -1]) @ R
        rot_str = " ".join(f"{x:.8g}" for x in rot.flatten())
        lines += [
            "  <MLRaster label=\"%s\">" % os.path.basename(image_names[v]),
            f'   <VCGCamera LensDistortion="0 0" '
            f'TranslationVector="{-C[0]:.8g} {-C[1]:.8g} {-C[2]:.8g} 1" '
            f'PixelSizeMm="1 1" CenterPx="{K[0,2]:.8g} {K[1,2]:.8g}" '
            f'FocalMm="{K[0,0]:.8g}" '
            f'ViewportPx="{w} {h}" CameraType="0" '
            f'RotationMatrix="{rot_str}"/>',
            f'   <Plane semantic="1" fileName="{image_names[v]}"/>',
            "  </MLRaster>"]
    lines += [" </RasterGroup>", "</MeshLabProject>"]
    with open(os.path.join(out_dir, "scene.mlp"), "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# MVE2 scene
# ---------------------------------------------------------------------------

def export_mve2(out_dir: str, scene: Scene, images: Sequence[np.ndarray],
                image_names: Sequence[str], device=None):
    """MVE scene tree: views/view_%04d.mve with meta.ini + undistorted image
    (src/utils/OpenMVGHelper.cpp:2928-3151 parity)."""
    views_dir = os.path.join(out_dir, "MVE", "views")
    os.makedirs(views_dir, exist_ok=True)
    with open(os.path.join(out_dir, "MVE", "synth_0.out"), "w") as f:
        f.write("drews 1.0\n0 0\n")
    ids = _posed_view_ids(scene)
    for n, v in enumerate(ids):
        vdir = os.path.join(views_dir, f"view_{n:04d}.mve")
        os.makedirs(vdir, exist_ok=True)
        K = _K_of(scene, v)
        R, t = _Rt_of(scene, v)
        w = int(_np(scene.views.width)[v])
        h = int(_np(scene.views.height)[v])
        # MVE stores focal normalized by the larger dimension
        flen = K[0, 0] / max(w, h)
        ppx = K[0, 2] / w
        ppy = K[1, 2] / h
        meta = configparser.ConfigParser()
        meta["view"] = {"id": str(n), "name": os.path.splitext(
            os.path.basename(image_names[v]))[0]}
        meta["camera"] = {
            "focal_length": f"{flen:.10g}",
            "pixel_aspect": "1",
            "principal_point": f"{ppx:.10g} {ppy:.10g}",
            "rotation": " ".join(f"{x:.10g}" for x in R.flatten()),
            "translation": " ".join(f"{x:.10g}" for x in t),
        }
        with open(os.path.join(vdir, "meta.ini"), "w") as f:
            meta.write(f)
        und = undistort_image(np.asarray(images[v]), scene, v, device)
        if und.dtype != np.uint8:
            und = (np.clip(und, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(und).save(os.path.join(vdir, "undistorted.png"))
