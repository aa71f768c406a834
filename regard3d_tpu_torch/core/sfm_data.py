"""Scene (SfM_Data) persistence: ``scene.npz`` and ``sfm_data.json``.

Counterpart of ``regard3d_tpu/core/sfm_data.py``:

* **npz** — raw struct-of-arrays fields under ``<group>.<field>`` keys, the
  same keys and dtypes as the reference's (``sfm_data.bin`` role);
* **json** — OpenMVG-style views / intrinsics / extrinsics / structure
  (``R3DProject::writeSfmData``). ``views_intrinsics_json_dict`` writes the
  views and intrinsics for both the matches stage (no poses, no structure)
  and full scenes; the writers produce the reference's bytes.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from regard3d_tpu_torch.core.types import (CAMERA_MODEL_NAMES, DISTO_NPARAMS,
                                           Scene, scene_from_numpy)

_OPENMVG_MODEL_NAMES = {
    "pinhole": "pinhole",
    "radial_k1": "pinhole_radial_k1",
    "radial_k3": "pinhole_radial_k3",
    "brown_t2": "pinhole_brown_t2",
    "fisheye": "fisheye",
}


def views_intrinsics_json_dict(widths, heights, intrinsic_id, models,
                               params,
                               image_names: Optional[Sequence[str]] = None,
                               view_mask=None, pose_id=None,
                               intr_widths=None, intr_heights=None,
                               intr_mask=None) -> dict:
    """OpenMVG-style dict with one view per live row of ``widths`` /
    ``heights`` (``pose_id`` defaults to the row) and one intrinsic per live
    row of ``models`` / ``params`` ((K, 9) float32: [f, cx, cy, d0..d5]).
    ``intr_widths`` / ``intr_heights`` default to the views' (the matches
    stage writes one intrinsic per view); masks default to all live."""
    params = np.asarray(params, np.float32)
    if intr_widths is None:
        intr_widths, intr_heights = widths, heights
    views = []
    for i in range(len(widths)):
        if view_mask is not None and not view_mask[i]:
            continue
        views.append({
            "key": int(i),
            "value": {
                "filename": (image_names[i] if image_names
                             else f"image{i:06d}"),
                "width": int(widths[i]),
                "height": int(heights[i]),
                "id_view": int(i),
                "id_intrinsic": int(intrinsic_id[i]),
                "id_pose": int(i if pose_id is None else pose_id[i]),
            },
        })
    intrinsics = []
    for k in range(len(models)):
        if intr_mask is not None and not intr_mask[k]:
            continue
        model = int(models[k])
        p = params[k]
        nd = DISTO_NPARAMS[model]
        intrinsics.append({
            "key": int(k),
            "value": {
                "polymorphic_name":
                    _OPENMVG_MODEL_NAMES[CAMERA_MODEL_NAMES[model]],
                "data": {
                    "width": int(intr_widths[k]),
                    "height": int(intr_heights[k]),
                    "focal_length": float(p[0]),
                    "principal_point": [float(p[1]), float(p[2])],
                    "disto": [float(x) for x in p[3:3 + nd]],
                },
            },
        })
    return {
        "sfm_data_version": "0.3",
        "root_path": "",
        "views": views,
        "intrinsics": intrinsics,
        "extrinsics": [],
        "structure": [],
        "control_points": [],
    }


def save_views_json(path: str, widths, heights, intrinsic_id, models, params,
                    image_names: Optional[Sequence[str]] = None):
    with open(path, "w") as f:
        json.dump(views_intrinsics_json_dict(widths, heights, intrinsic_id,
                                             models, params, image_names),
                  f, indent=1)


# ---------------------------------------------------------------------------
# Full scenes
# ---------------------------------------------------------------------------

def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def scene_to_numpy(scene: Scene) -> dict:
    flat = {}
    for name in ("views", "intrinsics", "poses", "landmarks", "observations"):
        for field, val in vars(getattr(scene, name)).items():
            flat[f"{name}.{field}"] = _np(val)
    return flat


def save_npz(path: str, scene: Scene, extra: Optional[dict] = None):
    flat = scene_to_numpy(scene)
    if extra:
        for k, v in extra.items():
            flat[f"extra.{k}"] = _np(v)
    np.savez_compressed(path, **flat)


def load_npz(path: str, device="cpu") -> Scene:
    with np.load(path) as z:
        return scene_from_numpy({k: z[k] for k in z.files}, device)


def _structure(s: dict) -> list:
    """Observations grouped by landmark, live rows of live landmarks."""
    structure = []
    lid_all = s["observations.landmark_id"]
    if not len(lid_all):
        return structure
    order = np.argsort(lid_all, kind="stable")
    lid = lid_all[order]
    vmask = s["observations.mask"][order]
    vid = s["observations.view_id"][order]
    fid = s["observations.feature_id"][order]
    xy = s["observations.xy"][order]
    lmask, X = s["landmarks.mask"], s["landmarks.X"]
    cur, acc = None, []

    def flush():
        if cur is not None and lmask[cur] and acc:
            structure.append({"key": int(cur), "value": {
                "X": [float(x) for x in X[cur]], "observations": acc.copy()}})

    for j in range(len(lid)):
        if not vmask[j]:
            continue
        if lid[j] != cur:
            flush()
            cur, acc = int(lid[j]), []
        acc.append({"key": int(vid[j]),
                    "value": {"id_feat": int(fid[j]),
                              "x": [float(xy[j, 0]), float(xy[j, 1])]}})
    flush()
    return structure


def scene_to_json_dict(scene: Scene, image_names: Optional[list] = None,
                       root_path: str = "") -> dict:
    """OpenMVG-style sfm_data dict (views/intrinsics/extrinsics/structure)."""
    s = scene_to_numpy(scene)
    d = views_intrinsics_json_dict(
        s["views.width"], s["views.height"], s["views.intrinsic_id"],
        s["intrinsics.model"], s["intrinsics.params"], image_names,
        view_mask=s["views.mask"], pose_id=s["views.pose_id"],
        intr_widths=s["intrinsics.width"], intr_heights=s["intrinsics.height"],
        intr_mask=s["intrinsics.mask"])
    d["root_path"] = root_path
    d["extrinsics"] = [
        {"key": int(p), "value": {
            "rotation": [[float(x) for x in row] for row in s["poses.R"][p]],
            "center": [float(x) for x in s["poses.C"][p]]}}
        for p in range(len(s["poses.mask"])) if s["poses.mask"][p]]
    d["structure"] = _structure(s)
    return d


def save_json(path: str, scene: Scene, image_names: Optional[list] = None,
              root_path: str = ""):
    with open(path, "w") as f:
        json.dump(scene_to_json_dict(scene, image_names, root_path), f,
                  indent=1)
