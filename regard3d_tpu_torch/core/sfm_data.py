"""sfm_data.json for the matches stage (views + intrinsics only).

Counterpart of the views/intrinsics part of ``regard3d_tpu/core/sfm_data.py``
(OpenMVG-style layout, ``R3DProject::writeSfmData``). The writer produces the
same bytes as the reference's ``save_json`` on a scene that has views and
intrinsics but no poses or structure — what the matches stage writes.
Poses, structure and npz persistence come with the SfM slice.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

from regard3d_tpu_torch.core.types import CAMERA_MODEL_NAMES, DISTO_NPARAMS

_OPENMVG_MODEL_NAMES = {
    "pinhole": "pinhole",
    "radial_k1": "pinhole_radial_k1",
    "radial_k3": "pinhole_radial_k3",
    "brown_t2": "pinhole_brown_t2",
    "fisheye": "fisheye",
}


def views_intrinsics_json_dict(widths, heights, intrinsic_id, models,
                               params,
                               image_names: Optional[Sequence[str]] = None
                               ) -> dict:
    """OpenMVG-style dict with one view per row of ``widths``/``heights``
    (view id = pose id = row) and one intrinsic per row of ``models`` /
    ``params`` ((K, 9) float32: [f, cx, cy, d0..d5])."""
    params = np.asarray(params, np.float32)
    views = []
    for i in range(len(widths)):
        views.append({
            "key": int(i),
            "value": {
                "filename": (image_names[i] if image_names
                             else f"image{i:06d}"),
                "width": int(widths[i]),
                "height": int(heights[i]),
                "id_view": int(i),
                "id_intrinsic": int(intrinsic_id[i]),
                "id_pose": int(i),
            },
        })
    intrinsics = []
    for k in range(len(models)):
        model = int(models[k])
        p = params[k]
        nd = DISTO_NPARAMS[model]
        intrinsics.append({
            "key": int(k),
            "value": {
                "polymorphic_name":
                    _OPENMVG_MODEL_NAMES[CAMERA_MODEL_NAMES[model]],
                "data": {
                    "width": int(widths[k]),
                    "height": int(heights[k]),
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
