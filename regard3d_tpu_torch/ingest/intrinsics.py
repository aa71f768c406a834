"""Focal priors + intrinsic grouping from EXIF metadata.

Parity with ``R3DProject::writeSfmData`` (src/R3DProject.cpp:1118-1308):
* focal prior  f_px = max(w, h) * f_mm / ccd_width_mm       (:1156)
* fallback     f_px = 1.1 * max(w, h) when EXIF/DB fails    (:1159)
* unknown-camera model defaults to radial-K3                (:1175,:398)
* views with identical (model, f, w, h) share one intrinsic group (:1247-1295)

Numpy copy of ``regard3d_tpu/ingest/intrinsics.py`` (the port imports nothing
from the reference package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from regard3d_tpu_torch.core.types import NUM_INTRINSIC_PARAMS, RADIAL_K3
from regard3d_tpu_torch.ingest.exif import ExifInfo


@dataclasses.dataclass
class ViewIntrinsics:
    focal_px: float
    width: int
    height: int
    model: int
    from_exif: bool          # True if derived from EXIF + sensor DB


def focal_prior(exif: ExifInfo, sensor_width_mm: Optional[float]
                ) -> ViewIntrinsics:
    """Priority chain (reference :1152-1159, extended for EXIF bodies the
    sensor DB misses): DB sensor width -> EXIF focal-plane-resolution
    sensor width -> 35mm-equivalent focal -> 1.1*max(w,h) fallback."""
    m = max(exif.width, exif.height)
    ccd = (sensor_width_mm if sensor_width_mm and sensor_width_mm > 0
           else (exif.sensor_width_mm
                 if 2.0 < exif.sensor_width_mm < 70.0 else 0.0))
    if exif.focal_length_mm > 0 and ccd > 0:
        f = m * exif.focal_length_mm / ccd
        return ViewIntrinsics(f, exif.width, exif.height, RADIAL_K3, True)
    if exif.focal_35mm > 0:
        # crop-factor route: f_px = max(w,h) * f35 / 36mm full-frame width
        f = m * exif.focal_35mm / 36.0
        return ViewIntrinsics(f, exif.width, exif.height, RADIAL_K3, True)
    return ViewIntrinsics(1.1 * m, exif.width, exif.height, RADIAL_K3, False)


def build_intrinsics(views: List[ViewIntrinsics], camera_model: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """Group views by shared (model, focal, w, h).

    Returns (intrinsic_id (V,), params (K, 9), models (K,), widths (K,),
    heights (K,))."""
    groups: Dict[Tuple, int] = {}
    intrinsic_id = np.zeros(len(views), np.int32)
    params: List[np.ndarray] = []
    models: List[int] = []
    widths: List[int] = []
    heights: List[int] = []
    for i, v in enumerate(views):
        key = (camera_model, round(v.focal_px, 3), v.width, v.height)
        if key not in groups:
            groups[key] = len(params)
            p = np.zeros(NUM_INTRINSIC_PARAMS, np.float32)
            p[0] = v.focal_px
            p[1] = v.width / 2.0
            p[2] = v.height / 2.0
            params.append(p)
            models.append(camera_model)
            widths.append(v.width)
            heights.append(v.height)
        intrinsic_id[i] = groups[key]
    return (intrinsic_id, np.stack(params), np.asarray(models, np.int32),
            np.asarray(widths, np.int32), np.asarray(heights, np.int32))
