"""OpenMVS ``scene.mvs`` exporter.

Binary writer for the ``MVS::Interface`` archive format (reference usage:
``src/utils/OpenMVGExportToMVS.cpp:56-250`` via
``software/SfM/InterfaceMVS.h``): header ``MVSI`` + version(2) + reserved,
then platforms / images / vertices / normals / colors / lines / transform,
with size_t-prefixed vectors and strings, row-major double matrices.

One platform per intrinsic group, one camera per platform (absolute K with
explicit width/height), one pose per posed view.

Counterpart of ``regard3d_tpu/export/openmvs.py`` on the port's ``Scene``
(host numpy); the archive is byte-identical to the reference's.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

from regard3d_tpu_torch.core.sfm_data import _np
from regard3d_tpu_torch.core.types import Scene

VERSION = 2


class _W:
    def __init__(self, f):
        self.f = f

    def u32(self, v):
        self.f.write(struct.pack("<I", int(v)))

    def u64(self, v):
        self.f.write(struct.pack("<Q", int(v)))

    def f32(self, *v):
        self.f.write(struct.pack(f"<{len(v)}f", *[float(x) for x in v]))

    def f64(self, *v):
        self.f.write(struct.pack(f"<{len(v)}d", *[float(x) for x in v]))

    def u8(self, *v):
        self.f.write(struct.pack(f"<{len(v)}B", *[int(x) for x in v]))

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.f.write(b)


def export_openmvs(path: str, scene: Scene, image_names: Sequence[str],
                   undistorted_dir: str = ""):
    pm = _np(scene.poses.mask)
    vm = _np(scene.views.mask)
    posed = [i for i in range(len(pm)) if pm[i] and vm[i]]
    iid = _np(scene.views.intrinsic_id)
    used_intr = sorted({int(iid[v]) for v in posed})
    plat_of_intr = {k: n for n, k in enumerate(used_intr)}

    params = _np(scene.intrinsics.params)
    iw = _np(scene.intrinsics.width)
    ih = _np(scene.intrinsics.height)
    R = _np(scene.poses.R)
    C = _np(scene.poses.C)

    # image -> (platform, poseID within platform)
    pose_idx = {}
    platform_poses = {k: [] for k in used_intr}
    for v in posed:
        k = int(iid[v])
        pose_idx[v] = len(platform_poses[k])
        platform_poses[k].append(v)

    lm_mask = _np(scene.landmarks.mask)
    lm_ids = np.where(lm_mask)[0]
    lm_row = {int(li): n for n, li in enumerate(lm_ids)}
    X = _np(scene.landmarks.X)
    col = np.clip(_np(scene.landmarks.color) * 255, 0,
                  255).astype(np.uint8)

    obs_lid = _np(scene.observations.landmark_id)
    obs_vid = _np(scene.observations.view_id)
    obs_ok = _np(scene.observations.mask)
    img_row = {v: n for n, v in enumerate(posed)}
    views_per_lm: List[List[int]] = [[] for _ in lm_ids]
    for o in range(len(obs_lid)):
        if obs_ok[o] and int(obs_vid[o]) in img_row:
            li = int(obs_lid[o])
            if li in lm_row:
                views_per_lm[lm_row[li]].append(img_row[int(obs_vid[o])])

    with open(path, "wb") as f:
        w = _W(f)
        f.write(b"MVSI")
        w.u32(VERSION)
        w.u32(0)  # reserved

        # platforms
        w.u64(len(used_intr))
        for k in used_intr:
            w.string(f"platform{k}")
            # cameras (1)
            w.u64(1)
            w.string(f"camera{k}")
            w.u32(int(iw[k]))
            w.u32(int(ih[k]))
            p = params[k]
            w.f64(p[0], 0.0, p[1], 0.0, p[0], p[2], 0.0, 0.0, 1.0)  # K
            w.f64(1, 0, 0, 0, 1, 0, 0, 0, 1)                        # R = I
            w.f64(0, 0, 0)                                          # C = 0
            # poses
            vs = platform_poses[k]
            w.u64(len(vs))
            for v in vs:
                w.f64(*R[v].flatten())
                w.f64(*C[v])

        # images
        w.u64(len(posed))
        for v in posed:
            k = int(iid[v])
            name = image_names[v]
            if undistorted_dir:
                name = f"{undistorted_dir}/{name}"
            w.string(name)
            w.u32(plat_of_intr[k])
            w.u32(0)
            w.u32(pose_idx[v])

        # vertices
        w.u64(len(lm_ids))
        for n, li in enumerate(lm_ids):
            w.f32(*X[li])
            vs = views_per_lm[n]
            w.u64(len(vs))
            for im in vs:
                w.u32(im)
                w.f32(0.0)   # confidence

        # verticesNormal (none), verticesColor
        w.u64(0)
        w.u64(len(lm_ids))
        for li in lm_ids:
            w.u8(*col[li])

        # lines, linesNormal, linesColor (version > 0)
        w.u64(0)
        w.u64(0)
        w.u64(0)
        # transform (version > 1): identity 4x4
        w.f64(1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1)
