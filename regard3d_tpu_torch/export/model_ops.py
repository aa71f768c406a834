"""Point-cloud / mesh model operations (host numpy/scipy).

Copy of ``regard3d_tpu/export/model_ops.py`` over the port's PLY module;
the files it writes are byte-identical to the reference's. Equivalent of
``R3DModelOperations`` (src/R3DModelOperations.cpp):
* combine PMVS cluster clouds (:53-168);
* colorize a surface by k-NN color transfer from the dense cloud — the
  reference uses a boost::geometry R-tree (:170-332); here a scipy cKDTree;
* PLY -> OBJ conversion (src/R3DModelOperations.h:36);
* point-cloud / surface re-export.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy.spatial import cKDTree

from regard3d_tpu_torch.export.ply import PlyData, read_ply, write_ply


def combine_clouds(paths: Sequence[str], out_path: str):
    """Concatenate dense cluster models (PMVS option-%04d outputs)."""
    xyz, rgb, nrm = [], [], []
    has_rgb = True
    has_nrm = True
    for p in paths:
        d = read_ply(p)
        xyz.append(d.xyz)
        has_rgb &= d.rgb is not None
        has_nrm &= d.normals is not None
        rgb.append(d.rgb)
        nrm.append(d.normals)
    data = PlyData(
        xyz=np.concatenate(xyz) if xyz else np.zeros((0, 3)),
        rgb=np.concatenate(rgb) if has_rgb and rgb else None,
        normals=np.concatenate(nrm) if has_nrm and nrm else None)
    write_ply(out_path, data)
    return len(data.xyz)


def colorize_mesh_from_cloud(mesh_path: str, cloud_path: str, out_path: str,
                             k: int = 3):
    """Vertex colors by inverse-distance-weighted k-NN transfer from the
    dense cloud (colorizeSurface parity, k query at
    src/R3DModelOperations.cpp:278)."""
    mesh = read_ply(mesh_path)
    cloud = read_ply(cloud_path)
    if cloud.rgb is None:
        raise ValueError("dense cloud has no colors to transfer")
    tree = cKDTree(cloud.xyz)
    dist, idx = tree.query(mesh.xyz, k=min(k, len(cloud.xyz)))
    if dist.ndim == 1:
        dist = dist[:, None]
        idx = idx[:, None]
    wgt = 1.0 / np.maximum(dist, 1e-12)
    wgt /= wgt.sum(1, keepdims=True)
    colors = (cloud.rgb[idx].astype(np.float64) * wgt[..., None]).sum(1)
    mesh.rgb = np.clip(np.round(colors), 0, 255).astype(np.uint8)
    write_ply(out_path, mesh)
    return mesh


def ply_to_obj(ply_path: str, obj_path: str):
    """Export mesh as OBJ (vertices + vertex colors as extension, faces)."""
    d = read_ply(ply_path)
    with open(obj_path, "w") as f:
        f.write("# exported by regard3d_tpu\n")
        for i, p in enumerate(d.xyz):
            if d.rgb is not None:
                c = d.rgb[i].astype(np.float64) / 255.0
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
            else:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if d.faces is not None:
            for face in d.faces:
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


def export_point_cloud(scene_points: np.ndarray,
                       colors: Optional[np.ndarray], out_path: str):
    rgb = None
    if colors is not None:
        rgb = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
    write_ply(out_path, PlyData(xyz=np.asarray(scene_points), rgb=rgb))
