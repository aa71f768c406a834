"""PLY point-cloud / mesh I/O (host-side export sink, numpy).

Counterpart of ``regard3d_tpu/export/ply.py``: ``cloud_and_poses.ply``
(cloud + green camera markers) and ``FinalColorized.ply``, written with the
reference's bytes (header comment included, so files of the two packages
compare equal). Reads ascii and binary_little_endian PLY; writes binary by
default.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class PlyData:
    xyz: np.ndarray                      # (N, 3) float
    rgb: Optional[np.ndarray] = None     # (N, 3) uint8
    normals: Optional[np.ndarray] = None # (N, 3) float
    faces: Optional[np.ndarray] = None   # (F, 3) int


_PROP_TYPES = {
    "float": ("f", 4, np.float32), "float32": ("f", 4, np.float32),
    "double": ("d", 8, np.float64), "float64": ("d", 8, np.float64),
    "uchar": ("B", 1, np.uint8), "uint8": ("B", 1, np.uint8),
    "char": ("b", 1, np.int8), "int8": ("b", 1, np.int8),
    "short": ("h", 2, np.int16), "ushort": ("H", 2, np.uint16),
    "int": ("i", 4, np.int32), "int32": ("i", 4, np.int32),
    "uint": ("I", 4, np.uint32), "uint32": ("I", 4, np.uint32),
}


def write_ply(path: str, data: PlyData, binary: bool = True):
    n = len(data.xyz)
    has_rgb = data.rgb is not None
    has_nrm = data.normals is not None
    has_faces = data.faces is not None and len(data.faces) > 0

    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              "comment generated by regard3d_tpu",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_nrm:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if has_rgb:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if has_faces:
        header += [f"element face {len(data.faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        xyz = np.asarray(data.xyz, np.float32)
        if binary:
            cols = [xyz]
            dtypes = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if has_nrm:
                cols.append(np.asarray(data.normals, np.float32))
                dtypes += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            if has_rgb:
                cols.append(np.asarray(data.rgb, np.uint8))
                dtypes += [("r", "u1"), ("g", "u1"), ("b", "u1")]
            rec = np.empty(n, dtype=dtypes)
            i = 0
            for c in cols:
                for k in range(c.shape[1]):
                    rec[rec.dtype.names[i]] = c[:, k]
                    i += 1
            f.write(rec.tobytes())
            if has_faces:
                faces = np.asarray(data.faces, np.int32)
                rec_f = np.empty(len(faces),
                                 dtype=[("n", "u1"), ("v", "<i4", (3,))])
                rec_f["n"] = 3
                rec_f["v"] = faces
                f.write(rec_f.tobytes())
        else:
            for i in range(n):
                row = [f"{xyz[i,0]:.6f}", f"{xyz[i,1]:.6f}", f"{xyz[i,2]:.6f}"]
                if has_nrm:
                    row += [f"{v:.6f}" for v in data.normals[i]]
                if has_rgb:
                    row += [str(int(v)) for v in data.rgb[i]]
                f.write((" ".join(row) + "\n").encode())
            if has_faces:
                for face in data.faces:
                    f.write((f"3 {face[0]} {face[1]} {face[2]}\n").encode())


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        # ---- header ----
        line = f.readline().decode().strip()
        if line != "ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []          # (name, count, [(prop_name, type or list)])
        while True:
            line = f.readline().decode().strip()
            if line == "end_header":
                break
            parts = line.split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append((parts[4], ("list", parts[2],
                                                       parts[3])))
                else:
                    elements[-1][2].append((parts[2], parts[1]))

        result: Dict[str, Dict[str, np.ndarray]] = {}
        faces = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().decode().split() for _ in range(count)]
                if name == "face":
                    faces = np.asarray([[int(x) for x in r[1:4]]
                                        for r in rows], np.int32)
                    continue
                cols = {}
                for ci, (pname, ptype) in enumerate(props):
                    npdt = _PROP_TYPES[ptype][2]
                    cols[pname] = np.asarray([r[ci] for r in rows],
                                             dtype=np.float64).astype(npdt)
                result[name] = cols
            else:
                if any(isinstance(p[1], tuple) for p in props):
                    # element with list property (faces): parse row by row
                    fl = []
                    for _ in range(count):
                        cnt = struct.unpack("<B", f.read(1))[0]
                        idx = struct.unpack(f"<{cnt}i", f.read(4 * cnt))
                        fl.append(idx[:3])
                    if name == "face":
                        faces = np.asarray(fl, np.int32)
                    continue
                dtypes = []
                for pname, ptype in props:
                    ch, sz, npdt = _PROP_TYPES[ptype]
                    dtypes.append((pname, "<" + np.dtype(npdt).str[1:]))
                rec = np.frombuffer(f.read(count * sum(
                    _PROP_TYPES[p[1]][1] for p in props)), dtype=dtypes)
                result[name] = {p[0]: rec[p[0]] for p in props}

    v = result.get("vertex", {})
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float64) \
        if "x" in v else np.zeros((0, 3))
    rgb = None
    for names in (("red", "green", "blue"), ("r", "g", "b"),
                  ("diffuse_red", "diffuse_green", "diffuse_blue")):
        if names[0] in v:
            rgb = np.stack([v[n] for n in names], -1).astype(np.uint8)
            break
    normals = None
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float64)
    return PlyData(xyz=xyz, rgb=rgb, normals=normals, faces=faces)


def export_cloud_and_poses(path: str, points: np.ndarray,
                           colors: Optional[np.ndarray],
                           camera_centers: np.ndarray, binary: bool = True):
    """Cloud + camera positions as green markers (cloud_and_poses parity)."""
    n_cam = len(camera_centers)
    xyz = np.concatenate([np.asarray(points, np.float32),
                          np.asarray(camera_centers, np.float32)])
    if colors is None:
        colors = np.full((len(points), 3), 255, np.uint8)
    cam_rgb = np.tile(np.asarray([[0, 255, 0]], np.uint8), (n_cam, 1))
    rgb = np.concatenate([np.asarray(colors, np.uint8), cam_rgb])
    write_ply(path, PlyData(xyz=xyz, rgb=rgb), binary=binary)
