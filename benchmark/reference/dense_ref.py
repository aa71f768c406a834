"""Plain reference of the dense step's results: the scene's exact surfaces.

The views are ray-cast from known planes and poses, so every pixel of a
depth map has one true depth and every point of the dense cloud has one
true distance to the nearest surface. The step's results live in the frame
of its own triangulation; ``similarity`` fits the map from that frame to
the truth (the estimated camera centres onto the exact ones, Umeyama) and
everything is judged there:

* ``truth_idepth``: the exact inverse depth of each pixel of a depth map,
  cast along the step's own ray for that pixel (its intrinsics at the
  sweep's level, its pose mapped into the truth frame);
* ``quad_distance``: each point's distance to the nearest plane (the
  finite parallelograms, not their infinite planes);
* ``coverage_samples`` and ``uncovered``: surface points cast through a
  grid of the exact cameras' pixels that enough exact views see, and the
  share of them with no dense point near (completeness, as Strecha et al.
  score multi-view stereo).

Everything runs in float64 on the run's device, in blocks of rays or rows.
Nothing here imports the program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

Plane = Tuple[np.ndarray, np.ndarray, np.ndarray]
BLOCK = 1 << 21              # rays or points a device block holds
F64 = torch.float64


def similarity(src: np.ndarray, dst: np.ndarray):
    """(s, R, t) of the best similarity dst ~ s R src + t (Umeyama)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    ms, md = src.mean(0), dst.mean(0)
    a, b = src - ms, dst - md
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D)
              / max((a ** 2).sum() / len(src), 1e-300))
    return s, R, md - s * R @ ms


def extent(planes: Sequence[Plane]) -> float:
    """The diagonal of the planes' bounding box."""
    corners = np.concatenate([[o, o + u, o + v, o + u + v]
                              for o, u, v in planes])
    return float(np.linalg.norm(corners.max(0) - corners.min(0)))


def cast(planes: Sequence[Plane], C, d: torch.Tensor) -> torch.Tensor:
    """Ray parameter of the nearest hit of each ray C + t d (inf: none);
    ``C`` (3,) or (N, 3), ``d`` (N, 3), float64 on one device."""
    dev = d.device
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    C = C if torch.is_tensor(C) else T(C)
    best = torch.full(d.shape[:1], float("inf"), dtype=F64, device=dev)
    for o, u, v in planes:
        n = np.cross(u, v)
        n = n / np.linalg.norm(n)
        g = np.linalg.inv(np.array([[u @ u, u @ v], [u @ v, v @ v]]))
        den = d @ T(n)
        safe = torch.where(den.abs() > 1e-12, den, torch.ones_like(den))
        t = ((T(o) - C) @ T(n)) / safe
        rel = C + t[:, None] * d - T(o)
        s_ = rel @ T(g[0, 0] * u + g[0, 1] * v)
        t_ = rel @ T(g[1, 0] * u + g[1, 1] * v)
        ok = ((den.abs() > 1e-12) & (t > 1e-6) & (s_ >= 0) & (s_ <= 1)
              & (t_ >= 0) & (t_ <= 1) & (t < best))
        best = torch.where(ok, t, best)
    return best


def truth_idepth(planes: Sequence[Plane], K: np.ndarray, R: np.ndarray,
                 C: np.ndarray, hw: Tuple[int, int], device) -> torch.Tensor:
    """(H, W) exact inverse depth (along the camera's z axis) of each pixel
    of a camera x_cam = R (X - C) with intrinsics ``K``, 0 where the ray
    meets no plane."""
    H, W = hw
    Kinv = torch.as_tensor(np.linalg.inv(K), dtype=F64, device=device)
    Rt = torch.as_tensor(np.asarray(R, np.float64), device=device)
    out = torch.empty(H * W, dtype=F64, device=device)
    rows = max(1, BLOCK // W)
    xs = torch.arange(W, dtype=F64, device=device)
    for y0 in range(0, H, rows):
        y1 = min(H, y0 + rows)
        ys = torch.arange(y0, y1, dtype=F64, device=device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pix = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
        d_cam = pix @ Kinv.T                      # z component 1
        t = cast(planes, C, d_cam @ Rt)           # = depth along z
        out[y0 * W:y1 * W] = torch.where(torch.isfinite(t), 1.0 / t, 0.0)
    return out.reshape(H, W)


def quad_distance(planes: Sequence[Plane], X: torch.Tensor) -> torch.Tensor:
    """(N,) distance of each point (N, 3) to the nearest plane."""
    dev = X.device
    out = torch.empty(X.shape[0], dtype=F64, device=dev)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    for b0 in range(0, X.shape[0], BLOCK):
        P = X[b0:b0 + BLOCK].to(F64)
        best = torch.full(P.shape[:1], float("inf"), dtype=F64, device=dev)
        for o, u, v in planes:
            rel = P - T(o)
            s = torch.clamp(rel @ T(u) / float(u @ u), 0.0, 1.0)
            t = torch.clamp(rel @ T(v) / float(v @ v), 0.0, 1.0)
            d = torch.linalg.norm(rel - s[:, None] * T(u) - t[:, None] * T(v),
                                  dim=1)
            best = torch.minimum(best, d)
        out[b0:b0 + BLOCK] = best
    return out


def coverage_samples(planes: Sequence[Plane], Rs: np.ndarray, Cs: np.ndarray,
                     f: float, size: Tuple[int, int], level: int, stride: int,
                     min_views: int, device) -> torch.Tensor:
    """(M, 3) surface points: every ``stride``-th pixel of every exact view
    at the sweep's ``level``, cast through the planes, kept where at least
    ``min_views`` exact views see the point (in the frame, in front, not
    hidden)."""
    w, h = size
    sc = 2.0 ** level
    ul = torch.arange(0, int(w // sc), stride, dtype=F64, device=device)
    vl = torch.arange(0, int(h // sc), stride, dtype=F64, device=device)
    gy, gx = torch.meshgrid(vl, ul, indexing="ij")
    # a level pixel's centre in full-resolution pixels (u + 0.5) s - 0.5;
    # the views' principal point is the frame's centre
    x = (gx.reshape(-1) + 0.5) * sc - 0.5
    y = (gy.reshape(-1) + 0.5) * sc - 0.5
    d_cam = torch.stack([(x - w / 2.0) / f, (y - h / 2.0) / f,
                         torch.ones_like(x)], -1)
    pts = []
    for R, C in zip(Rs, Cs):
        d = d_cam @ torch.as_tensor(np.asarray(R, np.float64), device=device)
        t = cast(planes, C, d)
        hit = torch.isfinite(t)
        pts.append(torch.as_tensor(np.asarray(C, np.float64), device=device)
                   + t[hit][:, None] * d[hit])
    P = torch.cat(pts)
    seen = torch.zeros(P.shape[0], dtype=torch.long, device=device)
    for R, C in zip(Rs, Cs):
        Ct = torch.as_tensor(np.asarray(C, np.float64), device=device)
        Rt = torch.as_tensor(np.asarray(R, np.float64), device=device)
        cam = (P - Ct) @ Rt.T
        z = cam[:, 2]
        zs = torch.where(z > 1e-9, z, torch.ones_like(z))
        px = f * cam[:, 0] / zs + w / 2.0
        py = f * cam[:, 1] / zs + h / 2.0
        inside = (z > 1e-9) & (px >= 0) & (px <= w - 1) & (py >= 0) \
            & (py <= h - 1)
        tj = cast(planes, Ct, P - Ct)
        seen += (inside & (tj > 1.0 - 1e-6)).long()
    return P[seen >= min_views]


def uncovered(samples: torch.Tensor, points: torch.Tensor,
              tol: float) -> float:
    """Share of ``samples`` (M, 3) with no point of ``points`` (N, 3)
    within ``tol``: a grid of cells ``tol`` wide, every point of the 27
    cells around a sample compared, in blocks of samples."""
    M = samples.shape[0]
    if M == 0:
        return 0.0
    if points.shape[0] == 0:
        return 1.0
    dev = samples.device
    P = points.to(F64)
    P = P[torch.isfinite(P).all(1)]
    if P.shape[0] == 0:
        return 1.0
    lo = samples.amin(0) - 2 * tol
    span = 1 << 20

    def key(c):
        c = torch.clamp(c, 0, span - 1)
        return (c[:, 0] * span + c[:, 1]) * span + c[:, 2]

    cell = torch.floor(torch.clamp((P - lo) / tol, -1.0, span)).long()
    keys, order = torch.sort(key(cell))
    P = P[order]
    base = torch.floor((samples - lo) / tol).long()
    covered = torch.zeros(M, dtype=torch.bool, device=dev)
    offs = torch.tensor([[a, b, c] for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1)], device=dev)
    for off in offs:
        k = key(base + off)
        first = torch.searchsorted(keys, k, right=False)
        count = torch.searchsorted(keys, k, right=True) - first
        most = int(count.max())
        if most == 0:
            continue
        rows = max(1, BLOCK // most)
        for b0 in range(0, M, rows):
            sl = slice(b0, b0 + rows)
            j = torch.arange(most, device=dev)
            idx = first[sl, None] + j
            ok = j < count[sl, None]
            near = torch.linalg.norm(
                P[torch.where(ok, idx, 0)] - samples[sl, None].to(F64),
                dim=-1) <= tol
            covered[sl] |= (near & ok).any(1)
    return float(1.0 - covered.double().mean())


def read_ply_xyz(path: str) -> np.ndarray:
    """(N, 3) float32 vertex positions of a binary little-endian PLY whose
    vertex properties are float or uchar scalars."""
    sizes = {"float": "<f4", "uchar": "u1", "double": "<f8", "int": "<i4"}
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY")
        n, props, fmt = 0, [], None
        in_vertex = False
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            tok = line.decode("ascii").split()
            if not tok:
                continue
            if tok[0] == "end_header":
                break
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] not in sizes:
                    raise ValueError(f"{path}: property {tok[1:]}")
                props.append((tok[2], sizes[tok[1]]))
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: format {fmt}")
        dt = np.dtype(props)
        buf = fh.read(n * dt.itemsize)
    if len(buf) != n * dt.itemsize:
        raise ValueError(f"{path}: {len(buf)} bytes for {n} vertices")
    rec = np.frombuffer(buf, dt)
    return np.stack([rec["x"], rec["y"], rec["z"]], -1)
