"""The scene's exact two-view geometry, independent of any code of the port.

The views are ray-cast from known planes and poses, so a keypoint of view i
has one true position in view j: cast its ray through the planes, take the
nearest hit, and project that point into view j, unless another plane hides
it there. ``transfer_px`` gives, for each match (keypoint of i, keypoint of
j), the distance from j's keypoint to that true position (infinite where
the ray hits nothing or the point is hidden from j). A match that is right
lies within a pixel or so of it, whatever the detector, the matcher or the
filter did to find it.

A keypoint whose patch straddles a plane's edge (a silhouette against the
empty background, or an occluding edge in either view) has no one true
position: ``clear`` tells the keypoints whose ring of radius ``r`` around
them meets the same plane as their centre and is seen from j throughout.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Plane = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _rays(R: np.ndarray, f: float, size, xy: np.ndarray) -> np.ndarray:
    """World directions of the rays through pixels ``xy`` (principal point
    at the frame's centre, pixel (x, y) centred on (x, y))."""
    w, h = size
    d = np.stack([(xy[:, 0] - w / 2.0) / f, (xy[:, 1] - h / 2.0) / f,
                  np.ones(len(xy))], -1)
    return d @ R


def cast(planes: Sequence[Plane], C: np.ndarray,
         d: np.ndarray) -> np.ndarray:
    """Ray parameter of the nearest hit of each ray C + t d (inf: none)."""
    return cast_id(planes, C, d)[0]


def cast_id(planes: Sequence[Plane], C: np.ndarray, d: np.ndarray):
    """(ray parameter, plane index) of the nearest hit of each ray C + t d
    (inf and -1 where it hits none)."""
    best = np.full(len(d), np.inf)
    which = np.full(len(d), -1)
    for k, (o, u, v) in enumerate(planes):
        n = np.cross(u, v)
        n = n / np.linalg.norm(n)
        g = np.linalg.inv(np.array([[u @ u, u @ v], [u @ v, v @ v]]))
        den = d @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((o - C) @ n) / den
            rel = C + t[:, None] * d - o
            s_ = rel @ (g[0, 0] * u + g[0, 1] * v)
            t_ = rel @ (g[1, 0] * u + g[1, 1] * v)
            ok = ((np.abs(den) > 1e-12) & (t > 1e-6) & (s_ >= 0)
                  & (s_ <= 1) & (t_ >= 0) & (t_ <= 1) & (t < best))
        best = np.where(ok, t, best)
        which = np.where(ok, k, which)
    return best, which


def _seen(planes, Ri, Ci, Rj, Cj, f, size, xi):
    """(true position in j, plane index in i, seen from j) of pixels
    ``xi`` of view i."""
    di = _rays(Ri, f, size, xi)
    t, which = cast_id(planes, Ci, di)
    X = Ci + np.where(np.isfinite(t), t, 0.0)[:, None] * di
    cam = (X - Cj) @ Rj.T
    w, h = size
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.stack([f * cam[:, 0] / cam[:, 2] + w / 2.0,
                      f * cam[:, 1] / cam[:, 2] + h / 2.0], -1)
    # hidden from j: j's own ray towards X meets a plane well before it
    tj = cast(planes, Cj, X - Cj)
    return p, which, np.isfinite(t) & (cam[:, 2] > 0) & (tj > 1.0 - 1e-6)


def transfer_px(planes: Sequence[Plane], Ri, Ci, Rj, Cj, f: float, size,
                xi: np.ndarray, xj: np.ndarray) -> np.ndarray:
    """Distance, in pixels of view j, from each ``xj`` to the true position
    of its partner ``xi`` of view i (inf where that has none)."""
    xi = np.asarray(xi, np.float64).reshape(-1, 2)
    xj = np.asarray(xj, np.float64).reshape(-1, 2)
    if len(xi) == 0:
        return np.zeros(0)
    p, _, seen = _seen(planes, Ri, Ci, Rj, Cj, f, size, xi)
    err = np.linalg.norm(p - xj, axis=-1)
    return np.where(seen, err, np.inf)


RING = 8                     # points on a keypoint's ring


def clear(planes: Sequence[Plane], Ri, Ci, Rj, Cj, f: float, size,
          xi: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Keypoints ``xi`` of view i whose ring of radius ``r`` meets the same
    plane as their centre and is seen from view j all round."""
    xi = np.asarray(xi, np.float64).reshape(-1, 2)
    n = len(xi)
    a = 2.0 * np.pi * np.arange(RING) / RING
    ring = xi[:, None] + np.asarray(r, np.float64).reshape(-1, 1, 1) * \
        np.stack([np.cos(a), np.sin(a)], -1)[None]
    pts = np.concatenate([xi[:, None], ring], 1).reshape(-1, 2)
    _, which, seen = _seen(planes, Ri, Ci, Rj, Cj, f, size, pts)
    which = which.reshape(n, RING + 1)
    seen = seen.reshape(n, RING + 1)
    return seen.all(1) & (which == which[:, :1]).all(1)
