"""Synthetic rendered multi-view datasets with exact ground truth.

The reference publishes no datasets (BASELINE.md), so the accuracy gate
(``bench_accuracy.py``) runs the FULL pipeline — detection, LIOP, matching,
ACRANSAC, incremental SfM, BA — on ray-cast scenes whose camera poses are
known exactly; ``chip_smoke.py`` checks the port's match files against the
same exact geometry. Scene shapes are
modeled on the BASELINE configs:

* ``castle``   — SceauxCastle-11 stand-in: two facade planes meeting at a
  corner + a ground plane, 11 cameras on an arc (the castle photos orbit a
  building corner);
* ``fountain`` — Strecha fountain-P11 stand-in: a wall + protruding slab,
  11 cameras in a tighter half-ring (strong parallax, partial occlusion).

Textures are band-limited random fields (smoothed uniform noise) — the same
statistics that make AKAZE/LIOP work on masonry. Rendering is exact
ray/plane intersection with bilinear texture lookup and nearest-hit
compositing, so ground truth is exact to float64.

* ``city``     — the scale axis (a Rome16K stand-in): a street of facade
  rows with ``n_cams`` views, as an open corridor or a closed loop, plus
  ``window_pairs``, the sequential pair list of an ordered capture.

Numpy copy of ``regard3d_tpu/ingest/synth.py`` (the port imports nothing
from the reference package): the same ``default_rng`` draws in the same
order, so the arrays are identical for the same seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Quad:
    """A textured parallelogram: origin o, edges u, v (texture axes)."""

    def __init__(self, o, u, v, tex):
        self.o = np.asarray(o, np.float64)
        self.u = np.asarray(u, np.float64)
        self.v = np.asarray(v, np.float64)
        self.n = np.cross(self.u, self.v)
        self.n /= np.linalg.norm(self.n)
        self.tex = np.asarray(tex, np.float32)


def _smooth_texture(rng, size: int, sigma: float = 0.6) -> np.ndarray:
    """Band-limited random texture (separable numpy Gaussian — keeps the
    renderer host-only, no device round trips)."""
    t = rng.uniform(0.0, 1.0, size=(size, size)).astype(np.float32)
    r = max(1, int(3 * sigma))
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)
    k /= k.sum()
    pad = np.pad(t, ((r, r), (0, 0)), mode="reflect")
    t = sum(k[i] * pad[i:i + size] for i in range(2 * r + 1))
    pad = np.pad(t, ((0, 0), (r, r)), mode="reflect")
    t = sum(k[i] * pad[:, i:i + size] for i in range(2 * r + 1))
    return t


def _bilinear(tex, s, t):
    H, W = tex.shape
    x = s * (W - 1)
    y = t * (H - 1)
    x0 = np.clip(x.astype(int), 0, W - 2)
    y0 = np.clip(y.astype(int), 0, H - 2)
    fx = x - x0
    fy = y - y0
    return ((1 - fx) * (1 - fy) * tex[y0, x0]
            + fx * (1 - fy) * tex[y0, x0 + 1]
            + (1 - fx) * fy * tex[y0 + 1, x0]
            + fx * fy * tex[y0 + 1, x0 + 1])


def _undistort_radial(mx, my, disto, iters: int = 12):
    """Invert x_d = x_u (1 + k1 r^2 + k2 r^4 + k3 r^6) by fixed-point
    iteration (the OpenMVG radial-K3 convention of core.cameras)."""
    k1, k2, k3 = disto
    ux, uy = mx.copy(), my.copy()
    for _ in range(iters):
        r2 = ux * ux + uy * uy
        s = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        ux = mx / s
        uy = my / s
    return ux, uy


def render_view(quads: List[Quad], R: np.ndarray, C: np.ndarray,
                f: float, hw: int, disto=None) -> np.ndarray:
    """Ray-cast one view: nearest quad hit wins (exact z-order).

    ``disto=(k1,k2,k3)`` ray-casts THROUGH a radial-K3 lens (the
    reference's default camera model, src/R3DProject.cpp:1167-1191): each
    distorted output pixel is un-distorted to its ideal normalized
    coordinate before the ray is built, so the image is exactly what a
    radial-K3 camera with those parameters would record."""
    c = hw / 2.0
    ys, xs = np.mgrid[0:hw, 0:hw].astype(np.float64)
    mx = (xs - c) / f
    my = (ys - c) / f
    if disto is not None and any(abs(d) > 0 for d in disto):
        mx, my = _undistort_radial(mx, my, disto)
    d_cam = np.stack([mx, my, np.ones_like(xs)], -1)
    d_world = d_cam @ R                       # R^T d (rows of R are axes)
    img = np.zeros((hw, hw), np.float32)
    zbuf = np.full((hw, hw), np.inf)
    for q in quads:
        denom = d_world @ q.n
        t_hit = ((q.o - C) @ q.n) / np.where(np.abs(denom) < 1e-12,
                                             1e-12, denom)
        P = C + t_hit[..., None] * d_world
        rel = P - q.o
        # texture coords via the dual basis of (u, v)
        g = np.array([[q.u @ q.u, q.u @ q.v], [q.u @ q.v, q.v @ q.v]])
        gi = np.linalg.inv(g)
        s_ = rel @ (gi[0, 0] * q.u + gi[0, 1] * q.v)
        t_ = rel @ (gi[1, 0] * q.u + gi[1, 1] * q.v)
        ok = ((t_hit > 1e-6) & (s_ >= 0) & (s_ <= 1) & (t_ >= 0) & (t_ <= 1)
              & (t_hit < zbuf))
        val = _bilinear(q.tex, np.clip(s_, 0, 1), np.clip(t_, 0, 1))
        img = np.where(ok, val.astype(np.float32), img)
        zbuf = np.where(ok, t_hit, zbuf)
    return img


def _look_at(C, target, up=(0.0, -1.0, 0.0)):
    """Rotation with camera +z toward target (world->cam row convention)."""
    z = np.asarray(target, np.float64) - C
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def make_dataset(name: str = "castle", n_cams: int = 11, hw: int = 320,
                 f: Optional[float] = None, seed: int = 0,
                 disto=None) -> Dict:
    """Returns dict(images, Rs, Cs, f, hw, name[, disto]) with exact GT
    poses; ``disto=(k1,k2,k3)`` renders through a radial-K3 lens."""
    rng = np.random.default_rng(seed)
    f = f or 1.3 * hw
    if name.endswith("_rk3"):
        # distorted twin of a base dataset, default mild barrel distortion
        name = name[:-4]
        if disto is None:
            disto = (-0.15, 0.02, 0.0)
    if name == "castle":
        # two facades meeting at the origin corner + ground plane
        t1 = _smooth_texture(rng, 160)
        t2 = _smooth_texture(rng, 160)
        t3 = _smooth_texture(rng, 192)
        quads = [
            Quad([0, -3, 0], [-6, 0, 2], [0, 6, 0], t1),     # left facade
            Quad([0, -3, 0], [6, 0, 3], [0, 6, 0], t2),      # right facade
            Quad([-6, 3, -1], [12, 0, 0], [0, 0, 6], t3),    # ground
        ]
        target = np.array([0.0, 0.0, 1.5])
        radius, z0 = 12.0, -10.0
        arc = np.linspace(-0.5, 0.5, n_cams)
        Cs = np.stack([radius * np.sin(arc),
                       rng.normal(scale=0.15, size=n_cams) - 0.5,
                       z0 + radius * (1 - np.cos(arc))], -1)
    elif name == "fountain":
        # wall + protruding slab (occlusion + strong parallax)
        t1 = _smooth_texture(rng, 224)
        t2 = _smooth_texture(rng, 128)
        t3 = _smooth_texture(rng, 128)
        quads = [
            Quad([-5, -3, 2], [10, 0, 0], [0, 6, 0], t1),    # back wall
            Quad([-1.2, -1.2, 0.6], [2.4, 0, 0], [0, 2.4, 0.9], t2),  # slab
            Quad([-5, 3, -4], [10, 0, 0], [0, 0, 6], t3),    # ground
        ]
        target = np.array([0.0, 0.0, 1.2])
        radius, z0 = 9.0, -7.5
        arc = np.linspace(-0.65, 0.65, n_cams)
        Cs = np.stack([radius * np.sin(arc),
                       rng.normal(scale=0.1, size=n_cams),
                       z0 + radius * (1 - np.cos(arc))], -1)
    else:
        raise ValueError(f"unknown synthetic dataset {name}")

    Rs, images = [], []
    for C in Cs:
        R = _look_at(C, target)
        Rs.append(R)
        images.append(render_view(quads, R, C, f, hw, disto=disto))
    return dict(images=images, Rs=np.stack(Rs).astype(np.float64),
                Cs=Cs.astype(np.float64), f=float(f), hw=hw, name=name,
                disto=tuple(disto) if disto is not None else None)


def make_city(n_cams: int = 1000, hw: int = 256, f: Optional[float] = None,
              seed: int = 0, facade_spacing: float = 5.0,
              street_half_width: float = 4.0,
              cull_dist: float = 30.0, loop: bool = False) -> Dict:
    """Large sequential dataset: a camera drives down a textured street
    (facade rows on both sides + ground), ~`n_cams` views with exact GT.

    The scale axis of BASELINE.md (Rome16K stand-in, network-free): view
    count grows with path length, scene size grows linearly, and only
    facades within ``cull_dist`` of the camera are ray-cast per view so
    render cost stays O(1) per image.

    ``loop=True`` drives a CLOSED circular block instead of an open
    corridor, with the last ~35 views re-traversing the start — a
    loop-closure capture (the 1DSfM photo-collection regime is heavily
    looped; an open corridor is pure odometry whose scale drift no amount
    of BA can observe).  Closing the loop requires pairing temporally
    distant views — ``retrieval_pairs`` in the matching stage."""
    rng = np.random.default_rng(seed)
    f = f or 1.3 * hw
    step = 0.22                           # camera advance per view

    if loop:
        # circular street: perimeter ~8% under the path length so the tail
        # re-traverses the head (loop-closure overlap); tiny captures lap
        # the block more than once (an orbit capture), which closes too
        perimeter = max(n_cams * step * 0.92,
                        2.0 * np.pi * (street_half_width + 2.0))
        radius = perimeter / (2.0 * np.pi)
        ctr = np.array([radius, 0.0, 0.0])

        def path(s):
            a = s / radius
            return ctr + radius * np.array([-np.cos(a), 0.0, np.sin(a)])

        def tangent(s):
            a = s / radius
            return np.array([np.sin(a), 0.0, np.cos(a)])

        def lateral(s):                  # outward normal
            a = s / radius
            return np.array([-np.cos(a), 0.0, np.sin(a)])

        quads = []
        n_fac = int(perimeter / facade_spacing) + 1
        for k in range(n_fac):
            s0 = k * facade_spacing
            for side in (-1.0, 1.0):
                tex = _smooth_texture(rng, 96)
                depth_jit = rng.uniform(-0.6, 0.6)
                base = (path(s0)
                        + side * (street_half_width + depth_jit)
                        * lateral(s0) + np.array([0.0, -3.0, 0.0]))
                quads.append(Quad(base,
                                  facade_spacing * 0.92 * tangent(s0),
                                  [0, 6.0, 0], tex))
        ground = _smooth_texture(rng, 256)
        ext = radius + street_half_width + 2.0
        quads.append(Quad([ctr[0] - ext, 3.0, ctr[2] - ext],
                          [2 * ext, 0, 0], [0, 0, 2 * ext], ground))
    else:
        length = n_cams * step + 30.0
        n_fac = int(length / facade_spacing) + 2

        quads = []
        for k in range(n_fac):
            x0 = k * facade_spacing - 10.0
            for side in (-1.0, 1.0):
                tex = _smooth_texture(rng, 96)
                depth_jit = rng.uniform(-0.6, 0.6)
                y_wall = side * (street_half_width + depth_jit)
                # facade quad: spans [x0, x0+spacing] along x, height 6 in
                # y; world frame: street along +x, facades vertical in y,
                # at lateral offset z (castle convention)
                quads.append(Quad([x0, -3.0, y_wall],
                                  [facade_spacing * 0.92, 0, 0],
                                  [0, 6.0, 0], tex))
        ground = _smooth_texture(rng, 256)
        quads.append(Quad([-10.0, 3.0, -street_half_width - 1],
                          [length + 20.0, 0, 0],
                          [0, 0, 2 * street_half_width + 2], ground))
    centers = np.asarray([np.asarray(q.o) + 0.5 * (np.asarray(q.u)
                                                   + np.asarray(q.v))
                          for q in quads])

    Rs, Cs, images = [], [], []
    for i in range(n_cams):
        # lateral weave with a short period: pure forward motion gives
        # window pairs sub-degree parallax (nothing triangulates); a real
        # capture platform always weaves, and the ~18-view period makes
        # neighbours (and i,i+6 pairs) carry 0.5-2.5 units of lateral
        # baseline against 4-10 units of depth
        dy = -0.4 + 0.15 * np.sin(i * 0.23)
        weave = 1.3 * np.sin(i * 0.35)
        sweep = 2.2 * np.sin(i * 0.1)
        if loop:
            s = i * step
            C = path(s) + weave * lateral(s) + np.array([0.0, dy, 0.0])
            target = (path(s + 6.0) + sweep * lateral(s)
                      + np.array([0.0, 0.2, 0.0]))
        else:
            x = 5.0 + i * step
            C = np.array([x, dy, weave])
            # look ahead with alternating lateral sweep so facades on both
            # sides get seen from many angles
            target = np.array([x + 6.0, 0.2, sweep])
        R = _look_at(C, target)
        near = [q for q, c in zip(quads, centers)
                if np.hypot(c[0] - C[0], c[2] - C[2]) < cull_dist
                or q is quads[-1]]
        Rs.append(R)
        Cs.append(C)
        images.append(render_view(near, R, C, f, hw))
    return dict(images=images, Rs=np.stack(Rs).astype(np.float64),
                Cs=np.stack(Cs).astype(np.float64), f=float(f), hw=hw,
                name="city", disto=None)


def window_pairs(n: int, window: int = 8):
    """Sequential pair pruning for ordered captures: each view pairs with
    its next ``window`` successors (the large-N alternative to exhaustive
    O(N^2) pairing)."""
    return [(i, j) for i in range(n)
            for j in range(i + 1, min(i + 1 + window, n))]
