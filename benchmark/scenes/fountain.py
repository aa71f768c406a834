"""Eleven-view scene: a back wall, a protruding slab and the ground, seen
from an arc of 1.3 rad (strong parallax, partial occlusion)."""

from __future__ import annotations

import numpy as np

from benchmark.scenes import render as rd


def make(seed: int, views: int, size, focal_factor: float, device):
    """``size`` = (width, height); the focal is ``focal_factor`` heights."""
    rng = rd.rng_of(seed)
    tex = lambda hu, wu: rd.detail_texture(rng, rd.texels(size, hu),
                                           rd.texels(size, wu))
    a = lambda *x: np.asarray(x, np.float64)
    quads = [
        (a(-8, -3, 2), a(16, 0, 0), a(0, 6, 0), tex(6, 16)),     # back wall
        (a(-1.2, -1.2, 0.6), a(2.4, 0, 0), a(0, 2.4, 0.9),
         tex(2.6, 2.4)),                                       # slab
        (a(-8, 3, -4), a(16, 0, 0), a(0, 0, 6), tex(6, 16)),     # ground
    ]
    radius, z0 = 9.0, -7.5
    arc = np.linspace(-0.65, 0.65, views)
    Cs = np.stack([radius * np.sin(arc),
                   rng.normal(scale=0.1, size=views),
                   z0 + radius * (1 - np.cos(arc))], -1)
    return rd.render_arc(quads, Cs, a(0.0, 0.0, 1.2), focal_factor * size[1],
                         size, device)
