"""Nineteen-view scene: two facades meeting at a corner and the ground,
seen from an arc of 1 rad around the corner."""

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
        (a(0, -3, 0), a(-9, 0, 3), a(0, 6, 0), tex(6, 9.5)),     # left facade
        (a(0, -3, 0), a(9, 0, 4.5), a(0, 6, 0), tex(6, 10)),     # right facade
        (a(-9, 3, -1), a(18, 0, 0), a(0, 0, 7), tex(7, 18)),     # ground
    ]
    radius, z0 = 12.0, -10.0
    arc = np.linspace(-0.5, 0.5, views)
    Cs = np.stack([radius * np.sin(arc),
                   rng.normal(scale=0.15, size=views) - 0.5,
                   z0 + radius * (1 - np.cos(arc))], -1)
    return rd.render_arc(quads, Cs, a(0.0, 0.0, 1.5), focal_factor * size[1],
                         size, device)
