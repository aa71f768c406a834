"""How far two rankings of one image's keypoints agree.

The measure that holds the port's corner detectors (GFTT, ORB, BRISK) to
the reference on the CPU (``tests/test_torch_corners.py``,
``tests/test_torch_features.py``) and the card to the CPU
(``chip_smoke.py``'s phase (m)). A keypoint counts where the other ranking
holds it within ``tol_px`` with the same size: at the same rank, or inside
its tie group, the consecutive ranks whose scores lie within a relative
tolerance of each other (the f32 rounding of a resize may swap them).
"""

from __future__ import annotations

import numpy as np


def rank_agreement(a, b, tol_px=1e-3, tie_rtol=2e-6, tie_atol=1e-7):
    """(in_rank, in_tie_group): the fractions of ``a``'s live keypoints that
    ``b`` holds at the same rank, and inside their tie group of ``a``'s
    ranking (consecutive ranks whose scores lie within the tolerance: the
    f32 rounding of a resize may swap them), within ``tol_px`` and with
    the same size. a, b: (xy, size, score, mask) numpy rows of one image,
    live rows first."""
    (xa, sa, ca, ma), (xb, sb, _, mb) = a, b
    n = int(ma.sum())
    if int(mb.sum()) != n:
        return 0.0, 0.0
    close = lambda i, k: (np.abs(xa[i] - xb[k]).max() <= tol_px
                          and abs(sa[i] - sb[k]) <= 1e-4 * sa[i])
    in_rank = sum(close(i, i) for i in range(n)) / max(n, 1)
    held, lo = 0, 0
    while lo < n:
        hi = lo + 1
        while hi < n and abs(ca[hi] - ca[hi - 1]) <= tie_atol + tie_rtol * abs(
                ca[hi - 1]):
            hi += 1
        free = set(range(lo, hi))
        for i in range(lo, hi):
            hit = next((k for k in free if close(i, k)), None)
            if hit is not None:
                free.discard(hit)
                held += 1
        lo = hi
    return in_rank, held / max(n, 1)
