"""Keypoint / match previews and SVG exports (inspection subsystem).

Equivalent of ``PreviewGeneratorThread`` (src/threads/PreviewGeneratorThread.
cpp: keypoint drawing :296, match-line drawing :340, track filtering
:344-366) and ``OpenMVGHelper``'s keypoint/match SVG exporters (:77-271) —
the artifacts the reference's MatchingResults dialog shows.

Host-side rendering with PIL; "rich" keypoints draw scaled circles with an
orientation spoke (cv::drawKeypoints DRAW_RICH_KEYPOINTS parity).

Copy of ``regard3d_tpu/pipeline/preview.py`` (host PIL; the port imports
nothing from the reference package): the PNGs and SVGs are identical.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw


def _to_rgb_image(img: np.ndarray) -> Image.Image:
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    return Image.fromarray(arr)


def draw_keypoints(img: np.ndarray, xy: np.ndarray,
                   sizes: Optional[np.ndarray] = None,
                   angles: Optional[np.ndarray] = None,
                   rich: bool = True,
                   color: Tuple[int, int, int] = (0, 255, 0)) -> Image.Image:
    """Keypoint preview (rich = circles scaled by size + orientation spoke,
    else small dots)."""
    im = _to_rgb_image(img)
    d = ImageDraw.Draw(im)
    for k in range(len(xy)):
        x, y = float(xy[k, 0]), float(xy[k, 1])
        if rich and sizes is not None:
            r = max(float(sizes[k]) / 2.0, 1.5)
            d.ellipse([x - r, y - r, x + r, y + r], outline=color)
            if angles is not None:
                a = float(angles[k])
                d.line([x, y, x + r * math.cos(a), y + r * math.sin(a)],
                       fill=color)
        else:
            d.ellipse([x - 1.5, y - 1.5, x + 1.5, y + 1.5], outline=color)
    return im


def draw_matches(img1: np.ndarray, xy1: np.ndarray,
                 img2: np.ndarray, xy2: np.ndarray,
                 matches: np.ndarray,
                 color: Tuple[int, int, int] = (0, 200, 255),
                 max_draw: int = 500) -> Image.Image:
    """Side-by-side match preview with connecting lines."""
    im1 = _to_rgb_image(img1)
    im2 = _to_rgb_image(img2)
    h = max(im1.height, im2.height)
    canvas = Image.new("RGB", (im1.width + im2.width, h))
    canvas.paste(im1, (0, 0))
    canvas.paste(im2, (im1.width, 0))
    d = ImageDraw.Draw(canvas)
    off = im1.width
    for a, b in matches[:max_draw]:
        x1, y1 = float(xy1[a, 0]), float(xy1[a, 1])
        x2, y2 = float(xy2[b, 0]) + off, float(xy2[b, 1])
        d.line([x1, y1, x2, y2], fill=color)
        d.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=(0, 255, 0))
        d.ellipse([x2 - 2, y2 - 2, x2 + 2, y2 + 2], outline=(0, 255, 0))
    return canvas


def filter_matches_to_tracks(matches: np.ndarray, i: int, j: int,
                             table) -> np.ndarray:
    """Keep only matches that belong to multi-view tracks (the dialog's
    'only show matches in tracks' toggle; TracksBuilder filter parity)."""
    pairs_in_tracks = set()
    by_track: Dict[int, Dict[int, int]] = {}
    for o in range(len(table.track_id)):
        by_track.setdefault(int(table.track_id[o]), {})[
            int(table.view_id[o])] = int(table.feature_id[o])
    for t, views in by_track.items():
        if i in views and j in views and len(views) > 2:
            pairs_in_tracks.add((views[i], views[j]))
    keep = [k for k in range(len(matches))
            if (int(matches[k, 0]), int(matches[k, 1])) in pairs_in_tracks]
    return matches[keep]


def keypoints_svg(path: str, image_name: str, width: int, height: int,
                  xy: np.ndarray, sizes: Optional[np.ndarray] = None):
    """SVG overlay of keypoints (exportKeypointsToSVG parity)."""
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}">',
             f'<image href="{image_name}" width="{width}" height="{height}"/>']
    for k in range(len(xy)):
        r = max(float(sizes[k]) / 2.0, 1.5) if sizes is not None else 2.0
        parts.append(f'<circle cx="{float(xy[k,0]):.1f}" '
                     f'cy="{float(xy[k,1]):.1f}" r="{r:.1f}" '
                     'fill="none" stroke="yellow" stroke-width="1"/>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))


def matches_svg(path: str, name1: str, name2: str, w1: int, h1: int,
                w2: int, h2: int, xy1: np.ndarray, xy2: np.ndarray,
                matches: np.ndarray, max_draw: int = 500):
    """Side-by-side match SVG (exportMatchesToSVG parity)."""
    W = w1 + w2
    H = max(h1, h2)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
             f'height="{H}">',
             f'<image href="{name1}" width="{w1}" height="{h1}"/>',
             f'<image href="{name2}" x="{w1}" width="{w2}" height="{h2}"/>']
    for a, b in matches[:max_draw]:
        x1, y1 = float(xy1[a, 0]), float(xy1[a, 1])
        x2, y2 = float(xy2[b, 0]) + w1, float(xy2[b, 1])
        parts.append(f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" '
                     f'y2="{y2:.1f}" stroke="lime" stroke-width="0.5"/>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
