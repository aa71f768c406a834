"""Port parity: keypoint / match previews and SVG exports
(``pipeline/preview.py``) against the JAX package, on the CPU: PNG pixels
equal, SVGs byte-equal, the track filter's matches equal.
"""

import filecmp

import numpy as np
import pytest

from regard3d_tpu.pipeline import preview as jprev
from regard3d_tpu.sfm import tracks as jtracks
from regard3d_tpu_torch.pipeline import preview as tprev
from regard3d_tpu_torch.sfm import tracks as ttracks


@pytest.fixture()
def inputs():
    rng = np.random.default_rng(0)
    img1 = rng.uniform(size=(60, 80)).astype(np.float32)
    img2 = (rng.uniform(size=(50, 70, 3)) * 255).astype(np.uint8)
    xy1 = rng.uniform(0, 60, size=(40, 2))
    xy2 = rng.uniform(0, 50, size=(30, 2))
    m = np.stack([rng.permutation(40)[:25], rng.permutation(30)[:25]], 1)
    return dict(img1=img1, img2=img2, xy1=xy1, xy2=xy2,
                sizes=rng.uniform(1, 9, 40), angles=rng.uniform(-3, 3, 40),
                matches=m)


def test_previews_match_reference(inputs, tmp_path):
    d = inputs
    for rich, sizes, angles in ((True, d["sizes"], d["angles"]),
                                (True, d["sizes"], None),
                                (False, None, None)):
        a = tprev.draw_keypoints(d["img1"], d["xy1"], sizes, angles,
                                 rich=rich)
        b = jprev.draw_keypoints(d["img1"], d["xy1"], sizes, angles,
                                 rich=rich)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for max_draw in (500, 10):
        a = tprev.draw_matches(d["img1"], d["xy1"], d["img2"], d["xy2"],
                               d["matches"], max_draw=max_draw)
        b = jprev.draw_matches(d["img1"], d["xy1"], d["img2"], d["xy2"],
                               d["matches"], max_draw=max_draw)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.size == (150, 60)
    for mod, tag in ((tprev, "port"), (jprev, "ref")):
        mod.keypoints_svg(str(tmp_path / f"k_{tag}.svg"), "a.png", 80, 60,
                          d["xy1"], d["sizes"])
        mod.keypoints_svg(str(tmp_path / f"k0_{tag}.svg"), "a.png", 80, 60,
                          d["xy1"])
        mod.matches_svg(str(tmp_path / f"m_{tag}.svg"), "a.png", "b.png", 80,
                        60, 70, 50, d["xy1"], d["xy2"], d["matches"])
    for name in ("k", "k0", "m"):
        assert filecmp.cmp(tmp_path / f"{name}_port.svg",
                           tmp_path / f"{name}_ref.svg", shallow=False)


def test_filter_matches_to_tracks_matches_reference():
    """Only matches on tracks of three or more views survive, in both."""
    m01 = np.array([[0, 0], [1, 1], [2, 2], [3, 3]])
    matches = {(0, 1): m01, (1, 2): np.array([[0, 5], [1, 6]]),
               (0, 2): np.array([[0, 5]])}
    tj = jtracks.build_tracks(matches)
    tt = ttracks.build_tracks(matches)
    a = tprev.filter_matches_to_tracks(m01, 0, 1, tt)
    b = jprev.filter_matches_to_tracks(m01, 0, 1, tj)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, [[0, 0], [1, 1]])
