"""Port parity: the tracks builder (``sfm/tracks.py``) against the JAX
package, which labels components with the native union-find where it
builds (``regard3d_tpu.native``) and with min-label propagation otherwise.

The port relabels min-label components densely with ``np.unique``, which
orders them by first appearance like the native library: the ``TrackTable``
must be identical, array for array, on random match graphs with
inconsistent (two features of one view) and short components, and on the
geometric matches of a real compute-matches run. ``covisibility_pairs``,
``shared_track_count`` and ``tracks_in_views`` identical too.
"""

import numpy as np
import pytest
import torch

from regard3d_tpu import native
from regard3d_tpu.sfm import tracks as jtr
from regard3d_tpu_torch.ingest import synth as tsynth
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.sfm import tracks as ttr

torch.set_num_threads(min(2, torch.get_num_threads()))


def random_matches(rng, n_views=7, n_feat=60, density=0.5, noise=0.05):
    """Pairwise matches of features of shared points; a fraction of the
    matches rewired at random makes inconsistent tracks; pairs keep
    between 0 and n_feat matches."""
    owner = [rng.permutation(n_feat) for _ in range(n_views)]
    matches = {}
    for i in range(n_views):
        for j in range(i + 1, n_views):
            if rng.uniform() > density:
                continue
            pts = rng.choice(n_feat, int(rng.integers(0, n_feat)),
                             replace=False)
            inv_i = np.argsort(owner[i])
            inv_j = np.argsort(owner[j])
            m = np.stack([inv_i[pts], inv_j[pts]], -1).astype(np.int64)
            bad = rng.uniform(size=len(m)) < noise
            m[bad, 1] = rng.integers(0, n_feat, int(bad.sum()))
            matches[(i, j)] = m
    return matches


def assert_same_table(a, b):
    assert a.num_tracks == b.num_tracks
    for f in ("track_id", "view_id", "feature_id"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f


def test_reference_labels_with_the_native_library_here():
    """The reference run in these tests takes its native union-find (the
    port is held against that path, not only against the fallback)."""
    lib = native.union_find(np.asarray([[0, 1]]), 2)
    if lib is None:
        pytest.skip("no C++ compiler: the reference falls back to the "
                    "port's own construction")
    np.testing.assert_array_equal(lib, [0, 0])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("min_length", [2, 3])
def test_build_tracks_identical_on_random_graphs(seed, min_length):
    rng = np.random.default_rng(seed)
    matches = random_matches(rng, noise=0.004 * (seed + 1))
    matches[(0, 1)] = np.zeros((0, 2), np.int64)       # an empty pair
    ref = jtr.build_tracks(matches, min_length)
    port = ttr.build_tracks(matches, min_length)
    assert_same_table(ref, port)
    assert ref.num_tracks > 0
    np.testing.assert_array_equal(port.lengths(), ref.lengths())
    V = 7
    for a, b in zip(jtr.covisibility_pairs(ref, V, 3),
                    ttr.covisibility_pairs(port, V, 3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttr.shared_track_count(port, V),
                                  jtr.shared_track_count(ref, V))
    np.testing.assert_array_equal(ttr.tracks_in_views(port, [1, 2]),
                                  jtr.tracks_in_views(ref, [1, 2]))


def test_build_tracks_edge_cases():
    for m in ({}, {(0, 1): np.zeros((0, 2), np.int64)},
              {(0, 1): np.array([[0, 5], [0, 6]])},          # inconsistent
              {(0, 1): np.array([[0, 5], [1, 6]]),
               (1, 2): np.array([[5, 9]]), (0, 2): np.array([[3, 2]])}):
        assert_same_table(jtr.build_tracks(m), ttr.build_tracks(m))
    empty = ttr.build_tracks({})
    for a, b in zip(ttr.covisibility_pairs(empty, 3),
                    jtr.covisibility_pairs(jtr.build_tracks({}), 3)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def stage_matches(tmp_path_factory):
    """Geometric matches of the port's compute-matches stage on 4 synthetic
    fountain views at 256 px (the stage fixture's scene)."""
    out = str(tmp_path_factory.mktemp("matches"))
    ds = tsynth.make_dataset("fountain", n_cams=11, hw=256, seed=0)
    tcm.run_compute_matches(ds["images"][:4], out, threshold=0.0007,
                            cfg=tcm.MatchConfig(ransac_iters=64),
                            focals=np.full(4, ds["f"] * 1.03),
                            max_keypoints=352, device="cpu")
    return {k: tcm.load_matches_txt(f"{out}/matches.{k}.txt")
            for k in ("putative", "f")}


@pytest.mark.parametrize("kind", ["putative", "f"])
def test_build_tracks_identical_on_stage_matches(stage_matches, kind):
    matches = stage_matches[kind]
    assert len(matches) >= 3
    ref = jtr.build_tracks(matches)
    port = ttr.build_tracks(matches)
    assert_same_table(ref, port)
    for a, b in zip(jtr.covisibility_pairs(ref, 4, 1),
                    ttr.covisibility_pairs(port, 4, 1)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttr.shared_track_count(port, 4),
                                  jtr.shared_track_count(ref, 4))
