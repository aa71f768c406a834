"""Port parity: the device-list (mesh) branches of the compute-matches stage
(``pipeline/features.extract_features``, ``pipeline/compute_matches.
match_all_pairs`` and ``geometric_filter``) over ``[cpu] * 2``, on the CPU.

The reference's mesh run is its ``run_compute_matches`` on this session's
8 virtual devices (its drivers build a mesh from every local device), on 4
fountain views at 256 px, 352 keypoints, 64 RANSAC iterations (the scene of
``tests/test_torch_compute_matches.py``). Checked:

* features: the mesh run writes the same bytes as the run without one;
  against the reference's, counts within 1% and >= 99% of its keypoints
  within 0.01 px of one of the port's;
* matching on the reference's feature files: the mesh run's putative
  matches equal the run's without one and the reference's mesh run's;
* filtering the reference's putative matches with the reference's draws:
  the mesh run, and the two halves of a 2-way block split
  (``block_shard``), give exactly the run without a mesh; against the
  reference's mesh run the F- and H-validated pairs are the same, and
  every pair's inliers of F, E and H overlap the reference's with a
  Jaccard index >= 0.9 (``tests/test_torch_compute_matches.py`` names and
  checks the few borderline differences).
"""

import os

import numpy as np
import pytest
import torch

from regard3d_tpu.pipeline import compute_matches as jcm
from regard3d_tpu.pipeline import features as jfeat
from regard3d_tpu_torch.dist import mesh as tmesh
from regard3d_tpu_torch.ingest import synth
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline import features as tfeat
from tests.test_torch_compute_matches import (HW, ITERS, MAX_KP, N_VIEWS,
                                              reference_provider)

torch.set_num_threads(min(2, torch.get_num_threads()))

MESH = tmesh.make_mesh("pairs", ["cpu"] * 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("sharded")
    ds = synth.make_dataset("fountain", n_cams=11, hw=HW, seed=0)
    images = ds["images"][:N_VIEWS]
    focals = np.full(N_VIEWS, ds["f"] * 1.03)
    ref = str(base / "ref")
    jcm.run_compute_matches(images, ref,
                            cfg=jcm.MatchConfig(ransac_iters=ITERS),
                            focals=focals, max_keypoints=MAX_KP)
    feats = {}
    for tag, mesh in (("one", None), ("mesh", MESH)):
        feats[tag] = str(base / tag)
        tfeat.extract_features(images, feats[tag], max_keypoints=MAX_KP,
                               device="cpu", mesh=mesh)
    kps, descs = tfeat.load_all_padded(ref, N_VIEWS, pad_to=256,
                                       padded_dim=tcm.MATCH_DIM,
                                       device="cpu")
    return dict(ref=ref, feats=feats, images=images, focals=focals,
                kps=kps, descs=descs)


def test_features_on_a_mesh(runs):
    one, mesh, ref = runs["feats"]["one"], runs["feats"]["mesh"], runs["ref"]
    for i in range(N_VIEWS):
        for path in (tfeat.feat_path, tfeat.desc_path):
            with open(path(one, i), "rb") as a, open(path(mesh, i),
                                                     "rb") as b:
                assert a.read() == b.read(), path(mesh, i)
        xy_r = jfeat.load_features(ref, i)[0]
        xy_p = tfeat.load_features(mesh, i)[0]
        assert abs(len(xy_p) - len(xy_r)) <= 0.01 * len(xy_r)
        dist = np.linalg.norm(xy_r[:, None] - xy_p[None], axis=-1).min(1)
        assert (dist <= 0.01).mean() >= 0.99


def test_matching_on_a_mesh(runs):
    cfg = tcm.MatchConfig()
    one = tcm.match_all_pairs(runs["kps"], runs["descs"], cfg)
    got = tcm.match_all_pairs(runs["kps"], runs["descs"], cfg, mesh=MESH)
    want = jcm.load_matches_txt(os.path.join(runs["ref"],
                                             "matches.putative.txt"))
    assert got.keys() == one.keys() == want.keys()
    for pr in want:
        np.testing.assert_array_equal(got[pr], one[pr])
        np.testing.assert_array_equal(got[pr], want[pr])


def _jaccard(m1, m2):
    a, b = set(map(tuple, m1)), set(map(tuple, m2))
    return len(a & b) / max(len(a | b), 1)


def test_filter_on_a_mesh_and_in_shards(runs):
    put = tcm.load_matches_txt(os.path.join(runs["ref"],
                                            "matches.putative.txt"))
    sizes = np.asarray([[im.shape[1], im.shape[0]] for im in runs["images"]])
    args = (runs["kps"], put, sizes, runs["focals"],
            tcm.MatchConfig(ransac_iters=ITERS))
    kw = dict(device="cpu", sample_provider=reference_provider(0))
    one = tcm.geometric_filter(*args, **kw)
    got = tcm.geometric_filter(*args, mesh=MESH, **kw)
    halves = [tcm.geometric_filter(*args, block_shard=(p, 2), **kw)
              for p in (0, 1)]
    assert sum(h.stats["filter_blocks"] for h in halves) == \
        one.stats["filter_blocks"]
    for kind in ("f", "e", "h"):
        want = getattr(one, kind)
        joined = {**getattr(halves[0], kind), **getattr(halves[1], kind)}
        for res in (getattr(got, kind), joined):
            assert res.keys() == want.keys()
            for pr in want:
                np.testing.assert_array_equal(res[pr], want[pr])
        ref = jcm.load_matches_txt(os.path.join(runs["ref"],
                                                f"matches.{kind}.txt"))
        if kind != "e":
            assert set(ref) == set(want), kind
        for pr in set(ref) & set(want):
            assert _jaccard(ref[pr], want[pr]) >= 0.9, (kind, pr)
    assert len(one.f) >= 3
