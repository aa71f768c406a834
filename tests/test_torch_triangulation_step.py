"""Port parity: the triangulation stage (``pipeline/triangulation_step.py``)
against the JAX package end to end, on the CPU: both packages'
``run_triangulation`` on the same match files (4 synthetic fountain views
at 256 px), the port with the reference's draws (``Replay`` of
``tests/test_torch_incremental.py``). The port must pose the reference's
cameras, triangulate its track count within 2%, and write artifacts that
the reference's readers load.
"""

import json
import os

import numpy as np
import pytest
import torch

from regard3d_tpu.core import metrics as jmet
from regard3d_tpu.core import sfm_data as jsd
from regard3d_tpu.core.types import PINHOLE
from regard3d_tpu.export import ply as jply
from regard3d_tpu.pipeline import triangulation_step as jts
from regard3d_tpu_torch.ingest import synth as tsynth
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline import triangulation_step as tts
from tests.test_torch_incremental import Replay

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """Matches of 4 synthetic fountain views at 256 px (the compute-matches
    stage fixture's scene, 352 keypoints, 64 iterations), then both
    packages' run_triangulation on them, the port with the reference's
    draws."""
    base = tmp_path_factory.mktemp("tri")
    ds = tsynth.make_dataset("fountain", n_cams=11, hw=256, seed=0)
    images = ds["images"][:4]
    f = ds["f"] * 1.03
    matches = str(base / "matches")
    tcm.run_compute_matches(images, matches, threshold=0.0007,
                            cfg=tcm.MatchConfig(ransac_iters=64),
                            focals=np.full(4, f), max_keypoints=352,
                            device="cpu")
    intr = np.zeros((1, 9), np.float32)
    intr[0, :3] = [f, 128.0, 128.0]
    names = [f"view{i}.png" for i in range(4)]
    kw = dict(intr_id=np.zeros(4, np.int32), intr=intr,
              models=np.asarray([PINHOLE], np.int32), image_names=names)
    ref, port = str(base / "ref"), str(base / "port")
    sj = jts.run_triangulation(matches, ref, images, **kw)
    st = tts.run_triangulation(matches, port, images, device="cpu",
                               sample_provider=Replay(), **kw)
    return dict(ref=ref, port=port, sj=sj, st=st, ds=ds)


def test_stage_matches_reference_and_artifacts_cross(stage):
    """The reference's camera count and track count (within 2%); every
    artifact is written and the reference's readers load the port's."""
    sj, st = stage["sj"], stage["st"]
    assert st["num_cameras"] == sj["num_cameras"] >= 3
    assert abs(st["num_tracks"] - sj["num_tracks"]) <= 0.02 * sj["num_tracks"]
    assert st["rms_px"] == pytest.approx(sj["rms_px"], rel=0.05)
    port = stage["port"]
    names = ("scene.npz", "sfm_data.json", "cloud_and_poses.ply",
             "FinalColorized.ply", "Reconstruction_Report.html")
    assert all(os.path.exists(os.path.join(port, n)) for n in names)
    scene = jsd.load_npz(os.path.join(port, "scene.npz"))
    assert int(np.asarray(scene.poses.mask).sum()) == st["num_cameras"]
    assert int(np.asarray(scene.landmarks.mask).sum()) == st["num_tracks"]
    ref_scene = jsd.load_npz(os.path.join(stage["ref"], "scene.npz"))
    for grp in ("views", "intrinsics", "poses", "landmarks", "observations"):
        a, b = vars(getattr(scene, grp)), vars(getattr(ref_scene, grp))
        assert {k: (v.shape, v.dtype) for k, v in a.items()} == \
            {k: (v.shape, v.dtype) for k, v in b.items()}, grp
    with open(os.path.join(port, "sfm_data.json")) as f:
        js = json.load(f)
    assert len(js["extrinsics"]) == st["num_cameras"]
    assert len(js["structure"]) == st["num_tracks"]
    assert js["views"][0]["value"]["filename"] == "view0.png"
    cloud = jply.read_ply(os.path.join(port, "cloud_and_poses.ply"))
    final = jply.read_ply(os.path.join(port, "FinalColorized.ply"))
    assert len(final.xyz) == st["num_tracks"]
    assert len(cloud.xyz) == st["num_tracks"] + st["num_cameras"]
    pm = np.asarray(scene.poses.mask)
    ate = jmet.ate_rmse(np.asarray(scene.poses.C)[pm],
                        stage["ds"]["Cs"][:4][pm])
    assert ate < 0.08, ate
    with open(os.path.join(port, "Reconstruction_Report.html")) as f:
        html = f.read()
    assert "Reconstruction report" in html and "<svg" in html
