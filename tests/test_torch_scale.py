"""Port parity and runs of the scale axis, on the CPU.

* ``ingest/synth.make_city`` and ``window_pairs`` against the JAX
  package's (``tests/test_ingest.py``'s sizes: 12 views at 64 px), as an
  open corridor and as a closed loop: images, rotations and centres equal
  to the last bit (both are numpy from one ``default_rng``), pair lists
  equal.
* ``tools/scale.run_scale(device="cpu")`` on the smallest corridor that
  meets the bench's gates here (16 views at 256 px, 512 keypoints, 128
  RANSAC iterations, window 8, BA every 5 views; 10 and 12 views miss the
  ATE gate): every gate holds, and its JSON keys hold every key of
  ``bench_scale.py``'s record (``SCALE200.json``).
* ``tools/profile_sfm`` poses every view of a small corridor (16 views,
  1500 points, each view seeing points within 6 units along the 60-unit
  corridor) with an ATE under 0.5% of the corridor.
"""

import json
import os

import numpy as np
import pytest
import torch

from regard3d_tpu.ingest import synth as jsynth
from regard3d_tpu_torch.ingest import synth as tsynth
from regard3d_tpu_torch.tools import profile_sfm, scale

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("loop", [False, True], ids=["corridor", "loop"])
def test_make_city_equals_reference(loop):
    a = jsynth.make_city(n_cams=12, hw=64, loop=loop)
    b = tsynth.make_city(n_cams=12, hw=64, loop=loop)
    assert a.keys() == b.keys()
    for k in ("Rs", "Cs"):
        np.testing.assert_array_equal(a[k], b[k])
    assert len(a["images"]) == len(b["images"]) == 12
    for x, y in zip(a["images"], b["images"]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a["f"], a["hw"], a["name"], a["disto"]) == \
        (b["f"], b["hw"], b["name"], b["disto"])


@pytest.mark.parametrize("n,window", [(12, 3), (12, 8), (200, 8), (5, 1)])
def test_window_pairs_equal_reference(n, window):
    assert tsynth.window_pairs(n, window) == jsynth.window_pairs(n, window)


def test_scale_run_meets_the_gates_on_a_small_corridor(capsys):
    r = scale.run_scale(views=16, hw=256, max_keypoints=512, window=8,
                        loop=False, retrieval_k=0, ransac_iters=128,
                        ba_every=5, ba_iterations=12, final_ba_iterations=20,
                        device="cpu")
    assert r["ok"] and all(r["gates"].values()), r
    assert r["num_cameras"] >= 0.95 * 16
    assert r["ate"] <= 0.005 * r["trajectory_extent"]
    assert r["pairs"] == len(tsynth.window_pairs(16, 8))
    assert r["device"] == "cpu" and r["matches_peak_device_gb"] is None
    assert r["filter_blocks"] >= 1
    with open(os.path.join(ROOT, "SCALE200.json")) as f:
        bench = json.load(f)
    assert set(bench) <= set(r), set(bench) - set(r)
    assert set(r["sfm_profile"]) == set(bench["sfm_profile"])
    assert "rendered 16 views" in capsys.readouterr().out


def test_profile_sfm_runs_the_engine_on_a_corridor():
    r = profile_sfm.run_profile(views=16, pts=1500, window=6.0, ba_every=4,
                                ba_iterations=4, device="cpu")
    assert r["posed"] == 16 and r["observations"] > 0
    assert r["ate"] < 0.005 * 60.0
    assert np.isfinite(r["rms_px"]) and r["rms_px"] < 2.0
    assert r["profile"]["ba_rounds"] >= 1
    assert r["device"] == "cpu"
