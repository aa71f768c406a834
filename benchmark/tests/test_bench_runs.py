"""Whole runs of ``benchmark/run.py`` on the CPU at a tiny size: the result
line's shape for both step kinds, a configuration, cell and metric added as
files alone, the faults that must turn ``correct`` false, and what a run
and the reference may import."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO, make_root, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell,metric", [("tiny.matches", "matches_s"),
                                         ("tiny.sfm", "sfm_s")])
def test_rehearsal_prints_the_contract_line(tiny_root, cell, metric):
    rc, line, err = run_cell(tiny_root, cell)
    assert rc == 0, err[-3000:]
    assert KEYS <= set(line)
    assert line["correct"] is True, err[-3000:]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", metric}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1
    assert list(line)[-1] == "compared"
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert [t.split()[0] for t in tail] == list(line["compared"])


def test_traced_run_reads_the_per_layer_metrics(tiny_root):
    rc, line, err = run_cell(tiny_root, "tiny.matches", trace=1)
    assert rc == 0, err[-3000:]
    # the CPU has no device trace: only the host-time readers report
    assert set(line["metrics"]) == {"features_s", "matching_s", "filter_s"}
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_config_cell_and_metric_are_files_only(tmp_path):
    """A configuration, a cell and a per-layer metric taken up from new
    files and ``BENCHMARK.json`` entries, no file of the harness edited."""
    root = make_root(str(tmp_path / "root"), cells=("tiny.matches",))
    conf = json.load(open(os.path.join(root, "benchmark/configs/tiny.json")))
    conf.update(name="tiny2", scene="castle", views=3)
    with open(os.path.join(root, "benchmark/configs/tiny2.json"), "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(root, "benchmark/metrics/keypoints_mean.py"),
              "w") as fh:
        fh.write("def read(run):\n"
                 "    p = run['profiled']\n"
                 "    k = p['result']['keypoints']\n"
                 "    return sum(k) / len(k)\n")
    bpath = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bpath))
    bench["configs"].append({"name": "tiny2", "source": "test",
                             "file": "benchmark/configs/tiny2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny2.matches", "config": "tiny2",
                               "traffic": "matches", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "matches_s" == m["name"]:
            m["workloads"].append("tiny2.matches")
    bench["per_layer"].append({"name": "keypoints_mean", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "features", "moves": "matches_s",
                               "workloads": ["tiny2.matches"]})
    json.dump(bench, open(bpath, "w"))
    rc, line, err = run_cell(root, "tiny2.matches", trace=1)
    assert rc == 0, err[-3000:]
    assert set(line["metrics"]) == {"keypoints_mean"}
    assert line["metrics"]["keypoints_mean"]["value"] > 0


FAULTS = {
    # the filter hands its input back unchanged
    "filter_unchanged": ("tiny.matches", """
import regard3d_tpu_torch.pipeline.compute_matches as cm
def _gf(kps, putative, *a, **k):
    p = dict(putative)
    return cm.FilterResult(p, p, p, dict(cm._match_stats(p, p, p, p),
                                         filter_blocks=0))
cm.geometric_filter = _gf
"""),
    # half of the pairs left out of matching
    "half_the_pairs": ("tiny.matches", """
import regard3d_tpu_torch.pipeline.compute_matches as cm
_orig = cm.match_all_pairs
def _half(*a, **k):
    out = _orig(*a, **k)
    return {p: m for n, (p, m) in enumerate(sorted(out.items())) if n % 2}
cm.match_all_pairs = _half
"""),
    # one kept match's index altered where the matcher produces it
    "answer_altered": ("tiny.matches", """
from regard3d_tpu_torch.kernels import match as mm
_orig = mm.match_pair_block
def _alter(desc, mask, pairs, *a, **k):
    idx, d1, ok = _orig(desc, mask, pairs, *a, **k)
    rows = ok[0].nonzero()
    if len(rows):
        r = int(rows[0])
        idx[0, r] = (idx[0, r] + 1) % int(mask[int(pairs[0][1])].sum())
    return idx, d1, ok
mm.match_pair_block = _alter
"""),
    # the features stage returns without doing its work
    "features_unchanged": ("tiny.matches", """
import regard3d_tpu_torch.pipeline.compute_matches as cm
cm.feat_mod.extract_features = lambda images, *a, **k: [0] * len(images)
"""),
    # bundle adjustment hands its input state back unchanged
    "ba_unchanged": ("tiny.sfm", """
from regard3d_tpu_torch.ba import lm
_orig = lm.bundle_adjust
def _ba(state, *a, **k):
    _, stats = _orig(state, *a, **k)
    return state, stats
lm.bundle_adjust = _ba
"""),
    # half of the observations left out of bundle adjustment
    "ba_half_the_observations": ("tiny.sfm", """
import torch
from regard3d_tpu_torch.ba import lm
_orig = lm.bundle_adjust
def _ba(state, obs, *a, **k):
    w = obs.weight.clone()
    w[1::2] = 0
    return _orig(state, obs._replace(weight=w), *a, **k)
lm.bundle_adjust = _ba
"""),
    # one camera's centre altered where the engine produces it
    "pose_altered": ("tiny.sfm", """
from regard3d_tpu_torch.pipeline import triangulation_step as ts
_orig = ts.incremental.run_incremental
def _inc(*a, **k):
    res = _orig(*a, **k)
    C = res.C.clone()
    C[1] += 0.5
    return res._replace(C=C)
ts.incremental.run_incremental = _inc
"""),
}


# every keypoint written with x and y swapped, by the program and by the
# frozen copy of its detector alike: the copy agrees, the filter finds the
# swapped geometry as consistent as the true one, and only the scene's
# exact geometry sees it
SHARED = """
import numpy as np
import regard3d_tpu_torch.pipeline.compute_matches as cm
from benchmark.reference import matches_ref
_save = cm.feat_mod.save_features
cm.feat_mod.save_features = lambda out, i, xy, *a: _save(out, i, xy[:, ::-1],
                                                         *a)
_ref = matches_ref.features
def _swapped(*a, **k):
    f = _ref(*a, **k)
    return dict(f, xy=np.ascontiguousarray(f["xy"][:, ::-1]))
matches_ref.features = _swapped
"""


def test_a_fault_the_frozen_copy_shares_fails_the_exact_geometry(tiny_root):
    rc, line, err = run_cell(tiny_root, "tiny.matches", fault=SHARED)
    assert rc == 0, err[-3000:]
    got = line["compared"]
    for name in ("feat_miss", "match_gap", "filter_diff"):
        assert got[name]["value"] <= got[name]["limit"], (name, got)
    assert got["xfer_out"]["value"] > got["xfer_out"]["limit"]
    assert line["correct"] is False


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_root, fault):
    cell, code = FAULTS[fault]
    rc, line, err = run_cell(tiny_root, cell, fault=code)
    # a fault the warm-up meets ends the run with no result: refused too
    assert (rc != 0 and line is None) or line["correct"] is False, (
        rc, line, err[-2000:])


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_port(
        tiny_root):
    rc, line, err = run_cell(tiny_root, "tiny.matches", fault="""
import atexit, sys
atexit.register(lambda: print('TOP', sorted({m.split('.')[0]
                                for m in sys.modules}), file=sys.stderr))
""")
    assert rc == 0, err[-3000:]
    top = eval([ln for ln in err.splitlines() if ln.startswith("TOP")][0][4:])
    assert not set(top) & {"jax", "jaxlib", "flax", "regard3d_tpu"}
    assert "regard3d_tpu_torch" in top
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import benchmark.reference.matches_ref, "
            "benchmark.reference.sfm_ref, benchmark.reference.tf32\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    top = eval(out)
    assert not set(top) & {"jax", "jaxlib", "flax", "regard3d_tpu",
                           "regard3d_tpu_torch"}


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    root = make_root(str(tmp_path / "root"))
    for name in ("regard3d_tpu_torch", "native"):
        os.unlink(os.path.join(root, name))
    rc, line, err = run_cell(root, "tiny.matches")
    assert rc != 0 and line is None


@pytest.mark.card
def test_one_short_cell_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "synthetic-11.matches", "--seed", str(2 ** 31 + 11), "--seconds",
         "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, p.stderr[-3000:]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["matches_s"]["value"] > 0
