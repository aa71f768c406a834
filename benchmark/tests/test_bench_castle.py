"""A tiny castle cell on the CPU: the ``synthetic-19`` configuration's
scene (two facades meeting at a corner and the ground) at 12 views of
384 x 256, so 66 exhaustive pairs in two matcher blocks of 64 and a
growth in several resection rounds. Both step kinds run through
``benchmark/run.py``'s ``main(device="cpu")`` as a benchmark run does,
with ``--trace 1`` so the new readers report, and are judged against the
reference as the tiny cells of ``conftest.py`` are."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import REPO, TINY, make_root, run_cell

VIEWS = 12

# print, for each step, what the result line does not show: the matcher's
# launches and the engine's rounds
PROBE = """
import sys
import regard3d_tpu_torch.pipeline.compute_matches as cm
import regard3d_tpu_torch.pipeline.triangulation_step as ts
_cm, _ts = cm.run_compute_matches, ts.run_triangulation
def _m(*a, **k):
    st = _cm(*a, **k)
    sp = st["spans"]
    print("PROBE matches", sp["compute_matches.matching.match"]["launches"],
          sp["compute_matches.matching.match.readback"]["n"],
          st["pairs_putative"], file=sys.stderr)
    return st
def _t(*a, **k):
    st = _ts(*a, **k)
    print("PROBE sfm", st["profile"]["resection_rounds"],
          st["profile"]["ba_rounds"],
          st["spans"]["triangulation.resection"]["views"], file=sys.stderr)
    return st
cm.run_compute_matches, ts.run_triangulation = _m, _t
"""


@pytest.fixture(scope="module")
def castle_root(tmp_path_factory):
    """The tiny checkout with a 12-view castle configuration and its two
    cells, entered in every metric the ``synthetic-19`` cells report."""
    root = make_root(str(tmp_path_factory.mktemp("castle") / "root"),
                     cells=())
    with open(os.path.join(REPO, "benchmark", "configs",
                           "synthetic-19.json")) as fh:
        assert json.load(fh)["scene"] == "castle"
    conf = dict(TINY, name="castle12", scene="castle", views=VIEWS,
                resolution=[384, 256])
    with open(os.path.join(root, "benchmark", "configs", "castle12.json"),
              "w") as fh:
        json.dump(conf, fh)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "castle12", "source": "test",
                             "file": "benchmark/configs/castle12.json",
                             "reduced": [], "why": "test"})
    for kind, traffic in (("matches", "matches"), ("sfm", "tiny_sfm")):
        cell = f"castle12.{kind}"
        bench["workloads"].append({"name": cell, "config": "castle12",
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"synthetic-19.{kind}" in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(path, "w") as fh:
        json.dump(bench, fh, indent=1)
    return root


def _probes(err, kind):
    return [[int(x) for x in ln.split()[2:]] for ln in err.splitlines()
            if re.match(f"PROBE {kind} ", ln)]


def test_castle_matches_over_two_blocks_is_correct(castle_root):
    rc, line, err = run_cell(castle_root, "castle12.matches", trace=1,
                             fault=PROBE)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    assert line["failed"] == 0
    # the readers of the matcher's spans report beside the older ones
    for name in ("matching_wait_s", "matching_unpack_s", "matching_s",
                 "filter_s"):
        assert line["metrics"][name]["value"] > 0, name
    # every step: 66 pairs in two launches, each read back once
    probes = _probes(err, "matches")
    assert len(probes) >= 2            # a warm step, the window, the traced
    assert all(p == [2, 2, 66] for p in probes), probes


def test_castle_sfm_in_rounds_is_correct(castle_root):
    rc, line, err = run_cell(castle_root, "castle12.sfm", trace=1,
                             fault=PROBE)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    assert line["failed"] == 0
    assert line["metrics"]["resection_ms_per_view"]["value"] > 0
    assert line["compared"]["unposed"]["value"] == 0
    # the growth took more than one round, and every view left after the
    # initial pair was tried at least once
    probes = _probes(err, "sfm")
    assert probes
    for rounds, ba_rounds, views in probes:
        assert rounds >= 2 and ba_rounds >= 3 and views >= VIEWS - 2
