"""The port's span recorder (``regard3d_tpu_torch/spans.py``), on the CPU.

* nesting, self time, names relative to the open span, counters, and a
  ``collect()`` inside another feeding the open one;
* spans opened by ``dist/mesh.run_on_mesh`` workers on two CPU positions
  count in the caller's collector, under the caller's span name;
* a compute-matches and a triangulation step (4 synthetic fountain views
  at 256 px, 352 keypoints, 64 RANSAC iterations: the stage tests' scene,
  with short BA rounds) return every span and counter of their layers and
  every stats key they returned before the recorder, each timing key equal
  to its span's seconds;
* the timeline shares the profiler's clock: under ``torch.profiler`` every
  timeline span has a profiler event of the same name, as many of them,
  each starting within 0.5 ms;
* ``add_to_trace`` appends the spans to a profiler trace in place, or
  beside it where the file is laid out another way;
* ``match_all_pairs`` over several blocks of 64 pairs (12 random-descriptor
  views: 66 pairs, 2 blocks, 62 pad slots) equals the benchmark
  reference's exact ratio test on every pair whatever the pairs' order,
  counts one ``launches`` a matcher call and opens one ``.readback`` and
  one ``.unpack`` span a block;
* the benchmark's readers of those spans and of resection's ``views``
  counter give the hand-computed values, and None on steps without them;
* ``spans.py`` is the one module of the port that imports
  ``record_function``, and the step drivers keep no timers of their own.
"""

import ast
import inspect
import os
import threading
import time

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.reference import matches_ref
from regard3d_tpu_torch import spans
from regard3d_tpu_torch.core.types import PINHOLE, Descriptors
from regard3d_tpu_torch.dist import mesh as meshlib
from regard3d_tpu_torch.ingest import synth
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline import triangulation_step as tts
from regard3d_tpu_torch.sfm import incremental as tinc

torch.set_num_threads(min(2, torch.get_num_threads()))

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "regard3d_tpu_torch")

MATCH_KEYS = {"pairs_putative", "pairs_f", "pairs_e", "pairs_h",
              "matches_putative", "matches_f", "matches_e", "matches_h",
              "filter_blocks", "keypoints", "elapsed_s", "time_features_s",
              "time_matching_s", "time_filter_s"}
MATCH_SPANS = {
    "compute_matches.step": (),
    "compute_matches.features": (),
    "compute_matches.features.upload": (),
    "compute_matches.features.detect": (),
    "compute_matches.features.describe": (),
    "compute_matches.features.readback": (),
    "compute_matches.features.write": (),
    "compute_matches.matching": (),
    "compute_matches.matching.load": (),
    "compute_matches.matching.match": ("launches",),
    "compute_matches.matching.match.readback": (),
    "compute_matches.matching.match.unpack": (),
    "compute_matches.filter": ("pairs",),
    "compute_matches.filter.block": (),
    **{f"compute_matches.filter.block.{k}": () for k in (
        "prep", "draws", "f", "e", "h", "readback", "collect")},
    "compute_matches.artifacts": (),
}
SFM_KEYS = {"num_cameras", "num_tracks", "num_observations", "rms_px",
            "residual_min", "residual_max", "residual_mean",
            "residual_median", "order_added", "profile", "init_hub",
            "init_pair", "elapsed_s"}
SFM_SPANS = {
    "triangulation.step": (),
    "triangulation.inputs": (),
    "triangulation.init": (),
    "triangulation.triangulation": (),
    "triangulation.select": (),
    "triangulation.resection": ("views",),
    "triangulation.ba": (),
    "triangulation.ba.trial": (),
    "triangulation.ba.cost": (),
    "triangulation.outlier": (),
    "triangulation.artifacts": (),
}


def test_nesting_self_time_relative_names_and_counters():
    with spans.collect() as col:
        with spans.span("a", k=1) as a:
            time.sleep(0.02)
            with spans.span(".b") as b:
                time.sleep(0.03)
                spans.count("x", 2)
            spans.count("y")
            with spans.collect() as inner, spans.span(".b"):
                assert inner is col
                spans.count("x")
            assert 0.05 <= a.seconds < 1.0
        with spans.span(".c"):          # no span open: the dot goes
            pass
    summary = col.summary()
    assert set(summary) == {"a", "a.b", "c"}
    assert summary["a"]["n"] == 1 and summary["a.b"]["n"] == 2
    assert summary["a"]["k"] == 1 and summary["a"]["y"] == 1
    assert summary["a.b"]["x"] == 3 and "x" not in summary["a"]
    assert summary["a"]["s"] == pytest.approx(a.seconds)
    assert summary["a"]["self_s"] == pytest.approx(
        a.seconds - summary["a.b"]["s"])
    assert summary["a.b"]["s"] >= b.seconds >= 0.03
    assert summary["a.b"]["self_s"] == summary["a.b"]["s"]
    # outside a collector a span still times its body and keeps nothing
    with spans.span("d") as d:
        time.sleep(0.01)
    assert d.seconds >= 0.01 and "d" not in col.summary()


def test_mesh_workers_count_in_the_callers_collector():
    mesh = meshlib.make_mesh("pairs", ["cpu"] * 2)
    threads = set()

    def work(item, dev):
        with spans.span(".item", items=1):
            threads.add(threading.get_ident())
            time.sleep(0.01)
        spans.count("done")
        return item * 2

    with spans.collect() as col:
        with spans.span("step"):
            out = meshlib.run_on_mesh(work, list(range(6)), mesh)
    summary = col.summary()
    assert out == [2 * k for k in range(6)]
    assert len(threads) == 2 and threading.get_ident() not in threads
    assert summary["step.item"]["n"] == 6
    assert summary["step.item"]["items"] == 6
    assert summary["step"]["done"] == 6
    # the workers' spans are not the caller's children
    assert summary["step"]["self_s"] == summary["step"]["s"]


def _check_spans(got, want):
    assert set(got) == set(want)
    for name, counters in want.items():
        assert got[name]["n"] >= 1, name
        assert got[name]["s"] >= got[name]["self_s"] >= 0.0, name
        assert set(got[name]) == {"n", "s", "self_s", *counters}, name


def test_steps_return_every_span_counter_and_stats_key(tmp_path):
    ds = synth.make_dataset("fountain", n_cams=11, hw=256, seed=0)
    images = ds["images"][:4]
    f = ds["f"] * 1.03
    matches = str(tmp_path / "matches")
    st = tcm.run_compute_matches(images, matches, threshold=0.0007,
                                 cfg=tcm.MatchConfig(ransac_iters=64),
                                 focals=np.full(4, f), max_keypoints=352,
                                 device="cpu")
    assert set(st) == MATCH_KEYS | {"spans"}
    sp = st["spans"]
    _check_spans(sp, MATCH_SPANS)
    for key, name in (("time_features_s", "compute_matches.features"),
                      ("time_matching_s", "compute_matches.matching"),
                      ("time_filter_s", "compute_matches.filter")):
        assert st[key] == sp[name]["s"]
    assert st["elapsed_s"] < sp["compute_matches.step"]["s"]
    # one span a filter block, the draws taken once for each kind a block
    # runs, and the counter the launches per pair are read over
    blocks = sp["compute_matches.filter.block"]["n"]
    assert sp["compute_matches.filter.block.f"]["n"] == blocks
    assert sp["compute_matches.filter.block.draws"]["n"] == sum(
        sp[f"compute_matches.filter.block.{k}"]["n"] for k in "feh")
    assert sp["compute_matches.filter"]["pairs"] == 6
    # 6 pairs: one matcher block, read back and unpacked once
    assert sp["compute_matches.matching.match"]["launches"] == 1
    assert sp["compute_matches.matching.match.readback"]["n"] == 1
    assert sp["compute_matches.matching.match.unpack"]["n"] == 1

    intr = np.zeros((1, 9), np.float32)
    intr[0, :3] = [f, 128.0, 128.0]
    st = tts.run_triangulation(
        matches, str(tmp_path / "tri"), images,
        intr_id=np.zeros(4, np.int32), intr=intr,
        models=np.asarray([PINHOLE], np.int32),
        params=tts.TriangulationParams(ba_iterations=3,
                                       final_ba_iterations=3),
        device="cpu")
    assert set(st) == SFM_KEYS | {"spans"}
    sp, prof = st["spans"], st["profile"]
    _check_spans(sp, SFM_SPANS)
    for key, name in (("init_s", "init"), ("ba_s", "ba"),
                      ("resection_s", "resection"), ("outlier_s", "outlier"),
                      ("triangulation_s", "triangulation")):
        assert prof[key] == pytest.approx(sp[f"triangulation.{name}"]["s"],
                                          rel=1e-9), key
    # the last selection finds no view and ends the growth: not host_s
    assert prof["host_s"] <= sp["triangulation.select"]["s"]
    assert sp["triangulation.select"]["n"] == 2 * prof["resection_rounds"] + 1
    assert sp["triangulation.resection"]["n"] == prof["resection_rounds"]
    assert sp["triangulation.ba"]["n"] == prof["ba_rounds"]
    # one trial a LM iteration, and a cost read more than trials a round
    assert sp["triangulation.ba.trial"]["n"] == prof["ba_iters"]
    assert sp["triangulation.ba.cost"]["n"] == \
        prof["ba_iters"] + prof["ba_rounds"]
    assert st["elapsed_s"] < sp["triangulation.step"]["s"]


def test_timeline_shares_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    with spans.span("clock.warm"):      # the first span pays set-up
        pass
    with spans.timeline() as line, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("clock.warm"):
            pass
        for _ in range(5):
            with spans.span("clock.outer"):
                torch.ones(1000).sum()
                with spans.span(".inner"):
                    torch.ones(10).sum()
    theirs, ours = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock."):
            theirs.setdefault(e.name(), []).append(e.start_ns())
    for name, start, end, thread in line:
        assert end >= start and thread == threading.get_native_id()
        ours.setdefault(name, []).append(start)
    assert set(ours) == set(theirs) == {"clock.warm", "clock.outer",
                                        "clock.outer.inner"}
    for name in ours:
        a, b = sorted(ours[name]), sorted(theirs[name])
        assert len(a) == len(b), name
        assert max(abs(x - y) for x, y in zip(a, b)) < 500_000, name


def test_spans_is_the_one_recorder():
    importers = []
    for d, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(d, fn)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, (ast.Import, ast.ImportFrom))
                         else [])
                if any("record_function" in n for n in names) or (
                        isinstance(node, ast.Attribute)
                        and node.attr == "record_function"):
                    importers.append(os.path.relpath(path, PKG))
    assert sorted(set(importers)) == ["spans.py"]
    for fn in (tcm.run_compute_matches, tcm._compute_matches,
               tinc.run_incremental, tts.run_triangulation,
               tts._triangulation):
        src = inspect.getsource(fn)
        assert "perf_counter" not in src and "time.time" not in src, fn


TRACE_HEAD = '{\n  "schemaVersion": 1,\n  "baseTimeNanoseconds": 7000,\n'
KERNEL = {"ph": "X", "cat": "kernel", "name": "k", "ts": 5.0, "dur": 1.0}


@pytest.mark.parametrize("events,tail", [
    ([], ''),
    ([KERNEL], ''),
    ([KERNEL], ', "distributedInfo": {"rank": 0}'),   # another layout
])
def test_add_to_trace_appends_in_place(tmp_path, events, tail):
    """``spans.add_to_trace`` on a trace laid out as the profiler writes
    it: the spans land at the end of ``traceEvents`` on the trace's time
    base, one track per thread, and the file stays JSON. Laid out another
    way, the trace is left as it was and the spans go to
    ``host_spans.json`` beside it, on the same time base."""
    import json
    path = tmp_path / "trace.json"
    body = ",".join(json.dumps(e) for e in events)
    text = (TRACE_HEAD + f'  "traceEvents": [\n{body}\n  ]{tail},'
            '"traceName": "t" }')
    path.write_text(text)
    got_path = spans.add_to_trace(
        str(path), [("a", 9000, 12000, 1), ("b", 7000, 7500, 2),
                    ("a.b", 10000, 11000, 1)])
    trace = json.loads(path.read_text())
    assert trace["traceName"] == "t" and trace["traceEvents"][:len(events)] \
        == events
    if tail:
        assert got_path == str(tmp_path / "host_spans.json")
        assert path.read_text() == text
        trace = json.loads(open(got_path).read())
    else:
        assert got_path == str(path)
    got = [(e["name"], e["ts"], e["dur"], e["tid"])
           for e in trace["traceEvents"] if e.get("cat") == "host_span"]
    tid = spans.HOST_SPANS_TID
    assert got == [("a", 2.0, 3.0, tid), ("b", 0.0, 0.5, tid + 1),
                   ("a.b", 3.0, 1.0, tid)]


def _random_views(n_views, seed=0):
    """Padded descriptors of ``n_views`` views of 96-160 rows each: rows
    drawn from a pool of 240 random descriptors, a few entries of each moved
    by one step, so that pairs share true matches. Entries lie on a grid of
    1/16, so every distance is exact in float32 (the program and the
    reference then decide alike, ties included)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 15, (240, 144))
    counts = rng.integers(96, 161, n_views)
    data = np.zeros((n_views, 256, tcm.MATCH_DIM), np.float32)
    mask = np.zeros((n_views, 256), bool)
    for v, c in enumerate(counts):
        rows = pool[rng.choice(len(pool), c, replace=False)]
        rows = rows + rng.integers(-1, 2, rows.shape) * (
            rng.random(rows.shape) < 0.2)
        data[v, :c, :144] = rows / 16.0
        mask[v, :c] = True
    return Descriptors(data=torch.as_tensor(data),
                       mask=torch.as_tensor(mask)), counts


def test_match_all_pairs_over_blocks_equals_the_exact_ratio_test():
    descs, counts = _random_views(12)
    cfg = tcm.MatchConfig()
    pairs = tcm.exhaustive_pairs(12)
    assert len(pairs) == 66           # two blocks of 64, 62 pad slots
    got = tcm.match_all_pairs(None, descs, cfg)
    order = np.random.default_rng(1).permutation(len(pairs))
    shuffled = tcm.match_all_pairs(None, descs, cfg,
                                   pairs=[pairs[k] for k in order])
    assert set(got) == set(shuffled) == set(pairs)
    for i, j in pairs:
        want = matches_ref.ratio_match(descs.data[i, :counts[i], :144],
                                       descs.data[j, :counts[j], :144],
                                       cfg.ratio)
        assert len(want) > 0
        np.testing.assert_array_equal(got[(i, j)], want)
        np.testing.assert_array_equal(shuffled[(i, j)], want)


@pytest.mark.parametrize("n_pairs", [1, 64, 66, 129])
def test_match_all_pairs_counts_launches_and_spans_a_block(n_pairs):
    descs, _ = _random_views(17, seed=n_pairs)
    pairs = tcm.exhaustive_pairs(17)[:n_pairs]
    with spans.collect() as col:
        with spans.span("m"):
            out = tcm.match_all_pairs(None, descs, tcm.MatchConfig(),
                                      pairs=pairs)
    summary = col.summary()
    blocks = -(-n_pairs // tcm.PAIR_BLOCK)
    assert len(out) == n_pairs
    assert summary["m"]["launches"] == blocks
    assert summary["m.readback"]["n"] == summary["m.unpack"]["n"] == blocks


def test_resection_counts_the_views_of_every_group_tried(monkeypatch):
    """On a small scene resected in groups of at most two views, the
    ``views`` counter of ``triangulation.resection`` is the sum of the
    groups handed to the batched resection, one group a round."""
    from regard3d_tpu_torch.kernels import ransac
    from tests.test_incremental import build_inputs, synth_scene
    from tests.test_torch_incremental import port_inputs
    sizes = []
    batch = ransac.acransac_resection_batch

    def record(*a, **kw):
        sizes.append(int(a[1].shape[0]))
        return batch(*a, **kw)

    monkeypatch.setattr(ransac, "acransac_resection_batch", record)
    inputs, _ = build_inputs(synth_scene(np.random.default_rng(0)))
    cfg = tinc.IncrementalConfig(ransac_iters=256, resection_iters=128,
                                 resection_group=2, ba_iterations=5,
                                 final_ba_iterations=5)
    with spans.collect() as col:
        res = tinc.run_incremental(port_inputs(inputs), cfg=cfg, seed=3,
                                   device="cpu")
    prof = res.stats["profile"]
    row = col.summary()["triangulation.resection"]
    assert res.stats["num_cameras"] == 8
    assert prof["resection_rounds"] == len(sizes) == row["n"] >= 3
    assert row["views"] == sum(sizes) >= 6
    assert prof["ba_rounds"] >= 3         # BA between the rounds too


def _read(name, steps):
    return bench_run.load_module("metrics", name).read(
        {"steps": steps, "profiled": None, "work": {}, "records": []})


def _row(s, **counters):
    return {"n": 2, "s": s, "self_s": s, **counters}


def test_readers_of_the_matching_spans_and_resection_views():
    steps = [{"spans": {
        "compute_matches.matching.match": _row(0.5, launches=3),
        "compute_matches.matching.match.readback": _row(0.25),
        "compute_matches.matching.match.unpack": _row(0.0625)}},
        {"spans": {
            "compute_matches.matching.match": _row(0.5, launches=3),
            "compute_matches.matching.match.readback": _row(0.75),
            "compute_matches.matching.match.unpack": _row(0.1875)}}]
    assert _read("matching_wait_s", steps) == pytest.approx(0.5)
    assert _read("matching_unpack_s", steps) == pytest.approx(0.125)
    steps = [{"profile": {"resection_s": 0.25},
              "spans": {"triangulation.resection": _row(0.25, views=10)}},
             {"profile": {"resection_s": 0.75},
              "spans": {"triangulation.resection": _row(0.75, views=10)}}]
    assert _read("resection_ms_per_view", steps) == pytest.approx(50.0)


@pytest.mark.parametrize("name,step", [
    ("matching_wait_s", {"time_matching_s": 1.0}),
    ("matching_unpack_s", {"time_matching_s": 1.0,
                           "spans": {"compute_matches.matching.match":
                                     _row(0.5)}}),
    ("resection_ms_per_view", {"profile": {"resection_s": 1.0}}),
    ("resection_ms_per_view", {"profile": {"resection_s": 1.0}, "spans": {
        "triangulation.resection": _row(1.0)}}),
])
def test_readers_give_none_without_their_span(name, step):
    """A program without the spans (the stats of a step before they were
    added) reads None, never an error."""
    assert _read(name, [step, step]) is None
