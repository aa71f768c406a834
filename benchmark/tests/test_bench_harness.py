"""The harness's pieces on the CPU: the scene generator, the readers of
the per-layer metrics, K1's operation count, TF32 rounding, and the
contract's charsets and keys in ``BENCHMARK.json``."""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from conftest import REPO

sys.path.insert(0, REPO)

from benchmark import run as bench_run  # noqa: E402
from benchmark import trace  # noqa: E402
from benchmark.reference import tf32  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("scene", ["fountain", "castle"])
def test_scene_is_a_function_of_the_seed(scene):
    mod = bench_run.load_module("scenes", scene)
    a = mod.make(2 ** 33 + 5, 3, (96, 64), 1.3, "cpu")
    b = mod.make(2 ** 33 + 5, 3, (96, 64), 1.3, "cpu")
    c = mod.make(2 ** 33 + 6, 3, (96, 64), 1.3, "cpu")
    for x, y in zip(a["images"], b["images"]):
        assert np.array_equal(x, y)
    assert np.array_equal(a["Cs"], b["Cs"])
    assert not np.array_equal(a["images"][0], c["images"][0])
    assert a["images"][0].dtype == np.float32
    assert 0.0 <= a["images"][0].min() and a["images"][0].max() <= 1.0


def test_a_seed_orders_the_views_of_one_image_set():
    from benchmark.scenes.render import shuffled
    scene = bench_run.load_module("scenes", "fountain").make(0, 5, (72, 48),
                                                             1.3, "cpu")
    a, b = shuffled(scene, 2 ** 40 + 1), shuffled(scene, 2 ** 40 + 2)
    key = lambda s: sorted(im.tobytes() for im in s["images"])
    assert key(a) == key(b) == key(scene)
    assert [im.tobytes() for im in a["images"]] != \
        [im.tobytes() for im in b["images"]]
    for s in (a, b):
        for im, C in zip(s["images"], s["Cs"]):
            k = [x.tobytes() for x in scene["images"]].index(im.tobytes())
            assert np.array_equal(C, scene["Cs"][k])


def test_exact_transfer_lands_on_the_same_texture():
    """A pixel's true position in another view shows the same texture
    there, and one pixel off it does not."""
    from benchmark.reference import geometry_ref as geo
    s = bench_run.load_module("scenes", "fountain").make(0, 3, (192, 128),
                                                         1.3, "cpu")
    rng = np.random.default_rng(3)
    xi = rng.uniform([2, 2], [189, 125], size=(1500, 2))
    d = geo._rays(s["Rs"][0], s["f"], s["size"], xi)
    t = geo.cast(s["planes"], s["Cs"][0], d)
    X = s["Cs"][0] + np.where(np.isfinite(t), t, 0.0)[:, None] * d
    cam = (X - s["Cs"][1]) @ s["Rs"][1].T
    xj = s["f"] * cam[:, :2] / cam[:, 2:] + np.array([96.0, 64.0])
    e = geo.transfer_px(s["planes"], s["Rs"][0], s["Cs"][0], s["Rs"][1],
                        s["Cs"][1], s["f"], s["size"], xi, xj)
    ok = np.isfinite(e) & (xj > 1).all(-1) & (xj < [190, 126]).all(-1)
    assert ok.sum() > 500 and np.abs(e[ok]).max() < 1e-9

    def bil(im, p):
        x0, y0 = np.floor(p).astype(int).T
        fx, fy = (p - np.floor(p)).T
        return ((1 - fx) * (1 - fy) * im[y0, x0] + fx * (1 - fy) * im[y0, x0 + 1]
                + (1 - fx) * fy * im[y0 + 1, x0] + fx * fy * im[y0 + 1, x0 + 1])
    a = bil(s["images"][0], xi[ok])
    b = bil(s["images"][1], xj[ok])
    off = bil(s["images"][1], np.clip(xj[ok] + [1.0, 0.0], 0, [190, 126]))
    assert np.median(np.abs(a - b)) * 4 < np.median(np.abs(a - off))


def test_k1_flop_counts_real_pairs_and_rows_only():
    k1 = bench_run.load_module("metrics", "k1_roofline")
    pairs = [(0, 1), (0, 2), (1, 2)]
    counts = [100, 200, 50]
    want = 2.0 * 144 * (100 * 200 + 100 * 50 + 200 * 50)
    assert k1.useful_flop(pairs, counts) == want
    # a launch of 64 slots, the last pair repeated: one kernel of 2 ms
    ops = [(0, 2_000_000, "void l2_top2_f32_kernel<0, 144>(...)"),
           (2_000_000, 3_000_000, "elementwise")]
    run = {"profiled": {"result": {"keypoints": counts}, "ops": ops},
           "work": {"pairs": pairs}}
    assert k1.read(run) == pytest.approx(100.0 * want / (2e-3 * 67e12))
    assert k1.read({"profiled": {"result": {"keypoints": counts},
                                 "ops": ops[1:]},
                    "work": {"pairs": pairs}}) is None


def test_busy_time_is_the_union_of_intervals():
    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(
        30e-9)
    assert trace.union_s([(0, 100), (10, 20)]) == pytest.approx(100e-9)
    assert trace.union_s([]) == 0.0


def _profiled():
    spans = [("compute_matches.features", 0, 1_000_000_000),
             ("compute_matches.matching", 1_000_000_000, 1_100_000_000),
             ("compute_matches.filter", 1_100_000_000, 3_100_000_000)]
    ops = [(100_000_000, 600_000_000, "conv"),
           (1_050_000_000, 1_060_000_000, "l2_top2_f32_kernel"),
           (1_200_000_000, 1_400_000_000, "ransac"),
           (1_300_000_000, 1_500_000_000, "ransac"),
           (2_000_000_000, 2_200_000_000, "ransac")]
    return {"spans": spans, "ops": ops, "result": {"keypoints": [10, 10]},
            "host_s": 4.0}


def test_readers_on_hand_made_events():
    steps = [{"time_features_s": 1.0, "time_matching_s": 0.1,
              "time_filter_s": 2.0, "elapsed_s": 3.2},
             {"time_features_s": 3.0, "time_matching_s": 0.3,
              "time_filter_s": 2.0, "elapsed_s": 5.2}]
    run = {"steps": steps, "profiled": _profiled(),
           "work": {"pairs": [(0, 1)]}, "records": []}
    read = lambda n: bench_run.load_module("metrics", n).read(run)
    assert read("features_s") == pytest.approx(2.0)
    assert read("matching_s") == pytest.approx(0.2)
    assert read("filter_s") == pytest.approx(2.0)
    # filter busy: [1.2, 1.5] and [2.0, 2.2] = 0.5 s of 2.0 s
    assert read("filter_idle") == pytest.approx(75.0)
    # all ops: 0.5 + 0.01 + 0.3 + 0.2 = 1.01 s of 4.2 s
    assert read("device_idle.matches") == pytest.approx(
        100.0 * (1 - 1.01 / 4.2))
    none = {"steps": [], "profiled": None, "work": {}, "records": []}
    for name in ("features_s", "filter_idle", "device_idle.matches"):
        assert bench_run.load_module("metrics", name).read(none) is None


def test_sfm_readers():
    steps = [{"profile": {"init_s": 4.0, "ba_s": 10.0, "ba_iters": 200},
              "elapsed_s": 20.0},
             {"profile": {"init_s": 6.0, "ba_s": 12.0, "ba_iters": 240},
              "elapsed_s": 22.0}]
    prof = {"spans": [("triangulation.ba", 0, 10)],
            "ops": [(0, 2_000_000_000, "gemv")]}
    run = {"steps": steps, "profiled": prof, "work": {}, "records": []}
    read = lambda n: bench_run.load_module("metrics", n).read(run)
    assert read("init_s") == pytest.approx(5.0)
    assert read("ba_s") == pytest.approx(11.0)
    assert read("ba_ms_per_iter") == pytest.approx(1000.0 * 22.0 / 440)
    assert read("device_idle.sfm") == pytest.approx(100.0 * (1 - 2 / 21))


def test_idle_gaps_are_named_by_the_host_span():
    prof = _profiled()
    gaps = trace.idle_gaps(prof["ops"], prof["spans"], n=2)
    assert gaps[0][0] == "compute_matches.filter"
    assert gaps[0][1] == pytest.approx(0.5)
    assert gaps[1][0] == "compute_matches.features"
    assert gaps[1][1] == pytest.approx(0.45)
    top = trace.top_ops(prof["ops"], n=1)
    assert top[0][0] == "ransac"


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2.5,
                      float("inf")])
    y = tf32.round_tf32(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -2.5, float("inf")]
    a, b = torch.rand(32, 144), torch.rand(144, 32)
    with tf32.emulate():
        got = a @ b
    want = tf32.round_tf32(a) @ tf32.round_tf32(b)
    assert torch.equal(got, want)
    assert not torch.equal(a @ b, got)


def test_benchmark_json_meets_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(REPO, c["file"])) as fh:
            conf = json.load(fh)
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in cells
        cells.add(w["name"])
        assert w["config"] in names and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(REPO, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
    metric_names = set()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in metric_names
        metric_names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    for root, _, files in os.walk(os.path.join(REPO, "benchmark")):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), REPO)
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
