"""The readers of the metrics that read the program's span recorder
(``stats["spans"]``): each on hand-made steps and a hand-made profiled
step gives the hand-computed value, and each gives None on stats without
``spans``, as a program without the recorder returns. ``ba_launches_per_
iter`` reads the profiler's ``triangulation.ba`` spans and the step's
``profile["ba_iters"]``, which a program without the recorder has too."""

from __future__ import annotations

import sys

import pytest

from conftest import REPO

sys.path.insert(0, REPO)

from benchmark import run as bench_run  # noqa: E402

MATCHES = ("filter_draws_s", "filter_wait_s", "filter_launches_per_pair",
           "features_write_s")
SFM = ("sfm_io_s",)
S = 1_000_000_000


def _row(s, **counters):
    return {"n": 1, "s": s, "self_s": s, **counters}


def _matches_steps():
    return [{"time_filter_s": 2.0, "spans": {
                "compute_matches.filter": _row(2.0, pairs=4),
                "compute_matches.filter.block.draws": _row(0.25),
                "compute_matches.filter.block.readback": _row(0.5),
                "compute_matches.features.write": _row(0.125)}},
            {"time_filter_s": 3.0, "spans": {
                "compute_matches.filter": _row(3.0, pairs=4),
                "compute_matches.filter.block.draws": _row(0.75),
                "compute_matches.filter.block.readback": _row(1.5),
                "compute_matches.features.write": _row(0.375)}}]


def _sfm_steps():
    return [{"profile": {"ba_s": 1.0, "ba_iters": 10}, "spans": {
                "triangulation.inputs": _row(0.25),
                "triangulation.artifacts": _row(0.5),
                "triangulation.ba": _row(1.0)}},
            {"profile": {"ba_s": 1.0, "ba_iters": 10}, "spans": {
                "triangulation.inputs": _row(0.75),
                "triangulation.artifacts": _row(1.0),
                "triangulation.ba": _row(1.0)}}]


def _profiled(result):
    """Two filter windows holding 5 of 7 operations, or two BA windows
    holding 6 of them (a start on a window's end counts)."""
    spans = [("compute_matches.features", 0, 1 * S),
             ("compute_matches.filter", 1 * S, 2 * S),
             ("compute_matches.filter.block", 1 * S, 2 * S),
             ("compute_matches.filter", 3 * S, 4 * S),
             ("triangulation.ba", 0, 2 * S),
             ("triangulation.ba.trial", 0, 1 * S),
             ("triangulation.ba", 3 * S, 4 * S)]
    starts = [0.5, 1.0, 1.5, 1.9, 2.5, 3.2, 4.0]
    ops = [(int(t * S), int(t * S) + 10, "k") for t in starts]
    return {"spans": spans, "ops": ops, "result": result, "host_s": 5.0}


def _read(name, run):
    return bench_run.load_module("metrics", name).read(run)


def test_matches_readers_give_the_hand_computed_values():
    steps = _matches_steps()
    run = {"steps": steps, "profiled": _profiled(steps[0]),
           "work": {}, "records": []}
    assert _read("filter_draws_s", run) == pytest.approx(0.5)
    assert _read("filter_wait_s", run) == pytest.approx(1.0)
    assert _read("features_write_s", run) == pytest.approx(0.25)
    # starts 1.0, 1.5, 1.9 in the first window, 3.2, 4.0 in the second:
    # 5 operations over 4 pairs
    assert _read("filter_launches_per_pair", run) == pytest.approx(1.25)


def test_sfm_readers_give_the_hand_computed_values():
    steps = _sfm_steps()
    run = {"steps": steps, "profiled": _profiled(steps[1]),
           "work": {}, "records": []}
    # (0.25 + 0.5 + 0.75 + 1.0) / 2
    assert _read("sfm_io_s", run) == pytest.approx(1.25)
    # starts 0.5, 1.0, 1.5, 1.9 in [0, 2], 3.2, 4.0 in [3, 4]: 6 over 10
    assert _read("ba_launches_per_iter", run) == pytest.approx(0.6)


@pytest.mark.parametrize("name", MATCHES + SFM)
def test_readers_give_none_without_the_recorder(name):
    """Stats as the program returned them before the recorder: the same
    keys with no ``spans``."""
    steps = [{k: v for k, v in s.items() if k != "spans"}
             for s in (_matches_steps() if name in MATCHES
                       else _sfm_steps())]
    run = {"steps": steps, "profiled": _profiled(steps[0]), "work": {},
           "records": []}
    assert _read(name, run) is None
    empty = {"steps": [], "profiled": None, "work": {}, "records": []}
    assert _read(name, empty) is None


def test_ba_launches_per_iter_reads_the_steps_own_iterations():
    """Without ``spans`` the reader gives the same value; it gives None
    with no LM iteration or no device operation."""
    steps = [{k: v for k, v in s.items() if k != "spans"}
             for s in _sfm_steps()]
    run = {"steps": steps, "profiled": _profiled(steps[0]), "work": {},
           "records": []}
    assert _read("ba_launches_per_iter", run) == pytest.approx(0.6)
    idle = dict(run, profiled=dict(run["profiled"], ops=[]))
    assert _read("ba_launches_per_iter", idle) is None
    none = {"profile": {"ba_s": 0.0, "ba_iters": 0}}
    run = dict(run, profiled=_profiled(none))
    assert _read("ba_launches_per_iter", run) is None
