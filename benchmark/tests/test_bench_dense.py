"""Whole runs of the dense step kind on the CPU at a tiny size: the result
line, the per-layer metrics a traced run reads, the control and the fault
that must fail their numbers, a broken timed path, and what the dense
reference may import.

The tiny dense cell is the tiny configuration with 8 views (4 leave too
few sources for the cross-view fusion at 256 x 256), swept at level 0 over
32 planes. At that size the sweep is far coarser than the cell's, so its
limits and its cloud gate are its own, set from tiny readings on the CPU
(seeds 5-9 and 2**31 + 7; program: ``depth_out`` <= 0.161,
``depth_median_planes`` <= 0.169, ``cloud_out`` <= 0.232,
``cloud_uncovered`` <= 0.513, ``sweep_diff`` <= 6.4e-5, ``fusion_diff``
<= 1.6e-4; seeds 5-7: TF32 control ``sweep_diff`` >= 0.0101,
``fusion_diff`` >= 0.420; fault ``depth_out`` >= 0.782,
``depth_median_planes`` >= 1.22, ``cloud_out`` >= 0.9997,
``cloud_uncovered`` >= 0.9995; every other view's points dropped by the
fusion: ``fusion_diff`` >= 0.502, every other number under its limit)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO, TINY, make_root, run_cell
from test_bench_control import _calibrate, _limits

CELL = "tinyd.dense"
TINY_DENSE = {"settings": {"level": 0, "num_planes": 32},
              "coverage_stride": 4, "cloud_gate": 0.5,
              "limits": {"depth_out": 0.4, "depth_median_planes": 0.6,
                         "cloud_out": 0.5, "cloud_uncovered": 0.8,
                         "sweep_diff": 0.002, "fusion_diff": 0.01}}


def make_dense_root(path: str) -> str:
    """A checkout with the tiny dense cell beside the tiny ones."""
    root = make_root(path, cells=())
    conf = dict(TINY, name="tinyd", views=8)
    with open(os.path.join(root, "benchmark/configs/tinyd.json"), "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(REPO, "benchmark/traffic/dense.json")) as fh:
        traffic = json.load(fh)
    traffic["settings"].update(TINY_DENSE["settings"])
    traffic.update({k: v for k, v in TINY_DENSE.items() if k != "settings"})
    with open(os.path.join(root, "benchmark/traffic/tiny_dense.json"),
              "w") as fh:
        json.dump(traffic, fh)
    bpath = os.path.join(root, "BENCHMARK.json")
    with open(bpath) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tinyd", "source": "test",
                             "file": "benchmark/configs/tinyd.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tinyd",
                               "traffic": "tiny_dense", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "synthetic-11.dense" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(bpath, "w") as fh:
        json.dump(bench, fh, indent=1)
    return root


@pytest.fixture(scope="module")
def dense_root(tmp_path_factory):
    return make_dense_root(str(tmp_path_factory.mktemp("dense") / "root"))


def test_rehearsal_prints_the_contract_line(dense_root):
    rc, line, err = run_cell(dense_root, CELL)
    assert rc == 0, err[-3000:]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, err[-3000:]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "dense_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "compared"
    assert set(line["compared"]) == {"depth_out", "depth_median_planes",
                                     "cloud_out", "cloud_uncovered",
                                     "sweep_diff", "fusion_diff"}
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert [t.split()[0] for t in tail] == list(line["compared"])


def host_readers(root: str, cell: str) -> set:
    """The per-layer metrics of ``cell`` a CPU run can read: those taken
    from the program's spans and counters (the CPU has no device trace)."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    return {m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            and m["source"] in ("program_span", "program_counter")}


def test_traced_run_reads_the_per_layer_metrics(dense_root):
    rc, line, err = run_cell(dense_root, CELL, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    want = host_readers(dense_root, CELL)
    assert want == {"dense_sweep_s", "dense_fusion_s", "dense_host_s"}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _control_and_fault(root, cell, seed, device):
    got = _calibrate(root, cell, seed, device)
    lim = _limits(root, cell)
    prog = got["program"]["numbers"]
    assert got["program"]["failed"] is None
    assert all(prog[k] <= lim[k] for k in lim), (prog, lim)
    # the TF32 control fails the drift guard, the fault each number held
    # to the scene
    assert got["control"]["numbers"]["sweep_diff"] > lim["sweep_diff"]
    for k in ("depth_out", "cloud_out", "cloud_uncovered"):
        assert got["fault"]["numbers"][k] > lim[k], (k, got["fault"], lim)


def test_control_and_fault_fail_their_numbers_on_the_cpu(dense_root):
    _control_and_fault(dense_root, CELL, 2 ** 31 + 7, "cpu")


FAULTS = {
    # the sweep hands back its nearest plane, every pixel accepted
    "sweep_unchanged": """
import torch
from regard3d_tpu_torch.mvs import planesweep as ps
def _sweep(ref, srcs, src_valid, homos, idepths, *a, **k):
    return (torch.full_like(ref, float(idepths[0])), torch.ones_like(ref))
ps.sweep = _sweep
""",
    # half of the views left out of the sweep
    "half_the_views": """
from regard3d_tpu_torch.mvs import driver
_orig = driver.compute_depth_maps
def _half(*a, **k):
    out = _orig(*a, **k)
    return {v: d for n, (v, d) in enumerate(sorted(out.items())) if n % 2}
driver.compute_depth_maps = _half
""",
    # every depth moved by two plane spacings where the sweep produces it
    "depth_altered": """
from regard3d_tpu_torch.mvs import planesweep as ps
_orig = ps.sweep
def _sweep(ref, srcs, src_valid, homos, idepths, *a, **k):
    idepth, ncc = _orig(ref, srcs, src_valid, homos, idepths, *a, **k)
    return idepth + 2.0 * (idepths[0] - idepths[1]), ncc
ps.sweep = _sweep
""",
    # every other view's points left out of the cloud by the fusion, every
    # depth map written whole
    "fusion_half_the_views": """
from regard3d_tpu_torch.mvs import fusion
_orig = fusion.fuse_points
_n = [0]
def _fuse(*a, **k):
    _n[0] += 1
    out = _orig(*a, **k)
    return out if _n[0] % 2 else tuple(x[:0] for x in out)
fusion.fuse_points = _fuse
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(dense_root, fault):
    rc, line, err = run_cell(dense_root, CELL, fault=FAULTS[fault])
    # a fault the warm-up meets ends the run with no result: refused too
    assert (rc != 0 and line is None) or line["correct"] is False, (
        rc, line, err[-2000:])


def test_the_dense_reference_imports_nothing_of_the_port(dense_root):
    rc, line, err = run_cell(dense_root, CELL, fault="""
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
            "import benchmark.reference.dense_ref, "
            "benchmark.reference.frozen.planesweep, "
            "benchmark.reference.frozen.densify\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & {"jax", "jaxlib", "flax", "regard3d_tpu",
                                 "regard3d_tpu_torch"}


@pytest.mark.card
def test_control_and_fault_fail_the_dense_cell_on_the_card(card):
    _control_and_fault(REPO, "synthetic-11.dense", 2 ** 31 + 101, "cuda")
