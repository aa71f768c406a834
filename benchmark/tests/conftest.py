"""Fixtures of the benchmark's own tests.

``tiny_root`` is a throwaway checkout: the benchmark's files, the port's
package linked in, and a ``BENCHMARK.json`` with two cells of a tiny
configuration (4 views of 256 x 256 on the CPU). ``run_cell`` runs
``benchmark/run.py`` there in a child process on the CPU (the harness's
look for a card skipped), optionally with a fault planted first, and
returns the exit code, the result line and standard error.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {
    "name": "tiny", "scene": "fountain", "scene_seed": 5, "views": 4,
    "resolution": [256, 256],
    "focal_factor": 1.3, "intrinsics_guess": 1.03, "detector": "fast-akaze",
    "threshold": 0.0005, "max_keypoints": 512, "ratio": 0.8,
    "matcher": "brute-force", "ransac_iters": 64, "max_err_px": 4.0,
    "engine": "incremental2", "initializer": "maxpair",
    "gates": {"f_pairs_share": 0.5, "ate": 0.08, "residual_median_px": 1.0},
}
TINY_BA_EXCESS = 0.5


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run these tests on the card")


def make_root(path: str, cells=("tiny.matches", "tiny.sfm")) -> str:
    """A checkout at ``path`` with the tiny configuration's cells."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("regard3d_tpu_torch", "native"):
        os.symlink(os.path.join(REPO, name), os.path.join(path, name))
    with open(os.path.join(path, "benchmark", "configs", "tiny.json"),
              "w") as fh:
        json.dump(TINY, fh)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    # the tiny scene's BA converges less far than the cells' (4 views at
    # 256 px leave shallow points): its own limit, from tiny readings
    with open(os.path.join(REPO, "benchmark", "traffic", "sfm.json")) as fh:
        tiny_sfm = json.load(fh)
    tiny_sfm["limits"]["ba_excess"] = TINY_BA_EXCESS
    with open(os.path.join(path, "benchmark", "traffic", "tiny_sfm.json"),
              "w") as fh:
        json.dump(tiny_sfm, fh)
    for cell in cells:
        kind = cell.split(".", 1)[1]
        traffic = {"matches": "matches", "sfm": "tiny_sfm"}[kind]
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        like = {"matches": "synthetic-11.matches",
                "sfm": "synthetic-11.sfm"}[kind]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh, indent=1)
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path / "root"))


def run_cell(root: str, cell: str, seed: int = 2 ** 31 + 7,
             trace: int = 0, fault: str = "", seconds: float = 0.5,
             timeout: float = 600):
    """(exit code, last stdout line as JSON or None, stderr)."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {root!r})\n"
        "torch.set_num_threads(2)\n"
        f"{fault}\n"
        "from benchmark import run\n"
        f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '{seed}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'], device='cpu'))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=root)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr
