"""The control of ``correct``: the reference put in the program's place in
TF32 must come out as not correct, while the program itself comes out
correct on the same seed. On the CPU at the tiny size for the matches
step; on the card at the cells' own sizes for both step kinds."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO


def _calibrate(root: str, cell: str, seed: int, device: str):
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {root!r})\n"
            "torch.set_num_threads(2)\n"
            "from benchmark import calibrate\n"
            f"sys.exit(calibrate.main(['--workload', {cell!r}, '--seeds', "
            f"'{seed}', '--control-seeds', '{seed}'], device={device!r}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=root)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(ln) for ln in p.stdout.splitlines()
            if ln.startswith("{")]
    return {r["who"]: r for r in rows}


def _limits(root: str, cell: str):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    traffic = {w["name"]: w["traffic"] for w in bench["workloads"]}[cell]
    with open(os.path.join(root, "benchmark", "traffic",
                           traffic + ".json")) as fh:
        return json.load(fh)["limits"]


def _check(root, cell, seed, device):
    got = _calibrate(root, cell, seed, device)
    lim = _limits(root, cell)
    prog, ctrl = got["program"]["numbers"], got["control"]["numbers"]
    assert got["program"]["failed"] is None
    assert all(prog[k] <= lim[k] for k in lim), (prog, lim)
    assert any(ctrl[k] > lim[k] for k in lim), (ctrl, lim)


def test_tf32_control_fails_the_matches_step_on_the_cpu(tiny_root):
    _check(tiny_root, "tiny.matches", 2 ** 31 + 7, "cpu")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["synthetic-11.matches", "synthetic-11.sfm"])
def test_tf32_control_fails_each_cell_on_the_card(card, cell):
    _check(REPO, cell, 2 ** 31 + 101, "cuda")
