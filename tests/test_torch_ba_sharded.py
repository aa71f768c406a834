"""Port parity: the distributed bundle adjustment (``ba/sharded.py``)
against the JAX package, on the CPU.

* ``partition_by_point``: the reference's arrays, bit for bit.
The problem is ``tests/test_ba.py``'s with 0.5 px noise. Refining the
intrinsics from a focal 2% off, LM still creeps along the focal-depth
valley after 40 iterations, so runs that sum in other orders end a little
apart (measured: within 1.2e-5 relative); with fixed intrinsics it stops
at its ftol in 15.

* ``bundle_adjust_point_sharded`` over ``[cpu] * 2`` and ``[cpu] * 3``
  (uneven blocks), intrinsics refined, 40 iterations, against the
  reference's on a 2- and 3-device slice of the session's 8 virtual
  devices and against the port's ``bundle_adjust``: final cost within
  1e-4 relative of both, centres within 1e-3 and points within 1e-2
  (``tests/test_ba_sharded.py`` allows 1e-2 and 5e-2), focal within 1e-4
  relative; a repeat gives the same bits.
* ``bundle_adjust_sharded``, fixed intrinsics, over 2 gloo CPU ranks
  (``launch_local``): final cost within 1e-5 relative of the reference's
  ``bundle_adjust_sharded`` on a 2-device mesh and of the port's
  ``bundle_adjust``, centres within 1e-3, points within 1e-2; the two
  ranks' results the same bits.
* ``LocalReduce`` (the in-process sum of the point-sharded path) under
  more threads than cores.
"""

import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from regard3d_tpu.ba import lm as jlm
from regard3d_tpu.ba import sharded as jsh
from regard3d_tpu_torch.ba import lm as tlm
from regard3d_tpu_torch.ba import sharded as tsh
from regard3d_tpu_torch.core.types import (ba_observations_from_numpy,
                                           ba_state_from_numpy)
from regard3d_tpu_torch.dist import launch
from regard3d_tpu_torch.dist import mesh as tmesh
from tests.test_ba import synth_ba_problem

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port(state, obs):
    return (ba_state_from_numpy(*(np.asarray(a) for a in state)),
            ba_observations_from_numpy(*(np.asarray(a) for a in obs)))


def problem(seed=0, refine=True, **kw):
    """tests/test_ba.py's problem with 0.5 px noise; with ``refine`` the
    focal starts 2% off and the intrinsics are refined."""
    js, _, jo = synth_ba_problem(np.random.default_rng(seed), noise_px=0.5,
                                 **kw)
    if refine:
        js = js._replace(intr=js.intr.at[0, 0].multiply(1.02))
    V = js.R.shape[0]
    fixed = np.zeros(V, bool)
    fixed[0] = True
    return js, jo, fixed


@pytest.mark.parametrize("n_dev,n_pts", [(2, 120), (3, 97), (8, 97)])
def test_partition_by_point_matches_reference(n_dev, n_pts):
    js, jo, _ = problem(n_pts=n_pts, n_cams=5)
    want = jsh.partition_by_point(jo, js.X, n_dev, build_layout=False)
    ts, to = port(js, jo)
    got = tsh.partition_by_point(to, ts.X, n_dev)
    assert (got.n_dev, got.Lloc, got.Omax, got.L) == (
        want.n_dev, want.Lloc, want.Omax, want.L)
    np.testing.assert_array_equal(got.global_of_slot, want.global_of_slot)
    np.testing.assert_array_equal(got.X.numpy(), np.asarray(want.X))
    for name, a, b in zip(jlm.BAObservations._fields, got.obs, want.obs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert len(got.layout) == n_dev


def _case(refine, iters):
    js, jo, fixed = problem(refine=refine)
    ts, to = port(js, jo)
    opts_t = tlm.BAOptions(max_iterations=iters, refine_intrinsics=refine)
    single = tlm.bundle_adjust(ts, to, opts_t,
                               fixed_pose_mask=torch.as_tensor(fixed),
                               device="cpu")
    return dict(js=js, jo=jo, ts=ts, to=to, fixed=fixed, opts_t=opts_t,
                opts_j=jlm.BAOptions(max_iterations=iters,
                                     refine_intrinsics=refine),
                single=single)


@pytest.fixture(scope="module")
def refined():
    return _case(True, 40)


@pytest.fixture(scope="module")
def fixed_intr():
    return _case(False, 15)


def _close(got, want):
    (gs, gst), (ws, wst) = got, want
    assert gst.final_cost == pytest.approx(float(wst.final_cost), rel=1e-4)
    np.testing.assert_allclose(np.asarray(gs.C), np.asarray(ws.C), atol=1e-3)
    np.testing.assert_allclose(np.asarray(gs.X), np.asarray(ws.X), atol=1e-2)
    assert float(gs.intr[0, 0]) == pytest.approx(float(ws.intr[0, 0]),
                                                 rel=1e-4)


@pytest.mark.parametrize("n_dev", [2, 3])
def test_point_sharded_matches_reference_and_single(refined, n_dev):
    r = refined
    got = tsh.bundle_adjust_point_sharded(
        r["ts"], r["to"], tmesh.make_mesh("obs", ["cpu"] * n_dev),
        r["opts_t"], fixed_pose_mask=torch.as_tensor(r["fixed"]))
    want = jsh.bundle_adjust_point_sharded(
        r["js"], r["jo"], Mesh(np.asarray(jax.devices()[:n_dev]), ("obs",)),
        r["opts_j"], fixed_pose_mask=jnp.asarray(r["fixed"]))
    _close(got, want)
    _close(got, r["single"])
    again = tsh.bundle_adjust_point_sharded(
        r["ts"], r["to"], tmesh.make_mesh("obs", ["cpu"] * n_dev),
        r["opts_t"], fixed_pose_mask=torch.as_tensor(r["fixed"]))
    assert all(torch.equal(a, b) for a, b in zip(got[0], again[0]))
    assert got[1] == again[1]


def test_local_reduce_under_stress():
    """More threads than cores, a short switch interval: every position
    gets every round's exact sum (a slot overwritten before all had read it
    would break it), and every thread ends in time."""
    n, rounds = os.cpu_count() + 4, 200
    red = tsh.LocalReduce(n)
    got = [None] * n

    def worker(p):
        hook = red.hook(p, "cpu")
        out = []
        for r in range(rounds):
            t = torch.tensor([float(p + 1) * (r + 1)], dtype=torch.float64)
            out.append(float(hook((t,), "stress")[0][0]))
        got[p] = out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(p,), daemon=True)
                   for p in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    want = [n * (n + 1) / 2 * (r + 1) for r in range(rounds)]
    assert all(g == want for g in got)


RANK = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from regard3d_tpu_torch.ba import lm, sharded
from regard3d_tpu_torch.dist import launch
assert launch.init_from_env()
z = np.load(sys.argv[1])
state = lm.BAState(*(torch.as_tensor(z[k]) for k in ("R", "C", "intr", "X")))
obs = lm.BAObservations(*(torch.as_tensor(z[k]) for k in (
    "view_id", "intr_id", "point_id", "model", "xy", "weight")))
out, st = sharded.bundle_adjust_sharded(
    state, obs, None, lm.BAOptions(max_iterations=15),
    fixed_pose_mask=torch.as_tensor(z["fixed"]), device="cpu")
rank = int(os.environ["R3D_PROCESS_ID"])
with open(sys.argv[2] + f".{rank}.json", "w") as fh:
    json.dump({"final_cost": st.final_cost, "iterations": st.iterations,
               "C": out.C.tolist(), "X": out.X.tolist(),
               "world": torch.distributed.get_world_size()}, fh)
"""


def test_obs_sharded_over_two_gloo_ranks_matches_reference(fixed_intr,
                                                           tmp_path,
                                                           monkeypatch):
    """Two CPU processes joined by ``launch_local`` over gloo; each must
    finish within the launcher's timeout, else both are killed."""
    r = fixed_intr
    npz = str(tmp_path / "problem.npz")
    np.savez(npz, fixed=r["fixed"],
             **{k: np.asarray(v) for k, v in r["ts"]._asdict().items()},
             **{k: np.asarray(v) for k, v in r["to"]._asdict().items()})
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv(launch.ENV_TIMEOUT, "240")
    rc = launch.launch_local(2, ["-c", RANK, npz, str(tmp_path / "out")],
                             module=None, log_dir=str(tmp_path / "logs"),
                             timeout=300)
    logs = tmp_path / "logs" / "proc1.log"
    assert rc == 0, logs.read_text() if logs.exists() else rc
    ranks = [json.load(open(tmp_path / f"out.{k}.json")) for k in (0, 1)]
    assert ranks[0] == ranks[1] and ranks[0]["world"] == 2
    want = jsh.bundle_adjust_sharded(
        r["js"], r["jo"], Mesh(np.asarray(jax.devices()[:2]), ("obs",)),
        r["opts_j"], fixed_pose_mask=jnp.asarray(r["fixed"]))
    assert ranks[0]["final_cost"] == pytest.approx(
        float(want[1].final_cost), rel=1e-5)
    np.testing.assert_allclose(ranks[0]["C"], np.asarray(want[0].C),
                               atol=1e-3)
    np.testing.assert_allclose(ranks[0]["X"], np.asarray(want[0].X),
                               atol=1e-2)
    assert ranks[0]["final_cost"] == pytest.approx(
        r["single"][1].final_cost, rel=1e-5)
