"""Port parity: the distributed runtime surface (``dist/mesh.py``,
``dist/launch.py``) against the JAX package, on the CPU.

* ``pad_to_multiple`` gives the reference's arrays (tensors and numpy);
  ``make_mesh_2d`` the reference's shapes and axis names for 1-8 devices.
* ``launch_local`` wires the env contract, picks gloo for CPU ranks and for
  ranks that share a card (nccl only when each has its own), returns the
  worst exit code, stops the other ranks when one fails and kills all at
  its timeout (the counterpart of ``tests/test_multihost.py``'s launcher
  test); ``is_primary`` follows R3D_PROCESS_ID.
* ``run_on_mesh`` runs item k on position k mod N and keeps the order.
"""

import os
import subprocess
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.dist import mesh as jmesh
from regard3d_tpu_torch.dist import launch, mesh

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("shape,axis,multiple",
                         [((5, 3), 0, 4), ((7,), 0, 7), ((2, 5), 1, 3),
                          ((0, 2), 0, 2)])
def test_pad_to_multiple_matches_reference(rng, shape, axis, multiple):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jmesh.pad_to_multiple(jnp.asarray(x), multiple, axis,
                                            fill=-1.5))
    got_t = mesh.pad_to_multiple(torch.as_tensor(x), multiple, axis,
                                 fill=-1.5)
    got_n = mesh.pad_to_multiple(x, multiple, axis, fill=-1.5)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(got_n, want)
    assert got_n.dtype == want.dtype


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_2d_matches_reference(n):
    want = jmesh.make_mesh_2d(devices=jax.devices()[:n])
    got = mesh.make_mesh_2d(devices=["cpu"] * n)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == n
    assert all(d == torch.device("cpu") for d in got.device_list)
    one = mesh.make_mesh("obs", ["cpu"] * n)
    assert one.shape == {"obs": n} and one.axis_names == ("obs",)


def test_make_mesh_needs_devices_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh("obs")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = mesh.make_mesh("pairs")
    assert [str(d) for d in m.device_list] == ["cuda:0", "cuda:1",
                                               "cuda:2"]
    assert mesh.local_mesh("pairs", None, "cpu") is None
    assert mesh.local_mesh("pairs", None, "cuda").size == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.local_mesh("pairs", None, "cuda") is None


CHECK = ("import os, sys;"
         "assert os.environ['R3D_NUM_PROCESSES'] == '2';"
         "assert os.environ['R3D_COORDINATOR'].startswith('127.0.0.1:');"
         "assert os.environ['R3D_DIST_BACKEND'] == 'gloo';"
         "assert 'CUDA_VISIBLE_DEVICES' not in os.environ "
         "or os.environ['CUDA_VISIBLE_DEVICES'] == %r;")


def test_launcher_env_contract_and_worst_exit_code(tmp_path, monkeypatch):
    """launch_local wires the env contract and returns the worst exit
    code."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    cvd = os.environ.get("CUDA_VISIBLE_DEVICES")
    rc = launch.launch_local(2, ["-c", CHECK % cvd + "sys.exit(0)"],
                             module=None, log_dir=str(tmp_path), timeout=120)
    assert rc == 0
    rc = launch.launch_local(
        2, ["-c", CHECK % cvd + "sys.exit(int(os.environ['R3D_PROCESS_ID']))"],
        module=None, log_dir=str(tmp_path), timeout=120)
    assert rc == 1
    # CPU ranks share the host's cores (OMP_NUM_THREADS unless set)
    share = os.environ.get("OMP_NUM_THREADS") or str(
        max(1, len(os.sched_getaffinity(0)) // 2))
    rc = launch.launch_local(
        2, ["-c", CHECK % cvd + f"assert os.environ['OMP_NUM_THREADS'] == "
            f"{share!r}", "--device", "cpu"],
        module=None, log_dir=str(tmp_path), timeout=120)
    assert rc == 0


def test_launcher_stops_the_ranks(tmp_path):
    """A failed rank stops the others; the timeout kills every rank."""
    t0 = time.time()
    rc = launch.launch_local(
        2, ["-c", "import os, sys, time\n"
                  "if os.environ['R3D_PROCESS_ID'] == '1': sys.exit(3)\n"
                  "time.sleep(120)"],
        module=None, log_dir=str(tmp_path), timeout=120)
    assert rc == 3 and time.time() - t0 < 60
    t0 = time.time()
    with pytest.raises(subprocess.TimeoutExpired):
        launch.launch_local(2, ["-c", "import time; time.sleep(120)"],
                            module=None, log_dir=str(tmp_path), timeout=2)
    assert time.time() - t0 < 60


def test_backend_choice(monkeypatch):
    """gloo for CPU ranks and for ranks that share a card; nccl when every
    rank has cards of its own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch.choose_backend(2, ["matches", "p"]) == "nccl"
    assert launch.choose_backend(2, ["matches", "p"],
                                 devices_per_process=2) == "nccl"
    assert launch.choose_backend(8, ["matches", "p"]) == "gloo"
    assert launch.choose_backend(2, ["--device", "cpu", "matches"]) == "gloo"
    assert launch.choose_backend(2, ["--device=cpu", "sfm"]) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launch.choose_backend(2, ["matches", "p"]) == "gloo"


def test_is_primary_and_init_from_env(monkeypatch):
    for k in (launch.ENV_COORD, launch.ENV_PID, launch.ENV_NPROC):
        monkeypatch.delenv(k, raising=False)
    assert launch.is_primary() and not launch.init_from_env()
    monkeypatch.setenv(launch.ENV_COORD, "127.0.0.1:1")
    monkeypatch.setenv(launch.ENV_PID, "1")
    assert not launch.is_primary()
    monkeypatch.setenv(launch.ENV_PID, "0")
    assert launch.is_primary()


def test_run_on_mesh_order_and_errors():
    m = mesh.make_mesh("pairs", ["cpu"] * 3)
    seen = []
    lock = threading.Lock()

    def fn(item, dev):
        with lock:
            seen.append((item, threading.get_ident()))
        return (item * 10, str(dev))
    out = mesh.run_on_mesh(fn, list(range(7)), m)
    assert out == [(k * 10, "cpu") for k in range(7)]
    threads = {}
    for item, tid in seen:
        threads.setdefault(item % 3, set()).add(tid)
    assert all(len(v) == 1 for v in threads.values()) and len(threads) == 3

    def bad(item, dev):
        if item == 4:
            raise ValueError("item 4")
        return item
    with pytest.raises(ValueError, match="item 4"):
        mesh.run_on_mesh(bad, list(range(6)), m)
    assert mesh.run_on_mesh(lambda i, d: i, [1, 2],
                            mesh.make_mesh("x", ["cpu"])) == [1, 2]
