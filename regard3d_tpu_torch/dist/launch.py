"""Multi-process launcher — the port's multi-process runtime entry point.

Counterpart of ``regard3d_tpu/dist/launch.py``, on ``torch.distributed``:

* ``launch_local(n, argv)`` — start ``n`` OS processes of any r3d command
  (or any python program), wiring the env contract (R3D_COORDINATOR /
  R3D_NUM_PROCESSES / R3D_PROCESS_ID, plus R3D_DIST_BACKEND), so the local
  launcher and a cluster launcher that sets the same variables are
  interchangeable;
* ``init_from_env()`` — called by the CLI before it parses its arguments:
  joins the process group when the env contract is present, else no-op.

The backend: NCCL refuses two ranks on one card, and the CPU has no NCCL,
so ranks that share a card, and CPU ranks, use **gloo** (which moves CUDA
tensors itself for ``all_reduce`` and ``broadcast``, the only collectives
the port calls); NCCL only when every rank has cards of its own, and then
each rank sees just its own through ``CUDA_VISIBLE_DEVICES``. The children
run on the card unless their arguments hold the CLI's ``--device cpu``.

Multi-process execution contract (enforced by the CLI dispatcher):

* ``sfm`` is collective — with ``--dist-ba`` its final bundle adjustment
  shards the observations over the ranks (``ba/sharded.py``); artifact
  writes and project mutations happen on the primary only
  (``is_primary``);
* ``matches`` is sharded — the images go to the processes by whole feature
  buckets, the pair list round-robin, the filter's blocks round-robin; each
  writes ``matches.*.part{pid}.txt`` and the primary merges the parts
  (``pipeline/compute_matches.py`` ``run_compute_matches``);
* every other subcommand is host-side or one-process work: secondary
  processes skip it instead of racing on the same artifact files.

Every wait is bounded: the process group's ``timeout``, the marker waits
of the matches handshake and ``launch_local(timeout=)``, which kills every
rank when one fails or time runs out.
"""

from __future__ import annotations

import atexit
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

ENV_COORD = "R3D_COORDINATOR"
ENV_NPROC = "R3D_NUM_PROCESSES"
ENV_PID = "R3D_PROCESS_ID"
ENV_BACKEND = "R3D_DIST_BACKEND"
ENV_TIMEOUT = "R3D_DIST_TIMEOUT_S"


def timeout_s() -> float:
    """Bound on every cross-process wait (s): ``R3D_DIST_TIMEOUT_S``, else
    the reference's 3600."""
    return float(os.environ.get(ENV_TIMEOUT, "3600"))


def init_from_env() -> bool:
    """Join the ``torch.distributed`` group if the launcher env contract is
    set. Returns True when running as part of a multi-process job."""
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    import torch
    from regard3d_tpu_torch.dist import mesh
    if torch.distributed.is_initialized():
        return True
    mesh.init_distributed(coord, int(os.environ[ENV_NPROC]),
                          int(os.environ[ENV_PID]),
                          backend=os.environ.get(ENV_BACKEND, "gloo"),
                          timeout_s=timeout_s())
    atexit.register(torch.distributed.destroy_process_group)
    return True


def is_primary() -> bool:
    """True on the process that should write artifacts / print stats."""
    if os.environ.get(ENV_COORD) is None:
        return True
    return int(os.environ.get(ENV_PID, "0")) == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_device(argv: List[str]) -> str:
    """The ``--device`` the children's arguments give (default cuda)."""
    for k, a in enumerate(argv):
        if a == "--device" and k + 1 < len(argv):
            return argv[k + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda"


def choose_backend(num_processes: int, argv: List[str],
                   devices_per_process: int = 1) -> str:
    """nccl when the children run on cards and every rank can have
    ``devices_per_process`` cards of its own; gloo otherwise."""
    import torch
    if (_child_device(argv).startswith("cuda")
            and torch.cuda.device_count()
            >= num_processes * devices_per_process):
        return "nccl"
    return "gloo"


def launch_local(num_processes: int, argv: List[str],
                 devices_per_process: int = 1,
                 log_dir: Optional[str] = None,
                 module: Optional[str] = "regard3d_tpu_torch.cli",
                 timeout: Optional[float] = None) -> int:
    """Run ``python -m <module> <argv>`` (or bare ``python <argv>`` when
    ``module`` is None) in ``num_processes`` coordinated processes on this
    machine. With NCCL, rank r sees cards [r d, (r + 1) d) for
    d = ``devices_per_process``; with gloo every rank sees every card.

    CPU ranks share the host's cores: unless ``OMP_NUM_THREADS`` is set,
    each gets an equal share as its intra-op threads (oversubscribed ranks
    spin against each other in every collective).

    Process 0 inherits stdout/stderr; the others log to ``log_dir`` (or are
    silenced). When a process fails the others are killed; after
    ``timeout`` seconds all are killed and ``subprocess.TimeoutExpired`` is
    raised. Returns the worst exit code."""
    port = _free_port()
    backend = choose_backend(num_processes, argv, devices_per_process)
    threads = None
    if (_child_device(argv) == "cpu"
            and "OMP_NUM_THREADS" not in os.environ):
        threads = str(max(1, len(os.sched_getaffinity(0)) // num_processes))
    cmd = ([sys.executable, "-m", module] if module
           else [sys.executable]) + list(argv)
    procs, logs = [], []
    try:
        for pid in range(num_processes):
            env = dict(os.environ)
            env[ENV_COORD] = f"127.0.0.1:{port}"
            env[ENV_NPROC] = str(num_processes)
            env[ENV_PID] = str(pid)
            env[ENV_BACKEND] = backend
            if threads:
                env["OMP_NUM_THREADS"] = threads
            if backend == "nccl":
                env["CUDA_VISIBLE_DEVICES"] = ",".join(str(c) for c in range(
                    pid * devices_per_process,
                    (pid + 1) * devices_per_process))
            if pid == 0 or log_dir is None:
                out = None if pid == 0 else subprocess.DEVNULL
                procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                              stderr=out))
            else:
                os.makedirs(log_dir, exist_ok=True)
                f = open(os.path.join(log_dir, f"proc{pid}.log"), "w")
                logs.append(f)
                procs.append(subprocess.Popen(cmd, env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
        deadline = None if timeout is None else time.time() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                       # one failed: stop the others
            if deadline is not None and time.time() > deadline:
                raise subprocess.TimeoutExpired(cmd, timeout)
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    return max(p.returncode for p in procs)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="r3d-launch",
        description="run an r3d command across N coordinated processes")
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--module", default="regard3d_tpu_torch.cli")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds before every process is killed")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="r3d subcommand + args to run in every process")
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    rc = launch_local(args.num_processes, args.command,
                      devices_per_process=args.devices_per_process,
                      log_dir=args.log_dir, module=args.module,
                      timeout=args.timeout)
    sys.exit(rc)


if __name__ == "__main__":
    main()
