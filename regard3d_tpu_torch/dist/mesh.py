"""Device meshes — the port's distributed runtime surface.

Counterpart of ``regard3d_tpu/dist/mesh.py``. A JAX ``Mesh`` is an array of
devices with named axes that one SPMD program spans; PyTorch runs one
program per process, so here a mesh is a named list of ``torch.device``s
that the stage drivers hand work to, one worker thread per mesh position:

* axis ``images`` — feature buckets go round-robin over the devices;
* axis ``pairs``  — matcher and filter blocks go round-robin over them;
* axis ``views``  — plane-sweep reference views go round-robin over them;
* axis ``obs``    — the shards of the distributed BA (``ba/sharded.py``).

A device may appear more than once (``[cuda:0, cuda:0]`` runs two shards on
one card; ``[cpu] * N`` in the tests). Across processes the collective is
``torch.distributed`` (``init_distributed``; ``dist/launch.py`` wires it).
The reference's ``shard_spec`` / ``replicated_spec`` are JAX
``NamedSharding``s, which place one array over a mesh; they have no
counterpart here, where each mesh position holds its own tensors.
"""

from __future__ import annotations

import datetime
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from regard3d_tpu_torch import spans


class Mesh:
    """Devices with named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per name of ``axis_names``."""

    def __init__(self, axis: Union[str, Sequence[str]], devices):
        self.axis_names: Tuple[str, ...] = (
            (axis,) if isinstance(axis, str) else tuple(axis))
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(*src.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes "
                             f"{self.axis_names}")
        self.devices = arr

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo", timeout_s: float = 3600.0):
    """Join a ``torch.distributed`` process group (no-op without a
    coordinator): ``coordinator`` is ``host:port`` of process 0."""
    if coordinator is None:
        return
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(axis_name: str = "obs", devices=None) -> Mesh:
    """1-D mesh over ``devices``; with none given, every visible CUDA
    device."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh found no CUDA device; pass the "
                               "devices, e.g. ['cpu'] * N")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(axis_name, list(devices))


def make_mesh_2d(axis_names=("images", "pairs"), shape=None,
                 devices=None) -> Mesh:
    """2-D mesh; with no ``shape``, the most square one that favours the
    first axis (the reference's rule)."""
    devices = make_mesh("_", devices).device_list
    n = len(devices)
    if shape is None:
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        shape = (n // a, a)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(axis_names, arr.reshape(shape))


def local_mesh(axis: str, mesh: Optional[Mesh], device) -> Optional[Mesh]:
    """The mesh a stage driver uses: ``mesh`` if given, else every visible
    card when ``device`` is a card and more than one is visible (the
    reference's drivers build their mesh from the local devices), else
    None (one device)."""
    if mesh is not None:
        return mesh
    if torch.device(device).type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh(axis)
    return None


def pad_to_multiple(x, multiple: int, axis: int = 0, fill=0):
    """Pad a tensor or numpy array so ``shape[axis]`` is a multiple of
    ``multiple`` (even shards)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = target - n
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                        device=x.device)], axis)
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(x, widths, constant_values=fill)


def run_on_mesh(fn: Callable, items: Sequence, mesh: Mesh) -> list:
    """``fn(item, device)`` for every item, item k on mesh position
    k mod N; one thread per position, each taking its items in order, all
    started together. Returns the results in item order; re-raises the
    first failure. With one position, runs in the calling thread. The
    workers' spans count in the caller's (``spans.bind``)."""
    fn = spans.bind(fn)
    devices = mesh.device_list
    n = len(devices)
    if n == 1:
        return [fn(item, devices[0]) for item in items]
    out = [None] * len(items)
    errors = []

    def worker(pos):
        try:
            for k in range(pos, len(items), n):
                out[k] = fn(items[k], devices[pos])
        except BaseException as e:            # noqa: BLE001 — re-raised
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(p,), daemon=True)
               for p in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out
