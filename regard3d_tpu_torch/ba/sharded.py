"""Distributed bundle adjustment over devices or processes.

Counterpart of ``regard3d_tpu/ba/sharded.py`` (P6 in SURVEY.md §2.3, the
replacement for Ceres' multithreaded sparse BA): the math of ``ba/lm.py``,
whose reduction hooks sum over the shards instead of a ``psum``. Two
shardings:

* ``bundle_adjust_sharded`` — **observation-sharded**: the observation
  table is split evenly over the ranks of a ``torch.distributed`` group,
  all parameters replicated; every reduction is an ``all_reduce``,
  including the (L,3) per-point sums of every CG step, so its traffic
  grows with the landmarks.
* ``bundle_adjust_point_sharded`` — **point-block-sharded**, over the
  devices of a ``Mesh`` in one process: landmarks are partitioned and every
  observation row lives with its landmark, so V-blocks, W^T x and the
  back-substitution are shard-local and only the reduced camera system is
  summed — (V,6,6)+(K,9,9)+(V,6)+(K,9) per linearization, (V,6)+(K,9) per
  CG step, whatever the landmark count.

In one process each mesh position runs the whole LM loop in a thread of its
own; a reduction waits for every position and each sums the shards' tensors
in position order on its own device (``LocalReduce``), so every shard holds
the same bits and takes the same steps, and a repeat gives the same bits.
Across processes the ranks do the same through ``all_reduce``. Results
match ``lm.bundle_adjust`` up to the order of the sums.
"""

from __future__ import annotations

import threading
from typing import Callable, List, NamedTuple, Optional

import numpy as onp
import torch
import torch.distributed as dist

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.ba import lm
from regard3d_tpu_torch.core.segments import SegmentTable
from regard3d_tpu_torch.dist import launch
from regard3d_tpu_torch.dist import mesh as meshlib


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

class LocalReduce:
    """Sum over the N positions of a mesh in one process. Position p's
    thread hands in its tensors, waits for the others, and sums all N in
    position order on its own device; a second wait keeps the slots until
    every position has read them."""

    def __init__(self, n: int):
        self.n = n
        self.slots: List = [None] * n
        self.barrier = threading.Barrier(n, timeout=launch.timeout_s())

    def hook(self, pos: int, device) -> lm.Reduce:
        def reduce(tensors, site):
            self.slots[pos] = tensors
            self.barrier.wait()
            out = []
            for k in range(len(tensors)):
                acc = self.slots[0][k].to(device)
                for r in range(1, self.n):
                    acc = acc + self.slots[r][k].to(device)
                out.append(acc)
            self.barrier.wait()
            return tuple(out)
        return reduce

    def abort(self):
        self.barrier.abort()


def group_reduce(group=None) -> lm.Reduce:
    """Sum over the ranks of a process group: the tuple flattened into one
    buffer, one ``all_reduce`` a call."""
    def reduce(tensors, site):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=group)
        out, o = [], 0
        for t in tensors:
            out.append(flat[o:o + t.numel()].view_as(t))
            o += t.numel()
        return tuple(out)
    return reduce


class _Shard(NamedTuple):
    """One shard's problem on its device."""
    state: lm.BAState
    obs: lm.BAObservations
    layout: lm.BALayout
    fixed: torch.Tensor
    intr_mask: torch.Tensor
    prior: Optional[torch.Tensor]


def _run_local(mesh: meshlib.Mesh, shards: List[_Shard],
               body: Callable) -> list:
    """``body(d, shard, reduce)`` for every shard, shard d in a thread on
    mesh position d, its reductions summed across the shards."""
    red = LocalReduce(len(shards))

    def run(d, dev):
        try:
            return body(d, shards[d], red.hook(d, dev))
        except BaseException:
            red.abort()            # no shard waits for a dead one
            raise
    return meshlib.run_on_mesh(run, list(range(len(shards))), mesh)


def _on(dev, x):
    return None if x is None else x.to(dev)


def _layout_to(layout: lm.BALayout, dev) -> lm.BALayout:
    return lm.BALayout(*(SegmentTable(t.n, *(_on(dev, a) for a in t[1:]))
                         for t in layout))


def _common(state, obs, opts, fixed_pose_mask):
    V, K = state.R.shape[0], state.intr.shape[0]
    if fixed_pose_mask is None:
        fixed_pose_mask = torch.zeros((V,), dtype=torch.bool)
    intr_mask = lm.intr_mask_of(lm._to(obs, "cpu"), K, opts.refine_intrinsics)
    return V, K, fixed_pose_mask.cpu(), intr_mask


# ---------------------------------------------------------------------------
# Observation sharding
# ---------------------------------------------------------------------------

def shard_observations(obs: lm.BAObservations,
                       n_shards: int) -> lm.BAObservations:
    """Pad the observation table to a multiple of ``n_shards`` rows; the
    padding rows have weight 0 (shard d takes the d-th equal block)."""
    return lm.BAObservations(*(meshlib.pad_to_multiple(a, n_shards)
                               for a in obs))


def _obs_shards(state, obs, opts, fixed_pose_mask, prior, devices,
                ranks=None) -> List[_Shard]:
    """The shards of ``ranks`` (default all) of an ``len(devices)``-way
    observation split, shard d on ``devices[d]``."""
    _, _, fixed, intr_mask = _common(state, obs, opts, fixed_pose_mask)
    n = len(devices)
    obs_p = shard_observations(lm._to(obs, "cpu"), n)
    rows = obs_p.view_id.shape[0] // n
    out = []
    for d in (range(n) if ranks is None else ranks):
        dev = devices[d]
        ob = lm.BAObservations(*(a[d * rows:(d + 1) * rows].to(dev)
                                 for a in obs_p))
        st = lm._to(state, dev)
        lay = lm.make_layout(ob, st.R.shape[0], st.X.shape[0],
                             st.intr.shape[0])
        out.append(_Shard(st, ob, lay, fixed.to(dev), intr_mask.to(dev),
                          _on(dev, prior)))
    return out


def bundle_adjust_sharded(state: lm.BAState, obs: lm.BAObservations,
                          group=None,
                          opts: lm.BAOptions = lm.BAOptions(),
                          fixed_pose_mask: Optional[torch.Tensor] = None,
                          center_prior: Optional[torch.Tensor] = None,
                          device=None):
    """LM bundle adjustment with the observation table sharded over the
    ranks of the ``torch.distributed`` process group ``group`` (None: the
    default group). Every rank calls this with the same inputs and runs on
    ``device`` (default cuda). Semantics of ``lm.bundle_adjust``, up to the
    order of the sums. Returns (state, BAStats), the same on every rank."""
    dev = runtime.resolve_device(device)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    sh, = _obs_shards(state, obs, opts, fixed_pose_mask, center_prior,
                      [dev] * n, ranks=[rank])
    red = group_reduce(group)
    return lm.lm_loop(sh.state, sh.obs, opts, sh.fixed, sh.intr_mask,
                      sh.prior, sh.layout, red, red)


# ---------------------------------------------------------------------------
# Point-block sharding
# ---------------------------------------------------------------------------

class PointPartition(NamedTuple):
    """Host-side plan placing each landmark (and all of its observation
    rows) on exactly one shard."""
    obs: lm.BAObservations     # (N*Omax,) rows grouped by shard, 0-padded;
                               # point_id is the LOCAL index within a shard
    X: torch.Tensor            # (N*Lloc, 3) points grouped by shard, padded
    global_of_slot: onp.ndarray  # (N*Lloc,) int64 global pid, -1 = padding
    n_dev: int
    Lloc: int                  # points per shard (padded)
    Omax: int                  # observation rows per shard (padded)
    L: int                     # original landmark count
    layout: Optional[List[lm.BALayout]]  # one per shard, or None


def _snake_assign(order: onp.ndarray, n_dev: int) -> onp.ndarray:
    """Boustrophedon round-robin: 0..N-1, N-1..0, ... — balances a
    count-sorted list across shards to within one item's weight."""
    n = len(order)
    pat = onp.concatenate([onp.arange(n_dev), onp.arange(n_dev)[::-1]])
    dev = onp.empty(n, onp.int32)
    dev[order] = pat[onp.arange(n) % (2 * n_dev)]
    return dev


def _segment_positions(sorted_ids: onp.ndarray, n_seg: int) -> onp.ndarray:
    """Position of each element within its (sorted) segment."""
    starts = onp.searchsorted(sorted_ids, onp.arange(n_seg))
    return onp.arange(len(sorted_ids)) - starts[sorted_ids]


def _stacked_layout(obs_p: lm.BAObservations, Od: onp.ndarray, V: int,
                    K: int, Lloc: int, Omax: int,
                    devices) -> List[lm.BALayout]:
    """One port ``BALayout`` per shard over its live rows, which occupy its
    first ``Od[d]`` local rows (the reference stacks device-uniform tables
    and falls back to ``segment_sum`` when their padding is too large; the
    port's tables fall back to sorted segments per shard)."""
    out = []
    for d, dev in enumerate(devices):
        live = slice(d * Omax, d * Omax + int(Od[d]))
        ob = lm.BAObservations(*(a[live].to(dev) for a in obs_p))
        out.append(lm.make_layout(ob, V, Lloc, K))
    return out


def partition_by_point(obs: lm.BAObservations, X, n_dev: int,
                       build_layout: bool = True,
                       num_cams: Optional[int] = None,
                       num_intrinsics: Optional[int] = None,
                       devices=None) -> PointPartition:
    """Partition landmarks across ``n_dev`` shards (balanced by observation
    count via snake round-robin) and group the observation table so each
    shard's rows reference only its own landmark block. The arrays equal
    the reference's; the layouts are built on ``devices`` (default cpu)."""
    pid = obs.point_id.cpu().numpy()
    Xn = torch.as_tensor(X).cpu().numpy()
    L = int(Xn.shape[0])
    counts = onp.bincount(pid, minlength=L)
    dev_of_point = _snake_assign(onp.argsort(-counts, kind="stable"), n_dev)

    # local slot of each point within its shard
    p_order = onp.argsort(dev_of_point, kind="stable")
    Ld = onp.bincount(dev_of_point, minlength=n_dev)
    Lloc = max(int(Ld.max()), 1)
    local_of_point = onp.empty(L, onp.int64)
    local_of_point[p_order] = _segment_positions(dev_of_point[p_order], n_dev)
    global_of_slot = onp.full(n_dev * Lloc, -1, onp.int64)
    global_of_slot[dev_of_point.astype(onp.int64) * Lloc
                   + local_of_point] = onp.arange(L)

    Xp = onp.zeros((n_dev * Lloc, 3), Xn.dtype)
    live = global_of_slot >= 0
    Xp[live] = Xn[global_of_slot[live]]

    # observations follow their point's shard
    dev_of_obs = dev_of_point[pid]
    Od = onp.bincount(dev_of_obs, minlength=n_dev)
    Omax = max(int(Od.max()), 1)
    o_order = onp.argsort(dev_of_obs, kind="stable")
    o_pos = _segment_positions(dev_of_obs[o_order], n_dev)
    slot = dev_of_obs[o_order].astype(onp.int64) * Omax + o_pos

    def place(arr, fill=0):
        a = torch.as_tensor(arr).cpu().numpy()
        out = onp.full((n_dev * Omax,) + a.shape[1:], fill, a.dtype)
        out[slot] = a[o_order]
        return torch.as_tensor(out)

    obs_p = lm.BAObservations(
        view_id=place(obs.view_id),
        intr_id=place(obs.intr_id),
        point_id=place(local_of_point[pid]),
        model=place(obs.model),
        xy=place(obs.xy),
        weight=place(obs.weight))          # padding rows get weight 0

    layout = None
    if build_layout:
        V = num_cams or int(obs.view_id.max()) + 1
        K = num_intrinsics or int(obs.intr_id.max()) + 1
        layout = _stacked_layout(obs_p, Od, V, K, Lloc, Omax,
                                 devices or ["cpu"] * n_dev)
    return PointPartition(obs_p, torch.as_tensor(Xp), global_of_slot,
                          n_dev, Lloc, Omax, L, layout)


def _point_shards(state, obs, mesh, opts, fixed_pose_mask, center_prior,
                  partition):
    V, K, fixed, intr_mask = _common(state, obs, opts, fixed_pose_mask)
    devs = mesh.device_list
    if partition is None:
        partition = partition_by_point(lm._to(obs, "cpu"), state.X,
                                       len(devs), num_cams=V,
                                       num_intrinsics=K, devices=devs)
    shards = []
    for d, dev in enumerate(devs):
        rows = slice(d * partition.Omax, (d + 1) * partition.Omax)
        ob = lm.BAObservations(*(a[rows].to(dev) for a in partition.obs))
        lay = (_layout_to(partition.layout[d], dev) if partition.layout
               else lm.make_layout(ob, V, partition.Lloc, K))
        st = lm.BAState(state.R.to(dev), state.C.to(dev),
                        state.intr.to(dev), partition.X[
                            d * partition.Lloc:(d + 1) * partition.Lloc]
                        .to(dev))
        shards.append(_Shard(st, ob, lay, fixed.to(dev), intr_mask.to(dev),
                             _on(dev, center_prior)))
    return shards, partition


def bundle_adjust_point_sharded(
        state: lm.BAState, obs: lm.BAObservations, mesh: meshlib.Mesh,
        opts: lm.BAOptions = lm.BAOptions(),
        fixed_pose_mask: Optional[torch.Tensor] = None,
        center_prior: Optional[torch.Tensor] = None,
        partition: Optional[PointPartition] = None):
    """LM bundle adjustment with landmarks block-sharded over the devices
    of ``mesh`` (a device may repeat), in this process.

    The only reductions are the camera system's, so traffic per CG step is
    (V,6)+(K,9) whatever the landmark count. Results match
    ``lm.bundle_adjust`` up to the order of the sums; points come back in
    the caller's numbering, the state on the mesh's first device."""
    shards, part = _point_shards(state, obs, mesh, opts, fixed_pose_mask,
                                 center_prior, partition)
    outs = _run_local(mesh, shards, lambda d, sh, red: lm.lm_loop(
        sh.state, sh.obs, opts, sh.fixed, sh.intr_mask, sh.prior, sh.layout,
        red, lm.identity_reduce))

    # un-permute the landmark blocks back to the caller's point numbering
    Xp = torch.cat([o[0].X.cpu() for o in outs])
    Xout = state.X.detach().cpu().clone()
    live = part.global_of_slot >= 0
    Xout[torch.as_tensor(part.global_of_slot[live])] = Xp[
        torch.as_tensor(live)]
    st0 = outs[0][0]
    return (lm.BAState(st0.R, st0.C, st0.intr, Xout.to(st0.R.device)),
            outs[0][1])
