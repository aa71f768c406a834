"""Deterministic segment sums over an observation table.

The reference reduces per-observation quantities into per-camera, per-point
or per-track sums with ``segment_sum`` (a scatter-add). On the card
``index_add_`` uses float atomics, whose order, and so whose rounding,
changes from run to run. The port instead builds, once per id table, either

* a padded gather table ``rows`` (n, cap) of observation indices with a
  0/1 ``mask`` (the reference's ``BALayout``): a reduction is one gather
  and one dense sum over ``cap``; or, when padding would exceed
  ``max_pad_factor`` times the number of rows (one long segment, many
  short ones),
* a sorted-segment table: the stable argsort of the ids and each segment's
  length, reduced by ``torch.segment_reduce``, which sums each segment
  sequentially in one thread.

Both give bit-identical results from run to run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class SegmentTable(NamedTuple):
    n: int                           # number of segments
    rows: Optional[torch.Tensor]     # (n, cap) int64 observation indices
    mask: Optional[torch.Tensor]     # (n, cap) float, 1 for live slots
    order: Optional[torch.Tensor]    # (O,) int64 stable argsort of the ids
    lengths: Optional[torch.Tensor]  # (n,) int64 segment lengths


def make_table(ids, n: int, device="cpu",
               max_pad_factor: float = 4.0) -> SegmentTable:
    """Table for reducing rows with segment ids ``ids`` (O,) into ``n``
    segments. Built on the host."""
    ids = np.asarray(ids, np.int64)
    counts = np.bincount(ids, minlength=n)
    order = np.argsort(ids, kind="stable")
    cap = max(int(counts.max()) if len(counts) else 1, 1)
    if cap * n <= max_pad_factor * max(len(ids), 1):
        rows = np.zeros((n, cap), np.int64)
        mask = np.zeros((n, cap), np.float32)
        sorted_ids = ids[order]
        starts = np.searchsorted(sorted_ids, np.arange(n))
        pos = np.arange(len(ids)) - starts[sorted_ids]
        rows[sorted_ids, pos] = order
        mask[sorted_ids, pos] = 1.0
        return SegmentTable(n, torch.as_tensor(rows, device=device),
                            torch.as_tensor(mask, device=device),
                            None, None)
    return SegmentTable(n, None, None, torch.as_tensor(order, device=device),
                        torch.as_tensor(counts, device=device))


def segment_sum(per_obs: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """sum over the rows of each segment: per_obs (O, ...) -> (n, ...)."""
    if table.rows is not None:
        g = per_obs[table.rows]                              # (n, cap, ...)
        m = table.mask.to(per_obs.dtype).reshape(
            table.mask.shape + (1,) * (per_obs.dim() - 1))
        return torch.sum(g * m, dim=1)
    return torch.segment_reduce(per_obs[table.order], "sum",
                                lengths=table.lengths, axis=0)
