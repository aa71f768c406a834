"""Reading one profiled step: spans, device intervals, busy time, gaps.

``collect(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA) and
returns its result, the host time of the call and the raw events: the
profiler's ``record_function`` spans as (name, start_ns, end_ns) and every
device operation (kernel, copy, memset) as (start_ns, end_ns, name). The
events stay in memory. Device busy time is the length of the union of the
device intervals, so overlapping operations count once.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Callable, Dict, List, Sequence, Tuple

Span = Tuple[str, int, int]
Op = Tuple[int, int, str]


def collect(fn: Callable, span_prefixes: Sequence[str]) -> Dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        host_s = time.perf_counter() - t0
    spans: List[Span] = []
    ops: List[Op] = []
    prefixes = tuple(span_prefixes)
    cuda = DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == cuda
        if name.startswith(prefixes):
            # the profiler mirrors each span on the device's timeline as an
            # annotation: the host's copy is the span, neither is an op
            if not on_device:
                spans.append((name, e.start_ns(), e.end_ns()))
        elif on_device:
            ops.append((e.start_ns(), e.end_ns(), name))
    return {"result": result, "host_s": host_s, "spans": spans, "ops": ops,
            "read_s": time.perf_counter() - t0 - host_s}


def union_s(intervals) -> float:
    """Length of the union of (start_ns, end_ns) intervals, in seconds."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9


def ops_in(ops: Sequence[Op], spans: Sequence[Span], name: str) -> List[Op]:
    """Device operations that start inside any span called ``name``."""
    wins = sorted((s, e) for n, s, e in spans if n == name)
    starts = [s for s, _ in wins]
    out = []
    for o in ops:
        k = bisect.bisect_right(starts, o[0]) - 1
        if k >= 0 and o[0] <= wins[k][1]:
            out.append(o)
    return out


def top_ops(ops: Sequence[Op], n: int = 10) -> List[list]:
    acc = collections.Counter()
    for s, e, name in ops:
        acc[name[:120]] += (e - s) * 1e-9
    return [[k, v] for k, v in acc.most_common(n)]


def idle_gaps(ops: Sequence[Op], spans: Sequence[Span],
              n: int = 10) -> List[list]:
    """The ``n`` longest gaps between device operations, each named by the
    innermost span the host was in at the gap's middle (``host`` outside
    every span)."""
    merged = []
    for s, e, _ in sorted(ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps.sort(reverse=True)
    out = []
    for length, s, e in gaps[:n]:
        mid = (s + e) // 2
        inside = [(se - ss, nm) for nm, ss, se in spans if ss <= mid <= se]
        out.append([min(inside)[1] if inside else "host", length * 1e-9])
    return out
