"""Spans and counters: the one recorder of the port's host work.

``span(name, **counters)`` is a profiler span (``record_function``, so a
device trace shows it under ``name``) that also times its body on the
host with ``time.perf_counter_ns``; its ``.seconds`` reads the time so far
while it is open and its whole time after. ``count(key, n)`` adds to the
innermost span open in the calling thread.

Inside ``collect()`` every span that closes adds to the step's summary::

    {name: {"n": calls, "s": seconds, "self_s": seconds less those of its
            child spans in the same thread, <counter>: total, ...}}

A ``collect()`` opened while another is open feeds the open one. A name
that starts with ``.`` extends the innermost open span's name
(``span(".trial")`` inside ``triangulation.ba`` is
``triangulation.ba.trial``), so code shared by several callers is named by
the caller. Each thread keeps its own stack of open spans; ``bind(fn)``
carries the caller's collector and innermost name into a worker thread
(``dist/mesh.run_on_mesh`` binds its workers), and the summary is merged
under a lock.

``timeline()`` keeps every span that closes while it is open as (name,
start_ns, end_ns, thread id), stamped with ``time.time_ns``, the clock the
profiler stamps its own events with; ``add_to_trace`` writes them into the
profiler's Chrome trace (``r3d --profile``). Open no span inside a loop
over pairs, rows or iterations of an inner solver: a span costs ~10 us
with no profiler running.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from torch.profiler import record_function

Event = Tuple[str, int, int, int]

_LOCK = threading.Lock()
_TLS = threading.local()
_TIMELINE: Optional[List[Event]] = None


def _local():
    t = _TLS
    if not hasattr(t, "stack"):
        t.stack, t.collector, t.base = [], None, None
    return t


class Collector:
    """One step's aggregate per span name."""

    def __init__(self):
        self._agg: Dict[str, Dict] = {}

    def _row(self, name: str) -> Dict:
        row = self._agg.get(name)
        if row is None:
            row = self._agg[name] = {"n": 0, "s": 0.0, "self_s": 0.0}
        return row

    def add(self, name: str, seconds: float, self_s: float,
            counters: Dict):
        with _LOCK:
            row = self._row(name)
            row["n"] += 1
            row["s"] += seconds
            row["self_s"] += self_s
            for k, v in counters.items():
                row[k] = row.get(k, 0) + v

    def add_count(self, name: str, key: str, n):
        with _LOCK:
            row = self._row(name)
            row[key] = row.get(key, 0) + n

    def summary(self) -> Dict[str, Dict]:
        with _LOCK:
            return {k: dict(v) for k, v in sorted(self._agg.items())}


class span:
    """Context manager: a named, timed, counted span (module docstring)."""

    __slots__ = ("name", "counters", "child_s", "_rf", "_t0", "_t1", "_w0")

    def __init__(self, name: str, **counters):
        self.name = name
        self.counters = counters
        self._t1 = None

    def __enter__(self) -> "span":
        t = _local()
        if self.name.startswith("."):
            parent = t.stack[-1].name if t.stack else t.base
            self.name = parent + self.name if parent else self.name[1:]
        self._rf = record_function(self.name)
        self._rf.__enter__()          # the profiler stamps its event here
        self._w0 = time.time_ns() if _TIMELINE is not None else None
        self.child_s = 0.0
        t.stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._t1 = time.perf_counter_ns()
        line = _TIMELINE
        if line is not None and self._w0 is not None:
            line.append((self.name, self._w0, time.time_ns(),
                         threading.get_native_id()))
        t = _local()
        t.stack.pop()
        s = self.seconds
        if t.stack:
            t.stack[-1].child_s += s
        if t.collector is not None:
            t.collector.add(self.name, s, s - self.child_s, self.counters)
        self._rf.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        end = self._t1 if self._t1 is not None else time.perf_counter_ns()
        return (end - self._t0) * 1e-9


def count(key: str, n=1):
    """Add ``n`` to counter ``key`` of the innermost span open in this
    thread (in a bound worker with none open: of the caller's span)."""
    t = _local()
    if t.stack:
        c = t.stack[-1].counters
        c[key] = c.get(key, 0) + n
    elif t.base is not None and t.collector is not None:
        t.collector.add_count(t.base, key, n)


@contextlib.contextmanager
def collect() -> Iterator[Collector]:
    """A step's collector: its ``summary()`` is the step's
    ``stats["spans"]``. Inside an open one, that one."""
    t = _local()
    if t.collector is not None:
        yield t.collector
        return
    t.collector = Collector()
    try:
        yield t.collector
    finally:
        t.collector = None


def bind(fn):
    """``fn`` run in another thread as if in this one: its spans feed this
    thread's collector and its relative names extend this thread's
    innermost open span."""
    t = _local()
    coll = t.collector
    base = t.stack[-1].name if t.stack else t.base

    def bound(*args, **kwargs):
        w = _local()
        saved = (w.collector, w.base)
        w.collector, w.base = coll, base
        try:
            return fn(*args, **kwargs)
        finally:
            w.collector, w.base = saved
    return bound


@contextlib.contextmanager
def timeline() -> Iterator[List[Event]]:
    """Every span that closes while this is open, on the profiler's clock.
    Enter it before the profiler: it pays ``record_function``'s first call
    (~0.3 ms, before the profiler's stamp) where no span is timed."""
    global _TIMELINE
    with record_function("spans.timeline"):
        pass
    _TIMELINE = out = []
    try:
        yield out
    finally:
        _TIMELINE = None


HOST_SPANS_TID = 1 << 30      # the host-spans tracks' thread ids
_TRACE_END = re.compile(rb'\s*(,\s*"traceName"\s*:\s*"[^"]*"\s*)?\}\s*')


def add_to_trace(path: str, line: List[Event]) -> str:
    """Write ``line`` (``timeline()``'s spans) into the Chrome trace at
    ``path``: a complete event each (``cat`` ``host_span``), on the trace's
    own time base (microseconds after its ``baseTimeNanoseconds``), on a
    "host spans" track per thread. The events go in at the end of
    ``traceEvents`` in place: a card's trace runs to a gigabyte, which a
    JSON round trip takes ~90 s to rewrite. Where the file is not laid out
    as the profiler writes it (the base in its first 64 KiB, the file
    ending in the list's ``]``, at most its ``"traceName"`` and the closing
    ``}``), they go to ``host_spans.json`` beside it instead, on the same
    time base where the base was found. Returns the path written."""
    with open(path, "r+b") as fh:
        found = re.search(rb'"baseTimeNanoseconds":\s*(\d+)',
                          fh.read(1 << 16))
        base = int(found.group(1)) if found else 0
        pid, tids, events = os.getpid(), {}, []
        for name, start, stop, thread in line:
            if thread not in tids:
                tids[thread] = HOST_SPANS_TID + len(tids)
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tids[thread], "args": {
                                   "name": f"host spans (thread {thread})"}})
            events.append({"ph": "X", "cat": "host_span", "name": name,
                           "pid": pid, "tid": tids[thread],
                           "ts": (start - base) / 1e3,
                           "dur": (stop - start) / 1e3})
        size = fh.seek(0, os.SEEK_END)
        at = fh.seek(max(0, size - 4096))
        tail = fh.read()
        end = tail.rfind(b"]")
        before = tail[:end].rstrip()
        if found and end >= 0 and before.endswith((b"}", b"[")) \
                and _TRACE_END.fullmatch(tail[end + 1:]):
            if events:
                fh.seek(at + end)
                fh.write((b"" if before.endswith(b"[") else b",")
                         + b",".join(json.dumps(e).encode() for e in events)
                         + tail[end:])
            return path
    aside = os.path.join(os.path.dirname(path), "host_spans.json")
    with open(aside, "w") as fh:
        json.dump({"baseTimeNanoseconds": base, "traceEvents": events}, fh)
    return aside
