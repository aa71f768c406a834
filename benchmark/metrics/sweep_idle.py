"""Plane sweep: the share of the sweep in which the device is idle, in
percent. Busy time is the union of the device operations that start inside
the profiled step's ``densify.sweep`` spans; the sweep's time is the mean
of the unprofiled steps' ``densify.sweep`` seconds, so the profiler's own
cost stays out of it."""

from benchmark import trace


def read(run):
    prof = run["profiled"]
    vals = [s.get("spans", {}).get("densify.sweep") for s in run["steps"]]
    if prof is None or not vals or None in vals:
        return None
    ops = trace.ops_in(prof["ops"], prof["spans"], "densify.sweep")
    if not ops:
        return None
    busy = trace.union_s([(s, e) for s, e, _ in ops])
    return 100.0 * (1.0 - busy / (sum(v["s"] for v in vals) / len(vals)))
