"""Filter layer: the share of the filter phase in which the device is
idle, in percent. Busy time is the union of the device operations that
start inside the profiled step's ``compute_matches.filter`` span; the
phase's time is the mean ``time_filter_s`` of the unprofiled steps, so the
profiler's own cost stays out of it."""

from benchmark import trace


def read(run):
    prof = run["profiled"]
    vals = [s["time_filter_s"] for s in run["steps"]]
    if prof is None or not vals:
        return None
    ops = trace.ops_in(prof["ops"], prof["spans"], "compute_matches.filter")
    if not ops:
        return None
    busy = trace.union_s([(s, e) for s, e, _ in ops])
    return 100.0 * (1.0 - busy / (sum(vals) / len(vals)))
