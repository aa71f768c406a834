"""Device: the share of a compute-matches step in which the device is
idle, in percent: 1 - the union of all device operations of the profiled
step / the mean host time of the unprofiled steps (``elapsed_s``)."""

from benchmark import trace


def read(run):
    prof = run["profiled"]
    vals = [s["elapsed_s"] for s in run["steps"]]
    if prof is None or not vals or not prof["ops"]:
        return None
    busy = trace.union_s([(s, e) for s, e, _ in prof["ops"]])
    return 100.0 * (1.0 - busy / (sum(vals) / len(vals)))
