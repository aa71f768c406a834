"""Filter layer: device operations per filtered pair. The device
operations (kernels, copies, sets) that start inside the profiled step's
``compute_matches.filter`` span, over that step's count of pairs that
entered a filter block (``stats["spans"]["compute_matches.filter"]
["pairs"]``). None where the program keeps no such counter, or the trace holds no device operation."""

from benchmark import trace

SPAN = "compute_matches.filter"


def read(run):
    prof = run["profiled"]
    if prof is None or not prof["ops"] \
            or not isinstance(prof["result"], dict):
        return None
    pairs = prof["result"].get("spans", {}).get(SPAN, {}).get("pairs")
    if not pairs:
        return None
    return len(trace.ops_in(prof["ops"], prof["spans"], SPAN)) / pairs
