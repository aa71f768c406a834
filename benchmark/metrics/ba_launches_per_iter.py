"""BA: device operations per Levenberg-Marquardt iteration. The device
operations (kernels, copies, sets) that start inside the profiled step's
``triangulation.ba`` spans, over that step's LM iterations
(``profile["ba_iters"]``, every one of them run inside those spans). None
where the trace holds no device operation or the step ran no iteration."""

from benchmark import trace

SPAN = "triangulation.ba"


def read(run):
    prof = run["profiled"]
    if prof is None or not prof["ops"] \
            or not isinstance(prof["result"], dict):
        return None
    iters = prof["result"].get("profile", {}).get("ba_iters")
    if not iters:
        return None
    return len(trace.ops_in(prof["ops"], prof["spans"], SPAN)) / iters
