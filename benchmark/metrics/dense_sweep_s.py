"""Plane sweep: the host time of the dense step's ``densify.sweep`` spans
(one a view, each ending in the depth map's read back), from the port's
``stats["spans"]``, mean over the unprofiled steps of the run. None where
the program keeps no such span."""


def read(run):
    vals = [s.get("spans", {}).get("densify.sweep") for s in run["steps"]]
    if not vals or None in vals:
        return None
    return sum(v["s"] for v in vals) / len(vals)
