"""Fusion: the host time of the dense step's ``densify.fusion`` spans (one
a view: the cross-view consistency check and the normals, read back), from
the port's ``stats["spans"]``, mean over the unprofiled steps of the run.
None where the program keeps no such span."""


def read(run):
    vals = [s.get("spans", {}).get("densify.fusion") for s in run["steps"]]
    if not vals or None in vals:
        return None
    return sum(v["s"] for v in vals) / len(vals)
