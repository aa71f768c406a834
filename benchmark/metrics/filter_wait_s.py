"""Filter layer: the host's wait on the device in the filter, the seconds
of the step's ``compute_matches.filter.block.readback`` spans (the
``.cpu()`` reads of each block's results; ``stats["spans"]``), mean over
the unprofiled steps of the run. None where the program keeps no such
span."""


def read(run):
    vals = [s.get("spans", {}).get("compute_matches.filter.block.readback")
            for s in run["steps"]]
    if not vals or None in vals:
        return None
    return sum(v["s"] for v in vals) / len(vals)
