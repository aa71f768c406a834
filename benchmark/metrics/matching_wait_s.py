"""Matching layer: the host's wait on the device in matching, the seconds
of the step's ``compute_matches.matching.match.readback`` spans (the
``.cpu()`` reads of each pair block's results; ``stats["spans"]``), mean
over the unprofiled steps of the run. None where the program keeps no
such span."""


def read(run):
    vals = [s.get("spans", {}).get("compute_matches.matching.match.readback")
            for s in run["steps"]]
    if not vals or None in vals:
        return None
    return sum(v["s"] for v in vals) / len(vals)
