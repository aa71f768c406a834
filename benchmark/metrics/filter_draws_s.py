"""Filter layer: the host time of the filter's sample draws, the seconds
of the step's ``compute_matches.filter.block.draws`` spans (the recorder's
``stats["spans"]``), mean over the unprofiled steps of the run. None where
the program keeps no such span."""


def read(run):
    vals = [s.get("spans", {}).get("compute_matches.filter.block.draws")
            for s in run["steps"]]
    if not vals or None in vals:
        return None
    return sum(v["s"] for v in vals) / len(vals)
