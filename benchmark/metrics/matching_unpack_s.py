"""Matching layer: the host work between the matcher's launches, the
seconds of the step's ``compute_matches.matching.match.unpack`` spans (each
pair block's results cut into the per-pair match arrays;
``stats["spans"]``), mean over the unprofiled steps of the run. None where
the program keeps no such span."""


def read(run):
    vals = [s.get("spans", {}).get("compute_matches.matching.match.unpack")
            for s in run["steps"]]
    if not vals or None in vals:
        return None
    return sum(v["s"] for v in vals) / len(vals)
