"""Features layer: the host time of writing the ``.feat`` / ``.desc``
files, the seconds of the step's ``compute_matches.features.write`` spans
(``stats["spans"]``), mean over the unprofiled steps of the run. None where
the program keeps no such span."""


def read(run):
    vals = [s.get("spans", {}).get("compute_matches.features.write")
            for s in run["steps"]]
    if not vals or None in vals:
        return None
    return sum(v["s"] for v in vals) / len(vals)
