"""Filter layer: the host time of the step's F / E / H filter phase
(``time_filter_s``), mean over the unprofiled steps of the run."""


def read(run):
    vals = [s["time_filter_s"] for s in run["steps"]]
    return sum(vals) / len(vals) if vals else None
