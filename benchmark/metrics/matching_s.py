"""Matching layer: the host time of the step's matching phase
(``time_matching_s``: loading the features, the K1 launches, the ratio
test), mean over the unprofiled steps of the run."""


def read(run):
    vals = [s["time_matching_s"] for s in run["steps"]]
    return sum(vals) / len(vals) if vals else None
