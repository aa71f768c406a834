"""Incremental engine: the MaxPair initializer's host time
(``profile["init_s"]``), mean over the unprofiled steps of the run."""


def read(run):
    vals = [s["profile"]["init_s"] for s in run["steps"]]
    return sum(vals) / len(vals) if vals else None
