"""BA: the host time of every bundle adjustment of the step
(``profile["ba_s"]``, each round ending in a synchronize), mean over the
unprofiled steps of the run."""


def read(run):
    vals = [s["profile"]["ba_s"] for s in run["steps"]]
    return sum(vals) / len(vals) if vals else None
