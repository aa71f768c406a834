"""Features layer: the host time of the step's features phase
(``time_features_s``, which ends in a device synchronize), mean over the
unprofiled steps of the run."""


def read(run):
    vals = [s["time_features_s"] for s in run["steps"]]
    return sum(vals) / len(vals) if vals else None
