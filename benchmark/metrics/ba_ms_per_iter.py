"""BA: milliseconds per Levenberg-Marquardt iteration, ``ba_s`` over
``ba_iters`` summed over the unprofiled steps, so a faster iteration shows
apart from a change in the number of iterations."""


def read(run):
    s = sum(x["profile"]["ba_s"] for x in run["steps"])
    n = sum(x["profile"]["ba_iters"] for x in run["steps"])
    return 1000.0 * s / n if n else None
