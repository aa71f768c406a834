"""Dense host work: the seconds of a dense step outside its
``densify.sweep`` and ``densify.fusion`` spans (the scene read, source
selection and depth ranges, the photos loaded and prepared, the points
gathered, ``depth_maps.npz`` and ``dense.ply`` written): the step's host
time (``elapsed_s``) less those spans' seconds, mean over the unprofiled
steps of the run. None where the program keeps no such spans."""

NAMES = ("densify.sweep", "densify.fusion")


def read(run):
    vals = []
    for s in run["steps"]:
        rows = [s.get("spans", {}).get(n) for n in NAMES]
        if None in rows or "elapsed_s" not in s:
            return None
        vals.append(s["elapsed_s"] - sum(r["s"] for r in rows))
    return sum(vals) / len(vals) if vals else None
