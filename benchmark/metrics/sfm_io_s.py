"""Step host work of a triangulation step: the seconds of its
``triangulation.inputs`` span (the match files read into tracks) plus its
``triangulation.artifacts`` span (colours, the scene, its files, the
report), from ``stats["spans"]``, mean over the unprofiled steps of the
run. None where the program keeps no such spans."""

NAMES = ("triangulation.inputs", "triangulation.artifacts")


def read(run):
    vals = []
    for s in run["steps"]:
        rows = [s.get("spans", {}).get(n) for n in NAMES]
        if None in rows:
            return None
        vals.append(sum(r["s"] for r in rows))
    return sum(vals) / len(vals) if vals else None
