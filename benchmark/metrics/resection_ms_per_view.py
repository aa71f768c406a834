"""Incremental engine: milliseconds of resection per view tried,
``profile["resection_s"]`` over the ``views`` counter of the
``triangulation.resection`` spans (the views of every group the engine
tried; ``stats["spans"]``), summed over the unprofiled steps, so a faster
resection shows apart from a change in the rounds or the group sizes. None
where the program keeps no such counter."""


def read(run):
    s = n = 0
    for x in run["steps"]:
        row = x.get("spans", {}).get("triangulation.resection")
        if row is None or "views" not in row:
            return None
        s += x["profile"]["resection_s"]
        n += row["views"]
    return 1000.0 * s / n if n else None
