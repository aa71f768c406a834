"""HTML matching report (pure Python).

Counterpart of ``write_matches_report`` and its helpers in
``regard3d_tpu/pipeline/report.py``: the per-pair match-count tables the
reference logs after matching (src/R3DComputeMatches.cpp:2066-2076). The
reconstruction report arrives with the SfM slice."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

_STYLE = """
body { font-family: sans-serif; margin: 2em; }
table { border-collapse: collapse; margin-bottom: 1.5em; }
td, th { border: 1px solid #ccc; padding: 4px 10px; }
th { background: #eef; text-align: left; }
h2 { color: #336; }
.num { text-align: right; }
"""


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def _kv_table(d: Dict[str, Any]) -> str:
    rows = "".join(f"<tr><td>{k}</td><td class=num>{_fmt(v)}</td></tr>"
                   for k, v in sorted(d.items()))
    return f"<table>{rows}</table>"


def write_matches_report(path: str, stats: Dict[str, Any],
                         pair_rows: List[Dict[str, Any]],
                         keypoint_counts: Optional[Sequence[int]] = None,
                         image_names: Optional[Sequence[str]] = None):
    """Matching report: global stats + per-pair putative/geometric counts
    + per-image keypoint counts."""
    stat_rows = _kv_table(stats)
    kp_html = ""
    if keypoint_counts is not None:
        head = "<tr><th>#</th><th>image</th><th>keypoints</th></tr>"
        body = "".join(
            f"<tr><td class=num>{i}</td>"
            f"<td>{image_names[i] if image_names else ''}</td>"
            f"<td class=num>{c}</td></tr>"
            for i, c in enumerate(keypoint_counts))
        kp_html = f"<h2>Keypoints</h2><table>{head}{body}</table>"
    head = ("<tr><th>i</th><th>j</th><th>putative</th><th>geometric</th>"
            "<th>survival</th></tr>")
    body = "".join(
        f"<tr><td class=num>{r['i']}</td><td class=num>{r['j']}</td>"
        f"<td class=num>{r['putative']}</td>"
        f"<td class=num>{r['geometric']}</td>"
        f"<td class=num>{r['survival']:.2f}</td></tr>"
        for r in pair_rows)
    html = f"""<!DOCTYPE html>
<html><head><title>regard3d_tpu matching report</title>
<style>{_STYLE}</style></head><body>
<h1>Matching report</h1>
<h2>Statistics</h2>{stat_rows}
{kp_html}
<h2>Pairs</h2><table>{head}{body}</table>
</body></html>"""
    with open(path, "w") as f:
        f.write(html)
