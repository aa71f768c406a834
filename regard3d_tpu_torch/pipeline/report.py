"""HTML reconstruction and matching reports (pure Python).

Counterpart of ``regard3d_tpu/pipeline/report.py``: OpenMVG's
``Generate_SfM_Report`` role after triangulation (global statistics, a
per-view table, a residual histogram, three orthographic scene snapshots as
inline SVG) and the per-pair match-count tables the reference logs after
matching (src/R3DComputeMatches.cpp:2066-2076)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def _histogram_svg(edges: Sequence[float], counts: Sequence[int],
                   width: int = 640, height: int = 180,
                   x_label: str = "residual (px)") -> str:
    """Inline SVG bar chart (no JS, renders anywhere)."""
    n = len(counts)
    if n == 0:
        return ""
    peak = max(max(counts), 1)
    bw = width / n
    bars = []
    for i, c in enumerate(counts):
        h = (height - 20) * c / peak
        bars.append(
            f'<rect x="{i * bw + 1:.1f}" y="{height - 20 - h:.1f}" '
            f'width="{bw - 2:.1f}" height="{h:.1f}" fill="#668" />')
    ticks = []
    for i in range(0, n + 1, max(n // 8, 1)):
        x = i * bw
        label = f"{edges[i]:.1f}" if i < len(edges) else ""
        ticks.append(f'<text x="{x:.1f}" y="{height - 6}" '
                     f'font-size="10">{label}</text>')
    return (f'<svg width="{width}" height="{height}" '
            f'xmlns="http://www.w3.org/2000/svg">'
            + "".join(bars) + "".join(ticks) +
            f'<text x="{width - 90}" y="{height - 6}" font-size="10">'
            f'{x_label}</text></svg>')


def scene_snapshots_svg(C, R, pose_mask, X, point_mask,
                        colors=None, width: int = 420, height: int = 420,
                        max_points: int = 4000) -> str:
    """Static scene renders for the report — the headless stand-in for the
    reference's interactive OSG viewer (Regard3DModelViewHelper.cpp:40-65):
    three orthographic projections (top / front / side) of the sparse cloud
    with camera frusta, as inline SVG (no JS, no GL).

    C: (V,3) camera centers; R: (V,3,3) world->cam rotations; pose_mask:
    (V,) bool; X: (L,3) points; point_mask: (L,) bool; colors: optional
    (L,3) float [0,1]."""
    import numpy as np

    C = np.asarray(C, np.float64)
    R = np.asarray(R, np.float64)
    pm = np.asarray(pose_mask, bool)
    X = np.asarray(X, np.float64)
    lm = np.asarray(point_mask, bool)
    P = X[lm]
    if len(P) == 0 and not pm.any():
        return ""
    if len(P) > max_points:
        step = len(P) // max_points + 1
        sel = np.arange(0, len(P), step)
        P = P[sel]
        cols = None if colors is None else np.asarray(colors)[lm][sel]
    else:
        cols = None if colors is None else np.asarray(colors)[lm]

    # robust scene bounds from point percentiles + camera centers
    ref_pts = np.concatenate([P, C[pm]]) if pm.any() else P
    lo = np.percentile(ref_pts, 2, axis=0)
    hi = np.percentile(ref_pts, 98, axis=0)
    ctr = 0.5 * (lo + hi)
    scale = float(max((hi - lo).max(), 1e-9))
    frustum = 0.06 * scale

    # camera frusta: 4 corner rays in the camera frame, mapped to world
    # (x_world = C + R^T x_cam), 35 deg half-angle square pyramid
    corners_cam = np.array([[-.6, -.45, 1], [.6, -.45, 1],
                            [.6, .45, 1], [-.6, .45, 1]]) * frustum
    frusta = []
    for v in np.nonzero(pm)[0]:
        apex = C[v]
        base = apex + corners_cam @ R[v]          # R^T applied row-wise
        frusta.append((apex, base))

    def render(axes, label):
        ax, ay = axes
        pad = 18
        span = scale * 1.08

        def to_px(w):
            x = (w[..., ax] - ctr[ax]) / span * (width - 2 * pad) + width / 2
            y = (height / 2
                 - (w[..., ay] - ctr[ay]) / span * (height - 2 * pad))
            return x, y

        px, py = to_px(P)
        inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        dots = []
        for i in np.nonzero(inside)[0]:
            c = "#467"
            if cols is not None:
                rgb = (np.clip(cols[i], 0, 1) * 255).astype(int)
                c = f"rgb({rgb[0]},{rgb[1]},{rgb[2]})"
            dots.append(f'<rect x="{px[i]:.1f}" y="{py[i]:.1f}" '
                        f'width="1.6" height="1.6" fill="{c}"/>')
        lines = []
        for apex, base in frusta:
            axp, ayp = to_px(apex)
            bx, by = to_px(base)
            for j in range(4):
                lines.append(
                    f'<line x1="{axp:.1f}" y1="{ayp:.1f}" x2="{bx[j]:.1f}" '
                    f'y2="{by[j]:.1f}" stroke="#c33" stroke-width="0.8"/>')
                k = (j + 1) % 4
                lines.append(
                    f'<line x1="{bx[j]:.1f}" y1="{by[j]:.1f}" '
                    f'x2="{bx[k]:.1f}" y2="{by[k]:.1f}" stroke="#c33" '
                    f'stroke-width="0.8"/>')
        return (f'<svg width="{width}" height="{height}" '
                f'xmlns="http://www.w3.org/2000/svg" '
                f'style="background:#fafafa;border:1px solid #ccc">'
                + "".join(dots) + "".join(lines)
                + f'<text x="8" y="16" font-size="12" fill="#333">{label}'
                  '</text></svg>')

    panels = [render((0, 2), "top (X-Z)"), render((0, 1), "front (X-Y)"),
              render((2, 1), "side (Z-Y)")]
    return ('<div style="display:flex;gap:8px;flex-wrap:wrap">'
            + "".join(panels) + "</div>")


def write_html_report(path: str, stats: Dict[str, Any], params=None,
                      views: Optional[List[Dict[str, Any]]] = None,
                      histogram: Optional[Tuple[Sequence[float],
                                                Sequence[int]]] = None,
                      snapshots: Optional[str] = None):
    """Reconstruction report.  ``views``: per-view dicts with keys
    id/name/width/height/posed/n_obs/mean_px/median_px; ``histogram``:
    (bin_edges, counts) of live reprojection residuals."""
    param_rows = ""
    if params is not None:
        import dataclasses
        d = (dataclasses.asdict(params)
             if dataclasses.is_dataclass(params) else dict(params))
        param_rows = _kv_table(d)
    stat_rows = _kv_table({k: v for k, v in stats.items()
                           if k != "order_added"})
    view_html = ""
    if views:
        head = ("<tr><th>#</th><th>image</th><th>size</th><th>posed</th>"
                "<th>#obs</th><th>mean px</th><th>median px</th></tr>")
        body = "".join(
            f"<tr><td class=num>{v['id']}</td><td>{v.get('name', '')}</td>"
            f"<td class=num>{v.get('width', '')}x{v.get('height', '')}</td>"
            f"<td>{'yes' if v.get('posed') else 'no'}</td>"
            f"<td class=num>{v.get('n_obs', 0)}</td>"
            f"<td class=num>{_fmt(v.get('mean_px', float('nan')))}</td>"
            f"<td class=num>{_fmt(v.get('median_px', float('nan')))}</td>"
            "</tr>"
            for v in views)
        view_html = f"<h2>Views</h2><table>{head}{body}</table>"
    hist_html = ""
    if histogram is not None:
        edges, counts = histogram
        hist_html = ("<h2>Residual histogram</h2>"
                     + _histogram_svg(list(edges), list(counts)))
    snap_html = ""
    if snapshots:
        snap_html = "<h2>Scene</h2>" + snapshots
    order = stats.get("order_added")
    order_html = ""
    if order:
        order_html = ("<h2>View addition order</h2><p>"
                      + " &rarr; ".join(str(v) for v in order) + "</p>")
    html = f"""<!DOCTYPE html>
<html><head><title>regard3d_tpu reconstruction report</title>
<style>{_STYLE}</style></head><body>
<h1>Reconstruction report</h1>
<h2>Parameters</h2>{param_rows}
<h2>Results</h2>{stat_rows}
{snap_html}
{view_html}
{hist_html}
{order_html}
</body></html>"""
    with open(path, "w") as f:
        f.write(html)


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
