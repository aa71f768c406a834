"""Step kind ``dense``: one dense step of the port, as ``r3d densify
--method tpu`` runs it (scene and photos -> per-view source selection ->
plane-sweep depth maps -> cross-view fusion -> ``depth_maps.npz`` and
``dense.ply``), on every posed view of the configuration.

Set-up makes the input a user has at this point: the sfm kind's set-up
(one compute-matches step on the views), one triangulation step written
into a project store as the command line lays it out, and the views
written as 8-bit PNG photos the project's picture set names. The window
drives the project-store entry point the command line dispatches to
(``mvs.driver.run_native_densification``) with the traffic's settings, each
step into a fresh directory, under the port's span collector. A step fails
if it raises, leaves an artifact missing or unreadable, leaves a posed view
without a depth map, or puts fewer than ``cloud_gate`` of its points within
``cloud_tol`` of the scene's extent of a plane. Its artifacts are judged
against ``reference/dense_ref.py`` (the scene's exact planes) and
``reference/frozen/`` (a float64 copy of the port's sweep and of what it
derives before it sweeps):

* ``depth_out``: share of accepted depth-map pixels (NCC at least the
  threshold), every view, whose inverse depth in the truth frame lies more
  than one plane spacing from the exact one along the step's own ray;
* ``depth_median_planes``: the median of that error, in plane spacings;
* ``cloud_out``: share of the cloud's points farther than ``cloud_tol`` of
  the extent from every plane (accuracy);
* ``cloud_uncovered``: share of exact surface samples (every
  ``coverage_stride``-th pixel of every view at the sweep's level, seen by
  at least ``min_image_num`` views) with no point of the cloud within
  ``cloud_tol`` of the extent (completeness);
* ``sweep_diff``: over ``sample_views`` views drawn from the seed,
  re-swept by the float64 copy on the step's own inputs, the share of the
  pixels either side accepts where only one does, or both do and their
  inverse depths differ by more than a quarter of a plane spacing;
* ``fusion_diff``: over every view, the share of the pixels of the fusion
  grid that the cloud and the float64 copy of the fusion, run on the step's
  own depth maps, do not both keep (each point of the cloud is traced back
  to the pixel whose ray and inverse depth it lies on); a point traced to
  no pixel, or to a pixel another point holds, counts as a difference.

The first four hold the step to the scene, whatever its code; the last two
follow the port's own sweep and fusion and catch a drift in precision or
work left out (a view's points missing from the cloud).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import time
import zipfile
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import dense_ref as ref
from benchmark.reference import tf32
from benchmark.reference.frozen import densify as fz
from benchmark.reference.frozen import fusion as ffu
from benchmark.reference.frozen import planesweep as fps
from benchmark.steps import sfm as sfm_step

SPANS = ("densify.",)
NAMES = ("depth_out", "depth_median_planes", "cloud_out", "cloud_uncovered",
         "sweep_diff", "fusion_diff")
REF_CHUNK = 4                # planes the reference sweeps at a time
TRACE_PX = 0.01              # a point's pixel: this close to a grid pixel
TRACE_RTOL = 1e-5            # and its inverse depth this close to the map's


def write_photos(images, folder: str) -> List[str]:
    """The views as 8-bit gray PNGs, as a user's photos sit on disk."""
    from PIL import Image
    os.makedirs(folder, exist_ok=True)
    paths = []
    for k, im in enumerate(images):
        path = os.path.join(folder, f"view{k:03d}.png")
        px = np.clip(np.rint(np.asarray(im, np.float64) * 255.0), 0, 255)
        Image.fromarray(px.astype(np.uint8)).save(path, compress_level=1)
        paths.append(path)
    return paths


def read_photo(path: str) -> np.ndarray:
    """(H, W, 3) uint8: a photo as the reference reads it."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def setup(cell) -> Dict:
    from regard3d_tpu_torch.mvs import driver
    from regard3d_tpu_torch.pipeline.project import Project
    tri = sfm_step.setup(dataclasses.replace(cell, traffic={"warm_steps": 0}))
    proj = Project.create(os.path.join(cell.work, "project"))
    photos = write_photos(cell.scene["images"],
                          os.path.join(cell.work, "photos"))
    w, h = cell.scene["size"]
    ps = proj.add_picture_set("photos", photos)
    ps.params["image_info"] = [{"path": p, "width": w, "height": h}
                               for p in photos]
    t_obj = proj.add_triangulation(proj.add_compute_matches(ps.id).id)
    out = proj.prepare(t_obj.id)
    stats = sfm_step.run(tri, out)
    err, _ = sfm_step.check(tri, out, stats)
    if err is not None:
        raise RuntimeError(f"the triangulation the dense step starts "
                           f"from: {err}")
    proj.finish(t_obj.id, {}, 0.0)
    sfm_step.release(tri)
    del tri
    with np.load(proj.paths(t_obj.id).scene_npz) as z:
        scene_npz = {k: z[k] for k in z.files}
    state = {"cell": cell, "driver": driver, "project": proj,
             "triangulation": t_obj.id, "photos": photos,
             "scene_npz": scene_npz,
             "args": argparse.Namespace(method="tpu",
                                        **cell.traffic["settings"]),
             "seed": int(cell.seed) & ((1 << 63) - 1)}
    for k in range(cell.traffic["warm_steps"]):
        run(state, os.path.join(cell.work, f"warm{k}"))
    return state


def run(state: Dict, out: str) -> Dict:
    """The timed call: one whole dense step into ``out``, its spans
    collected; ``elapsed_s`` is the call's host time."""
    from regard3d_tpu_torch import spans
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    with spans.collect() as col:
        stats = state["driver"].run_native_densification(
            state["project"], state["triangulation"], out, state["args"],
            device=state["cell"].device)
    return dict(stats, elapsed_s=time.perf_counter() - t0,
                spans=col.summary())


def read_artifacts(out: str) -> Dict:
    with np.load(os.path.join(out, "depth_maps.npz")) as z:
        idepth = {int(k[7:]): z[k] for k in z.files
                  if k.startswith("idepth_")}
        ncc = {int(k[4:]): z[k] for k in z.files if k.startswith("ncc_")}
    if set(idepth) != set(ncc):
        raise ValueError(f"depth maps {sorted(idepth)}, scores "
                         f"{sorted(ncc)}")
    return {"idepth": idepth, "ncc": ncc,
            "xyz": ref.read_ply_xyz(os.path.join(out, "dense.ply"))}


def check(state: Dict, out: str, stats: Dict):
    """(failure or None, record): the artifacts read back and the gates."""
    t = state["cell"].traffic
    try:
        rec = read_artifacts(out)
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        return f"artifacts: {e}", None
    if stats.get("num_points") != len(rec["xyz"]):
        return (f"dense.ply holds {len(rec['xyz'])} points, the step "
                f"reported {stats.get('num_points')}"), rec
    missing = sorted(set(fz.posed_views(state["scene_npz"]))
                     - set(rec["idepth"]))
    if missing:
        return f"posed views without a depth map: {missing}", rec
    out_share = cloud_out(state, rec)
    if not out_share <= 1.0 - t["cloud_gate"]:
        return (f"{1.0 - out_share:.4f} of the points within "
                f"{t['cloud_tol']} of the extent of a plane (gate "
                f"{t['cloud_gate']})"), rec
    return None, rec


def release(state: Dict):
    state.pop("driver", None)
    state.pop("project", None)
    if state["cell"].device.type == "cuda":
        torch.cuda.empty_cache()


def work(state: Dict) -> Dict:
    return {}


# --------------------------------------------------------------------------
# Judging
# --------------------------------------------------------------------------

def _truth(state: Dict) -> Dict:
    """What every step of a run is judged against, worked out once: the
    similarity from the step's frame to the truth, the extent, each view's
    plane spacing and exact inverse depths, the coverage samples."""
    if "truth" in state:
        return state["truth"]
    z = state["scene_npz"]
    cell = state["cell"]
    scene, t = cell.scene, cell.traffic
    st = t["settings"]
    dev = cell.device
    posed = fz.posed_views(z)
    Cp = np.stack([fz.pose(z, v)[1] for v in posed]).astype(np.float64)
    s, R, tr = ref.similarity(Cp, scene["Cs"][posed])
    ext = ref.extent(scene["planes"])
    views = {}
    for v in posed:
        rng = fz.depth_range(z, v)
        if rng is None:
            continue
        depths = fps.inverse_depth_planes(rng[0], rng[1], st["num_planes"])
        Rp, Cv = (np.asarray(a, np.float64) for a in fz.pose(z, v))
        views[v] = {"spacing": float(abs(1.0 / depths[1] - 1.0 / depths[0])),
                    "mid": 0.5 * (rng[0] + rng[1]),
                    "R": Rp @ R.T, "C": s * R @ Cv + tr,
                    "K": fz.K_for(z, v, st["level"])}
    samples = ref.coverage_samples(
        scene["planes"], scene["Rs"], scene["Cs"], scene["f"], scene["size"],
        st["level"], t["coverage_stride"], st["min_image_num"], dev)
    state["truth"] = {"s": s, "R": R, "t": tr, "extent": ext,
                      "views": views, "samples": samples, "idepth": {}}
    return state["truth"]


def _cloud_truth(state: Dict, xyz: np.ndarray) -> torch.Tensor:
    tr = _truth(state)
    dev = state["cell"].device
    X = torch.as_tensor(np.asarray(xyz, np.float64), device=dev)
    R = torch.as_tensor(tr["R"], dtype=torch.float64, device=dev)
    T = torch.as_tensor(tr["t"], dtype=torch.float64, device=dev)
    return tr["s"] * X @ R.T + T


def cloud_out(state: Dict, rec: Dict) -> float:
    if "cloud_out" not in rec:
        tr = _truth(state)
        if len(rec["xyz"]) == 0:
            rec["cloud_out"] = 1.0
        else:
            d = ref.quad_distance(state["cell"].scene["planes"],
                                  _cloud_truth(state, rec["xyz"]))
            tol = state["cell"].traffic["cloud_tol"] * tr["extent"]
            rec["cloud_out"] = float((~(d <= tol)).double().mean())
    return rec["cloud_out"]


def _depth_errors(state: Dict, rec: Dict) -> torch.Tensor:
    """Errors of every accepted pixel, every view, in plane spacings."""
    tr = _truth(state)
    cell = state["cell"]
    dev = cell.device
    thr = cell.traffic["settings"]["threshold"]
    errs = []
    for v in sorted(rec["idepth"]):
        if v not in tr["views"]:
            continue
        tv = tr["views"][v]
        idp = torch.as_tensor(rec["idepth"][v], dtype=torch.float64,
                              device=dev)
        if v not in tr["idepth"]:
            tr["idepth"][v] = ref.truth_idepth(cell.scene["planes"], tv["K"],
                                               tv["R"], tv["C"], idp.shape,
                                               dev)
        want = tr["idepth"][v]
        acc = torch.as_tensor(rec["ncc"][v], device=dev) >= thr
        # the step's inverse depth in the truth frame is idepth / s
        e = (idp / tr["s"] - want).abs() / (tv["spacing"] / tr["s"])
        e = torch.where(want > 0, e, torch.full_like(e, float("inf")))
        errs.append(torch.nan_to_num(e[acc], nan=float("inf")))
    return torch.cat(errs) if errs else torch.zeros(0, dtype=torch.float64,
                                                    device=dev)


def _sampled_views(state: Dict) -> List[int]:
    views = sorted(_truth(state)["views"])
    rng = np.random.default_rng([state["seed"], 4])
    k = min(state["cell"].traffic["sample_views"], len(views))
    return sorted(int(v) for v in rng.choice(views, k, replace=False))


def frozen_sweep(state: Dict, views: List[int], dtype) -> Dict:
    """{view: (idepth, ncc)} of the frozen sweep on the step's inputs
    worked out again: sources, depth range, planes, homographies and the
    gray images at the sweep's level from the photos, in ``dtype``."""
    z = state["scene_npz"]
    cell = state["cell"]
    st = cell.traffic["settings"]
    dev = cell.device
    S = st["num_sources"]
    sources = fz.select_sources(z, S)
    gray = {}
    tdt = torch.float64 if dtype == np.float64 else torch.float32

    def image(v):
        if v not in gray:
            rgb = read_photo(state["photos"][v]).astype(dtype) / 255.0
            gray[v] = torch.as_tensor(
                fz.gray_at_level(z, v, rgb, st["level"], dev, dtype),
                dtype=tdt, device=dev)
        return gray[v]

    out = {}
    for v in views:
        srcs = sources[v]
        lo, hi = fz.depth_range(z, v)
        depths = fps.inverse_depth_planes(lo, hi, st["num_planes"])
        src_ids = (srcs + [srcs[0]] * S)[:S]
        live = np.array([i < len(srcs) for i in range(S)])
        Rr, Cr = fz.pose(z, v)
        homos = fps.plane_homographies(
            fz.K_for(z, v, st["level"]), Rr, Cr,
            np.stack([fz.K_for(z, s, st["level"]) for s in src_ids]),
            np.stack([fz.pose(z, s)[0] for s in src_ids]),
            np.stack([fz.pose(z, s)[1] for s in src_ids]), depths)
        with torch.no_grad():
            idepth, ncc = fps.sweep(
                image(v), torch.stack([image(s) for s in src_ids]),
                torch.as_tensor(live, device=dev),
                torch.as_tensor(homos.astype(dtype), device=dev),
                torch.as_tensor((1.0 / depths).astype(dtype), device=dev),
                wsize=st["wsize"], top_k=min(fps.AGG_TOP_K, len(srcs)),
                chunk=REF_CHUNK)
        out[v] = (idepth.cpu().numpy(), ncc.cpu().numpy())
    return out


def _sweep_diff(state: Dict, rec: Dict) -> float:
    if "frozen" not in state:
        state["frozen"] = frozen_sweep(state, _sampled_views(state),
                                       np.float64)
    tr = _truth(state)
    thr = state["cell"].traffic["settings"]["threshold"]
    bad = either = 0
    for v, (rid, rncc) in state["frozen"].items():
        if v not in rec["idepth"]:
            return 1.0
        pid, pncc = rec["idepth"][v], rec["ncc"][v]
        if pid.shape != rid.shape:
            return 1.0
        ap, ar = pncc >= thr, rncc >= thr
        far = np.abs(pid.astype(np.float64) - rid) \
            > 0.25 * tr["views"][v]["spacing"]
        bad += int(((ap ^ ar) | (ap & ar & far)).sum())
        either += int((ap | ar).sum())
    return bad / either if either else 1.0


def frozen_fusion(state: Dict, rec: Dict) -> Dict[int, torch.Tensor]:
    """{view: (h, w) bool}: the pixels of the ``csize`` grid that the
    float64 copy of the fusion keeps, from the step's own depth maps and
    scores and the sources and cameras worked out again."""
    z = state["scene_npz"]
    cell = state["cell"]
    st = cell.traffic["settings"]
    dev = cell.device
    S, cs = st["num_sources"], st["csize"]
    sources = fz.select_sources(z, S)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    views = sorted(rec["idepth"])
    idp = {v: t(rec["idepth"][v]) for v in views}
    ok = {v: torch.as_tensor(rec["ncc"][v] >= st["threshold"], device=dev)
          for v in views}
    out = {}
    for v in views:
        srcs = [s for s in sources.get(v, []) if s in idp]
        if not srcs:
            continue
        src_ids = (srcs + [srcs[0]] * S)[:S]
        live = np.array([i < len(srcs) for i in range(S)])
        R, C = fz.pose(z, v)
        with torch.no_grad():
            keep = ffu.consistency_mask(
                idp[v], ok[v], t(fz.K_for(z, v, st["level"])), t(R), t(C),
                torch.stack([idp[s] for s in src_ids]),
                torch.stack([ok[s] for s in src_ids]),
                t(np.stack([fz.K_for(z, s, st["level"]) for s in src_ids])),
                t(np.stack([fz.pose(z, s)[0] for s in src_ids])),
                t(np.stack([fz.pose(z, s)[1] for s in src_ids])),
                torch.as_tensor(live, device=dev), tol=ffu.DEPTH_TOL,
                min_consistent=min(max(st["min_image_num"] - 1, 1),
                                   len(srcs)))
        out[v] = keep[::cs, ::cs]
    return out


def cloud_pixels(state: Dict, rec: Dict):
    """({view: (h, w) points on each pixel of the ``csize`` grid}, points
    on no pixel): each point of the cloud traced back to the first view,
    in order, on whose grid pixel's ray it lies at that pixel's inverse
    depth, in the step's own frame."""
    z = state["scene_npz"]
    cell = state["cell"]
    st = cell.traffic["settings"]
    dev = cell.device
    cs = st["csize"]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = t(rec["xyz"]).reshape(-1, 3)
    left = torch.ones(len(X), dtype=torch.bool, device=dev)
    counts = {}
    for v in sorted(rec["idepth"]):
        idp = t(rec["idepth"][v])
        H, W = idp.shape
        h, w = -(-H // cs), -(-W // cs)
        R, C = fz.pose(z, v)
        xc = (X - t(C)) @ t(R).T
        uvw = xc @ t(fz.K_for(z, v, st["level"])).T
        u, y = uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]
        gx, gy = torch.round(u / cs), torch.round(y / cs)
        on = ((xc[:, 2] > 0) & ((u - gx * cs).abs() < TRACE_PX)
              & ((y - gy * cs).abs() < TRACE_PX)
              & (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h))
        ix = torch.where(on, gx, 0.0).long()
        iy = torch.where(on, gy, 0.0).long()
        d = idp[iy * cs, ix * cs]
        hit = left & on & ((1.0 / xc[:, 2] - d).abs() <= TRACE_RTOL * d.abs())
        grid = torch.zeros(h * w, dtype=torch.long, device=dev)
        grid.index_add_(0, (iy * w + ix)[hit],
                        torch.ones(int(hit.sum()), dtype=torch.long,
                                   device=dev))
        counts[v] = grid.reshape(h, w)
        left &= ~hit
    return counts, int(left.sum())


def _fusion_diff(state: Dict, rec: Dict) -> float:
    want = frozen_fusion(state, rec)
    got, stray = cloud_pixels(state, rec)
    bad = either = stray
    for v in sorted(set(want) | set(got)):
        g = got.get(v)
        k = want.get(v)
        if g is None:
            g = torch.zeros(k.shape, dtype=torch.long, device=k.device)
        if k is None:
            k = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
        extra = int(torch.clamp_min(g - 1, 0).sum())
        bad += int(((g > 0) ^ k).sum()) + extra
        either += int(((g > 0) | k).sum()) + extra
    return bad / either if either else 1.0


def numbers(state: Dict, rec: Dict) -> Dict[str, float]:
    tr = _truth(state)
    t = state["cell"].traffic
    e = _depth_errors(state, rec)
    if len(rec["xyz"]):
        unc = ref.uncovered(tr["samples"], _cloud_truth(state, rec["xyz"]),
                            t["cloud_tol"] * tr["extent"])
    else:
        unc = 1.0
    return {"depth_out": float((e > 1.0).double().mean()) if len(e) else 1.0,
            "depth_median_planes": (float(e.median()) if len(e)
                                    else float("inf")),
            "cloud_out": cloud_out(state, rec),
            "cloud_uncovered": unc,
            "sweep_diff": _sweep_diff(state, rec),
            "fusion_diff": _fusion_diff(state, rec)}


def digest(rec: Dict) -> str:
    """Equal digests: equal artifacts (the steps of one run share their
    inputs, so one judgement serves every step that wrote the same)."""
    h = hashlib.sha1()
    for v in sorted(rec["idepth"]):
        h.update(repr(v).encode() + rec["idepth"][v].tobytes()
                 + rec["ncc"][v].tobytes())
    h.update(rec["xyz"].tobytes())
    return h.hexdigest()


def judge(state: Dict, records: List[Dict]) -> List:
    """The numbers of every judged step, each the worst over the steps,
    beside its limit from the traffic file."""
    lim = state["cell"].traffic["limits"]
    worst = {k: 0.0 for k in NAMES}
    for rec in {digest(r): r for r in records}.values():
        for k, v in numbers(state, rec).items():
            worst[k] = max(worst[k], v)
    return [(k, worst[k], lim[k]) for k in NAMES]


def control(state: Dict, rec: Dict) -> Dict:
    """``rec`` with the sampled views' depth maps swept by the reference in
    the program's place, in TF32: float32 inputs, every product's operands
    rounded to TF32 (the homographies' warp of the pixel grid)."""
    with tf32.emulate():
        maps = frozen_sweep(state, _sampled_views(state), np.float32)
    out = dict(rec, idepth=dict(rec["idepth"]), ncc=dict(rec["ncc"]))
    for v, (idepth, ncc) in maps.items():
        out["idepth"][v], out["ncc"][v] = idepth, ncc
    return out


def moved(state: Dict, rec: Dict) -> Dict:
    """``rec`` with every depth moved farther by the depth of one plane
    spacing at the middle of its view's range, and the cloud moved as far
    away from the cameras' centroid."""
    tr = _truth(state)
    out = {"idepth": {}, "ncc": dict(rec["ncc"])}
    shifts = []
    for v, idp in rec["idepth"].items():
        tv = tr["views"].get(v)
        dz = tv["spacing"] * tv["mid"] ** 2 if tv else 0.0
        shifts.append(dz)
        depth = 1.0 / np.maximum(idp.astype(np.float64), 1e-12)
        out["idepth"][v] = (1.0 / (depth + dz)).astype(idp.dtype)
    z = state["scene_npz"]
    centre = np.mean([fz.pose(z, v)[1] for v in fz.posed_views(z)], 0)
    X = np.asarray(rec["xyz"], np.float64)
    away = X - centre
    away /= np.maximum(np.linalg.norm(away, axis=1, keepdims=True), 1e-12)
    out["xyz"] = (X + np.mean(shifts) * away).astype(np.float32)
    return out


def thinned(state: Dict, rec: Dict) -> Dict:
    """``rec`` with every other accepted pixel and every other point
    dropped."""
    out = {"idepth": dict(rec["idepth"]), "ncc": {}}
    for v, ncc in rec["ncc"].items():
        H, W = ncc.shape
        odd = (np.add.outer(np.arange(H), np.arange(W)) % 2) == 1
        out["ncc"][v] = np.where(odd, -1.0, ncc).astype(ncc.dtype)
    out["xyz"] = np.asarray(rec["xyz"])[::2]
    return out


def fault(state: Dict, rec: Dict) -> Dict:
    """``rec`` with its answers altered where they are produced: moved,
    then thinned. Its numbers are the upper readings of the numbers held to
    the scene, which the TF32 control does not move (``cloud_uncovered``'s
    from the move: a thinned cloud still covers the scene)."""
    return thinned(state, moved(state, rec))
