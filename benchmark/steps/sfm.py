"""Step kind ``sfm``: one triangulation step of the port, as ``r3d sfm``
runs it (tracks -> incremental2 with the MaxPair initializer -> bundle
adjustment -> posed scene and artifacts), from the configuration's matches.

Set-up runs one compute-matches step on the views (the input users feed
``sfm``) and warms the triangulation step on it. The window drives
``run_triangulation``, each step into a fresh directory. A step fails if it
raises, leaves an artifact missing or unreadable, or misses the port's
gates (every view posed, ATE after a similarity within the bound, median
residual under 1 px). Its end state is judged against
``reference/sfm_ref.py``:

* ``track_diff``: tracks of the step's table that the reference's union-find
  over the same matches does not give, and the reverse (exact: 0);
* ``ba_excess``: how far the step's Huber cost lies above the optimum the
  float64 reference BA reaches from the step's own end state, as a share of
  that optimum;
* ``ate``: camera centres against the exact ones after a similarity;
* ``unposed``: views left without a pose (0);
* ``residual_median_px``: the median reprojection residual of the end
  state, recomputed in float64.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import sfm_ref as ref
from benchmark.reference import tf32
from benchmark.steps import matches as matches_step

SPANS = ("triangulation.",)
NAMES = ("track_diff", "ba_excess", "ate", "unposed", "residual_median_px")


def setup(cell) -> Dict:
    from regard3d_tpu_torch.core.types import PINHOLE
    from regard3d_tpu_torch.pipeline import triangulation_step as ts
    m_state = matches_step.setup_inputs(cell)
    mdir = os.path.join(cell.work, "matches")
    matches_step.run(m_state, mdir)
    scene = cell.scene
    n = len(scene["images"])
    intr = np.zeros((1, 9), np.float32)
    w, h = scene["size"]
    intr[0, :3] = [cell.config["intrinsics_guess"] * scene["f"], w / 2.0,
                   h / 2.0]
    state = {"cell": cell, "ts": ts, "matches": mdir,
             "images": scene["images"], "intr": intr,
             "models": np.asarray([PINHOLE], np.int32),
             "intr_id": np.zeros(n, np.int32),
             "seed": int(cell.seed) & ((1 << 63) - 1),
             "f_matches": matches_step.read_matches(
                 os.path.join(mdir, "matches.f.txt")),
             "xy": [matches_step.read_features(mdir, i)["xy"]
                    for i in range(n)]}
    for k in range(cell.traffic["warm_steps"]):
        run(state, os.path.join(cell.work, f"warm{k}"))
    return state


def run(state: Dict, out: str) -> Dict:
    """The timed call: one whole triangulation step into ``out``."""
    c = state["cell"].config
    ts = state["ts"]
    return ts.run_triangulation(
        state["matches"], out, state["images"], intr_id=state["intr_id"],
        intr=state["intr"], models=state["models"],
        params=ts.TriangulationParams(engine=c["engine"],
                                      initializer=c["initializer"]),
        seed=state["seed"], device=state["cell"].device)


def check(state: Dict, out: str, stats: Dict):
    """(failure or None, record): the scene read back and the gates."""
    scene = state["cell"].scene
    gates = state["cell"].config["gates"]
    try:
        with np.load(os.path.join(out, "scene.npz")) as z:
            rec = {k: z[k] for k in z.files}
        for name in ("sfm_data.json", "cloud_and_poses.ply",
                     "FinalColorized.ply", "Reconstruction_Report.html"):
            if os.path.getsize(os.path.join(out, name)) == 0:
                raise ValueError(f"{name} is empty")
    except (OSError, ValueError, KeyError) as e:
        return f"artifacts: {e}", None
    pm = np.asarray(rec["poses.mask"], bool)
    n = len(pm)
    if pm.sum() < n:
        return f"{int(pm.sum())} of {n} views posed", rec
    ate = ref.umeyama_rmse(rec["poses.C"][pm], scene["Cs"][pm])
    if not ate <= gates["ate"]:
        return f"ATE {ate} over {gates['ate']}", rec
    if not stats["residual_median"] < gates["residual_median_px"]:
        return f"median residual {stats['residual_median']} px", rec
    return None, rec


def release(state: Dict):
    state.pop("ts", None)
    if state["cell"].device.type == "cuda":
        torch.cuda.empty_cache()


def work(state: Dict) -> Dict:
    return {}


def numbers(state: Dict, rec: Dict, want_tracks=None) -> Dict[str, float]:
    """The numbers of one end state (a ``scene.npz``'s arrays)."""
    dev = state["cell"].device
    scene = state["cell"].scene
    if want_tracks is None:
        want_tracks = ref.tracks(state["f_matches"])
    got = ref.program_tracks(rec)
    diff = len(set(got) ^ want_tracks) + (len(got) - len(set(got)))
    vid = np.asarray(rec["observations.view_id"])
    fid = np.asarray(rec["observations.feature_id"])
    xy = np.asarray(rec["observations.xy"], np.float32)
    feat = np.float32(np.concatenate(
        [state["xy"][v][f][None] for v, f in zip(vid, fid)])) \
        if len(vid) else np.zeros((0, 2), np.float32)
    diff += int((feat != xy).any(-1).sum())

    pm = np.asarray(rec["poses.mask"], bool)
    prob = ref.problem_from_scene(rec, torch.float64, dev)
    resid = ref.residuals_px(prob)
    with torch.no_grad():
        c_prog = float(prob.cost())
        c_opt = prob.solve()
    return {"track_diff": float(diff),
            "ba_excess": max(c_prog - c_opt, 0.0) / max(c_opt, 1e-300),
            "ate": (ref.umeyama_rmse(rec["poses.C"][pm], scene["Cs"][pm])
                    if pm.sum() >= 3 else float("inf")),
            "unposed": float(len(pm) - pm.sum()),
            "residual_median_px": (float(np.median(resid)) if len(resid)
                                   else float("inf"))}


def judge(state: Dict, records: List[Dict]) -> List:
    want = ref.tracks(state["f_matches"])
    worst = {k: 0.0 for k in NAMES}
    for rec in records:
        for k, v in numbers(state, rec, want).items():
            worst[k] = max(worst[k], v)
    lim = state["cell"].traffic["limits"]
    return [(k, worst[k], lim[k]) for k in NAMES]


def control(state: Dict, rec: Dict) -> Dict:
    """The reference BA in the program's place, in TF32 (float32 with every
    product's operands rounded to TF32), from the end state ``rec``: the
    arrays of a ``scene.npz`` holding the control's state instead."""
    dev = state["cell"].device
    with torch.no_grad(), tf32.emulate():
        prob = ref.problem_from_scene(rec, torch.float32, dev)
        prob.solve()
    out = dict(rec)
    pm = np.asarray(rec["poses.mask"], bool)
    live = (np.asarray(rec["observations.mask"], bool)
            & np.asarray(rec["landmarks.mask"], bool)[
                rec["observations.landmark_id"]]
            & pm[rec["observations.view_id"]])
    pts = np.unique(np.asarray(rec["observations.landmark_id"])[live])
    out["poses.R"] = prob.R.double().cpu().numpy()
    out["poses.C"] = prob.C.double().cpu().numpy()
    X = np.array(rec["landmarks.X"], np.float64)
    X[pts] = prob.X.double().cpu().numpy()
    out["landmarks.X"] = X
    params = np.array(rec["intrinsics.params"], np.float64)
    params[0, :3] = prob.intr.double().cpu().numpy()
    out["intrinsics.params"] = params
    return out
