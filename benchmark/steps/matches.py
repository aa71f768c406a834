"""Step kind ``matches``: one compute-matches step of the port, as
``r3d matches`` runs it (features -> ratio-test matching -> F / E / H
filter -> artifacts), on every view of the configuration.

The window drives ``run_compute_matches`` with the configuration's
settings; each step writes a fresh directory and recomputes its features.
A step fails if it raises, leaves an artifact missing or unreadable, or
F-validates fewer than the configuration's share of the pairs. Its
artifacts are judged against ``reference/matches_ref.py``:

* ``feat_miss``: share of keypoints, over views drawn from the seed, that
  the float64 detector and descriptor do not reproduce;
* ``match_gap``: widest departure of a kept or dropped row from the exact
  ratio test on the step's descriptors, every pair;
* ``filter_diff``: mean set distance between the step's F / E / H inliers
  and the float64 filter's with the same draws, over pairs drawn from the
  seed;
* ``xfer_out``: share of the step's F / E / H inlier matches, every pair,
  that lie more than the configuration's ``max_err_px`` from the true
  position of their partner, by the scene's exact geometry
  (``reference/geometry_ref.py``); matches whose keypoint in view i lies
  within half its scale of a plane's edge have no one true position and
  are left out;
* ``xfer_median_px``: the median of those distances.

The first three follow a frozen copy of the port's own stages and catch a
drift from them; the last two hold the step to the scene itself, whatever
its code.
"""

from __future__ import annotations

import hashlib
import math
import os
import struct
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import geometry_ref as geo
from benchmark.reference import matches_ref as ref
from benchmark.reference import tf32

SPANS = ("compute_matches.",)
LIOP_DIM = 144


def _pairs(n: int):
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def setup_inputs(cell) -> Dict:
    """The step's inputs: the views, the focal guesses, the settings."""
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    c = cell.config
    scene = cell.scene
    n = len(scene["images"])
    return {
        "cell": cell, "cm": cm,
        "images": scene["images"],
        "focals": np.full(n, scene["f"] * c["intrinsics_guess"]),
        "cfg": cm.MatchConfig(ratio=c["ratio"], matcher=c["matcher"],
                              ransac_iters=c["ransac_iters"],
                              max_err_px=c["max_err_px"]),
        "seed": int(cell.seed) & ((1 << 63) - 1),
    }


def setup(cell) -> Dict:
    state = setup_inputs(cell)
    for k in range(cell.traffic["warm_steps"]):
        run(state, os.path.join(cell.work, f"warm{k}"))
    return state


def run(state: Dict, out: str) -> Dict:
    """The timed call: one whole compute-matches step into ``out``."""
    c = state["cell"].config
    return state["cm"].run_compute_matches(
        state["images"], out, threshold=c["threshold"], cfg=state["cfg"],
        focals=state["focals"], max_keypoints=c["max_keypoints"], force=True,
        detector=c["detector"], device=state["cell"].device,
        seed=state["seed"])


def read_matches(path: str) -> Dict:
    out = {}
    with open(path) as fh:
        tok = fh.read().split()
    pos = 0
    while pos < len(tok):
        i, j, n = int(tok[pos]), int(tok[pos + 1]), int(tok[pos + 2])
        pos += 3
        out[(i, j)] = np.asarray(tok[pos:pos + 2 * n],
                                 np.int64).reshape(n, 2)
        pos += 2 * n
    return out


def read_features(out: str, i: int) -> Dict[str, np.ndarray]:
    feat = np.loadtxt(os.path.join(out, f"image{i:06d}.feat"),
                      dtype=np.float64, ndmin=2).reshape(-1, 4)
    with open(os.path.join(out, f"image{i:06d}.desc"), "rb") as fh:
        n = struct.unpack("<Q", fh.read(8))[0]
        desc = np.frombuffer(fh.read(n * LIOP_DIM * 4), np.float32)
    if len(feat) != n or desc.size != n * LIOP_DIM:
        raise ValueError(f"image {i}: {len(feat)} keypoints, {n} descriptors")
    return {"xy": feat[:, :2], "scale": feat[:, 2], "angle": feat[:, 3],
            "desc": desc.reshape(n, LIOP_DIM).astype(np.float64)}


def check(state: Dict, out: str, stats: Dict):
    """(failure or None, record): the artifacts read back and the gate."""
    n = len(state["images"])
    try:
        rec = {"features": [read_features(out, i) for i in range(n)]}
        for kind in ("putative", "f", "e", "h"):
            rec[kind] = read_matches(os.path.join(out, f"matches.{kind}.txt"))
        for name in ("sfm_data.json", "Matching_Report.html",
                     "PutativeAdjacencyMatrix.svg",
                     "GeometricAdjacencyMatrix.svg"):
            if os.path.getsize(os.path.join(out, name)) == 0:
                raise ValueError(f"{name} is empty")
    except (OSError, ValueError) as e:
        return f"artifacts: {e}", None
    pairs = len(_pairs(n))
    share = state["cell"].config["gates"]["f_pairs_share"]
    if len(rec["f"]) < share * pairs:
        return (f"{len(rec['f'])} of {pairs} pairs F-validated "
                f"(gate {share})"), rec
    return None, rec


def release(state: Dict):
    state.pop("cm", None)
    if state["cell"].device.type == "cuda":
        torch.cuda.empty_cache()


def work(state: Dict) -> Dict:
    return {"pairs": _pairs(len(state["images"]))}


# --------------------------------------------------------------------------
# Judging
# --------------------------------------------------------------------------

def _draw(state: Dict, salt: int) -> np.random.Generator:
    return np.random.default_rng([state["seed"], salt])


def _ref_features(state: Dict, views: List[int]) -> Dict[int, Dict]:
    c = state["cell"].config
    dev = state["cell"].device
    return {v: ref.features(state["images"][v], c["threshold"],
                            c["max_keypoints"], torch.float64, dev)
            for v in views}


NAMES = ("feat_miss", "match_gap", "filter_diff", "xfer_out",
         "xfer_median_px")


def digest(rec: Dict) -> str:
    """Equal digests: equal artifacts (steps of one run repeat their
    inputs, so one judgement serves every step that wrote the same)."""
    h = hashlib.sha1()
    for f in rec["features"]:
        for k in ("xy", "scale", "angle", "desc"):
            h.update(f[k].tobytes())
    for kind in ("putative", "f", "e", "h"):
        for p, m in sorted(rec[kind].items()):
            h.update(repr(p).encode() + m.tobytes())
    return h.hexdigest()


def judge(state: Dict, records: List[Dict]) -> List:
    """The numbers of every judged step, each the worst over the steps,
    beside its limit from the traffic file."""
    t = state["cell"].traffic
    n = len(state["images"])
    views = ref.sample(_draw(state, 1), list(range(n)), t["sample_views"])
    feats = _ref_features(state, views)
    worst = {k: 0.0 for k in NAMES}
    unique = {digest(rec): rec for rec in records}
    for rec in unique.values():
        for k, v in numbers(state, rec, views, feats).items():
            worst[k] = max(worst[k], v)
    return [(k, worst[k], t["limits"][k]) for k in NAMES]


def _chosen(state: Dict, putative: Dict) -> List:
    """The pairs whose filter is judged: drawn from the seed among those
    the filter runs on."""
    n = len(state["images"])
    eligible = [p for p in _pairs(n)
                if len(putative.get(p, ())) >= ref.MIN_FILTER_MATCHES]
    return ref.sample(_draw(state, 2), eligible,
                      state["cell"].traffic["sample_pairs"])


def _filter(state: Dict, feats, putative, pairs, dtype) -> List[Dict]:
    c = state["cell"].config
    sizes = [np.asarray(im.shape[::-1], np.float64) for im in state["images"]]
    return ref.filter_pairs([(i, j, putative[(i, j)]) for i, j in pairs],
                            [f["xy"] for f in feats], sizes, state["focals"],
                            state["seed"], c["ransac_iters"],
                            c["max_err_px"], dtype, state["cell"].device)


def numbers(state: Dict, rec: Dict, views, feats) -> Dict[str, float]:
    c = state["cell"].config
    dev = state["cell"].device
    n = len(state["images"])
    miss = [ref.feature_miss(rec["features"][v], feats[v], dev)
            for v in views]
    feat_miss = sum(a for a, _ in miss) / max(sum(b for _, b in miss), 1)

    gap = 0.0
    for (i, j) in _pairs(n):
        got = rec["putative"].get((i, j), np.zeros((0, 2), np.int64))
        gap = max(gap, ref.match_gap(rec["features"][i]["desc"],
                                     rec["features"][j]["desc"], got,
                                     c["ratio"], dev))

    dists = []
    empty = np.zeros((0, 2), np.int64)
    chosen = _chosen(state, rec["putative"])
    want = _filter(state, rec["features"], rec["putative"], chosen,
                   torch.float64)
    for (i, j), w in zip(chosen, want):
        for kind in ("f", "e", "h"):
            dists.append(ref.set_distance(rec[kind].get((i, j), empty),
                                          w.get(kind, empty)))
    filt = float(np.mean(dists)) if dists else 0.0
    out, med = transfer(state, rec)
    return {"feat_miss": feat_miss, "match_gap": gap, "filter_diff": filt,
            "xfer_out": out, "xfer_median_px": med}


def transfer(state: Dict, rec: Dict):
    """(share over ``max_err_px``, median) of the exact transfer distances
    of every pair's F / E / H inlier matches, each match once."""
    scene = state["cell"].scene
    errs = []
    for (i, j) in _pairs(len(state["images"])):
        rows = [rec[k][(i, j)] for k in ("f", "e", "h") if (i, j) in rec[k]]
        if not rows:
            continue
        m = np.unique(np.concatenate(rows), axis=0)
        views = (scene["planes"], scene["Rs"][i], scene["Cs"][i],
                 scene["Rs"][j], scene["Cs"][j], scene["f"], scene["size"])
        fi, fj = rec["features"][i], rec["features"][j]
        err = geo.transfer_px(*views, fi["xy"][m[:, 0]], fj["xy"][m[:, 1]])
        errs.append(err[geo.clear(*views, fi["xy"][m[:, 0]],
                                  0.5 * fi["scale"][m[:, 0]])])
    e = np.concatenate(errs) if errs else np.zeros(0)
    if len(e) == 0:
        return math.inf, math.inf
    lim = state["cell"].config["max_err_px"]
    return float((~(e <= lim)).mean()), float(np.median(e))


def fault(state: Dict, rec: Dict) -> Dict:
    """``rec`` with an answer altered where it is produced: in every pair,
    half of the F / E / H inlier matches (drawn from the seed) point at
    another keypoint of view j. Its numbers are the upper readings of the
    two exact-geometry numbers, which the TF32 control does not move."""
    rng = _draw(state, 3)
    out = dict(rec)
    for kind in ("f", "e", "h"):
        out[kind] = {}
        for (i, j), m in rec[kind].items():
            m = m.copy()
            k = rng.random(len(m)) < 0.5
            n = len(rec["features"][j]["xy"])
            m[k, 1] = (m[k, 1] + rng.integers(1, max(n, 2), k.sum())) % n
            out[kind][(i, j)] = m
    return out


def control(state: Dict, rec: Dict = None) -> Dict:
    """The reference in the program's place, in TF32 (float32 with every
    product and convolution's operands rounded to TF32): a record shaped
    like a step's, for ``numbers``."""
    c = state["cell"].config
    dev = state["cell"].device
    n = len(state["images"])
    with tf32.emulate():
        feats = [ref.features(im, c["threshold"], c["max_keypoints"],
                              torch.float32, dev) for im in state["images"]]
        rec = {"features": feats, "putative": {}, "f": {}, "e": {}, "h": {}}
        for (i, j) in _pairs(n):
            da = torch.as_tensor(feats[i]["desc"], dtype=torch.float32,
                                 device=dev)
            db = torch.as_tensor(feats[j]["desc"], dtype=torch.float32,
                                 device=dev)
            rec["putative"][(i, j)] = ref.ratio_match(da, db, c["ratio"])
        chosen = _chosen(state, rec["putative"])
        for (i, j), got in zip(chosen, _filter(state, feats, rec["putative"],
                                               chosen, torch.float32)):
            for kind, inl in got.items():
                rec[kind][(i, j)] = inl
    return rec
