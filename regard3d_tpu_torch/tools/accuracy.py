"""Accuracy run of the port's main path on synthetic scenes with exact poses.

Counterpart of ``bench_accuracy.run_dataset`` and ``GATES``: a ray-cast
scene (``ingest/synth.py``: SceauxCastle-11 and fountain-P11 stand-ins, and
their radial-K3 twins) goes through ``run_compute_matches`` (2048 RANSAC
iterations, 2048 keypoints, focal prior 1.03x the truth) and
``run_triangulation`` (``engine``: incremental2 with MaxPair by default,
or the global engine on the E-filtered matches; intrinsics refined; the
``_rk3`` twins run the radial-K3 model with zero-initialized distortion
recovered by BA). A row holds the posed cameras, the ATE after Sim3
alignment against the true centers, the residual statistics, the engine's
profile and the device it ran on; the gates are the reference's.

Run: ``python -m regard3d_tpu_torch.tools.accuracy [--datasets castle,...]
[--engine global] [--out rows.json] [--device cpu]``. Runs on cuda unless
``--device cpu`` (raises with no card). Each row prints beside the
reference's row for the same dataset and engine (``GLOBAL.json`` for the
global engine, ``ACCURACY.json`` otherwise), which it does not write.
Exits non-zero when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

GATES = {
    "castle": {"ate": 0.08, "median_px": 1.0, "min_cameras": 11},
    "fountain": {"ate": 0.08, "median_px": 1.0, "min_cameras": 11},
    "castle_rk3": {"ate": 0.08, "median_px": 1.0, "min_cameras": 11},
    "fountain_rk3": {"ate": 0.08, "median_px": 1.0, "min_cameras": 11},
}
# the settings ACCURACY.json's rows were measured at (bench_accuracy)
HW = 320
MAX_KEYPOINTS = 2048
RANSAC_ITERS = 2048


def run_dataset(name: str, seed: int = 0, device=None,
                engine: str = "incremental2",
                ransac_iters: int = RANSAC_ITERS) -> dict:
    from regard3d_tpu_torch import runtime
    from regard3d_tpu_torch.core import metrics
    from regard3d_tpu_torch.core.sfm_data import load_npz
    from regard3d_tpu_torch.core.types import PINHOLE, RADIAL_K3
    from regard3d_tpu_torch.ingest import synth
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import triangulation_step as ts

    dev = runtime.resolve_device(device)
    t0 = time.time()
    ds = synth.make_dataset(name, n_cams=11, hw=HW, seed=seed)
    V = len(ds["images"])
    f_prior = 1.03 * ds["f"]
    model = RADIAL_K3 if ds.get("disto") else PINHOLE
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "matches")
        mstats = cm.run_compute_matches(
            ds["images"], out, threshold=0.0001,
            cfg=cm.MatchConfig(ransac_iters=ransac_iters),
            focals=np.full(V, f_prior), max_keypoints=MAX_KEYPOINTS,
            device=dev, seed=seed)
        intr = np.zeros((1, 9), np.float32)
        intr[0, :3] = [f_prior, ds["hw"] / 2, ds["hw"] / 2]
        tri = os.path.join(tmp, "tri")
        tstats = ts.run_triangulation(
            out, tri, ds["images"], intr_id=np.zeros(V, np.int32),
            intr=intr, models=np.asarray([model], np.int32),
            params=ts.TriangulationParams(engine=engine,
                                          refine_intrinsics=True),
            seed=seed, device=dev)
        scene = load_npz(os.path.join(tri, "scene.npz"))

    pm = scene.poses.mask.numpy()
    ate = metrics.ate_rmse(scene.poses.C.numpy()[pm],
                           ds["Cs"][np.nonzero(pm)[0]])
    extra = {}
    if ds.get("disto"):
        params = scene.intrinsics.params.numpy()
        extra["disto_gt"] = [float(v) for v in ds["disto"]]
        extra["disto_est"] = [float(v) for v in params[0, 3:6]]
        extra["focal_est"] = float(params[0, 0])
        extra["focal_gt"] = float(ds["f"])
    return {
        **extra,
        "dataset": name,
        "num_cameras": int(tstats["num_cameras"]),
        "num_tracks": int(tstats["num_tracks"]),
        "ate": float(ate),
        "residual_px": {k: float(tstats[f"residual_{k}"])
                        for k in ("min", "max", "mean", "median")},
        "rms_px": float(tstats["rms_px"]),
        "pairs_f": int(mstats["pairs_f"]),
        "pairs_e": int(mstats["pairs_e"]),
        "engine": engine,
        "ransac_iters": ransac_iters,
        "elapsed_s": time.time() - t0,
        "sfm_profile": tstats.get("profile"),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def gate_failures(row: dict) -> list:
    g = GATES[row["dataset"]]
    out = []
    if row["num_cameras"] < g["min_cameras"]:
        out.append(f"{row['dataset']}: calibrated {row['num_cameras']} < "
                   f"{g['min_cameras']} cameras")
    if row["ate"] > g["ate"]:
        out.append(f"{row['dataset']}: ATE {row['ate']} > bound {g['ate']}")
    med = row["residual_px"]["median"]
    if med > g["median_px"]:
        out.append(f"{row['dataset']}: median residual {med} px > "
                   f"{g['median_px']} px")
    return out


def reference_rows(engine: str) -> dict:
    """The reference's rows by dataset: GLOBAL.json for the global engine,
    ACCURACY.json otherwise (empty where the file is absent)."""
    from regard3d_tpu_torch import runtime
    path = os.path.join(runtime.repo_root(), "GLOBAL.json" if engine ==
                        "global" else "ACCURACY.json")
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return {r["dataset"]: r for r in json.load(fh)["results"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--datasets",
                    default="castle,fountain,castle_rk3,fountain_rk3")
    ap.add_argument("--engine", default="incremental2",
                    choices=["incremental", "incremental2", "global"])
    ap.add_argument("--out", default=None,
                    help="write the rows and gates here as JSON")
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    refs = reference_rows(args.engine)
    rows, failures = [], []
    for name in args.datasets.split(","):
        r = run_dataset(name, device=args.device, engine=args.engine)
        rows.append(r)
        failures += gate_failures(r)
        print(json.dumps({"port": r, "reference": refs.get(name)}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": rows, "gates": GATES,
                       "ok": not failures}, f, indent=1)
    if failures:
        print("ACCURACY GATE FAILED:", file=sys.stderr)
        for msg in failures:
            print("  " + msg, file=sys.stderr)
        sys.exit(1)
    print("accuracy gates OK")


if __name__ == "__main__":
    main()
