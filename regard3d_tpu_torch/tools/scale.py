"""Scale run: the whole pipeline on a synthetic city of hundreds of views.

Counterpart of the top-level ``bench_scale.py`` (as ``tools/accuracy.py``
is of ``bench_accuracy.py``), with the same options, defaults and JSON
keys: ``ingest/synth.make_city`` renders a street of textured facades
(an open corridor, or a closed loop that needs retrieval pairs to close)
with exact poses -> window pairs (each view with its next ``window``
views) plus ``retrieval_k`` retrieval pairs -> ``run_compute_matches``
(1024 RANSAC iterations, focal prior 1.03x the truth) ->
``run_triangulation`` (incremental2, intrinsics refined, BA every
``ba_every`` views, ``ba_iterations``, ``final_ba_iterations``) -> ATE
after Sim3 against the true centres. Gates (the bench's): >= 95% of the
views posed, ATE <= 0.5% of the trajectory extent.

Keys beyond the bench's: ``device`` (the card's name, or ``cpu``),
``card`` (``nvidia-smi``'s name and power limit), the stage's time split
(``time_{features,matching,filter}_s``), its filter blocks, the pairs each
filter validated, and the peak device memory of each stage.

Run: ``python -m regard3d_tpu_torch.tools.scale [--views 1000]
[--window 8] [--hw 256] [--no-loop] [--retrieval-k 8] [--out FILE]
[--device cpu]``. Runs on cuda unless ``--device cpu`` (raises with no
card). Prints the result as one JSON line and writes it only where
``--out`` says; exits non-zero when a gate fails. Importable as
:func:`run_scale`.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[dev.index or 0] if r.returncode == 0 and lines else (
        "nvidia-smi failed")


def run_scale(views: int = 1000, window: int = 8, hw: int = 256,
              max_keypoints: int = 1024, engine: str = "incremental2",
              ba_every: int = 25, ba_iterations: int = 12,
              final_ba_iterations: int = 100, loop: bool = True,
              retrieval_k: int = 8, ransac_iters: int = 1024,
              workdir=None, device=None) -> dict:
    """One scale run; returns the result dict (``ok`` and ``gates`` as the
    bench's). ``workdir``: keep the render and the matches there and reuse
    them on a rerun (default: a fresh temporary directory)."""
    from regard3d_tpu_torch import runtime
    from regard3d_tpu_torch.core import metrics
    from regard3d_tpu_torch.core.sfm_data import load_npz
    from regard3d_tpu_torch.core.types import PINHOLE
    from regard3d_tpu_torch.ingest import synth
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import triangulation_step as ts

    dev = runtime.resolve_device(device)
    cuda = dev.type == "cuda"

    def peak_gb():
        if not cuda:
            return None
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) / 1e9

    t0 = time.time()
    render_npz = os.path.join(workdir, "render.npz") if workdir else None
    if render_npz and os.path.exists(render_npz):
        z = np.load(render_npz)
        ds = {"images": list(z["images"]), "Cs": z["Cs"],
              "f": float(z["f"]), "hw": int(z["hw"])}
    else:
        ds = synth.make_city(n_cams=views, hw=hw, loop=loop)
        if render_npz:
            os.makedirs(workdir, exist_ok=True)
            np.savez(render_npz, images=np.stack(ds["images"]), Cs=ds["Cs"],
                     f=ds["f"], hw=ds["hw"])
    t_render = time.time() - t0
    V = len(ds["images"])
    pairs = synth.window_pairs(V, window)
    print(f"# rendered {V} views in {t_render:.1f}s "
          f"({'loop' if loop else 'corridor'}), {len(pairs)} window pairs",
          flush=True)

    f_prior = 1.03 * ds["f"]
    stage_t, stage_rss, stage_peak = {}, {"render_rss_gb": peak_rss_gb()}, {}
    tmp_ctx = tempfile.TemporaryDirectory() if workdir is None else None
    tmp = tmp_ctx.name if tmp_ctx else workdir
    try:
        out = os.path.join(tmp, "matches")
        done_marker = os.path.join(out, ".matches_done")
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.time()
        if workdir and os.path.exists(done_marker):
            with open(done_marker) as fh:
                mstats = json.load(fh)
        else:
            mstats = cm.run_compute_matches(
                ds["images"], out, threshold=0.0005,
                cfg=cm.MatchConfig(ransac_iters=ransac_iters),
                focals=np.full(V, f_prior), max_keypoints=max_keypoints,
                pairs=pairs, retrieval_k=retrieval_k, device=dev)
            if workdir:
                with open(done_marker, "w") as fh:
                    json.dump({k: v for k, v in mstats.items()
                               if isinstance(v, (int, float, str))}, fh)
        stage_t["matches_s"] = time.time() - t1
        stage_rss["matches_rss_gb"] = peak_rss_gb()
        stage_peak["matches_peak_device_gb"] = peak_gb()
        print(f"# matching done in {stage_t['matches_s']:.1f}s: "
              f"{mstats['pairs_f']} F-pairs "
              f"(+{mstats.get('pairs_retrieval', 0)} retrieval)", flush=True)

        intr = np.zeros((1, 9), np.float32)
        intr[0, :3] = [f_prior, ds["hw"] / 2, ds["hw"] / 2]
        tri = os.path.join(tmp, "tri")
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t2 = time.time()
        tstats = ts.run_triangulation(
            out, tri, ds["images"], intr_id=np.zeros(V, np.int32), intr=intr,
            models=np.asarray([PINHOLE], np.int32),
            params=ts.TriangulationParams(
                engine=engine, refine_intrinsics=True, ba_every=ba_every,
                ba_iterations=ba_iterations,
                final_ba_iterations=final_ba_iterations), device=dev)
        stage_t["sfm_s"] = time.time() - t2
        stage_rss["sfm_rss_gb"] = peak_rss_gb()
        stage_peak["sfm_peak_device_gb"] = peak_gb()
        scene = load_npz(os.path.join(tri, "scene.npz"))
    finally:
        if tmp_ctx:
            tmp_ctx.cleanup()

    pm = scene.poses.mask.numpy()
    ate = float(metrics.ate_rmse(scene.poses.C.numpy()[pm],
                                 ds["Cs"][np.nonzero(pm)[0]]))
    extent = float(np.linalg.norm(ds["Cs"].max(0) - ds["Cs"].min(0)))
    posed_frac = float(pm.sum()) / V
    gates = {"posed_ok": posed_frac >= 0.95, "ate_ok": ate <= 0.005 * extent}
    n_retrieval = int(mstats.get("pairs_retrieval", 0))
    return {
        "views": V,
        "window": window,
        "loop": loop,
        "retrieval_k": retrieval_k,
        "pairs": len(pairs) + n_retrieval,
        "pairs_retrieval": n_retrieval,
        "pairs_f": int(mstats["pairs_f"]),
        "pairs_e": int(mstats["pairs_e"]),
        "pairs_h": int(mstats["pairs_h"]),
        "filter_blocks": int(mstats["filter_blocks"]),
        "engine": engine,
        "num_cameras": int(pm.sum()),
        "posed_fraction": posed_frac,
        "num_tracks": int(tstats["num_tracks"]),
        "num_observations": int(tstats.get("num_observations", 0)),
        "ate": ate,
        "trajectory_extent": extent,
        "ate_fraction_of_extent": ate / extent,
        "rms_px": float(tstats["rms_px"]),
        "render_s": t_render,
        **stage_t,
        "time_features_s": mstats.get("time_features_s"),
        "time_matching_s": mstats.get("time_matching_s"),
        "time_filter_s": mstats.get("time_filter_s"),
        "total_s": time.time() - t0,
        "peak_rss_gb": peak_rss_gb(),
        **stage_rss,
        **stage_peak,
        "sfm_profile": tstats.get("profile"),
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if cuda else "cpu"),
        "card": card_line(dev),
        "gates": gates,
        "ok": all(gates.values()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=1000)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--max-keypoints", type=int, default=1024)
    ap.add_argument("--engine", default="incremental2")
    ap.add_argument("--ba-every", type=int, default=25,
                    help="incremental local-BA cadence (views between BAs)")
    ap.add_argument("--ba-iterations", type=int, default=12)
    ap.add_argument("--final-ba-iterations", type=int, default=100,
                    help="post-growth full-BA polish; loop-closure drift "
                         "redistribution happens here")
    ap.add_argument("--loop", action="store_true", default=True,
                    help="closed-circuit capture (loop closure; default)")
    ap.add_argument("--no-loop", dest="loop", action="store_false",
                    help="open corridor (pure odometry: scale drift is "
                         "unobservable and ATE grows superlinearly)")
    ap.add_argument("--retrieval-k", type=int, default=8,
                    help="retrieval loop-closure pairs per image on top of "
                         "the window (0 disables)")
    ap.add_argument("--out", default=None,
                    help="also write the result here as JSON (default: "
                         "print only)")
    ap.add_argument("--workdir", default=None,
                    help="persistent work dir: render + matching artifacts "
                         "are kept and reused on rerun (default: fresh "
                         "temp dir)")
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    result = run_scale(
        views=args.views, window=args.window, hw=args.hw,
        max_keypoints=args.max_keypoints, engine=args.engine,
        ba_every=args.ba_every, ba_iterations=args.ba_iterations,
        final_ba_iterations=args.final_ba_iterations, loop=args.loop,
        retrieval_k=args.retrieval_k, workdir=args.workdir,
        device=args.device)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    sys.exit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
