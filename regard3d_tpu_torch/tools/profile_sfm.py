"""Engine-only SfM profile: a corridor scene, no detection or matching.

Counterpart of the top-level ``tools/profile_sfm.py``: cameras dolly along
a corridor of random points, each seeing a local window of them (the
local visibility of a city walk), with exact observations plus pixel
noise built straight into ``SfMInputs``; ``run_incremental`` poses them
and the run prints its wall time, the engine's ``profile`` phases, the
posed count, the rms residual and the ATE after Sim3. Engine changes (BA,
initializer, resection) can be timed here without the matching stage.

Run: ``python -m regard3d_tpu_torch.tools.profile_sfm [--views 200]
[--pts 4500] [--window 3.0] [--ba-every 25] [--ba-iterations 12]
[--device cpu]``. Runs on cuda unless ``--device cpu`` (raises with no
card). The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def corridor_scene(rng, n_cams=150, n_pts=12000, f=800.0, w=1000, h=1000,
                   window=5.0, noise_px=0.4):
    """Cameras dolly along a corridor, each seeing only a local window of
    points; builds ``SfMInputs`` directly (no pairwise matches), so it
    scales to hundreds of views. The port's copy of the reference tests'
    ``corridor_scene`` (``tests/test_incremental.py``): the same draws in
    the same order. Returns (inputs on the CPU, TrackTable, true centres)."""
    from regard3d_tpu_torch.core import cameras
    from regard3d_tpu_torch.core.types import PINHOLE
    from regard3d_tpu_torch.sfm import incremental, tracks

    span = 60.0
    X = np.stack([rng.uniform(0, span, n_pts),
                  rng.normal(size=n_pts) * 2.5,
                  8.0 + rng.normal(size=n_pts) * 1.2], -1)
    cx = np.linspace(0, span, n_cams)
    Rs = np.tile(np.eye(3), (n_cams, 1, 1))
    Cs = np.stack([cx, 0.05 * rng.normal(size=n_cams),
                   np.zeros(n_cams)], -1)
    intr = np.zeros((1, 9), np.float32)
    intr[0, :3] = [f, w / 2, h / 2]

    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    obs_v, obs_t, obs_xy = [], [], []
    for v in range(n_cams):
        ids = np.nonzero(np.abs(X[:, 0] - cx[v]) < window)[0]
        uv, depth = cameras.project(f32(Rs[v]), f32(Cs[v]),
                                    torch.tensor(PINHOLE), f32(intr[0]),
                                    f32(X[ids]))
        uv = uv.numpy() + rng.normal(size=(len(ids), 2)) * noise_px
        inside = ((uv[:, 0] > 0) & (uv[:, 0] < w)
                  & (uv[:, 1] > 0) & (uv[:, 1] < h) & (depth.numpy() > 0))
        obs_v.append(np.full(inside.sum(), v, np.int64))
        obs_t.append(ids[inside].astype(np.int64))
        obs_xy.append(uv[inside])
    obs_v = np.concatenate(obs_v)
    obs_t = np.concatenate(obs_t)
    obs_xy = np.concatenate(obs_xy).astype(np.float32)
    # keep only tracks seen twice or more; renumber densely
    keep = np.bincount(obs_t, minlength=n_pts)[obs_t] >= 2
    obs_v, obs_t, obs_xy = obs_v[keep], obs_t[keep], obs_xy[keep]
    uniq, obs_t = np.unique(obs_t, return_inverse=True)
    order = np.argsort(obs_t, kind="stable")
    i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64)
    inputs = incremental.SfMInputs(
        xy=torch.as_tensor(obs_xy[order]), track_id=i64(obs_t[order]),
        view_id=i64(obs_v[order]), feature_id=i64(np.zeros(len(order))),
        num_tracks=len(uniq), intr_id=i64(np.zeros(n_cams)),
        intr=torch.as_tensor(intr), models=i64([PINHOLE]),
        image_sizes=np.tile([[w, h]], (n_cams, 1)))
    table = tracks.TrackTable(obs_t[order], obs_v[order],
                              np.zeros(len(order), np.int64), len(uniq))
    return inputs, table, Cs


def run_profile(views: int = 200, pts: int = 4500, window: float = 3.0,
                ba_every: int = 25, ba_iterations: int = 12,
                device=None) -> dict:
    """Build the corridor, run the engine on ``device``; returns a dict of
    the run's numbers."""
    from regard3d_tpu_torch import runtime
    from regard3d_tpu_torch.core import metrics
    from regard3d_tpu_torch.sfm import incremental

    dev = runtime.resolve_device(device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    inputs, _, Cs = corridor_scene(rng, n_cams=views, n_pts=pts,
                                   window=window)
    t_scene = time.time() - t0
    print(f"scene built in {t_scene:.1f}s: {inputs.xy.shape[0]} obs, "
          f"{inputs.num_tracks} tracks", flush=True)
    cfg = incremental.IncrementalConfig(ba_every=ba_every,
                                        ba_iterations=ba_iterations)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = incremental.run_incremental(inputs, cfg=cfg, device=dev)
    elapsed = time.time() - t0
    pm = res.pose_mask
    return {
        "views": views, "observations": int(inputs.xy.shape[0]),
        "tracks": inputs.num_tracks, "posed": int(pm.sum()),
        "rms_px": res.stats["rms_px"],
        "ate": float(metrics.ate_rmse(res.C.cpu().numpy()[pm], Cs[pm])),
        "scene_s": t_scene, "elapsed_s": elapsed,
        "profile": res.stats["profile"],
        "peak_device_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=200)
    ap.add_argument("--pts", type=int, default=4500)
    ap.add_argument("--window", type=float, default=3.0)
    ap.add_argument("--ba-every", type=int, default=25)
    ap.add_argument("--ba-iterations", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    r = run_profile(args.views, args.pts, args.window, args.ba_every,
                    args.ba_iterations, device=args.device)
    print(f"device={r['device']} views={r['views']} posed={r['posed']} "
          f"rms={r['rms_px']:.3f} ate={r['ate']:.4f}")
    print(f"TOTAL {r['elapsed_s']:.1f}s  profile={r['profile']}")
    print(json.dumps(r))


if __name__ == "__main__":
    main()
