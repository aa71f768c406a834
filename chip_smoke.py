#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA card and the CUDA toolkit (nvcc). Phases, each of which fails the
run if it fails:

(a) build the port's CUDA kernels from ``regard3d_tpu_torch/csrc`` (nvcc)
    and, beside them, its host library from ``native/r3d_native.cpp``
    (g++), and print the card; fail unless the three modes of the bf16
    kernel hold the same number of tensor-core instructions (HMMA) in the
    built SASS;
(b) drive the port's compute-matches stage through its library entry point,
    ``regard3d_tpu_torch.pipeline.compute_matches.run_compute_matches``, on
    the synthetic fountain scene (11 views at 1024x1024, 55 exhaustive
    pairs, 4096 keypoints, the default f32 brute-force matcher, 1024 RANSAC
    iterations, focals at 1.03x the truth); check the artifacts parse, hold
    the F inliers against the ground-truth epipolar geometry, and show the
    matcher kernel was launched on that run. Then the stage's matching once
    more, ``match_all_pairs`` under the flann (bf16) preset on the stage's
    descriptors: its bf16 kernel launched, its matches agree with the f32
    run's;
(c) hold each kernel against its plain PyTorch version on the card at the
    main paths' shapes (the stage's own descriptors): K1 in f32 and bf16,
    the single-pair call in f32 and bf16 with ragged M != N (split over
    column ranges), the two ablations of the matcher profile at the
    kernel's column tile, batched single pairs (``match_pairs_batched``,
    K1 over the table (p, p), one launch); time kernel, plain version and
    ``torch.bmm`` /
    ``torch.mm`` of the same distance products (a yardstick only; none for
    ``min_only``), and split
    the single-pair call's host time per call between its wrapper, its
    launch and its C call. Fails if bf16 K1 is not above the FFMA peak (it
    would not be on the tensor cores) or ``mm_only`` beats its tensor-core
    bound (almost none of its product ran). Exact ties inside
    one mma tile and across two column ranges keep the lowest column with
    d2 == d1; the bf16 kernel's instance for D set at run time agrees at
    D = 256;
(e) where the time goes: the stage again on its first 4 views (6 pairs),
    warm, once on the host clock and once under ``torch.profiler``; per
    phase (the stage's own profiler
    spans) the host time, the device's busy time and idle share, the number
    of device operations and the largest kernels, as one ``profile`` JSON
    line;
(f) the matcher profile, ``regard3d_tpu_torch.tools.profile_matcher``, on
    the stage's descriptors (64 pairs): its JSON line, and its three
    kernels launched;
(g) the triangulation stage at full width: ``regard3d_tpu_torch.pipeline.
    triangulation_step.run_triangulation`` on phase (b)'s own match
    directory (11 views at 1024x1024, 4096 keypoints; PINHOLE, one
    intrinsic group with f at 1.03x the truth, ``TriangulationParams()``:
    incremental2, MaxPair, intrinsics refined). Fails unless 11/11 cameras
    are posed, the ATE after Sim3 alignment against the true centers is <=
    0.08, the median residual < 1 px, ``scene.npz`` loads back,
    ``sfm_data.json`` holds 11 extrinsics and one structure entry per live
    track, both PLYs read back, and two ``bundle_adjust`` calls on the final
    state give bit-identical states. The run is under ``torch.profiler``:
    per engine span (``triangulation.<phase>``) the host time, the device's
    busy time and idle share and the number of device operations. One
    ``sfm`` JSON line;
(l) the engine menu on phase (b)'s matches at full width:
    ``run_triangulation`` with the global engine (on ``matches.e.txt``) and
    with the stellar initializer, each on the host clock (no profiler: (g)
    holds the profiled span breakdown) and held to (g)'s gates and artifact
    checks and to having allocated on the card; the engine's own phase
    times, the stellar run's pod size; one ``engines`` JSON line;
(m) the detector menu and the float64 engines at full width: phase (b)'s
    stage with each of GFTT, ORB, BRISK (corners on the card), MSER and
    TBMR (the port's native binding to ``native/r3d_native.cpp``, built by
    g++), each held to: every view's features parse with 1..4096
    keypoints inside the image, LIOP norms in (0.2, 1.01) (0: a flat
    patch), K1 f32 launched; TBMR's F inliers at a median < 1 px from the
    exact geometry on at least half the pairs (the other detectors' LIOP
    patches span a pixel or less and validate pairs on wrong matches in
    the reference too: their counts and medians are printed); view 0 on
    the card against the CPU (corners
    >= 99% in their tie group within 1e-3 px; host rows identical,
    descriptors >= 97% within 1e-4 and cosine > 0.9995: LIOP's gate at
    the CPU tests' share for small patches); one ``detectors`` line. Then ``run_triangulation
    (f64=True)`` on (b)'s matches with incremental2 + MaxPair and with the
    global engine, unprofiled, held to (g)'s gates and artifact checks,
    float64 in scene.npz and a bit-identical f64 ``bundle_adjust`` repeat;
    one ``f64`` line beside (g)'s and (l)'s f32 numbers;
(k) the scale axis at full width: ``regard3d_tpu_torch.tools.scale.
    run_scale`` on the synthetic city's 200-view open corridor (256 px,
    window 8, no retrieval: 1564 pairs, 1024 keypoints, 1024 RANSAC
    iterations, BA every 25 views, 12 / 100 iterations, focal at 1.03x;
    ``make_city`` renders the views in a process of its own started before
    (j), and ``run_scale`` reads them from its work directory).
    Fails unless >= 95% of the views are posed, the ATE after Sim3 is <=
    0.5% of the trajectory extent (``bench_scale.py``'s gates) and K1 f32
    was launched once per 64 pairs (25 times). One ``scale`` JSON line
    beside SCALE200.json's record (a TPU run of an older engine: set beside,
    not a gate). Then K1 f32 at that path's shape (64 window pairs, N =
    1024) against its plain version, timed beside its bound and
    ``torch.bmm``;
(h) the radial-K3 path: ``regard3d_tpu_torch.tools.accuracy.run_dataset(
    "fountain_rk3")`` (320 px, 2048 keypoints, 512 RANSAC iterations,
    radial-K3 with zero-initialized distortion recovered by BA) must meet
    the reference's gates; its row is printed beside ACCURACY.json's row
    for the same dataset (an ``accuracy`` JSON line);
(i) the dense slice on (g)'s posed scene and the same images, at the CLI's
    defaults for ``--method tpu``: ``mvs.driver.densify_scene`` (level 1,
    96 planes, 6 sources) -> ``dense.ply`` -> ``surface.poisson.
    reconstruct`` (depth 8, point weight 4, trim 7) -> ``surface.ply`` ->
    ``export.model_ops.colorize_mesh_from_cloud`` (k = 3) ->
    ``surface.texture.texture_mesh`` + ``write_textured_obj``. Fails unless
    every view has a depth map, the cloud and the mesh, mapped into the
    truth frame by the Sim3 fitted on the camera centres, lie on the
    fountain's quads (the GATE_* constants) and every artifact reads back.
    The run is profiled: per span (``densify.*``, ``surface.*``,
    ``texture.*``) the host time, device busy time, idle share, operation
    count and largest kernels; the grid statistics of the cloud handed to
    ``reconstruct`` (bounding box and diagonal, cell size, occupied cells
    and points per cell, faces before and after the trim); one ``dense``
    JSON line;
(j) the README's quick start through the command line, first of all the
    phases (before this process touches the card, whatever the card's
    compute mode): phase (b)'s 11 views written as JPEGs (quality 95) with
    EXIF (a ``BUILTIN_SENSORS`` body, the focal at 1.03x the truth in mm,
    GPS at the true centres: one scene unit a metre east/north/up of a
    fixed origin), then ``python -m regard3d_tpu_torch.cli`` subprocesses
    from another directory: init, import, ``matches --profile`` (the CLI
    defaults: 4096 keypoints, 1024 iterations, brute-force), ``pairs
    --json``, sfm (incremental2, radial-K3), ``sfm --engine incremental
    --initial-pair <best pair> --use-gps``, export in all nine formats,
    ``densify --method tpu``, ``surface --method tpu --depth 8`` with vertex
    colors and with textures, previews, info. Fails unless every command
    exits 0 and every step is ``finished``; import takes 11/11 focals from
    EXIF within 1e-3 and the GPS back within 0.01 m; >= half the pairs are
    F-validated with a median epipolar error < 1 px against the exact
    geometry, and the trace shows the f32 matcher kernel launched; the
    first sfm meets the accuracy gates; the GPS sfm's centres lie within
    0.08 RMS of the truth with no alignment; every export parses; the
    dense cloud and mesh meet (i)'s geometry gates, the two surfaces'
    reconstructs of one cloud give the same mesh bit for bit and the
    textured model reads back; no kernel was rebuilt. Steps that only read
    the project run beside the next writing step. One ``cli`` JSON line
    with each command's wall time (process start included),
    ``running_time_s`` and the grid of the cloud handed to ``reconstruct``
    (bounding box, cell, occupied cells, faces after the trim);
(n) distribution, right after (g), with two of everything on the one card
    (gloo between processes): ``python -m regard3d_tpu_torch.cli launch -n
    2 -- matches <(j)'s project>`` (every ``.feat``, ``.desc`` and
    ``matches.*.txt`` the bytes of (j)'s one-process ``matches``), then
    ``launch -n 2 -- sfm <(j)'s project> --dist-ba`` on them (exit 0, one
    new step each, ``finished``, 11/11 cameras, ATE <= 0.08 after Sim3,
    median < 1 px), in the background while this process runs
    ``bundle_adjust_point_sharded`` over ``[cuda:0, cuda:0]`` on (g)'s
    final problem (cost within 1e-4 of (g)'s
    ``bundle_adjust``, a repeat bit-identical), ``run_triangulation(
    dist_ba=True)`` on (b)'s matches at (g)'s gates and
    ``compute_depth_maps_sharded`` over ``[cuda:0, cuda:0]`` at level 2
    against ``compute_depth_maps`` (plane flips on <= 1% of the valid
    pixels); then ``dist.launch.launch_local(2, ..., module=None)`` runs
    this file's rank program: ``run_compute_matches(proc_id, proc_count=2)``
    at (b)'s settings (every ``.feat``, ``.desc`` and ``matches.*.txt`` the
    bytes of (b)'s, K1 f32 launched in each rank), then
    ``bundle_adjust_sharded`` over the ranks' gloo group on (g)'s problem
    (the same state in both ranks, cost within 1e-4 of (g)'s). No rank
    rebuilds a kernel. One ``dist`` JSON line with the ranks' layout;
(d) print the ``kernels`` JSON line (launches from the run of the path each
    kernel lies on: (b), its flann run, or (f), and K1's launches in (j)'s
    ``matches`` as ``launches_cli``, in (m)'s runs as
    ``launches_detectors``, in (n)'s two ranks as ``launches_ranks``, in
    (k)'s run as ``launches_scale``
    with the timings at (k)'s shape under ``scale``; (g), (h), (i), (l)
    and (m)'s f64 runs launch no kernel of their own), then the card's
    name and power limit, and the final ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import bisect
import collections
import concurrent.futures
import dataclasses
import json
import os
import shlex
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published peaks of one H100 SXM (dense): FP32 FFMA, bf16 tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

N_CAMS, HW, MAX_KP, PAIR_BLOCK = 11, 1024, 4096, 64
PROFILE_VIEWS = 4                # (e): the profiled stage's views
ACCURACY_ITERS = 512             # (h): RANSAC iterations
PHASES = ("features", "matching", "filter")
SFM_PHASES = ("init", "resection", "triangulation", "ba", "outlier")
SCALE_VIEWS = 200                # (k): SCALE200.json's corridor
ATE_BOUND = 0.08                 # bench_accuracy.GATES

# (i) the dense slice at the CLI's defaults for --method tpu
# (regard3d_tpu/pipeline/external.py:229-234, :263-267; densify_scene's at
# :135-138 are tools/dense_normals.DENSE_KW)
SURFACE_KW = dict(depth=8, samples_per_node=1.0, point_weight=4.0,
                  trim_threshold=7.0)
DENSE_SPANS = ("densify.sweep", "densify.fusion", "surface.splat",
               "surface.solve", "surface.marching", "surface.trim",
               "texture.visibility", "texture.sample")
# geometry gates of (i) against the fountain's quads
# (tools/dense_normals.dense_geometry); distances are fractions of the
# scene extent (the diagonal of the quads' bounding box)
GATE_CLOUD_TOL, GATE_CLOUD_FRAC = 0.01, 0.90
# set from the first card run (PERF.md §6, PR 4): normals of 7x7-smoothed
# 512^2 depth maps gave a median |cos| of 0.888 on (g)'s scene and on the
# exact poses alike; the window is fixed in pixels, so the finer the map the
# more of the sweep's depth noise reaches the normals. The reference gives
# the same normals on the same depth maps, and the same statistic on the
# fountain at 256 px (tests/test_torch_mvs.py). tools/dense_normals.py
# takes those readings again, outside this script's time budget
GATE_NORMAL_COS = 0.85
GATE_MIN_POINTS = 50_000         # 11 views x 256^2 grid cells at csize=2
GATE_SURFACE_TOL, GATE_SURFACE_FRAC = 0.02, 0.80
# (j) the command line's export menu
CLI_FORMATS = ("bundler", "pmvs", "nvm", "meshlab", "mve", "openmvs",
               "sfmoutput", "externalmvs", "mvstexturing")


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def true_fundamental(ds, i, j):
    """F with x2^T F x1 = 0 from the dataset's exact poses
    (x_cam = R (X - C)), focal f and principal point hw/2."""
    R1, C1, R2, C2 = ds["Rs"][i], ds["Cs"][i], ds["Rs"][j], ds["Cs"][j]
    R = R2 @ R1.T
    t = R2 @ (C1 - C2)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    c = ds["hw"] / 2.0
    K = np.array([[ds["f"], 0, c], [0, ds["f"], c], [0, 0, 1.0]])
    Ki = np.linalg.inv(K)
    return Ki.T @ (tx @ R) @ Ki


def sym_epipolar_px(F, p1, p2):
    h1 = np.concatenate([p1, np.ones((len(p1), 1))], 1)
    h2 = np.concatenate([p2, np.ones((len(p2), 1))], 1)
    l2 = h1 @ F.T
    l1 = h2 @ F
    num = np.abs(np.sum(h2 * l2, 1))
    return 0.5 * (num / np.hypot(l2[:, 0], l2[:, 1])
                  + num / np.hypot(l1[:, 0], l1[:, 1]))


def phase_build():
    """(a) build the kernels and the host library; then count the
    tensor-core instructions of each mode of the bf16 kernel in the built
    SASS: ptxas deletes an mma whose result is dead, so ``mm_only`` must
    keep as many HMMA as ``full``, or it would time only part of the
    product."""
    from regard3d_tpu_torch import native
    from regard3d_tpu_torch.kernels import _build
    from regard3d_tpu_torch.kernels import match as match_mod
    t0 = time.time()
    # nvcc and g++ side by side: the matcher's kernels and (m)'s host
    # library (built here, so no CLI process of (j) builds anything)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        host = pool.submit(native.build)
        lib = _build.build(match_mod._SOURCE)
        log(f"(a) built {match_mod._SOURCE} in {time.time() - t0:.1f} s")
        log(f"(a) built {os.path.basename(host.result())} from "
            f"{os.path.relpath(native.SOURCE)} in {time.time() - t0:.1f} s")
    hmma = _build.hmma_counts(lib)
    log(f"(a) HMMA per bf16 kernel instance (mode,D): {hmma}")
    for dc in ("0", "144"):                  # D at run time, D = 144
        n = [hmma.get(f"{m},{dc}", 0) for m in (0, 1, 2)]
        check(n[0] == n[1] == n[2] > 0,
              f"HMMA of full, mm_only, min_only (D={dc}; 0: set at run "
              f"time): {n}")


def run_stage(ds, out, detector="fast-akaze"):
    """The main path: the port's stage entry point at the smoke's shapes."""
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    return cm.run_compute_matches(ds["images"], out, cfg=cm.MatchConfig(),
                                  focals=np.full(len(ds["images"]),
                                                 ds["f"] * 1.03),
                                  max_keypoints=MAX_KP, detector=detector)


def epipolar_dists(ds, out):
    """Per F-validated pair of a match directory, the symmetric epipolar
    distances of its inliers against the exact geometry."""
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import features as fm
    f_matches = cm.load_matches_txt(os.path.join(out, "matches.f.txt"))
    kps, _ = fm.load_all_padded(out, N_CAMS, device="cpu")
    xy = kps.xy.numpy()
    return {(i, j): sym_epipolar_px(true_fundamental(ds, i, j),
                                    xy[i][m[:, 0]], xy[j][m[:, 1]])
            for (i, j), m in f_matches.items()}


def epipolar_check(ds, out):
    """F-validated pairs of a match directory and the median symmetric
    epipolar distance of their inliers against the exact geometry."""
    dists = list(epipolar_dists(ds, out).values())
    med = float(np.median(np.concatenate(dists))) if dists else float("inf")
    return len(dists), med


def phase_stage(ds, workdir):
    from regard3d_tpu_torch.kernels import match as match_mod
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import features as fm

    out = os.path.join(workdir, "matches")
    torch.cuda.reset_peak_memory_stats()
    match_mod.reset_launch_counts()
    stats = run_stage(ds, out)
    launches = dict(match_mod.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # artifacts exist and parse
    for i in range(N_CAMS):
        xy, sc, an, d = fm.load_features(out, i)
        check(len(xy) == stats["keypoints"][i] and d.shape == (len(xy), 144)
              and np.isfinite(d).all() and len(xy) > 0,
              f"bad features for image {i}")
    files = {}
    for tag in ("putative", "f", "e", "h"):
        files[tag] = cm.load_matches_txt(os.path.join(out,
                                                      f"matches.{tag}.txt"))
    with open(os.path.join(out, "sfm_data.json")) as fh:
        sfm = json.load(fh)
    check(len(sfm["views"]) == N_CAMS and len(sfm["intrinsics"]) == N_CAMS,
          "sfm_data.json views/intrinsics")
    n_pairs = N_CAMS * (N_CAMS - 1) // 2
    check(len(files["putative"]) == n_pairs,
          f"putative pairs {len(files['putative'])} != {n_pairs}")

    # ground truth: F inliers against the exact epipolar geometry
    n_f, med = epipolar_check(ds, out)
    summary = {
        "pairs": n_pairs, "pairs_f": n_f, "pairs_e": len(files["e"]),
        "pairs_h": len(files["h"]),
        "keypoints_mean": float(np.mean(stats["keypoints"])),
        "matches_putative": stats["matches_putative"],
        "matches_f": stats["matches_f"],
        "median_sym_epipolar_px": med,
        "time_features_s": stats["time_features_s"],
        "time_matching_s": stats["time_matching_s"],
        "time_filter_s": stats["time_filter_s"],
        "elapsed_s": stats["elapsed_s"],
        "peak_device_gb": peak_gb,
        "launches": launches,
    }
    log("(b) stage " + json.dumps(summary))
    check(launches["l2_top2_block_f32"] > 0,
          "the matcher kernel was not launched on the main path")
    check(n_f * 2 >= n_pairs, f"only {n_f} of {n_pairs} pairs F-validated")
    check(med < 1.0, f"median symmetric epipolar distance {med:.3f} px")
    return out, launches


def phase_flann(out, kps, descs):
    """(b) the stage's matching under the flann preset (bf16 operands) on
    the stage's own descriptors; its putative matches must agree with the
    f32 run's. Returns the run's launch counts."""
    from regard3d_tpu_torch.kernels import match as match_mod
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    match_mod.reset_launch_counts()
    got = cm.match_all_pairs(kps, descs, cm.MatchConfig(matcher="flann"))
    torch.cuda.synchronize()
    launches = dict(match_mod.LAUNCHES)
    f32 = cm.load_matches_txt(os.path.join(out, "matches.putative.txt"))
    inter = union = 0
    for pr in set(f32) | set(got):
        a = {tuple(r) for r in f32.get(pr, np.zeros((0, 2), int)).tolist()}
        b = {tuple(r) for r in got.get(pr, np.zeros((0, 2), int)).tolist()}
        inter, union = inter + len(a & b), union + len(a | b)
    jac = inter / max(union, 1)
    log(f"(b) flann preset: {sum(map(len, got.values()))} putative matches, "
        f"Jaccard {jac:.5f} against the f32 run's, launches {launches}")
    check(launches["l2_top2_block_bf16"] > 0,
          "the bf16 matcher kernel was not launched by the flann preset")
    check(jac >= 0.9, f"flann putative matches: Jaccard {jac:.4f} < 0.9")
    return launches


def _compare(name, got, want, rtol, atol):
    """Kernel (d1, i1, d2) against the plain version's: i1 equal on at
    least 99.9% of rows, every differing row a near-tie, d1/d2 within the
    tolerance. Returns the largest absolute distance error."""
    d1k, i1k, d2k = got
    d1p, i1p, d2p = want
    same = (i1k == i1p)
    frac = same.float().mean().item()
    diff = ~same
    near_tie = (d2p - d1p).abs() <= 1e-4 * d1p.abs() + 1e-6
    check(frac >= 0.999, f"{name}: i1 agrees on {frac:.5f} of rows")
    check(bool(near_tie[diff].all()),
          f"{name}: {int((diff & ~near_tie).sum())} differing rows are not "
          f"near-ties")
    err = max(_close(name, a, b, rtol, atol)
              for a, b in ((d1k, d1p), (d2k, d2p)))
    log(f"(c) {name}: i1 equal on {frac:.6f} of rows, max |d err| {err:.3e}")
    return err


def _close(name, a, b, rtol, atol):
    """a within rtol/atol of b (3e38 entries must stay 3e38); returns the
    largest absolute error over the finite entries."""
    big = b.abs() > 1e30
    ok = ((a - b).abs() <= rtol * b.abs() + atol) | (big & (a.abs() > 1e30))
    check(bool(ok.all()), f"{name}: values outside rtol {rtol} atol {atol}")
    e = (a - b).abs()[~big]
    return float(e.max()) if e.numel() else 0.0


# which path's run each row's launch count comes from: the stage's default
# f32 run, the stage's matching under the flann (bf16) preset, the matcher
# profile; the single-pair call lies on none of them
ROW_PATH = {"l2_top2_block_f32": "stage", "l2_top2_block_bf16": "flann",
            "l2_top2_f32": "stage", "l2_top2_bf16": "stage",
            "l2_top2_block_mm_only_bf16": "profile",
            "l2_top2_block_min_only_bf16": "profile"}
K1 = "regard3d_tpu/kernels/match.py:246"
K2 = "regard3d_tpu/kernels/match.py:151"
K3 = "tools/profile_matcher.py:86"


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn`` over back-to-back calls (the
    launches queue on the card; one synchronize after the timed calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def host_split(match_mod, a, b, mb, ab, bb, bf16):
    """(c) where a single-pair call's host time goes: the wrapper
    ``l2_top2``; its ``_launch`` on operands and |b|^2 made beforehand
    (argument checks, output allocation, the C call); the C call alone on
    outputs and scratch allocated once (kernel attributes, the launches of
    the kernel and of the merge of its column ranges)."""
    dev = a.device
    (M, D), N = a.shape, b.shape[0]
    bn = match_mod._bnorm(b, mb)[None]
    splits = match_mod.column_splits(1, M, N, match_mod._sm_count(dev.index))
    outs = [torch.empty((1, M), dtype=t, device=dev)
            for t in (torch.float32, torch.int32, torch.float32)]
    part = torch.empty(((3 * splits + 1) * M,), device=dev)
    fn = match_mod._lib()
    args = (int(bf16), 0, ab.data_ptr(), bb.data_ptr(), bn.data_ptr(),
            match_mod._single_pair(dev.index).data_ptr(), 1, M, N, D, splits,
            *(t.data_ptr() for t in outs), part.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(fn(*args) == 0, "the single-pair C call failed")
    return {
        "wrapper": host_us(lambda: match_mod.l2_top2(a, b, mb, bf16=bf16)),
        "launch": host_us(lambda: match_mod._launch(ab[None], bb[None], bn,
                                                    None)),
        "c_call": host_us(lambda: fn(*args)),
    }


def kernel_row(name, run, plain, lib, P, M, N, D, in_bytes, out_words,
               bf16, replaces, compare, tag="(c)"):
    """One kernel against its plain version on the same inputs, timed
    beside its bound, its plain version and a library call: the row of the
    ``kernels`` line (``launches`` filled in by the caller)."""
    got = run()
    torch.cuda.synchronize()
    err = compare(name, got, plain())
    ms = cuda_ms(run, reps=20)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    lib_ms = cuda_ms(lib, reps=10) if lib is not None else None
    flops = 2.0 * P * M * N * D
    nbytes = in_bytes + out_words * P * M * 4
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    row = {
        "name": name, "route": "cuda",
        "source": "regard3d_tpu_torch/csrc/match_top2.cu",
        "replaces": replaces, "launches": None,
        "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms,
        "shape": {"P": P, "M": M, "N": N, "D": D,
                  "dtype": "bfloat16" if bf16 else "float32"},
        "tflops": flops / (ms * 1e-3) / 1e12,
    }
    lib_s = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
    log(f"{tag} {name} (P={P} M={M} N={N}): {ms:.4f} ms (plain "
        f"{plain_ms:.3f} ms, library {lib_s}, bound {row['bound_ms']:.4f} "
        f"ms, {row['tflops']:.1f} TFLOP/s)")
    return row


def phase_kernels(desc, mask, parr):
    """(c) every kernel against its plain version at the main paths'
    shapes, timed beside its bound, its plain version and a library call."""
    from regard3d_tpu_torch.kernels import match as match_mod

    B, N, D = desc.shape
    pl = parr.long().cuda()
    P = parr.shape[0]
    log(f"(c) main-path shapes: B={B} N={N} D={D} P={P}")
    rows = []

    def entry(name, M, Nn, **kw):
        Pn = P if name.startswith("l2_top2_block") else 1
        rows.append(kernel_row(name, P=Pn, M=M, N=Nn, D=D, **kw))
        return rows[-1]

    # (rtol, atol) of d1/d2: both sides sum exact products in f32 in other
    # orders; bf16's looser rtol covers the tensor cores' adder tree
    tol = {False: (1e-5, 1e-5), True: (1e-4, 1e-5)}
    top2 = lambda bf16: lambda n, g, w: _compare(n, g, w, *tol[bf16])
    dbytes = desc.numel() * desc.element_size() + mask.numel() + P * 8
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        ga, gb = desc[pl[:, 0]], desc[pl[:, 1]]
        if bf16:
            ga, gb = ga.to(torch.bfloat16), gb.to(torch.bfloat16)
        row = entry(f"l2_top2_block_{tag}",
                    run=lambda b=bf16: match_mod.l2_top2_block(
                        desc, mask, parr, bf16=b),
                    plain=lambda b=bf16: match_mod.l2_top2_block_plain(
                        desc, mask, parr, bf16=b),
                    lib=lambda ga=ga, gb=gb: torch.bmm(ga, gb.transpose(1, 2)),
                    M=N, Nn=N, in_bytes=dbytes, out_words=3, bf16=bf16,
                    replaces=K1, compare=top2(bf16))
        if bf16:
            check(row["tflops"] * 1e12 > PEAK_F32_FLOPS,
                  f"K1 bf16 at {row['tflops']:.1f} TFLOP/s is not above the "
                  f"FFMA peak: not on the tensor cores")
    # single pair with ragged M != N (no tile divides either); split over
    # column ranges to fill the card
    a = desc[0, :4000].contiguous()
    b = desc[1, :3001].contiguous()
    mb = mask[1, :3001].contiguous()
    for bf16 in (False, True):
        ab, bb = ((a.to(torch.bfloat16), b.to(torch.bfloat16)) if bf16
                  else (a, b))
        unsq = lambda f: (lambda: tuple(t[None] for t in f()))
        row = entry(f"l2_top2_{'bf16' if bf16 else 'f32'}",
                    run=unsq(lambda x=bf16: match_mod.l2_top2(a, b, mb,
                                                              bf16=x)),
                    plain=unsq(lambda x=bf16: match_mod.l2_top2_plain(
                        a, b, mb, bf16=x)),
                    lib=lambda ab=ab, bb=bb: torch.mm(ab, bb.t()),
                    M=a.shape[0], Nn=b.shape[0],
                    in_bytes=(a.numel() + b.numel()) * 4 + mb.numel(),
                    out_words=3, bf16=bf16, replaces=K2, compare=top2(bf16))
        row["host_us"] = host_split(match_mod, a, b, mb, ab, bb, bf16)
        log(f"(c) {row['name']}: host us per call {row['host_us']}")
    # K3: the ablations against their plain versions at the kernel's tile_n;
    # mm_only's library call is torch.bmm of the same bf16 operands (K1's),
    # min_only has none (it would take baddbmm + amin)
    ga = desc[pl[:, 0]].to(torch.bfloat16)
    gb = desc[pl[:, 1]].to(torch.bfloat16)
    for mode in match_mod.ABLATIONS:
        row = entry(f"l2_top2_block_{mode}_bf16",
                    run=lambda m=mode: match_mod.l2_top2_block_ablated(
                        desc, mask, parr, m),
                    plain=lambda m=mode: match_mod.l2_top2_block_ablated_plain(
                        desc, mask, parr, m, match_mod.TILE_N),
                    lib=(lambda: torch.bmm(ga, gb.transpose(1, 2)))
                    if mode == "mm_only" else None,
                    M=N, Nn=N, in_bytes=dbytes, out_words=1,
                    bf16=True, replaces=K3,
                    compare=lambda n, g, w: _close(n, g, w, 1e-5, 1e-5))
        if mode == "mm_only":
            # catches only a product removed almost entirely: one that keeps
            # part of its mma still runs above the bound. Phase (a)'s HMMA
            # count per mode is the guard that sees a partial removal.
            check(row["ms"] >= row["bound_ms"],
                  f"mm_only ran in {row['ms']:.4f} ms, under its tensor-core "
                  f"bound {row['bound_ms']:.4f} ms: almost all of the product "
                  f"was removed")
    # batched single pairs (M != N, ragged) reach K1 over the pair table
    # (p, p), one launch
    A = desc[pl[:3, 0], :1000].contiguous()
    Bt = desc[pl[:3, 1], :777].contiguous()
    ma, mb = mask[pl[:3, 0], :1000], mask[pl[:3, 1], :777]
    before = match_mod.LAUNCHES["l2_top2_block_f32"]
    got = match_mod.match_pairs_batched(A, ma, Bt, mb)
    torch.cuda.synchronize()
    want = match_mod.match_pairs_batched(A, ma, Bt, mb, use_kernel=False)
    check(match_mod.LAUNCHES["l2_top2_block_f32"] == before + 1,
          "match_pairs_batched did not launch K1 once")
    same = (got[0] == want[0]).float().mean().item()
    check(same >= 0.999 and (got[2] == want[2]).float().mean().item()
          >= 0.999, f"match_pairs_batched: idx/ok agree on {same:.5f}")
    err = _close("match_pairs_batched", got[1], want[1], 1e-5, 1e-5)
    log(f"(c) match_pairs_batched (3 x 1000 x 777): K1 launched once, idx "
        f"equal on {same:.6f}, max |d1 err| {err:.3e}")
    return rows


def phase_ties(desc):
    """(c) exact ties in a split single-pair call: duplicate B rows inside
    one mma tile (columns 9 and 11, one n8 tile, two lanes) and in two
    column ranges (5 and 2000): i1 is the lowest column and d2 == d1, in
    both dtypes, as in ``tests/test_torch_match.py``."""
    from regard3d_tpu_torch.kernels import match as match_mod
    a = desc[0, :256].contiguous()
    b = desc[1, :3001].clone()
    b[5] = a[0] + 0.01
    b[2000] = b[5]
    b[9] = a[1] + 0.01
    b[11] = b[9]
    mb = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = match_mod.column_splits(1, a.shape[0], b.shape[0], sms)
    check(splits > 1, "the tie case is not split")
    per = -(-(-(-b.shape[0] // 128)) // splits) * 128   # columns a range
    check(5 // per != 2000 // per, "columns 5 and 2000 share a range")
    for bf16 in (False, True):
        got = match_mod.l2_top2(a, b, mb, bf16=bf16)
        torch.cuda.synchronize()
        want = match_mod.l2_top2_plain(a, b, mb, bf16=bf16)
        name = f"ties_{'bf16' if bf16 else 'f32'}"
        _compare(name, tuple(t[None] for t in got),
                 tuple(t[None] for t in want), 1e-4, 1e-5)
        d1, i1, d2 = (t.cpu() for t in got)
        check(int(i1[0]) == 5 and int(i1[1]) == 9,
              f"{name}: i1 {int(i1[0])}, {int(i1[1])} (want 5, 9)")
        check(bool(d1[0] == d2[0]) and bool(d1[1] == d2[1]),
              f"{name}: d2 != d1 on a tie")
    log(f"(c) ties: lowest column and d2 == d1 in f32 and bf16, "
        f"{splits} column ranges of {per} columns")


def phase_wide(desc, mask, parr):
    """(c) the bf16 kernel's instance for D fixed at run time (the one for
    D = 144 is compiled apart): the stage's descriptors zero-padded to the
    reference's 256 columns, 4 pairs, against the plain versions."""
    from regard3d_tpu_torch.kernels import match as match_mod
    wide = torch.nn.functional.pad(desc, (0, 256 - desc.shape[2]))
    pr = parr[:4]
    _compare("l2_top2_block_bf16_d256",
             match_mod.l2_top2_block(wide, mask, pr, bf16=True),
             match_mod.l2_top2_block_plain(wide, mask, pr, bf16=True),
             1e-4, 1e-5)
    for mode in match_mod.ABLATIONS:
        err = _close(f"{mode}_d256",
                     match_mod.l2_top2_block_ablated(wide, mask, pr, mode),
                     match_mod.l2_top2_block_ablated_plain(wide, mask, pr,
                                                           mode), 1e-5, 1e-5)
        log(f"(c) {mode}_d256: max |d err| {err:.3e}")


def phase_matcher_profile(desc, mask, parr):
    """(f) the matcher profile (this slice's entry point) on the stage's
    own descriptors; returns its launch counts."""
    from regard3d_tpu_torch.kernels import match as match_mod
    from regard3d_tpu_torch.tools import profile_matcher as pm
    match_mod.reset_launch_counts()
    res = pm.profile(desc, mask, parr)
    launches = dict(match_mod.LAUNCHES)
    log(json.dumps({"matcher_profile": res}))
    for key in ("l2_top2_block_bf16", "l2_top2_block_mm_only_bf16",
                "l2_top2_block_min_only_bf16"):
        check(launches[key] > 0, f"the profile did not launch {key}")
    check(all(np.isfinite(res[f"{v}_tflops"]) and res[f"{v}_tflops"] > 0
              for v in pm.VARIANTS), "profile rates")
    return launches


def _busy_s(intervals):
    """Length of the union of (start, end) intervals in ns, in seconds."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9


def phase_profile(ds, workdir):
    """The stage again, warm: host times from an unprofiled run, device
    operations from a profiled one, each attributed to the phase span
    (``compute_matches.<phase>``) in which it starts. Idle share = 1 -
    device busy time (union of kernel, copy and memset intervals) / host
    time of the phase. Reads the profiler's raw events: building its
    per-op event tree for ~3M events would take minutes. On the first
    PROFILE_VIEWS views (the profiler's cost grows with the events it
    records, ~15 us each on the card's host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ds = dict(ds, images=ds["images"][:PROFILE_VIEWS])
    warm = run_stage(ds, os.path.join(workdir, "warm"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_stage(ds, os.path.join(workdir, "profiled"))
    events = prof.profiler.kineto_results.events()
    tag = "compute_matches."
    spans, device = {}, []
    for e in events:
        name = e.name()
        if name.startswith(tag):
            if e.device_type() == DeviceType.CPU:
                spans[name[len(tag):]] = (e.start_ns(), e.end_ns())
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), name))
    rows = []
    for ph in PHASES:
        check(ph in spans, f"no profiler span for phase {ph}")
        lo, hi = spans[ph]
        ops = [o for o in device if lo <= o[0] <= hi]
        busy = _busy_s([(a, b) for a, b, _ in ops])
        host = warm[f"time_{ph}_s"]
        top = collections.Counter()
        for a, b, name in ops:
            top[name[:80]] += (b - a) * 1e-9
        rows.append({"phase": ph, "host_s": host, "device_busy_s": busy,
                     "idle_share": 1.0 - busy / host,
                     "device_ops": len(ops),
                     "top_kernels": [[k, v] for k, v in
                                     top.most_common(4)]})
        log(f"(e) {ph}: host {host:.3f} s, device busy {busy:.3f} s, idle "
            f"share {1.0 - busy / host:.3f}, {len(ops)} device ops")
        check(len(ops) > 0, f"phase {ph} ran nothing on the device")
    log(json.dumps({"profile": rows, "stage_warm_s": warm["elapsed_s"],
                    "views": PROFILE_VIEWS}))


def run_sfm(ds, matches, out, device=None, **params):
    """The triangulation stage at the smoke's shapes; ``params`` of
    ``TriangulationParams`` (none: the main path, incremental2 + MaxPair)."""
    from regard3d_tpu_torch.core.types import PINHOLE
    from regard3d_tpu_torch.pipeline import triangulation_step as ts
    intr = np.zeros((1, 9), np.float32)
    intr[0, :3] = [1.03 * ds["f"], HW / 2.0, HW / 2.0]
    return ts.run_triangulation(matches, out, ds["images"],
                                intr_id=np.zeros(N_CAMS, np.int32),
                                intr=intr,
                                models=np.asarray([PINHOLE], np.int32),
                                params=ts.TriangulationParams(**params),
                                device=device)


def check_sfm(ds, out, stats, tag):
    """A triangulation run's gates and artifacts: every camera posed, ATE
    after Sim3 within the bound, median residual < 1 px, ``scene.npz``
    loads back, ``sfm_data.json`` holds every extrinsic and one structure
    entry per live track, both PLYs read back. Returns (scene, ATE)."""
    from regard3d_tpu_torch.core import metrics
    from regard3d_tpu_torch.core.sfm_data import load_npz
    from regard3d_tpu_torch.export import ply
    scene = load_npz(os.path.join(out, "scene.npz"))
    pm = scene.poses.mask.numpy()
    ate = metrics.ate_rmse(scene.poses.C.numpy()[pm],
                           ds["Cs"][np.nonzero(pm)[0]])
    with open(os.path.join(out, "sfm_data.json")) as fh:
        sfm = json.load(fh)
    clouds = {n: ply.read_ply(os.path.join(out, n)) for n in
              ("cloud_and_poses.ply", "FinalColorized.ply")}
    log(f"{tag} {stats['num_cameras']}/{N_CAMS} cameras, "
        f"{stats['num_tracks']} tracks, ATE {ate:.5f}, median residual "
        f"{stats['residual_median']:.4f} px")
    check(stats["num_cameras"] == N_CAMS,
          f"{tag} {stats['num_cameras']} of {N_CAMS} cameras posed")
    check(ate <= ATE_BOUND, f"{tag} ATE {ate:.4f} > {ATE_BOUND}")
    check(stats["residual_median"] < 1.0,
          f"{tag} median residual {stats['residual_median']:.3f} px")
    check(len(sfm["extrinsics"]) == N_CAMS
          and len(sfm["structure"]) == stats["num_tracks"]
          and len(sfm["views"]) == N_CAMS,
          f"{tag} sfm_data.json: {len(sfm['extrinsics'])} extrinsics, "
          f"{len(sfm['structure'])} structure entries")
    check(len(clouds["FinalColorized.ply"].xyz) == stats["num_tracks"]
          and len(clouds["cloud_and_poses.ply"].xyz)
          == stats["num_tracks"] + N_CAMS, f"{tag} PLY vertex counts")
    check(bool(np.isfinite(scene.landmarks.X.numpy()).all()),
          f"{tag} non-finite landmarks")
    return scene, ate


def span_table(events, names):
    """Per profiler span name (CPU ``record_function`` spans, one name may
    open many times): the number of spans, their host time, the device's
    busy time and idle share over the device operations that start inside
    them, the operation count and the three largest kernels by time. The
    device-side copies of the spans' own annotations are not operations."""
    from torch.autograd import DeviceType
    spans, device = collections.defaultdict(list), []
    for e in events:
        name = e.name()
        if name in names:
            if e.device_type() == DeviceType.CPU:
                spans[name].append((e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), name))
    device.sort()
    starts = [o[0] for o in device]
    rows = []
    for name in names:
        check(name in spans, f"no profiler span {name}")
        ops = []
        for lo, hi in spans[name]:
            ops += device[bisect.bisect_left(starts, lo):
                          bisect.bisect_right(starts, hi)]
        host = sum(hi - lo for lo, hi in spans[name]) * 1e-9
        busy = _busy_s([(a, b) for a, b, _ in ops])
        top = collections.Counter()
        for a, b, kname in ops:
            top[kname[:80]] += (b - a) * 1e-9
        rows.append({"span": name, "spans": len(spans[name]),
                     "host_s": host, "device_busy_s": busy,
                     "idle_share": 1.0 - busy / host if host else None,
                     "device_ops": len(ops),
                     "top_kernels": [[k, v] for k, v in top.most_common(3)]})
    return rows


def _ba_problem(scene):
    """The final scene as a BA problem: state, observations, the fixed
    poses (unposed views and the first posed one) and (g)'s options."""
    from regard3d_tpu_torch.ba import lm
    pm = scene.poses.mask
    obs = scene.observations
    g = scene.views.intrinsic_id.long()[obs.view_id.long()]
    ba_obs = lm.BAObservations(
        view_id=obs.view_id.long(), intr_id=g,
        point_id=obs.landmark_id.long(),
        model=scene.intrinsics.model.long()[g], xy=obs.xy,
        weight=obs.mask.to(obs.xy.dtype))
    state = lm.BAState(R=scene.poses.R, C=scene.poses.C,
                       intr=scene.intrinsics.params, X=scene.landmarks.X)
    fixed = ~pm.clone()
    fixed[int(torch.nonzero(pm)[0])] = True
    opts = lm.BAOptions(max_iterations=10, refine_intrinsics=True,
                        huber_delta_px=2.0)
    return state, ba_obs, fixed, opts


def final_cost(scene) -> float:
    """The BA cost (Huber 2 px) of a run's final scene."""
    from regard3d_tpu_torch.ba import lm
    state, ba_obs, _, opts = _ba_problem(scene)
    return float(lm.compute_cost(state, ba_obs, opts))


def _bit_identical_ba(scene):
    """Two bundle_adjust calls on the final scene: the same bits."""
    from regard3d_tpu_torch.ba import lm
    state, ba_obs, fixed, opts = _ba_problem(scene)
    outs = [lm.bundle_adjust(state, ba_obs, opts, fixed_pose_mask=fixed)
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    check(same, "two bundle_adjust calls on the same state differ")
    check(outs[0][1] == outs[1][1], "two bundle_adjust calls: other stats")
    return {"iterations": outs[0][1].iterations,
            "initial_cost": outs[0][1].initial_cost,
            "final_cost": outs[0][1].final_cost, "bit_identical": same,
            "dtype": str(outs[0][0].X.dtype)}


def phase_sfm(ds, matches, workdir):
    """(g) the triangulation stage on phase (b)'s matches, its artifacts,
    the determinism of BA, and where its time goes by engine span (one run,
    under the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(workdir, "sfm")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = run_sfm(ds, matches, out)
    elapsed = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    scene, ate = check_sfm(ds, out, stats, f"(g) {elapsed:.1f} s:")
    ba = _bit_identical_ba(scene)

    # where the time goes, by engine span
    rows = span_table(prof.profiler.kineto_results.events(),
                      ["triangulation." + ph for ph in SFM_PHASES])
    for r in rows:
        r["phase"] = r.pop("span")[len("triangulation."):]
        log(f"(g) {r['phase']}: {r['spans']} spans, host {r['host_s']:.3f} "
            f"s, device busy {r['device_busy_s']:.3f} s, {r['device_ops']} "
            f"device ops")
    check(sum(r["device_ops"] for r in rows) > 0,
          "the triangulation stage ran nothing on the device")
    summary = {
        "cameras": stats["num_cameras"], "tracks": stats["num_tracks"],
        "observations": stats["num_observations"], "ate": ate,
        "rms_px": stats["rms_px"],
        "residual_px": {k: stats[f"residual_{k}"]
                        for k in ("min", "max", "mean", "median")},
        "init_pair": stats["init_pair"], "profile": stats["profile"],
        "elapsed_profiled_s": elapsed, "peak_device_gb": peak_gb,
        "focal_est": float(scene.intrinsics.params[0, 0]),
        "focal_gt": float(ds["f"]), "final_cost": final_cost(scene),
        "ba_repeat": ba, "spans": rows}
    log(json.dumps({"sfm": summary}))
    return summary


def device_allocations() -> int:
    """Blocks the caching allocator has handed out on the card so far: it
    grows with every device operation that makes a tensor."""
    return torch.cuda.memory_stats().get("allocation.all.allocated", 0)


def phase_engines(ds, matches, workdir):
    """(l) the engine menu on phase (b)'s matches at full width: the global
    engine (``matches.e.txt``) and the stellar initializer, each through
    ``run_triangulation`` on the host clock (unprofiled: (g) holds the
    profiled breakdown of the engine spans), each held to (g)'s gates and
    artifact checks and to having run on the card (device allocations),
    with the engine's own phase times; one ``engines`` line."""
    out = {}
    for tag, params in (("global", dict(engine="global")),
                        ("stellar", dict(initializer="stellar"))):
        run_dir = os.path.join(workdir, f"sfm_{tag}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocs = device_allocations()
        t0 = time.time()
        stats = run_sfm(ds, matches, run_dir, **params)
        torch.cuda.synchronize()
        elapsed = time.time() - t0
        allocs = device_allocations() - allocs
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        scene, ate = check_sfm(ds, run_dir, stats,
                               f"(l) {tag} {elapsed:.1f} s:")
        check(allocs > 0, f"(l) {tag} ran nothing on the device")
        out[tag] = {
            "params": params, "cameras": stats["num_cameras"],
            "tracks": stats["num_tracks"],
            "observations": stats["num_observations"], "ate": ate,
            "rms_px": stats["rms_px"],
            "residual_median_px": stats["residual_median"],
            "final_cost": final_cost(scene), "seconds": elapsed,
            "profiled": False, "device_allocations": allocs,
            "peak_device_gb": peak_gb,
            **{k: stats[k] for k in ("num_relative_motions", "init_hub",
                                     "stellar_pod_size", "init_pair",
                                     "profile") if k in stats}}
    log(json.dumps({"engines": out}))
    return out


# (m) the detector menu beside the default Fast-AKAZE, and the f64 engines
MENU = ("gftt", "orb", "brisk", "mser", "tbmr")
# the detectors whose F-validated pairs are not held to the exact geometry:
# GFTT describes 3 px corners at kpSizeFactor 0.13, a LIOP patch under a
# pixel, so its putative matches are mostly wrong and the filter validates
# pairs on wrong matches in the reference as in the port
# (tests/test_torch_detector_geometry.py runs both on the same views); its
# counts and medians are printed. Every other detector's F-validated
# pairs must lie at a median < 1 px, and TBMR, which describes its regions
# at their size, must also validate half the pairs
GEOMETRY_EXEMPT = ("gftt",)


def liop_gate(a, b):
    """(fraction within 1e-4 in L2, largest distance, smallest cosine); a
    flat patch's zero descriptor must be zero in both."""
    dist = np.linalg.norm(a - b, axis=1)
    live = np.linalg.norm(a, axis=1) > 0.5
    check(bool((live == (np.linalg.norm(b, axis=1) > 0.5)).all()),
          "zero descriptors differ")
    cos = np.sum(a * b, 1)[live]
    return (float((dist <= 1e-4).mean()), float(dist.max()),
            float(cos.min()) if len(cos) else 1.0)


def _detector_on_both_devices(img, d, workdir):
    """View 0 through detector ``d`` on the card and on the CPU (the plain
    torch path): the corner detectors' keypoints in tie-group rank order,
    the host detectors' .feat rows and their descriptors (LIOP on each
    device)."""
    from regard3d_tpu_torch.kernels import corners
    from regard3d_tpu_torch.pipeline import features as fm
    from regard3d_tpu_torch.tools.keypoint_agreement import rank_agreement
    if d not in fm.HOST_DETECTORS:
        fn = getattr(corners, f"detect_{d}")
        rows = []
        for dev in ("cuda", "cpu"):
            k = fn(torch.as_tensor(img[None], device=dev),
                   max_keypoints=MAX_KP)
            rows.append(tuple(t[0].cpu().numpy() for t in (
                k.xy, k.scale, k.score, k.mask)))
        in_rank, frac = rank_agreement(rows[1], rows[0])
        log(f"(m) {d} view 0, cuda against cpu: of {int(rows[1][3].sum())} "
            f"keypoints {in_rank:.5f} at their rank, {frac:.5f} in their "
            f"tie group")
        check(frac >= 0.99, f"(m) {d}: cuda agrees with cpu on {frac:.4f}")
        return {"keypoints_at_rank": in_rank, "keypoints_in_tie_group": frac}
    got = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(workdir, f"view0_{d}_{dev}")
        fm.extract_features([img], out, max_keypoints=MAX_KP, detector=d,
                            device=dev)
        got[dev] = fm.load_features(out, 0)
    (pa, sa, aa, da), (pb, sb, ab, db) = got["cuda"], got["cpu"]
    check(np.array_equal(pa, pb) and np.array_equal(sa, sb)
          and np.array_equal(aa, ab), f"(m) {d}: .feat rows differ")
    within, worst, cos = liop_gate(db, da)
    log(f"(m) {d} view 0, cuda against cpu: {len(pa)} identical rows, "
        f"descriptors {within:.5f} within 1e-4 (largest {worst:.2e}, "
        f"cosine >= {cos:.6f})")
    # LIOP's gate (ROADMAP §3: cosine > 0.9995) at the share of
    # tests/test_torch_features.py for small patches: bilinear samples of
    # a pixel-sized neighbourhood tie often, so f32 rounding moves a few
    # pixels across an ordinal bin
    check(within >= 0.97 and cos > 0.9995,
          f"(m) {d}: descriptors {within:.4f} within 1e-4, cosine {cos}")
    return {"rows_identical": True, "desc_within_1e-4": within,
            "desc_max_l2": worst, "desc_min_cosine": cos}


def phase_detectors(ds, workdir):
    """(m) the detector menu at full width: ``run_compute_matches`` with
    each of GFTT, ORB, BRISK, MSER and TBMR on (b)'s views, settings and
    focals. Fails unless every view's features parse with 1..4096
    keypoints inside the image, every LIOP norm lies in (0.2, 1.01) (or is
    0: a flat patch, as the reference writes), K1 f32 was launched on that
    run, the F-validated pairs' inliers lie at a median < 1 px from the
    exact epipolar geometry (but for ``GEOMETRY_EXEMPT``, whose counts and
    medians are printed) and TBMR validates half the pairs; view 0 on the
    card agrees with the CPU. Times the ``.feat`` parse of TBMR's views
    (``feat_parse``). One ``detectors`` line; returns K1's launches per
    detector."""
    from regard3d_tpu_torch.kernels import match as match_mod
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import features as fm
    n_pairs = N_CAMS * (N_CAMS - 1) // 2
    rows, launches = {}, {}
    for d in MENU:
        out = os.path.join(workdir, f"matches_{d}")
        match_mod.reset_launch_counts()
        t0 = time.time()
        stats = run_stage(ds, out, detector=d)
        elapsed = time.time() - t0
        launches[d] = match_mod.LAUNCHES["l2_top2_block_f32"]
        zero = 0
        for i in range(N_CAMS):
            xy, sc, an, desc = fm.load_features(out, i)
            n = len(xy)
            check(1 <= n <= MAX_KP and n == stats["keypoints"][i]
                  and desc.shape == (n, 144), f"(m) {d} view {i}: {n} rows")
            check(bool(((xy >= 0) & (xy <= HW - 1)).all()),
                  f"(m) {d} view {i}: keypoints outside the image")
            norms = np.linalg.norm(desc, axis=1)
            zero += int((norms == 0).sum())
            check(bool(((norms == 0) | ((norms > 0.2) & (norms < 1.01)))
                       .all()), f"(m) {d} view {i}: LIOP norms out of range")
        files = {t: cm.load_matches_txt(os.path.join(out,
                                                     f"matches.{t}.txt"))
                 for t in ("putative", "f", "e", "h")}
        dists = epipolar_dists(ds, out)
        n_f = len(dists)
        med = (float(np.median(np.concatenate(list(dists.values()))))
               if dists else float("inf"))
        on_geometry = sum(float(np.median(v)) < 1.0 for v in dists.values())
        rows[d] = {
            "keypoints": stats["keypoints"], "zero_descriptors": zero,
            "pairs_putative": len(files["putative"]),
            "pairs_f": len(files["f"]), "pairs_e": len(files["e"]),
            "pairs_h": len(files["h"]),
            "matches_putative": stats["matches_putative"],
            "matches_f": stats["matches_f"],
            "median_sym_epipolar_px": med if n_f else None,
            "pairs_f_on_geometry": on_geometry,
            "k1_launches": launches[d],
            **{k: stats[k] for k in ("time_features_s", "time_matching_s",
                                     "time_filter_s", "elapsed_s")},
            "wall_s": elapsed}
        log(f"(m) {d}: keypoints {min(stats['keypoints'])}-"
            f"{max(stats['keypoints'])}, putative pairs "
            f"{len(files['putative'])}, F/E/H {n_f}/{len(files['e'])}/"
            f"{len(files['h'])}, median {med:.4f} px ({on_geometry} pairs "
            f"on the geometry), K1 {launches[d]}, {elapsed:.1f} s")
        check(launches[d] > 0, f"(m) {d}: the matcher kernel was not "
              "launched")
        if d == "tbmr":
            check(n_f * 2 >= n_pairs, f"(m) {d}: {n_f} of {n_pairs} pairs "
                  "F-validated")
        if n_f and d not in GEOMETRY_EXEMPT:
            check(med < 1.0, f"(m) {d}: median {med:.3f} px")
        rows[d]["view0"] = _detector_on_both_devices(ds["images"][0], d,
                                                     workdir)
    rows["feat_parse"] = feat_parse_times(os.path.join(workdir,
                                                        "matches_tbmr"))
    log(json.dumps({"detectors": rows}))
    return launches


def feat_parse_times(out, repeats=5):
    """Seconds to parse a match directory's ``.feat`` files (one pass over
    the views, best of ``repeats``) through the native parser that
    ``load_features`` calls and through ``np.loadtxt``; the rows must be
    identical."""
    from regard3d_tpu_torch import native
    from regard3d_tpu_torch.pipeline import features as fm
    paths = [fm.feat_path(out, i) for i in range(N_CAMS)]
    best = {}
    for name, parse in (("native_s", native.parse_feats),
                        ("loadtxt_s", lambda p: np.loadtxt(
                            p, np.float32, ndmin=2))):
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            got = [parse(p) for p in paths]
            times.append(time.perf_counter() - t0)
        best[name] = min(times)
        best[name.replace("_s", "_rows")] = got
    check(all(np.array_equal(a, b) for a, b in zip(best.pop("native_rows"),
                                                   best["loadtxt_rows"])),
          "(m) native and np.loadtxt parse different .feat rows")
    rows = sum(len(a) for a in best.pop("loadtxt_rows"))
    log(f"(m) .feat parse of {len(paths)} views, {rows} rows: native "
        f"{best['native_s'] * 1e3:.2f} ms, np.loadtxt "
        f"{best['loadtxt_s'] * 1e3:.2f} ms")
    return {"views": len(paths), "rows": rows, **best}


F64_FIELDS = ("poses.R", "poses.C", "landmarks.X", "observations.xy",
              "intrinsics.params")


def phase_f64(ds, matches, workdir, f32):
    """(m) the float64 engines on (b)'s matches: ``run_triangulation(
    f64=True)`` with incremental2 + MaxPair and with the global engine,
    unprofiled, each held to (g)'s gates and artifact checks, float64 in
    scene.npz's poses, points, observations and intrinsics (the
    reference's f64 writer; colors float32), and two f64 ``bundle_adjust``
    calls on the final scene bit-identical. One ``f64`` line beside the
    f32 runs of (g) and (l) (``f32``: tag -> their summaries)."""
    out = {}
    for tag, params in (("incremental2", {}),
                        ("global", dict(engine="global"))):
        run_dir = os.path.join(workdir, f"sfm_f64_{tag}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        stats = run_sfm(ds, matches, run_dir, f64=True, **params)
        elapsed = time.time() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        scene, ate = check_sfm(ds, run_dir, stats,
                               f"(m) f64 {tag} {elapsed:.1f} s:")
        with np.load(os.path.join(run_dir, "scene.npz")) as z:
            dtypes = {k: str(z[k].dtype) for k in z.files}
        check(all(dtypes[k] == "float64" for k in F64_FIELDS)
              and dtypes["landmarks.color"] == "float32",
              f"(m) f64 {tag}: scene.npz dtypes {dtypes}")
        ba = _bit_identical_ba(scene)
        check(ba["dtype"] == "torch.float64", f"(m) f64 {tag}: BA in "
              f"{ba['dtype']}")
        ref = f32[tag]
        out[tag] = {
            "f64": {"cameras": stats["num_cameras"],
                    "tracks": stats["num_tracks"], "ate": ate,
                    "residual_median_px": stats["residual_median"],
                    "rms_px": stats["rms_px"],
                    "final_cost": final_cost(scene), "seconds": elapsed,
                    "peak_device_gb": peak_gb, "ba_repeat": ba},
            "f32": {"ate": ref["ate"],
                    "residual_median_px": ref["residual_median_px"],
                    "rms_px": ref["rms_px"],
                    "final_cost": ref["final_cost"],
                    "seconds": ref["seconds"], "profiled": ref["profiled"],
                    "peak_device_gb": ref["peak_device_gb"]}}
    log(json.dumps({"f64": out}))


# (k)'s render: ``make_city`` in a process of its own, started first, so
# the host renders while the card runs the earlier phases; ``run_scale``
# reads the result from its work directory
RENDER = """import sys, time
import numpy as np
from regard3d_tpu_torch.ingest import synth
t0 = time.time()
ds = synth.make_city(n_cams=int(sys.argv[2]), hw=256, loop=False)
np.savez(sys.argv[1], images=np.stack(ds["images"]), Cs=ds["Cs"],
         f=ds["f"], hw=ds["hw"])
print(time.time() - t0)
"""


def start_render(workdir):
    """Start (k)'s render; returns (the process, the scale work dir)."""
    wd = os.path.join(workdir, "scale")
    os.makedirs(wd)
    proc = subprocess.Popen(
        [sys.executable, "-c", RENDER, os.path.join(wd, "render.npz"),
         str(SCALE_VIEWS)], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, wd


def phase_scale(render, wd):
    """(k) the scale axis at full width: ``tools/scale.run_scale`` on the
    200-view open corridor at 256 px, window 8, no retrieval (SCALE200's
    configuration: 1564 pairs), 1024 keypoints and the bench's other
    defaults, on the views ``start_render`` rendered; its gates, K1 f32
    launched once per 64 pairs, one ``scale`` line beside SCALE200.json's
    record. Returns K1's launches and the run's match directory."""
    from regard3d_tpu_torch.kernels import match as match_mod
    from regard3d_tpu_torch.tools import scale
    t0 = time.time()
    out, err = render.communicate(timeout=1200)
    check(render.returncode == 0, f"(k) render failed: {err[-2000:]}")
    render_s = float(out.split()[-1])
    log(f"(k) rendered {SCALE_VIEWS} views in {render_s:.1f} s (beside the "
        f"earlier phases; waited {time.time() - t0:.1f} s)")
    match_mod.reset_launch_counts()
    t0 = time.time()
    r = scale.run_scale(views=SCALE_VIEWS, hw=256, max_keypoints=1024,
                        window=8, loop=False, retrieval_k=0, workdir=wd)
    r["render_s"] = render_s
    launches = dict(match_mod.LAUNCHES)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "SCALE200.json")
    ref = None
    if os.path.exists(path):
        with open(path) as fh:
            ref = json.load(fh)
    log(json.dumps({"scale": {**r, "launches": launches,
                              "phase_s": time.time() - t0,
                              "reference": ref}}))
    want = -(-r["pairs"] // PAIR_BLOCK)
    check(launches["l2_top2_block_f32"] == want,
          f"(k) K1 f32 launched {launches['l2_top2_block_f32']} times, "
          f"want {want}")
    check(r["gates"]["posed_ok"],
          f"(k) {r['num_cameras']} of {r['views']} views posed (< 95%)")
    check(r["gates"]["ate_ok"],
          f"(k) ATE {r['ate']:.4f} = {100 * r['ate_fraction_of_extent']:.3f}"
          f"% of the extent (> 0.5%)")
    return launches["l2_top2_block_f32"], os.path.join(wd, "matches")


def phase_scale_kernel(matches):
    """(k) K1 f32 at the scale path's shape (the first 64 window pairs of
    the 200 views, 1024 keypoints padded to 1024), against its plain
    version, timed beside its bound and ``torch.bmm``."""
    from regard3d_tpu_torch.ingest import synth
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import features as fm
    from regard3d_tpu_torch.kernels import match as match_mod
    kps, descs = fm.load_all_padded(matches, SCALE_VIEWS, pad_to=256,
                                    padded_dim=cm.MATCH_DIM, device="cuda")
    desc, mask = descs.data, descs.mask
    parr = torch.as_tensor(np.asarray(
        synth.window_pairs(SCALE_VIEWS, 8)[:PAIR_BLOCK], np.int32))
    pl = parr.long().cuda()
    B, N, D = desc.shape
    ga, gb = desc[pl[:, 0]], desc[pl[:, 1]]
    return kernel_row(
        "l2_top2_block_f32",
        run=lambda: match_mod.l2_top2_block(desc, mask, parr),
        plain=lambda: match_mod.l2_top2_block_plain(desc, mask, parr),
        lib=lambda: torch.bmm(ga, gb.transpose(1, 2)),
        P=PAIR_BLOCK, M=N, N=N, D=D,
        in_bytes=(len(torch.unique(pl)) * (N * D * 4 + N)
                  + PAIR_BLOCK * 8),
        out_words=3, bf16=False, replaces=K1,
        compare=lambda n, g, w: _compare(n, g, w, 1e-5, 1e-5), tag="(k)")


def dense_geometry(scene, Cs_true, xyz, nrm, verts=None):
    """The cloud and the mesh in the truth frame against the fountain's
    quads, at the gates' tolerances (``tools/dense_normals``)."""
    from regard3d_tpu_torch.tools import dense_normals
    return dense_normals.dense_geometry(scene, Cs_true, xyz, nrm, verts,
                                        GATE_CLOUD_TOL, GATE_SURFACE_TOL)


def run_dense(scene, images, out, device="cuda"):
    """The dense slice's main path as the CLI chains it (densify ->
    dense.ply -> reconstruct on the cloud read back -> surface.ply ->
    k-NN vertex colors -> texture atlas -> OBJ + MTL + PNG). Returns the
    products, each step's host seconds and peak device memory, and the
    grid statistics of the cloud handed to ``reconstruct``."""
    from regard3d_tpu_torch.export import model_ops, ply
    from regard3d_tpu_torch.mvs import driver
    from regard3d_tpu_torch.surface import poisson, texture
    from regard3d_tpu_torch.tools.dense_normals import DENSE_KW
    os.makedirs(out, exist_ok=True)
    cuda = torch.device(device).type == "cuda"
    steps = {}

    def step(name, fn):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = fn()
        if cuda:
            torch.cuda.synchronize()
        steps[name] = {"host_s": time.perf_counter() - t0,
                       "peak_device_gb": (torch.cuda.max_memory_allocated()
                                          / 1e9 if cuda else None)}
        return r

    xyz, nrm, rgb, dmaps = step("densify", lambda: driver.densify_scene(
        scene, images, device=device, **DENSE_KW))
    dense = os.path.join(out, "dense.ply")
    ply.write_ply(dense, ply.PlyData(xyz=xyz, rgb=(rgb * 255).astype(
        np.uint8), normals=nrm))
    cloud = ply.read_ply(dense)
    grid = {}
    verts, faces = step("surface", lambda: poisson.reconstruct(
        cloud.xyz, cloud.normals, device=device, stats=grid, **SURFACE_KW))
    surface = os.path.join(out, "surface.ply")
    ply.write_ply(surface, ply.PlyData(xyz=verts, faces=faces))
    colored = step("colorize", lambda: model_ops.colorize_mesh_from_cloud(
        surface, dense, os.path.join(out, "surface_colored.ply"), k=3))
    surf = ply.read_ply(surface)
    tex = step("texture", lambda: texture.texture_mesh(
        scene, images, surf.xyz, surf.faces, device=device))
    step("write_obj", lambda: texture.write_textured_obj(
        os.path.join(out, "textured"), tex))
    return dict(xyz=xyz, nrm=nrm, dmaps=dmaps, verts=verts, faces=faces,
                colored=colored, tex=tex, cloud=cloud, steps=steps,
                poisson=grid)


def check_dense_artifacts(out, res):
    """Every artifact parses back with the counts of the run."""
    from PIL import Image
    from regard3d_tpu_torch.export import ply
    n, nv, nf = len(res["xyz"]), len(res["verts"]), len(res["faces"])
    dense = res["cloud"]
    check(len(dense.xyz) == n and dense.normals is not None
          and dense.rgb is not None, "dense.ply: points, normals, colors")
    surf = ply.read_ply(os.path.join(out, "surface.ply"))
    check(len(surf.xyz) == nv and len(surf.faces) == nf,
          "surface.ply: vertex and face counts")
    col = ply.read_ply(os.path.join(out, "surface_colored.ply"))
    check(len(col.xyz) == nv and len(col.faces) == nf and col.rgb is not None
          and col.rgb.shape == (nv, 3), "surface_colored.ply")
    prefix = os.path.join(out, "textured")
    with open(prefix + ".obj") as fh:
        kinds = collections.Counter(line.split(" ", 1)[0] for line in fh)
    check(kinds["v"] == nv and kinds["vt"] == 3 * nf and kinds["f"] == nf,
          f"textured.obj: {dict(kinds)}")
    with open(prefix + ".mtl") as fh:
        check("map_Kd textured.png" in fh.read(), "textured.mtl")
    A = res["tex"].atlas.shape[0]
    with Image.open(prefix + ".png") as im:
        check(im.size == (A, A), f"textured.png {im.size} != {A}")


def phase_dense(ds, scene_npz, workdir):
    """(i) the dense slice on (g)'s posed scene at the CLI defaults: its
    geometry against the fountain's quads, every artifact read back, and
    where its time goes by span (one run, under the profiler; (j) holds
    two reconstructs of one cloud to the same bits)."""
    from torch.profiler import ProfilerActivity, profile
    from regard3d_tpu_torch.core.sfm_data import load_npz
    from regard3d_tpu_torch.tools import dense_normals

    scene = load_npz(scene_npz)
    out = os.path.join(workdir, "dense")
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_dense(scene, ds["images"], out)
    elapsed = time.time() - t0
    geo = dense_geometry(scene, ds["Cs"], res["xyz"], res["nrm"],
                         res["verts"])
    n, nf = len(res["xyz"]), len(res["faces"])
    log(f"(i) {len(res['dmaps'])} depth maps, {n} points, "
        f"{len(res['verts'])} vertices, {nf} faces, {elapsed:.1f} s; "
        f"geometry {geo}; steps {res['steps']}")
    check_dense_artifacts(out, res)
    rows = span_table(prof.profiler.kineto_results.events(), DENSE_SPANS)
    for r in rows:       # span "<step>.<name>": the peak of its step
        r["peak_device_gb_of_step"] = res["steps"][
            r["span"].split(".")[0]]["peak_device_gb"]
        log(f"(i) {r['span']}: {r['spans']} spans, host {r['host_s']:.3f} "
            f"s, device busy {r['device_busy_s']:.3f} s, idle "
            f"{r['idle_share']:.3f}, {r['device_ops']} device ops, top "
            f"{[k for k, _ in r['top_kernels']]}")
    phase_s = time.time() - t0
    log(json.dumps({"dense": {
        "config": {"densify": dense_normals.DENSE_KW, "surface": SURFACE_KW,
                   "colorize_k": 3, "views": N_CAMS, "hw": HW},
        "points": n, "vertices": len(res["verts"]), "faces": nf,
        "depth_maps": len(res["dmaps"]),
        "atlas_px": res["tex"].atlas.shape[0],
        "labelled_faces": float((res["tex"].labels >= 0).mean()),
        "geometry": geo, "poisson": res["poisson"],
        "elapsed_profiled_s": elapsed, "phase_s": phase_s,
        "steps": res["steps"], "spans": rows}}))
    check(len(res["dmaps"]) == N_CAMS, f"{len(res['dmaps'])} depth maps")
    check(n >= GATE_MIN_POINTS, f"{n} dense points < {GATE_MIN_POINTS}")
    check(geo["cloud_near_frac"] >= GATE_CLOUD_FRAC,
          f"{geo['cloud_near_frac']:.4f} of the dense points within "
          f"{GATE_CLOUD_TOL} of the extent of a quad < {GATE_CLOUD_FRAC}")
    check(geo["normal_cos_median"] >= GATE_NORMAL_COS,
          f"median |cos| of the normals {geo['normal_cos_median']:.4f}")
    check(geo["surface_near_frac"] >= GATE_SURFACE_FRAC,
          f"{geo['surface_near_frac']:.4f} of the surface vertices within "
          f"{GATE_SURFACE_TOL} of the extent < {GATE_SURFACE_FRAC}")
    check(sum(r["device_ops"] for r in rows) > 0,
          "the dense slice ran nothing on the device")


def trace_kernel_launches(path):
    """Kernel events of a ``torch.profiler`` Chrome trace whose name comes
    from ``csrc/match_top2.cu``, by name. The trace of a profiled stage
    holds millions of events, so only the events around each occurrence of
    the kernels' names are decoded."""
    with open(path) as fh:
        text = fh.read()
    dec = json.JSONDecoder()
    counts = collections.Counter()
    for tag in ("l2_top2", "merge_splits_kernel"):
        pos = text.find(tag)
        while pos >= 0:
            start = text.rfind("{", 0, pos)
            try:
                ev, end = dec.raw_decode(text, start)
            except ValueError:
                ev, end = {}, pos + 1
            if ev.get("cat") == "kernel" and tag in ev.get("name", ""):
                # "void (anonymous namespace)::l2_top2_f32_kernel<..>(..)"
                name = ev["name"].replace("(anonymous namespace)::", "")
                counts[name.split("(")[0].replace("void ", "")] += 1
            pos = text.find(tag, max(end, pos + 1))
    return dict(counts)


def check_exports(root, n):
    """Every format of the export menu wrote its files and they parse."""
    import glob
    import xml.etree.ElementTree as ET
    from PIL import Image

    def files(fmt, pattern, want):
        got = sorted(glob.glob(os.path.join(root, fmt, pattern)))
        check(len(got) == want,
              f"export {fmt}: {len(got)} x {pattern}, want {want}")
        return got

    def read(path):
        with open(path) as fh:
            return fh.read().splitlines()

    def images(paths):
        for q in paths:
            with Image.open(q) as im:
                im.load()

    for fmt in ("bundler", "pmvs"):
        head = read(files(fmt, "bundle.rd.out", 1)[0])
        check(head[0] == "# Bundle file v0.3"
              and int(head[1].split()[0]) == n, f"{fmt}: bundle.rd.out")
        check(len(read(files(fmt, "list.txt", 1)[0])) == n, f"{fmt}: list")
    for q in files("pmvs", "PMVS/txt/*.txt", n):
        rows = read(q)
        check(rows[0] == "CONTOUR" and all(len(r.split()) == 4
                                           for r in rows[1:4]), q)
    images(files("pmvs", "PMVS/visualize/*.jpg", n))
    files("pmvs", "PMVS/pmvs_options.txt", 1)
    nvm = read(files("nvm", "scene.nvm", 1)[0])
    check(nvm[0].startswith("NVM_V3") and int(nvm[2]) == n, "nvm header")
    mlp = ET.parse(files("meshlab", "scene.mlp", 1)[0])
    check(len(mlp.findall(".//MLRaster")) == n, "meshlab rasters")
    files("mve", "MVE/synth_0.out", 1)
    files("mve", "MVE/views/view_*.mve/meta.ini", n)
    images(files("mve", "MVE/views/view_*.mve/undistorted.png", n))
    with open(files("openmvs", "scene.mvs", 1)[0], "rb") as fh:
        check(fh.read(4) == b"MVSI", "openmvs magic")
    so = "SfM_output"
    check(int(read(files("sfmoutput", f"{so}/views.txt", 1)[0])[2]) == n,
          "SfM_output views.txt")
    check(all(os.path.getsize(q) == 96
              for q in files("sfmoutput", f"{so}/cameras/*.bin", n)),
          "SfM_output camera matrices")
    files("sfmoutput", f"{so}/cameras_disto/*.txt", n)
    check(read(files("sfmoutput", f"{so}/clouds/calib.ply", 1)[0])[0]
          == "ply", "calib.ply")
    images(files("sfmoutput", f"{so}/images/*.jpg", n))
    for q in files("externalmvs", "CMPMVS/*_P.txt", n):
        check(read(q)[0] == "CONTOUR", q)
    images(files("externalmvs", "CMPMVS/*.jpg", n))
    check(int(read(files("externalmvs", "meshrecon/output.sfm", 1)[0])[0])
          == n, "meshrecon/output.sfm")
    files("externalmvs", "SURE/*.ori", n)
    files("externalmvs", "MVMPR/data/*.cam", n)
    files("externalmvs", "*.ini", 2)
    for q in files("mvstexturing", "*.cam", n):
        rows = read(q)
        check(len(rows) == 2 and len(rows[0].split()) == 12, q)


def phase_cli(ds, workdir, device="cuda", match_args=()):
    """(j) the README's quick start through ``python -m regard3d_tpu_torch.
    cli`` subprocesses on the card; returns K1's launches in its
    ``matches``. ``device="cpu"`` and ``match_args`` (extra ``matches``
    options) serve a rehearsal on a small scene."""
    from regard3d_tpu_torch.core.sfm_data import load_npz
    from regard3d_tpu_torch.core import metrics
    from regard3d_tpu_torch.export import ply
    from regard3d_tpu_torch.ingest import geodesy
    from regard3d_tpu_torch.kernels import _build
    from regard3d_tpu_torch.kernels import match as match_mod
    from regard3d_tpu_torch.tools import photos
    from PIL import Image

    t_phase = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(workdir, "cli")
    run_dir = os.path.join(base, "cwd")          # not the repository
    os.makedirs(run_dir)
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build_dir = os.path.dirname(_build._lib_path(match_mod._SOURCE))
    built = {f: os.path.getmtime(os.path.join(build_dir, f))
             for f in os.listdir(build_dir)}
    paths = photos.write_dataset(ds, os.path.join(base, "photos"))
    proj = os.path.join(base, "proj")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    walls = []

    def run(argv):
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "regard3d_tpu_torch.cli",
                            "--device", device, *argv], cwd=run_dir, env=env,
                           capture_output=True, text=True, timeout=900)
        return r, time.time() - t0

    def clis(*argvs):
        """One CLI process per argv, all started together; their standard
        outputs. Each process's wall time counts its start."""
        with concurrent.futures.ThreadPoolExecutor(len(argvs)) as pool:
            done = list(pool.map(run, argvs))
        for argv, (r, wall) in zip(argvs, done):
            check(r.returncode == 0, f"cli {' '.join(argv)}: exit "
                  f"{r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
            walls.append({"argv": " ".join(a.replace(base, "<base>")
                                           for a in argv), "wall_s": wall,
                          "concurrent": len(argvs)})
            log(f"(j) {walls[-1]['argv']}: {wall:.2f} s"
                + (f" ({len(argvs)} at once)" if len(argvs) > 1 else ""))
        return [r.stdout for r, _ in done]

    def cli(*argv):
        return clis(argv)[0]

    cli("init", proj)
    cli("import", proj, *paths)
    prof_dir = os.path.join(base, "prof")
    m_stats = json.loads(cli("matches", proj, "--profile", prof_dir,
                             *match_args))
    # a step that only reads the project (pairs, export, preview) runs
    # beside the step that writes it next (saves replace project.json
    # whole); the writing steps run one at a time
    s1, pairs = clis(("sfm", proj), ("pairs", proj, "--json"))
    s1, pairs = json.loads(s1), json.loads(pairs)
    best = f"{pairs[0]['i']},{pairs[0]['j']}"
    exports = os.path.join(base, "exports")
    s2 = json.loads(clis(
        ("sfm", proj, "--engine", "incremental", "--initial-pair", best,
         "--use-gps", "--id", "1"),
        *(("export", proj, "--id", "2", "--format", fmt, "--out",
           os.path.join(exports, fmt)) for fmt in CLI_FORMATS))[0])
    previews = os.path.join(base, "previews")
    d_stats = json.loads(clis(
        ("densify", proj, "--id", "2", "--method", "tpu"),
        ("preview", proj, "--view", "0", "--out", previews),
        ("preview", proj, "--pair", best, "--out", previews))[0])
    v_stats = json.loads(cli("surface", proj, "--method", "tpu", "--depth",
                             "8", "--colorize", "vertices"))
    t_stats = json.loads(cli("surface", proj, "--id", "4", "--method", "tpu",
                             "--depth", "8", "--colorize", "textures"))
    info = cli("info", proj)

    # the project: every step finished, one line of `info` each
    with open(os.path.join(proj, "project.json")) as fh:
        pj = json.load(fh)
    objs = {o["id"]: o for o in pj["objects"]}
    steps = [o for o in objs.values() if o["kind"] != "pictureset"]
    check([o["kind"] for o in steps] == ["matches", "triangulation",
                                         "triangulation", "densification",
                                         "surface", "surface"]
          and all(o["state"] == "finished" for o in steps),
          f"steps: {[(o['kind'], o['state']) for o in steps]}")
    check(info.count("finished") == len(steps), "info")
    # import: EXIF focals, GPS back after ENU
    infos = objs[0]["params"]["image_info"]
    f_err = max(abs(i["focal_px"] / (1.03 * ds["f"]) - 1.0) for i in infos)
    ecef = np.array([geodesy.lla_to_ecef(*i["gps"]) for i in infos])
    local, origin, R = geodesy.local_enu_frame(ecef)
    true_local = (photos.enu_to_ecef(ds["Cs"]) - origin) @ R.T
    gps_err = float(np.abs(local - true_local).max())
    check(sum(i["from_exif"] for i in infos) == N_CAMS and f_err <= 1e-3,
          f"import: focal from EXIF, rel err {f_err:.2e}")
    check(gps_err <= 0.01, f"GPS read back {gps_err:.4f} m off")
    # matches: the exact geometry, and K1 in the trace
    mdir = os.path.join(proj, "matches_1")
    n_f, med = epipolar_check(ds, mdir)
    n_pairs = N_CAMS * (N_CAMS - 1) // 2
    check(n_f * 2 >= n_pairs, f"cli matches: {n_f} of {n_pairs} pairs F")
    check(med < 1.0, f"cli matches: median epipolar {med:.3f} px")
    kernels = trace_kernel_launches(os.path.join(prof_dir, "trace.json"))
    k1 = sum(v for k, v in kernels.items() if "l2_top2_f32_kernel" in k)
    check(k1 > 0, f"the trace shows no f32 matcher launch: {kernels}")
    # sfm: accuracy gates; GPS centres against the truth, no alignment
    sc1 = load_npz(os.path.join(proj, "triangulation_2", "scene.npz"))
    pm = sc1.poses.mask.numpy()
    ate = metrics.ate_rmse(sc1.poses.C.numpy()[pm], ds["Cs"][pm])
    check(s1["num_cameras"] == N_CAMS and ate <= ATE_BOUND
          and s1["residual_median"] < 1.0,
          f"cli sfm: {s1['num_cameras']} cameras, ATE {ate:.4f}, median "
          f"{s1['residual_median']:.3f} px")
    sc2 = load_npz(os.path.join(proj, "triangulation_3", "scene.npz"))
    gps_rms = float(np.sqrt(((sc2.poses.C.numpy() - true_local) ** 2)
                            .sum(1).mean()))
    check(s2["num_cameras"] == N_CAMS and gps_rms <= ATE_BOUND,
          f"cli sfm --use-gps: {s2['num_cameras']} cameras, centres "
          f"{gps_rms:.4f} RMS from the truth")
    check_exports(exports, N_CAMS)
    # densify and surface: (i)'s gates; the textured model reads back
    cloud = ply.read_ply(d_stats["dense_cloud"])
    surf = ply.read_ply(os.path.join(proj, "surface_5", "surface.ply"))
    geo = dense_geometry(sc1, ds["Cs"], cloud.xyz, cloud.normals, surf.xyz)
    check(d_stats["num_depth_maps"] == N_CAMS
          and len(cloud.xyz) >= GATE_MIN_POINTS
          and geo["cloud_near_frac"] >= GATE_CLOUD_FRAC
          and geo["normal_cos_median"] >= GATE_NORMAL_COS
          and geo["surface_near_frac"] >= GATE_SURFACE_FRAC,
          f"cli dense: {len(cloud.xyz)} points, geometry {geo}")
    col = ply.read_ply(v_stats["surface"])
    check(col.rgb is not None and len(col.xyz) == len(surf.xyz),
          "surface_colored.ply")
    tsurf = ply.read_ply(os.path.join(proj, "surface_6", "surface.ply"))
    check(np.array_equal(tsurf.xyz, surf.xyz)
          and np.array_equal(tsurf.faces, surf.faces),
          "two reconstructs of the same cloud gave other meshes")
    # the grid the CLI's reconstruct laid over its cloud (the faces before
    # the trim are (i)'s alone: they would take another marching here)
    from regard3d_tpu_torch.surface import poisson
    grid = dict(poisson.grid_stats(cloud.xyz, SURFACE_KW["depth"]),
                faces=len(surf.faces))
    log(f"(j) the cloud handed to reconstruct: {grid}")
    prefix = t_stats["surface"][:-len(".obj")]
    with open(prefix + ".obj") as fh:
        kinds = collections.Counter(line.split(" ", 1)[0] for line in fh)
    check(kinds["v"] == len(tsurf.xyz) and kinds["vt"] == 3 * len(tsurf.faces)
          and kinds["f"] == len(tsurf.faces), f"textured.obj {dict(kinds)}")
    with open(prefix + ".mtl") as fh:
        check("map_Kd textured.png" in fh.read(), "textured.mtl")
    with Image.open(prefix + ".png") as im:
        im.load()
    for name in ("keypoints_0.png", "keypoints_0.svg",
                 f"matches_{best.replace(',', '_')}_putative.png"):
        check(os.path.getsize(os.path.join(previews, name)) > 0, name)
    rebuilt = {f: t for f, t in ((f, os.path.getmtime(os.path.join(
        build_dir, f))) for f in os.listdir(build_dir)) if built.get(f) != t}
    check(not rebuilt, f"a CLI process rebuilt the kernels: {rebuilt}")

    running = {o["id"]: o["running_time_s"] for o in steps}
    step_of = {"matches": 1, "sfm": None, "densify": 4, "surface": None}
    sfm_ids, surf_ids = iter((2, 3)), iter((5, 6))
    for w in walls:
        cmd = w["argv"].split()[0]
        oid = (next(sfm_ids) if cmd == "sfm" else next(surf_ids)
               if cmd == "surface" else step_of.get(cmd))
        w["running_time_s"] = running.get(oid)
    log(json.dumps({"cli": {
        "compute_mode": mode, "commands": walls,
        "matches": {"pairs_f": n_f, "median_sym_epipolar_px": med,
                    "matches_f": m_stats["matches_f"],
                    "time_features_s": m_stats["time_features_s"],
                    "time_matching_s": m_stats["time_matching_s"],
                    "time_filter_s": m_stats["time_filter_s"],
                    "trace_kernels": kernels,
                    "trace_mb": os.path.getsize(os.path.join(
                        prof_dir, "trace.json")) / 1e6},
        "import": {"focal_rel_err": f_err, "gps_err_m": gps_err},
        "sfm": {"cameras": s1["num_cameras"], "ate": ate,
                "residual_median_px": s1["residual_median"],
                "focal_est": float(sc1.intrinsics.params[0, 0])},
        "sfm_gps": {"cameras": s2["num_cameras"], "init_pair": best,
                    "centre_rms_no_alignment": gps_rms},
        "dense": {"points": len(cloud.xyz), "vertices": len(surf.xyz),
                  "faces": len(surf.faces), "geometry": geo,
                  "poisson": grid},
        "phase_s": time.time() - t_phase}}))
    return k1


# (n) distribution: a rank of the two-process stage + sharded BA, a program
# of its own run by ``dist.launch.launch_local(module=None)``; argv: the
# work directory (views.npy, ba.npz, the stage's settings in rank.json)
RANK = r"""
import hashlib, json, os, sys, time
import numpy as np, torch
from regard3d_tpu_torch.ba import lm, sharded
from regard3d_tpu_torch.dist import launch
from regard3d_tpu_torch.kernels import match as match_mod
from regard3d_tpu_torch.pipeline import compute_matches as cm
assert launch.init_from_env()
rank = int(os.environ[launch.ENV_PID])
work = sys.argv[1]
with open(os.path.join(work, "rank.json")) as fh:
    cfg = json.load(fh)
images = list(np.load(os.path.join(work, "views.npy")))
dev = torch.device(cfg["device"])
match_mod.reset_launch_counts()
t0 = time.time()
cm.run_compute_matches(images, os.path.join(work, "matches"),
                       cfg=cm.MatchConfig(), focals=np.asarray(cfg["focals"]),
                       max_keypoints=cfg["max_kp"], proc_id=rank,
                       proc_count=2, device=dev)
stage_s = time.time() - t0
z = np.load(os.path.join(work, "ba.npz"))
state = lm.BAState(*(torch.as_tensor(z[k]) for k in ("R", "C", "intr", "X")))
obs = lm.BAObservations(*(torch.as_tensor(z[k]) for k in (
    "view_id", "intr_id", "point_id", "model", "xy", "weight")))
t0 = time.time()
out, st = sharded.bundle_adjust_sharded(
    state, obs, None, lm.BAOptions(**cfg["ba_opts"]),
    fixed_pose_mask=torch.as_tensor(z["fixed"]), device=dev)
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
sync()
ba_s = time.time() - t0
digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in out))
# what one reduction costs between the ranks: the camera system of a CG
# step, (V,6)+(K,9), and the obs-sharded path's (L,3) point sums
reduce_ms = {}
for n in (state.R.shape[0] * 6 + state.intr.shape[0] * 9,
          state.X.shape[0] * 3):
    buf = torch.zeros(n, device=dev)
    torch.distributed.all_reduce(buf)
    sync()
    t1 = time.time()
    for _ in range(100):
        torch.distributed.all_reduce(buf)
    sync()
    reduce_ms[str(n)] = (time.time() - t1) * 10.0
with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
    json.dump({"rank": rank, "device": str(out.X.device),
               "backend": torch.distributed.get_backend(),
               "launches": dict(match_mod.LAUNCHES), "stage_s": stage_s,
               "ba_s": ba_s, "all_reduce_ms": reduce_ms, "ba": st._asdict(),
               "state_sha256": digest.hexdigest()}, fh)
"""


def same_bytes(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_dist(ds, matches, workdir, g, device="cuda"):
    """(n) distribution on the card, one card shared by two of everything:
    ``r3d launch -n 2 -- matches`` and ``-- sfm --dist-ba`` on (j)'s
    project in the background while this process runs the point-sharded
    BA over ``[cuda:0, cuda:0]`` on (g)'s final problem (against (g)'s ``bundle_adjust``, and its repeat
    bit for bit), ``run_triangulation(dist_ba=True)`` on (b)'s matches at
    (g)'s gates and the view-sharded plane sweep at level 2 against
    ``compute_depth_maps``; then two ranks of ``launch_local`` run (b)'s
    stage sharded (artifacts the bytes of (b)'s, K1 f32 launched in each)
    and ``bundle_adjust_sharded`` over their gloo group (the same final
    state in both, the cost within 1e-4 of (g)'s). One ``dist`` line;
    returns each rank's K1 f32 launches. ``device="cpu"`` serves a
    rehearsal on a small scene."""
    from regard3d_tpu_torch.ba import lm, sharded
    from regard3d_tpu_torch.core import metrics
    from regard3d_tpu_torch.core.sfm_data import load_npz
    from regard3d_tpu_torch.dist import launch
    from regard3d_tpu_torch.dist import mesh as meshlib
    from regard3d_tpu_torch.kernels import _build
    from regard3d_tpu_torch.kernels import match as match_mod
    from regard3d_tpu_torch.mvs import driver
    from regard3d_tpu_torch.pipeline import features as fm
    from regard3d_tpu_torch.pipeline.project import Project
    from regard3d_tpu_torch.tools.dense_normals import DENSE_KW

    t_phase = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(workdir, "dist")
    os.makedirs(base)
    # every rank imports the port from this checkout
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    two = ["cuda:0"] * 2 if device == "cuda" else [device] * 2
    build_dir = os.path.dirname(_build._lib_path(match_mod._SOURCE))
    built = {f: os.path.getmtime(os.path.join(build_dir, f))
             for f in os.listdir(build_dir)}
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"compute_mode": mode}

    # 3. the command line, started first: its processes start while this
    # one works on the card. `matches` (the CLI's defaults, as (j)'s) and
    # then `sfm --dist-ba` on its result, two ranks each, in a session of
    # their own, so a failure kills the launchers and their ranks at once;
    # every wait of a rank is bounded
    proj = os.path.join(workdir, "cli", "proj")
    n_objects = len(Project.load(proj).objects)
    t_cli = time.time()
    r3d = [sys.executable, "-m", "regard3d_tpu_torch.cli", "--device",
           device, "launch", "-n", "2", "--log-dir"]
    steps = [r3d + [os.path.join(base, "cli_matches"), "--", "matches",
                    proj],
             r3d + [os.path.join(base, "cli_sfm"), "--", "sfm", proj,
                    "--dist-ba"]]
    cli = subprocess.Popen(
        ["bash", "-c", " && ".join(" ".join(map(shlex.quote, c))
                                   for c in steps)],
        cwd=os.path.join(workdir, "cli", "cwd"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env=dict(os.environ, R3D_DIST_TIMEOUT_S="600"))
    try:
        # 1. in this process: point-sharded BA on (g)'s final problem
        scene = load_npz(os.path.join(workdir, "sfm", "scene.npz"))
        state, ba_obs, fixed, opts = _ba_problem(scene)
        mesh2 = meshlib.make_mesh("obs", two)
        t0 = time.time()
        pts = [sharded.bundle_adjust_point_sharded(
            state, ba_obs, mesh2, opts, fixed_pose_mask=fixed)
            for _ in range(2)]
        ba_s = (time.time() - t0) / 2
        t0 = time.time()
        one = lm.bundle_adjust(state, ba_obs, opts, fixed_pose_mask=fixed,
                               device=two[0])
        one_s = time.time() - t0
        single = g["ba_repeat"]["final_cost"]
        pt_cost = pts[0][1].final_cost
        check(all(torch.equal(a, b) for a, b in zip(pts[0][0], pts[1][0]))
              and pts[0][1] == pts[1][1],
              "(n) two point-sharded BA runs on the same state differ")
        check(abs(pt_cost - single) <= 1e-4 * single,
              f"(n) point-sharded BA cost {pt_cost} against {single}")
        out["point_sharded_ba"] = {
            "shards": [str(d) for d in mesh2.device_list],
            "final_cost": pt_cost, "bundle_adjust_final_cost": single,
            "iterations": pts[0][1].iterations, "seconds": ba_s,
            "bundle_adjust_s": one_s,
            "bundle_adjust_repeat_cost": one[1].final_cost,
            "bit_identical": True}
        log(f"(n) point-sharded BA over {two}: cost {pt_cost} "
            f"(bundle_adjust {single}), {ba_s:.2f} s a run against "
            f"{one_s:.2f} s")

        # run_triangulation with the sharded polish at (g)'s gates
        run_dir = os.path.join(base, "sfm_dist_ba")
        t0 = time.time()
        stats = run_sfm(ds, matches, run_dir, dist_ba=True, device=device)
        sc, ate = check_sfm(ds, run_dir, stats,
                            f"(n) dist_ba {time.time() - t0:.1f} s:")
        out["sfm_dist_ba"] = {"cameras": stats["num_cameras"], "ate": ate,
                              "residual_median_px": stats["residual_median"],
                              "seconds": time.time() - t0}

        # the view-sharded sweep at level 2 against the host loop
        params = driver.PlaneSweepParams(**{
            k: v for k, v in dict(DENSE_KW, level=2).items()
            if k in ("level", "num_planes", "wsize", "threshold",
                     "num_sources")})
        t0 = time.time()
        got = driver.compute_depth_maps_sharded(
            scene, ds["images"], params,
            meshlib.make_mesh("views", two))
        t1 = time.time()
        want = driver.compute_depth_maps(scene, ds["images"], params,
                                         device=device)
        t2 = time.time()
        check(set(got) == set(want) and len(got) == N_CAMS,
              f"(n) sharded depth maps of views {sorted(got)}")
        flips = valid = 0
        for v in got:
            both = got[v].valid & want[v].valid
            rel = (np.abs(got[v].idepth - want[v].idepth)
                   / np.abs(want[v].idepth))
            flips += int((rel[both] > 1e-4).sum())
            valid += int(both.sum())
        check(flips <= 0.01 * valid, f"(n) sharded sweep: {flips} plane "
              f"flips of {valid} valid pixels")
        out["sweep_sharded"] = {
            "level": 2, "views": len(got), "valid_px": valid,
            "flips": flips, "identical": all(
                np.array_equal(got[v].idepth, want[v].idepth)
                for v in got), "sharded_s": t1 - t0, "host_loop_s": t2 - t1}
        log(f"(n) sharded sweep: {flips} flips of {valid} valid pixels, "
            f"{t1 - t0:.1f} s against {t2 - t1:.1f} s")

        # 2. two ranks: (b)'s stage sharded, then the obs-sharded BA
        rwork = os.path.join(base, "ranks")
        os.makedirs(rwork)
        np.save(os.path.join(rwork, "views.npy"), np.stack(ds["images"]))
        np.savez(os.path.join(rwork, "ba.npz"), fixed=fixed.numpy(),
                 **{k: v.numpy() for k, v in state._asdict().items()},
                 **{k: v.numpy() for k, v in ba_obs._asdict().items()})
        with open(os.path.join(rwork, "rank.json"), "w") as fh:
            json.dump({"focals": [ds["f"] * 1.03] * N_CAMS, "max_kp": MAX_KP,
                       "ba_opts": dataclasses.asdict(opts),
                       "device": device}, fh)
        t0 = time.time()
        rc = launch.launch_local(2, ["-c", RANK, rwork], module=None,
                                 log_dir=os.path.join(base, "rank_logs"),
                                 timeout=400)
        ranks_s = time.time() - t0
        log1 = os.path.join(base, "rank_logs", "proc1.log")
        check(rc == 0, f"(n) ranks exit {rc}: " + (
            open(log1).read()[-3000:] if os.path.exists(log1) else ""))
        ranks = []
        for r in (0, 1):
            with open(os.path.join(rwork, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        rdir = os.path.join(rwork, "matches")
        names = [f"image{i:06d}.{e}" for i in range(N_CAMS)
                 for e in ("feat", "desc")] + [
            f"matches.{k}.txt" for k in ("putative", "f", "e", "h")]
        differ = [n for n in names if not same_bytes(
            os.path.join(matches, n), os.path.join(rdir, n))]
        check(not differ, f"(n) two-rank stage differs from (b) in {differ}")
        k1 = [r["launches"]["l2_top2_block_f32"] for r in ranks]
        # (the CPU rehearsal runs the plain matcher: no launch to count)
        check(min(k1) >= 1 or device == "cpu",
              f"(n) K1 f32 launches per rank {k1}")
        costs = [r["ba"]["final_cost"] for r in ranks]
        check(costs[0] == costs[1]
              and ranks[0]["state_sha256"] == ranks[1]["state_sha256"],
              f"(n) the ranks' BA results differ: {costs}")
        check(abs(costs[0] - single) <= 1e-4 * single,
              f"(n) obs-sharded BA cost {costs[0]} against {single}")
        out["ranks"] = {"seconds": ranks_s,
                        "artifacts_identical_to_b": len(names),
                        "per_rank": ranks}
        log(f"(n) two ranks: stage {[r['stage_s'] for r in ranks]} s, BA "
            f"{[r['ba_s'] for r in ranks]} s, cost {costs[0]}, K1 {k1}, "
            f"all_reduce ms {ranks[0]['all_reduce_ms']}")

        # 3. the command line's result
        cli_out, cli_err = cli.communicate(timeout=600)
    finally:
        if cli.poll() is None:
            os.killpg(cli.pid, signal.SIGKILL)
            cli.wait()
    check(cli.returncode == 0, f"(n) cli launch matches, sfm --dist-ba: "
          f"exit {cli.returncode}\n{cli_out[-2000:]}\n{cli_err[-3000:]}")
    cli_s = time.time() - t_cli
    p = Project.load(proj)
    new = [o for o in p.objects.values() if o.id >= n_objects]
    check([(o.kind, o.state) for o in new]
          == [("matches", "finished"), ("triangulation", "finished")],
          f"(n) cli: new objects {[(o.kind, o.state) for o in new]}")
    mdir = p.paths(new[0].id).matches_dir
    differ = [n for n in names if not same_bytes(
        os.path.join(proj, "matches_1", n), os.path.join(mdir, n))]
    check(not differ, f"(n) cli launch -n 2 -- matches differs from (j)'s "
          f"matches in {differ}")
    res = new[1].results
    sc = load_npz(os.path.join(p.paths(new[1].id).triangulation_dir,
                               "scene.npz"))
    pm = sc.poses.mask.numpy()
    ate = metrics.ate_rmse(sc.poses.C.numpy()[pm], ds["Cs"][pm])
    check(res["num_cameras"] == N_CAMS and ate <= ATE_BOUND
          and res["residual_median"] < 1.0,
          f"(n) cli sfm --dist-ba: {res['num_cameras']} cameras, ATE "
          f"{ate:.4f}, median {res['residual_median']:.3f} px")
    out["cli"] = {"matches_identical_to_j": len(names),
                  "matches_running_time_s": new[0].running_time_s,
                  "sfm_dist_ba": {
                      "cameras": res["num_cameras"], "ate": ate,
                      "residual_median_px": res["residual_median"],
                      "running_time_s": new[1].running_time_s},
                  "wall_s": cli_s}
    rebuilt = {f: t for f, t in ((f, os.path.getmtime(os.path.join(
        build_dir, f))) for f in os.listdir(build_dir)) if built.get(f) != t}
    check(not rebuilt, f"(n) a rank rebuilt the kernels: {rebuilt}")
    out["layout"] = {
        "ranks": [{"rank": r["rank"], "device": r["device"],
                   "backend": r["backend"]} for r in ranks],
        "cli_ranks": f"2 x {device} (gloo)",
        "cpu_fallback": device != "cuda"}
    out["phase_s"] = time.time() - t_phase
    log(json.dumps({"dist": out}))
    return k1


def phase_accuracy():
    """(h) the radial-K3 twin at the reference's accuracy settings but 512
    RANSAC iterations (2048 there; (j) gates radial-K3 through the command
    line at full depth), held to the reference's gates and printed beside
    ACCURACY.json's row."""
    from regard3d_tpu_torch.tools import accuracy
    row = accuracy.run_dataset("fountain_rk3", ransac_iters=ACCURACY_ITERS)
    ref = accuracy.reference_rows("incremental2").get("fountain_rk3")
    log(json.dumps({"accuracy": {"port": row, "reference": ref}}))
    bad = accuracy.gate_failures(row)
    check(not bad, "; ".join(bad))


def run_phases(ds, work, render, scale_wd, stamp):
    """Phases (j) to (k) in order, in the work directory; returns the rows
    of the ``kernels`` line with their launch counts."""
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import features as fm
    # first: the CLI's processes take the card before this one does
    k1_cli = phase_cli(ds, work)
    stamp("(j)")
    out, launches = phase_stage(ds, work)
    kps, descs = fm.load_all_padded(out, N_CAMS, pad_to=256,
                                    padded_dim=cm.MATCH_DIM, device="cuda")
    paths = {"stage": launches, "flann": phase_flann(out, kps, descs)}
    stamp("(b)")
    pairs = cm.exhaustive_pairs(N_CAMS)
    pairs = pairs + [pairs[-1]] * ((-len(pairs)) % PAIR_BLOCK)
    parr = torch.as_tensor(np.asarray(pairs[:PAIR_BLOCK], np.int32))
    rows = phase_kernels(descs.data, descs.mask, parr)
    phase_ties(descs.data)
    phase_wide(descs.data, descs.mask, parr)
    stamp("(c)")
    phase_profile(ds, work)
    stamp("(e)")
    paths["profile"] = phase_matcher_profile(descs.data, descs.mask, parr)
    stamp("(f)")
    g = phase_sfm(ds, out, work)
    stamp("(g)")
    k1_ranks = phase_dist(ds, out, work, g)
    stamp("(n)")
    engines = phase_engines(ds, out, work)
    stamp("(l)")
    paths["detectors"] = phase_detectors(ds, work)
    phase_f64(ds, out, work, {
        "incremental2": dict(ate=g["ate"],
                             residual_median_px=g["residual_px"]["median"],
                             seconds=g["elapsed_profiled_s"], profiled=True,
                             **{k: g[k] for k in (
                                 "rms_px", "final_cost", "peak_device_gb")}),
        "global": engines["global"]})
    stamp("(m)")
    phase_dense(ds, os.path.join(work, "sfm", "scene.npz"), work)
    stamp("(i)")
    k1_scale, scale_matches = phase_scale(render, scale_wd)
    scale_row = phase_scale_kernel(scale_matches)
    stamp("(k)")
    for row in rows:
        row["launches"] = paths[ROW_PATH[row["name"]]][row["name"]]
    k1_f32 = next(r for r in rows if r["name"] == "l2_top2_block_f32")
    k1_f32["launches_cli"] = k1_cli       # (j)'s matches
    k1_f32["launches_scale"] = k1_scale   # (k)'s matches
    k1_f32["launches_detectors"] = paths["detectors"]     # (m)'s matches
    k1_f32["launches_ranks"] = k1_ranks   # (n)'s two ranks
    k1_f32["scale"] = {k: scale_row[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "shape", "tflops")}
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    import regard3d_tpu_torch  # noqa: F401  (fails outside the repository)

    t0 = time.time()
    last = [t0]

    def stamp(tag):
        """The time so far and the phase's own seconds."""
        now = time.time()
        log(f"[{now - t0:.1f} s] {tag} done in {now - last[0]:.1f} s")
        last[0] = now
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    phase_build()
    from regard3d_tpu_torch.ingest import synth
    t1 = time.time()
    ds = synth.make_dataset("fountain", n_cams=N_CAMS, hw=HW, seed=0)
    log(f"(b) rendered {N_CAMS} views at {HW}x{HW} in "
        f"{time.time() - t1:.1f} s")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as work:
        render, scale_wd = start_render(work)
        try:
            rows = run_phases(ds, work, render, scale_wd, stamp)
        finally:
            if render.poll() is None:
                render.kill()
                render.wait()
    phase_accuracy()
    stamp("(h)")
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
