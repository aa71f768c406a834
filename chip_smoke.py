#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA card and the CUDA toolkit (nvcc). Phases, each of which fails the
run if it fails:

(a) build the port's CUDA kernels from ``regard3d_tpu_torch/csrc`` and
    print the card; fail unless the three modes of the bf16 kernel hold the
    same number of tensor-core instructions (HMMA) in the built SASS;
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
    kernel's column tile; time kernel, plain version and ``torch.bmm`` /
    ``torch.mm`` of the same distance products (a yardstick only; none for
    ``min_only``), and split
    the single-pair call's host time per call between its wrapper, its
    launch and its C call. Fails if bf16 K1 is not above the FFMA peak (it
    would not be on the tensor cores) or ``mm_only`` beats its tensor-core
    bound (almost none of its product ran). Exact ties inside
    one mma tile and across two column ranges keep the lowest column with
    d2 == d1; the bf16 kernel's instance for D set at run time agrees at
    D = 256;
(e) where the time goes: the stage again, warm, once on the host clock and
    once under ``torch.profiler``; per phase (the stage's own profiler
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
    state give bit-identical states. Then the stage once more under
    ``torch.profiler``: per engine span (``triangulation.<phase>``) the
    host time, the device's busy time and idle share and the number of
    device operations. One ``sfm`` JSON line;
(h) the radial-K3 path: ``regard3d_tpu_torch.tools.accuracy.run_dataset(
    "fountain_rk3")`` (320 px, 2048 keypoints, 2048 RANSAC iterations,
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
    fountain's quads (the GATE_* constants), a second reconstruct of the
    same cloud gives the same mesh bit for bit, and every artifact reads
    back. The second run is profiled: per span (``densify.*``,
    ``surface.*``, ``texture.*``) the host time, device busy time, idle
    share, operation count and largest kernels; one ``dense`` JSON line;
(d) print the ``kernels`` JSON line (launches from the run of the path each
    kernel lies on: (b), its flann run, or (f); (g), (h) and (i) launch no
    kernel of their own), then the card's name and power limit, and the
    final ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
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
PHASES = ("features", "matching", "filter")
SFM_PHASES = ("init", "resection", "triangulation", "ba", "outlier")
ATE_BOUND = 0.08                 # bench_accuracy.GATES

# (i) the dense slice at the CLI's defaults for --method tpu
# (regard3d_tpu/pipeline/external.py:135-138, :229-234, :263-267)
DENSE_KW = dict(level=1, num_planes=96, wsize=7, threshold=0.7,
                num_sources=6, csize=2, min_image_num=3)
SURFACE_KW = dict(depth=8, samples_per_node=1.0, point_weight=4.0,
                  trim_threshold=7.0)
DENSE_SPANS = ("densify.sweep", "densify.fusion", "surface.splat",
               "surface.solve", "surface.marching", "surface.trim",
               "texture.visibility", "texture.sample")
# the fountain stand-in's three quads (origin, u, v), copied from
# regard3d_tpu/ingest/synth.py:164-166 (each a rectangle: u . v = 0)
FOUNTAIN_QUADS = np.array([
    [[-5, -3, 2], [10, 0, 0], [0, 6, 0]],               # back wall
    [[-1.2, -1.2, 0.6], [2.4, 0, 0], [0, 2.4, 0.9]],    # slab
    [[-5, 3, -4], [10, 0, 0], [0, 0, 6]],               # ground
], np.float64)
# geometry gates of (i); distances are fractions of the scene extent (the
# diagonal of the quads' bounding box)
GATE_CLOUD_TOL, GATE_CLOUD_FRAC = 0.01, 0.90
# set from the first card run (PERF.md §6, PR 4): normals of 7x7-smoothed
# 512^2 depth maps gave a median |cos| of 0.888 on (g)'s scene and on the
# exact poses alike; the window is fixed in pixels, so the finer the map the
# more of the sweep's depth noise reaches the normals. The reference gives
# the same normals on the same depth maps, and the same statistic on the
# fountain at 256 px (tests/test_torch_mvs.py)
GATE_NORMAL_COS = 0.85
GATE_MIN_POINTS = 50_000         # 11 views x 256^2 grid cells at csize=2
GATE_SURFACE_TOL, GATE_SURFACE_FRAC = 0.02, 0.80


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
    """(a) build the kernels; then count the tensor-core instructions of
    each mode of the bf16 kernel in the built SASS: ptxas deletes an mma
    whose result is dead, so ``mm_only`` must keep as many HMMA as
    ``full``, or it would time only part of the product."""
    from regard3d_tpu_torch.kernels import _build
    from regard3d_tpu_torch.kernels import match as match_mod
    t0 = time.time()
    lib = _build.build(match_mod._SOURCE)
    log(f"(a) built {match_mod._SOURCE} in {time.time() - t0:.1f} s")
    hmma = _build.hmma_counts(lib)
    log(f"(a) HMMA per bf16 kernel instance (mode,D): {hmma}")
    for dc in ("0", "144"):                  # D at run time, D = 144
        n = [hmma.get(f"{m},{dc}", 0) for m in (0, 1, 2)]
        check(n[0] == n[1] == n[2] > 0,
              f"HMMA of full, mm_only, min_only (D={dc}; 0: set at run "
              f"time): {n}")


def run_stage(ds, out):
    """The main path: the port's stage entry point at the smoke's shapes."""
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    return cm.run_compute_matches(ds["images"], out, cfg=cm.MatchConfig(),
                                  focals=np.full(N_CAMS, ds["f"] * 1.03),
                                  max_keypoints=MAX_KP)


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
    kps, _ = fm.load_all_padded(out, N_CAMS, device="cpu")
    xy = kps.xy.numpy()
    dists = []
    for (i, j), m in files["f"].items():
        F = true_fundamental(ds, i, j)
        dists.append(sym_epipolar_px(F, xy[i][m[:, 0]], xy[j][m[:, 1]]))
    n_f = len(files["f"])
    med = float(np.median(np.concatenate(dists))) if dists else float("inf")
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


def phase_kernels(desc, mask, parr):
    """(c) every kernel against its plain version at the main paths'
    shapes, timed beside its bound, its plain version and a library call."""
    from regard3d_tpu_torch.kernels import match as match_mod

    B, N, D = desc.shape
    pl = parr.long().cuda()
    P = parr.shape[0]
    log(f"(c) main-path shapes: B={B} N={N} D={D} P={P}")
    rows = []

    def entry(name, run, plain, lib, M, Nn, in_bytes, out_words, bf16,
              replaces, compare):
        got = run()
        torch.cuda.synchronize()
        err = compare(name, got, plain())
        ms = cuda_ms(run, reps=20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        lib_ms = cuda_ms(lib, reps=10) if lib is not None else None
        Pn = P if name.startswith("l2_top2_block") else 1
        flops = 2.0 * Pn * M * Nn * D
        nbytes = in_bytes + out_words * Pn * M * 4
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
            "shape": {"P": Pn, "M": M, "N": Nn, "D": D,
                      "dtype": "bfloat16" if bf16 else "float32"},
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        rows.append(row)
        lib_s = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
        log(f"(c) {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
            f"{lib_s}, bound {row['bound_ms']:.4f} ms, "
            f"{row['tflops']:.1f} TFLOP/s)")
        return row

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
    per-op event tree for ~3M events would take minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    log(json.dumps({"profile": rows, "stage_warm_s": warm["elapsed_s"]}))


def run_sfm(ds, matches, out):
    """The triangulation stage's main path at the smoke's shapes."""
    from regard3d_tpu_torch.core.types import PINHOLE
    from regard3d_tpu_torch.pipeline import triangulation_step as ts
    intr = np.zeros((1, 9), np.float32)
    intr[0, :3] = [1.03 * ds["f"], HW / 2.0, HW / 2.0]
    return ts.run_triangulation(matches, out, ds["images"],
                                intr_id=np.zeros(N_CAMS, np.int32),
                                intr=intr,
                                models=np.asarray([PINHOLE], np.int32),
                                params=ts.TriangulationParams())


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


def _bit_identical_ba(scene):
    """Two bundle_adjust calls on the final scene: the same bits."""
    from regard3d_tpu_torch.ba import lm
    pm = scene.poses.mask
    obs = scene.observations
    g = scene.views.intrinsic_id.long()[obs.view_id.long()]
    ba_obs = lm.BAObservations(
        view_id=obs.view_id.long(), intr_id=g,
        point_id=obs.landmark_id.long(),
        model=scene.intrinsics.model.long()[g], xy=obs.xy,
        weight=obs.mask.float())
    state = lm.BAState(R=scene.poses.R, C=scene.poses.C,
                       intr=scene.intrinsics.params, X=scene.landmarks.X)
    fixed = ~pm.clone()
    fixed[int(torch.nonzero(pm)[0])] = True
    opts = lm.BAOptions(max_iterations=10, refine_intrinsics=True,
                        huber_delta_px=2.0)
    outs = [lm.bundle_adjust(state, ba_obs, opts, fixed_pose_mask=fixed)
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    check(same, "two bundle_adjust calls on the same state differ")
    check(outs[0][1] == outs[1][1], "two bundle_adjust calls: other stats")
    return {"iterations": outs[0][1].iterations,
            "initial_cost": outs[0][1].initial_cost,
            "final_cost": outs[0][1].final_cost, "bit_identical": same}


def phase_sfm(ds, matches, workdir):
    """(g) the triangulation stage on phase (b)'s matches, its artifacts,
    the determinism of BA, and where its time goes by engine span."""
    from torch.profiler import ProfilerActivity, profile
    from regard3d_tpu_torch.core import metrics
    from regard3d_tpu_torch.core.sfm_data import load_npz
    from regard3d_tpu_torch.export import ply

    out = os.path.join(workdir, "sfm")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    stats = run_sfm(ds, matches, out)
    elapsed = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    scene = load_npz(os.path.join(out, "scene.npz"))
    pm = scene.poses.mask.numpy()
    ate = metrics.ate_rmse(scene.poses.C.numpy()[pm],
                           ds["Cs"][np.nonzero(pm)[0]])
    with open(os.path.join(out, "sfm_data.json")) as fh:
        sfm = json.load(fh)
    clouds = {n: ply.read_ply(os.path.join(out, n)) for n in
              ("cloud_and_poses.ply", "FinalColorized.ply")}
    log(f"(g) {stats['num_cameras']}/{N_CAMS} cameras, "
        f"{stats['num_tracks']} tracks, ATE {ate:.5f}, median residual "
        f"{stats['residual_median']:.4f} px, {elapsed:.1f} s")
    check(stats["num_cameras"] == N_CAMS,
          f"{stats['num_cameras']} of {N_CAMS} cameras posed")
    check(ate <= ATE_BOUND, f"ATE {ate:.4f} > {ATE_BOUND}")
    check(stats["residual_median"] < 1.0,
          f"median residual {stats['residual_median']:.3f} px")
    check(len(sfm["extrinsics"]) == N_CAMS
          and len(sfm["structure"]) == stats["num_tracks"]
          and len(sfm["views"]) == N_CAMS,
          f"sfm_data.json: {len(sfm['extrinsics'])} extrinsics, "
          f"{len(sfm['structure'])} structure entries")
    check(len(clouds["FinalColorized.ply"].xyz) == stats["num_tracks"]
          and len(clouds["cloud_and_poses.ply"].xyz)
          == stats["num_tracks"] + N_CAMS, "PLY vertex counts")
    check(bool(np.isfinite(scene.landmarks.X.numpy()).all()),
          "non-finite landmarks")
    ba = _bit_identical_ba(scene)

    # where the time goes: the stage again under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = run_sfm(ds, matches, os.path.join(workdir, "sfm_prof"))
    rows = span_table(prof.profiler.kineto_results.events(),
                      ["triangulation." + ph for ph in SFM_PHASES])
    for r in rows:
        r["phase"] = r.pop("span")[len("triangulation."):]
        log(f"(g) {r['phase']}: {r['spans']} spans, host {r['host_s']:.3f} "
            f"s, device busy {r['device_busy_s']:.3f} s, {r['device_ops']} "
            f"device ops")
    check(sum(r["device_ops"] for r in rows) > 0,
          "the triangulation stage ran nothing on the device")
    check(again["num_cameras"] == N_CAMS, "profiled run: cameras")
    log(json.dumps({"sfm": {
        "cameras": stats["num_cameras"], "tracks": stats["num_tracks"],
        "observations": stats["num_observations"], "ate": ate,
        "rms_px": stats["rms_px"],
        "residual_px": {k: stats[f"residual_{k}"]
                        for k in ("min", "max", "mean", "median")},
        "init_pair": stats["init_pair"], "profile": stats["profile"],
        "elapsed_s": elapsed, "peak_device_gb": peak_gb,
        "focal_est": float(scene.intrinsics.params[0, 0]),
        "focal_gt": float(ds["f"]), "ba_repeat": ba,
        "profiled_run": {"elapsed_s": again["elapsed_s"],
                         "profile": again["profile"], "spans": rows}}}))


def quad_distances(P):
    """Distance of each point (N, 3) to each fountain quad: (N, 3)."""
    out = []
    for o, u, v in FOUNTAIN_QUADS:
        rel = P - o
        s = np.clip(rel @ u / (u @ u), 0.0, 1.0)
        t = np.clip(rel @ v / (v @ v), 0.0, 1.0)
        out.append(np.linalg.norm(rel - s[:, None] * u - t[:, None] * v,
                                  axis=1))
    return np.stack(out, 1)


def scene_extent() -> float:
    o, u, v = FOUNTAIN_QUADS[:, 0], FOUNTAIN_QUADS[:, 1], FOUNTAIN_QUADS[:, 2]
    corners = np.concatenate([o, o + u, o + v, o + u + v])
    return float(np.linalg.norm(corners.max(0) - corners.min(0)))


def exact_scene(scene, ds):
    """(g)'s scene with the dataset's exact poses and focal, its landmarks
    mapped into the truth frame (so the sweep keeps its sources and depth
    ranges): what the dense slice gives without the scene's own error."""
    from regard3d_tpu_torch.core import metrics
    pm = scene.poses.mask.numpy()
    sim = metrics.umeyama(scene.poses.C.numpy()[pm], ds["Cs"][pm])
    params = scene.intrinsics.params.clone()
    params[:, :3] = torch.tensor([ds["f"], ds["hw"] / 2.0, ds["hw"] / 2.0])
    params[:, 3:] = 0.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return scene.replace(
        intrinsics=scene.intrinsics.replace(params=params),
        poses=scene.poses.replace(R=f32(ds["Rs"]), C=f32(ds["Cs"])),
        landmarks=scene.landmarks.replace(
            X=f32(sim.apply(scene.landmarks.X.numpy()))))


def dense_geometry(scene, Cs_true, xyz, nrm, verts=None):
    """The dense cloud and the mesh vertices in the truth frame (the Sim3
    that ``umeyama`` fits from the estimated camera centres to the true
    ones) against the fountain's quads: the share of points within
    GATE_CLOUD_TOL of the extent of a quad, the median |cos| between each
    point's normal and its nearest quad's, the share of mesh vertices
    within GATE_SURFACE_TOL."""
    from regard3d_tpu_torch.core import metrics
    pm = scene.poses.mask.numpy()
    sim = metrics.umeyama(scene.poses.C.numpy()[pm], Cs_true[pm])
    ext = scene_extent()
    X = sim.apply(xyz)
    N = np.asarray(nrm, np.float64) @ sim.R.T
    N /= np.maximum(np.linalg.norm(N, axis=1, keepdims=True), 1e-12)
    d = quad_distances(X)
    qn = np.cross(FOUNTAIN_QUADS[:, 1], FOUNTAIN_QUADS[:, 2])
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    cos = np.abs(np.sum(N * qn[d.argmin(1)], 1))
    geo = {"extent": ext, "sim3_scale": sim.scale,
            "cloud_near_frac": float((d.min(1) <= GATE_CLOUD_TOL * ext)
                                     .mean()),
            "cloud_dist_median": float(np.median(d.min(1))),
            "cloud_dist_p90": float(np.percentile(d.min(1), 90)),
            "normal_cos_median": float(np.median(cos))}
    if verts is not None:
        dv = quad_distances(sim.apply(verts)).min(1)
        geo["surface_near_frac"] = float((dv <= GATE_SURFACE_TOL * ext)
                                         .mean())
        geo["surface_dist_median"] = float(np.median(dv))
    return geo


def run_dense(scene, images, out, device="cuda", cloud_path=None,
              write_obj=True):
    """The dense slice's main path as the CLI chains it (densify ->
    dense.ply -> reconstruct on the cloud read back -> surface.ply ->
    k-NN vertex colors -> texture atlas -> OBJ + MTL + PNG). Reconstructs
    ``cloud_path`` instead of this run's own cloud when given. Returns the
    products and each step's host seconds and peak device memory."""
    from regard3d_tpu_torch.export import model_ops, ply
    from regard3d_tpu_torch.mvs import driver
    from regard3d_tpu_torch.surface import poisson, texture
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
    cloud = ply.read_ply(cloud_path or dense)
    verts, faces = step("surface", lambda: poisson.reconstruct(
        cloud.xyz, cloud.normals, device=device, **SURFACE_KW))
    surface = os.path.join(out, "surface.ply")
    ply.write_ply(surface, ply.PlyData(xyz=verts, faces=faces))
    colored = step("colorize", lambda: model_ops.colorize_mesh_from_cloud(
        surface, dense, os.path.join(out, "surface_colored.ply"), k=3))
    surf = ply.read_ply(surface)
    tex = step("texture", lambda: texture.texture_mesh(
        scene, images, surf.xyz, surf.faces, device=device))
    if write_obj:
        step("write_obj", lambda: texture.write_textured_obj(
            os.path.join(out, "textured"), tex))
    return dict(xyz=xyz, nrm=nrm, dmaps=dmaps, verts=verts, faces=faces,
                colored=colored, tex=tex, cloud=cloud, steps=steps)


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
    geometry against the fountain's quads, a reconstruct that repeats bit
    for bit, every artifact read back, and where its time goes by span."""
    from torch.profiler import ProfilerActivity, profile
    from regard3d_tpu_torch.core.sfm_data import load_npz

    scene = load_npz(scene_npz)
    out = os.path.join(workdir, "dense")
    t0 = time.time()
    res = run_dense(scene, ds["images"], out)
    elapsed = time.time() - t0
    geo = dense_geometry(scene, ds["Cs"], res["xyz"], res["nrm"],
                         res["verts"])
    n, nf = len(res["xyz"]), len(res["faces"])
    log(f"(i) {len(res['dmaps'])} depth maps, {n} points, "
        f"{len(res['verts'])} vertices, {nf} faces, {elapsed:.1f} s; "
        f"geometry {geo}; steps {res['steps']}")
    check_dense_artifacts(out, res)
    from regard3d_tpu_torch.mvs import driver
    # the same densify on the exact poses and focal, at the CLI's level
    # (512^2 depth maps) and one level coarser (256^2): how much of the
    # normals' spread is the scene's error and how much the map resolution
    exact = exact_scene(scene, ds)
    geo_exact = {}
    for level in (DENSE_KW["level"], DENSE_KW["level"] + 1):
        xyz_e, nrm_e, _, _ = driver.densify_scene(
            exact, ds["images"], **dict(DENSE_KW, level=level))
        geo_exact[f"level{level}"] = dict(
            dense_geometry(exact, ds["Cs"], xyz_e, nrm_e),
            points=len(xyz_e))
    log(f"(i) the same densify on the exact poses and focal: {geo_exact}")

    # the same cloud once more under the profiler: its reconstruct must
    # give the same mesh bit for bit
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = run_dense(scene, ds["images"], os.path.join(workdir,
                                                            "dense_prof"),
                          cloud_path=os.path.join(out, "dense.ply"),
                          write_obj=False)
    repeat = {"mesh_identical": bool(
        np.array_equal(again["verts"], res["verts"])
        and np.array_equal(again["faces"], res["faces"])),
        "cloud_identical": bool(np.array_equal(again["xyz"], res["xyz"])
                                and np.array_equal(again["nrm"],
                                                   res["nrm"]))}
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
        "config": {"densify": DENSE_KW, "surface": SURFACE_KW,
                   "colorize_k": 3, "views": N_CAMS, "hw": HW},
        "points": n, "vertices": len(res["verts"]), "faces": nf,
        "depth_maps": len(res["dmaps"]),
        "atlas_px": res["tex"].atlas.shape[0],
        "labelled_faces": float((res["tex"].labels >= 0).mean()),
        "geometry": geo, "geometry_exact_poses": geo_exact,
        "repeat": repeat, "elapsed_s": elapsed, "phase_s": phase_s,
        "steps": res["steps"],
        "profiled_run": {"steps": again["steps"], "spans": rows}}}))
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
    check(repeat["mesh_identical"],
          "a second reconstruct of the same cloud gave another mesh")
    check(sum(r["device_ops"] for r in rows) > 0,
          "the dense slice ran nothing on the device")


def phase_accuracy():
    """(h) the radial-K3 twin at the reference's accuracy settings, held to
    the reference's gates and printed beside ACCURACY.json's row."""
    from regard3d_tpu_torch.tools import accuracy
    row = accuracy.run_dataset("fountain_rk3")
    ref = None
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ACCURACY.json")
    if os.path.exists(path):
        with open(path) as fh:
            ref = {r["dataset"]: r for r in json.load(fh)["results"]}.get(
                "fountain_rk3")
    log(json.dumps({"accuracy": {"port": row, "reference": ref}}))
    bad = accuracy.gate_failures(row)
    check(not bad, "; ".join(bad))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    import regard3d_tpu_torch  # noqa: F401  (fails outside the repository)

    t0 = time.time()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    phase_build()
    from regard3d_tpu_torch.ingest import synth
    t1 = time.time()
    ds = synth.make_dataset("fountain", n_cams=N_CAMS, hw=HW, seed=0)
    log(f"(b) rendered {N_CAMS} views at {HW}x{HW} in "
        f"{time.time() - t1:.1f} s")
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import features as fm
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as work:
        out, launches = phase_stage(ds, work)
        kps, descs = fm.load_all_padded(out, N_CAMS, pad_to=256,
                                        padded_dim=cm.MATCH_DIM,
                                        device="cuda")
        paths = {"stage": launches, "flann": phase_flann(out, kps, descs)}
        pairs = cm.exhaustive_pairs(N_CAMS)
        pairs = pairs + [pairs[-1]] * ((-len(pairs)) % PAIR_BLOCK)
        parr = torch.as_tensor(np.asarray(pairs[:PAIR_BLOCK], np.int32))
        rows = phase_kernels(descs.data, descs.mask, parr)
        phase_ties(descs.data)
        phase_wide(descs.data, descs.mask, parr)
        phase_profile(ds, work)
        paths["profile"] = phase_matcher_profile(descs.data, descs.mask,
                                                 parr)
        phase_sfm(ds, out, work)
        phase_dense(ds, os.path.join(work, "sfm", "scene.npz"), work)
    phase_accuracy()
    for row in rows:
        row["launches"] = paths[ROW_PATH[row["name"]]][row["name"]]
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
