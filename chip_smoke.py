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
    ``torch.mm`` of the same distance products (a yardstick only), and split
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
(d) print the ``kernels`` JSON line (launches from the run of the path each
    kernel lies on: (b), its flann run, or (f)), then the card's name and
    power limit, and the final ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

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
    # K3: the ablations against their plain versions at the kernel's tile_n
    for mode in match_mod.ABLATIONS:
        row = entry(f"l2_top2_block_{mode}_bf16",
                    run=lambda m=mode: match_mod.l2_top2_block_ablated(
                        desc, mask, parr, m),
                    plain=lambda m=mode: match_mod.l2_top2_block_ablated_plain(
                        desc, mask, parr, m, match_mod.TILE_N),
                    lib=None, M=N, Nn=N, in_bytes=dbytes, out_words=1,
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
