#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA card and the CUDA toolkit (nvcc). Phases, each of which fails the
run if it fails:

(a) build the port's CUDA kernel from ``regard3d_tpu_torch/csrc`` and
    print the card;
(b) drive the port's compute-matches stage through its library entry point,
    ``regard3d_tpu_torch.pipeline.compute_matches.run_compute_matches``, on
    the synthetic fountain scene (11 views at 1024x1024, 55 exhaustive
    pairs, 4096 keypoints, the default f32 brute-force matcher, 1024 RANSAC
    iterations, focals at 1.03x the truth); check the artifacts parse, hold
    the F inliers against the ground-truth epipolar geometry, and show the
    matcher kernel was launched on that run;
(c) hold each kernel against its plain PyTorch version on the card at the
    main path's shapes (the stage's own descriptors), in f32 and bf16, and
    for the single-pair call with ragged M != N; time kernel, plain version
    and ``torch.bmm`` of the same distance products (a yardstick only);
(d) print the ``kernels`` JSON line;
(e) where the time goes: the stage again, warm, once on the host clock and
    once under ``torch.profiler``; per phase (the stage's own profiler
    spans) the host time, the device's busy time and idle share, the number
    of device operations and the largest kernels, as one ``profile`` JSON
    line. Then the card's name and power limit, and the final
    ``{"ok": true, ...}`` line.

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
    from regard3d_tpu_torch.kernels import _build
    from regard3d_tpu_torch.kernels import match as match_mod
    t0 = time.time()
    _build.build(match_mod._SOURCE)
    log(f"(a) built {match_mod._SOURCE} in {time.time() - t0:.1f} s")


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


def _compare(name, got, want, rtol, atol):
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
    err = 0.0
    for a, b, lab in ((d1k, d1p, "d1"), (d2k, d2p, "d2")):
        big = b.abs() > 1e30
        ok = ((a - b).abs() <= rtol * b.abs() + atol) | (big & (a.abs() > 1e30))
        check(bool(ok.all()), f"{name}: {lab} outside rtol {rtol} atol {atol}")
        e = (a - b).abs()[~big]
        err = max(err, float(e.max()) if e.numel() else 0.0)
    log(f"(c) {name}: i1 equal on {frac:.6f} of rows, max |d err| {err:.3e}")
    return err


def phase_kernels(out, launches):
    from regard3d_tpu_torch.kernels import match as match_mod
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import features as fm

    _, descs = fm.load_all_padded(out, N_CAMS, pad_to=256,
                                  padded_dim=cm.MATCH_DIM, device="cuda")
    desc, mask = descs.data, descs.mask
    B, N, D = desc.shape
    pairs = cm.exhaustive_pairs(B)
    pairs = pairs + [pairs[-1]] * ((-len(pairs)) % PAIR_BLOCK)
    parr = torch.as_tensor(np.asarray(pairs[:PAIR_BLOCK], np.int32))
    pl = parr.long().cuda()
    log(f"(c) main-path shapes: B={B} N={N} D={D} P={parr.shape[0]}")
    rows = []

    def entry(name, run, plain, lib, P, M, Nn, in_bytes, bf16, replaces,
              rtol, atol):
        got = run()
        torch.cuda.synchronize()
        want = plain()
        if got[0].dim() == 1:
            got, want = (tuple(t[None] for t in x) for x in (got, want))
        err = _compare(name, got, want, rtol, atol)
        ms = cuda_ms(run, reps=20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        lib_ms = cuda_ms(lib, reps=10)
        flops = 2.0 * P * M * Nn * D
        nbytes = in_bytes + 3 * P * M * 4
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "regard3d_tpu_torch/csrc/match_top2.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
            "shape": {"P": P, "M": M, "N": Nn, "D": D,
                      "dtype": "bfloat16" if bf16 else "float32"},
            "tflops": flops / (ms * 1e-3) / 1e12,
        })
        log(f"(c) {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bmm "
            f"{lib_ms:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms, "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s)")

    k1 = "regard3d_tpu/kernels/match.py:246"
    k2 = "regard3d_tpu/kernels/match.py:151"
    P = parr.shape[0]
    for bf16 in (False, True):
        d = desc.to(torch.bfloat16) if bf16 else desc
        ga, gb = d[pl[:, 0]], d[pl[:, 1]]
        entry(f"l2_top2_block_{'bf16' if bf16 else 'f32'}",
              run=lambda d=d: match_mod.l2_top2_block(d, mask, parr),
              plain=lambda d=d: match_mod.l2_top2_block_plain(d, mask, parr),
              lib=lambda ga=ga, gb=gb: torch.bmm(ga, gb.transpose(1, 2)),
              P=P, M=N, Nn=N,
              in_bytes=d.numel() * d.element_size() + mask.numel()
              + parr.numel() * 4,
              bf16=bf16, replaces=k1,
              rtol=1e-2 if bf16 else 1e-5, atol=1e-3 if bf16 else 1e-5)
    # single pair with ragged M != N (no tile divides either)
    a = desc[0, :4000].contiguous()
    b = desc[1, :3001].contiguous()
    mb = mask[1, :3001].contiguous()
    entry("l2_top2_f32",
          run=lambda: match_mod.l2_top2(a, b, mb),
          plain=lambda: match_mod.l2_top2_plain(a, b, mb),
          lib=lambda: torch.mm(a, b.t()),
          P=1, M=a.shape[0], Nn=b.shape[0],
          in_bytes=(a.numel() + b.numel()) * 4 + mb.numel(),
          bf16=False, replaces=k2, rtol=1e-5, atol=1e-5)
    return rows


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
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as work:
        out, launches = phase_stage(ds, work)
        rows = phase_kernels(out, launches)
        phase_profile(ds, work)
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
