"""Matcher roofline profile: the fused bf16 top-2 kernel against its ablations.

Counterpart of ``tools/profile_matcher.py``. Times three variants of the
block matcher on the same inputs, all on the bf16 tensor-core kernel of
``csrc/match_top2.cu`` with one tiling, to split its time between the
product and the top-2 merge:

* ``full``     — ``l2_top2_block(..., bf16=True)`` (product + top-2 merge);
* ``mm_only``  — the product and one cheap per-row min: the product's cost;
* ``min_only`` — the product and one min pass (no argmin, no second min).

Prints one JSON line with pairs/s and TFLOP/s per variant, the top-2 merge's
cost per pair (``full - mm_only``) and the min pass's (``min_only -
mm_only``), and the card's name under ``backend``.

Run: ``python -m regard3d_tpu_torch.tools.profile_matcher [--n 4096]
[--d 256] [--pairs 64] [--b 8] [--device cuda]``. The device is ``cuda``
unless ``--device cpu`` is given (the plain versions, timed on the host
clock: a check of the tool, not a measurement of the kernel); with no card
it raises. On the card, times come from CUDA events after a warm-up call.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.kernels import match as match_mod

VARIANTS = ("full",) + match_mod.ABLATIONS


def make_inputs(n: int, d: int, pairs: int, b: int, device):
    """The reference tool's inputs: ``default_rng(0)`` uniform rows made
    unit-norm, every row valid, a random (pairs, 2) table over b images."""
    rng = np.random.default_rng(0)
    desc = torch.as_tensor(rng.random((b, n, d), np.float32), device=device)
    desc = desc / torch.linalg.norm(desc, dim=-1, keepdim=True)
    mask = torch.ones((b, n), dtype=torch.bool, device=device)
    prs = torch.as_tensor(rng.integers(0, b, (pairs, 2)).astype(np.int32))
    return desc, mask, prs


def _variant(name, desc, mask, pairs):
    if name == "full":
        return lambda: match_mod.l2_top2_block(desc, mask, pairs, bf16=True)[0]
    return lambda: match_mod.l2_top2_block_ablated(desc, mask, pairs, name)


def _seconds(fn, reps: int, cuda: bool) -> float:
    fn()                                    # build + warm
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e-3 / reps


def profile(desc, mask, pairs, reps: int = 5) -> Dict:
    """Times the three variants on (B, N, D) descriptors ``desc`` with mask
    (B, N) and a (P, 2) pair table; returns the reference tool's JSON keys
    (``backend`` holds the card's name, or ``cpu``)."""
    cuda = desc.is_cuda
    B, N, D = desc.shape
    P = int(pairs.shape[0])
    res = {f"{v}_s": _seconds(_variant(v, desc, mask, pairs), reps, cuda)
           for v in VARIANTS}
    flop_pair = 2 * N * N * D
    out = {
        "n": N, "d": D, "pairs": P,
        "tile_m": match_mod.TILE_M, "tile_n": match_mod.TILE_N,
        "flop_per_pair_g": flop_pair / 1e9,
        "backend": (torch.cuda.get_device_name(desc.device) if cuda
                    else "cpu"),
    }
    for k, v in res.items():
        tag = k[:-2]
        out[f"{tag}_pairs_per_s"] = P / v
        out[f"{tag}_tflops"] = flop_pair * P / v / 1e12
    out["top2_overhead_s_per_pair_us"] = (
        (res["full_s"] - res["mm_only_s"]) / P * 1e6)
    out["min_pass_s_per_pair_us"] = (
        (res["min_only_s"] - res["mm_only_s"]) / P * 1e6)
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)
    desc, mask, prs = make_inputs(args.n, args.d, args.pairs, args.b, dev)
    out = profile(desc, mask, prs)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
