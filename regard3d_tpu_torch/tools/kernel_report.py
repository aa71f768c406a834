"""What the compiler made of a CUDA source: registers, spills, shared memory
and the SASS instruction mix of every kernel instance.

Builds ``regard3d_tpu_torch/csrc/match_top2.cu`` (or ``--source FILE``) with
the port's nvcc flags (``kernels/_build.NVCC_FLAGS``, which include
``-Xptxas -v``) unless its library exists, then prints one JSON line per
kernel instance: ptxas's ``registers``, ``spill_stores`` / ``spill_loads``
(bytes), ``stack`` and static ``smem`` (bytes), and the count of each
instruction class of ``MIX`` in the SASS that ``cuobjdump -sass`` prints
(``other`` holds the rest).

With ``--time`` it also loads the built library and, on the card, times
its C entry point ``r3d_l2_top2`` alone (CUDA events, operands and |b|^2
made beforehand) on the matcher's main-path shapes: K1 at B = 11, N = 4096
and at B = 200, N = 768 in f32, K1 bf16 and its two ablations at N = 4096,
P = 64 pairs, D = 144, on unit-norm descriptors drawn from
``default_rng(0)``; each result is held against the plain version
(``kernels/match``) on the same inputs. One JSON line per case, with
``torch.bmm`` of the same operands beside it. Two sources timed in one run
(``--source A --source B``, in turns A, B, B, A) compare two versions of
the kernels on one card.

Run: ``python -m regard3d_tpu_torch.tools.kernel_report [--source FILE]...
[--time]`` on a machine with the CUDA toolkit (nvcc, cuobjdump); ``--time``
needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
from typing import Dict, List

import numpy as np
import torch

from regard3d_tpu_torch.kernels import _build
from regard3d_tpu_torch.kernels import match as match_mod

# instruction classes of the matcher kernels: the product (FFMA; HMMA of
# mma.sync, HGMMA of wgmma and its WARPGROUP fences), shared-memory reads
# (LDS, LDSM), copies into shared memory (LDGSTS of cp.async, UTMALDG of
# TMA, UBLKCP of bulk copies), global loads, barriers (BAR, SYNCS of the
# mbarriers), the top-2 (FMNMX, FSETP, SEL) and shuffles
MIX = ("FFMA", "HMMA", "HGMMA", "WARPGROUP", "LDS", "LDSM", "LDGSTS",
       "UTMALDG", "UBLKCP", "LDG", "BAR", "SYNCS", "FMNMX", "FSETP", "SEL",
       "SHFL", "BRA")


def mix(ops: Dict[str, int]) -> Dict[str, int]:
    """``ops`` (opcode -> count) grouped into ``MIX`` and ``other``."""
    out = {k: ops.get(k, 0) for k in MIX}
    out["other"] = sum(v for k, v in ops.items() if k not in MIX)
    return out


def report(source: str) -> Dict[str, dict]:
    """Per kernel instance: ptxas's usage and the SASS mix of ``source``
    built with the port's flags."""
    lib = _build.compile_library(_build.nvcc_path(), _build.NVCC_FLAGS,
                                 source)
    usage = _build.ptxas_usage(_build.build_log(lib))
    return {name: {**usage.get(name, {}), "mix": mix(ops)}
            for name, ops in sorted(_build.sass_opcodes(lib).items())}


# (name, images, rows, dtype, mode) of the timed cases; P = 64, D = 144
CASES = (("k1_f32_n4096", 11, 4096, 0, 0), ("k1_f32_n768", 200, 768, 0, 0),
         ("k1_bf16_n4096", 11, 4096, 1, 0), ("mm_only_n4096", 11, 4096, 1, 1),
         ("min_only_n4096", 11, 4096, 1, 2))
PAIRS, DIM = 64, 144


def _entry(lib: str):
    fn = ctypes.CDLL(lib).r3d_l2_top2
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5)
    return fn


def _inputs(images: int, rows: int):
    """Unit-norm descriptors, every row valid, and the first 64 pairs of
    the exhaustive table (of an 8-view window past 20 images)."""
    rng = np.random.default_rng(0)
    d = rng.random((images, rows, DIM), dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if images <= 20:
        pairs = [(i, j) for i in range(images) for j in range(i + 1, images)]
    else:
        pairs = [(i, i + 1 + k) for i in range(images - 8) for k in range(8)]
    desc = torch.from_numpy(d).cuda()
    mask = torch.ones((images, rows), dtype=torch.bool, device="cuda")
    return desc, mask, torch.tensor((pairs * 2)[:PAIRS], dtype=torch.int32)


def _cuda_ms(fn, reps: int = 20) -> float:
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


def c_call(fn, desc, mask, pairs, bf16: bool, mode: int = 0):
    """The block kernel's C call ``fn`` (``r3d_l2_top2``) on ``desc``'s
    operands, |b|^2 and pair table, made here once, as a function of no
    arguments that returns its error code; and the (d1, i1, d2) it
    writes."""
    ops = match_mod._kernel_operands(desc, bf16)
    bn = match_mod._bnorm(desc, mask)
    pd = pairs.to(desc.device)
    P, (_, N, D) = pairs.shape[0], desc.shape
    res = [torch.empty((P, N), dtype=t, device=desc.device)
           for t in (torch.float32, torch.int32, torch.float32)]
    args = (int(bf16), mode, ops.data_ptr(), ops.data_ptr(), bn.data_ptr(),
            pd.data_ptr(), P, N, N, D, 1, *(t.data_ptr() for t in res),
            None, torch.cuda.current_stream(desc.device).cuda_stream)
    # the operands live as long as the closure
    return (lambda keep=(ops, bn, pd): fn(*args)), res


def time_cases(libs: List[str]) -> List[dict]:
    """Each case on each library (in turns: first, second, ..., then back),
    the C call alone, against the plain version and ``torch.bmm``."""
    if not torch.cuda.is_available():
        raise RuntimeError("--time needs a CUDA card")
    fns = [_entry(lib) for lib in libs]
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    out = []
    for name, images, rows, dtype, mode in CASES:
        desc, mask, pairs = _inputs(images, rows)
        bf16 = dtype == 1
        calls = [c_call(fn, desc, mask, pairs, bf16, mode) for fn in fns]
        if mode == 0:
            want = match_mod.l2_top2_block_plain(desc, mask, pairs, bf16)
        else:
            want = (match_mod.l2_top2_block_ablated_plain(
                desc, mask, pairs, match_mod.ABLATIONS[mode - 1]),)
        pl = pairs.long().cuda()
        ops = match_mod._kernel_operands(desc, bf16)
        ga, gb = ops[pl[:, 0]], ops[pl[:, 1]]
        bmm_ms = _cuda_ms(lambda: torch.bmm(ga, gb.transpose(1, 2)))
        for turn, k in enumerate(order):
            run, res = calls[k]
            if run() != 0:
                raise RuntimeError(f"{libs[k]}: launch failed")
            torch.cuda.synchronize()
            err = float((res[0] - want[0]).abs().max())
            same = (float((res[1] == want[1]).float().mean())
                    if mode == 0 else None)
            row = {"case": name, "source": libs[k], "turn": turn,
                   "ms": _cuda_ms(run),
                   "bmm_ms": bmm_ms, "max_abs_err_d1": err,
                   "i1_agree": same}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append",
                    help="CUDA source (repeatable; default csrc/match_top2.cu)")
    ap.add_argument("--time", action="store_true",
                    help="time the C entry point of each source on the card")
    args = ap.parse_args(argv)
    sources = args.source or [os.path.join(_build.CSRC, "match_top2.cu")]
    libs = []
    for src in sources:
        for name, row in report(src).items():
            print(json.dumps({"source": src, "kernel": name, **row}))
        libs.append(_build.library_path(src, _build.NVCC_FLAGS))
    return time_cases(libs) if args.time else None


if __name__ == "__main__":
    main()
