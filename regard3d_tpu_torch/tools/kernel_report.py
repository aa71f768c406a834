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
its C entry point ``r3d_l2_top2`` alone (CUDA events; the call prepared
beforehand by ``kernels/match.prepare_block``, with the entry of the
library timed) on the matcher's main-path shapes: K1 at B = 11, N = 4096
and at B = 200, N = 768 in f32, K1 bf16 and its two ablations at N = 4096,
P = 64 pairs, D = 144, on unit-norm descriptors drawn from
``default_rng(0)``; each result is held against the plain version
(``kernels/match``) on the same inputs. One JSON line per case, with
``torch.bmm`` of the same operands beside it. Then the single-pair call
(K2) on ``chip_smoke.py`` (c)'s ragged (4000, 144) x (3001, 144) shape in
f32 and bf16 (every 50th B row masked), through its C entry
``r3d_l2_top2_pair`` alone, which does all the device work of one call
(prepared by ``kernels/match.prepare_pair``): ``call_ms``,
``call_host_us`` per call issued back to back (``call_host_us_busy`` with
the card kept busy by a spin kernel queued ahead, so no launch meets an
idle card), and the device operations of one call by ``torch.profiler``
with their summed time (``device_us``); every row says
whether its outputs are bit for bit the first source's; and, once per
case, this tree's own wrapper ``kernels/match.l2_top2`` (``wrapper_ms``,
``wrapper_host_us``) and ``torch.mm`` of the operands. Two sources timed
in one run (``--source A --source B``, in turns A, B, B, A) compare two
versions of the kernels on one card; each must have the C interface that
``kernels/_build.SIGNATURES`` declares.

Run: ``python -m regard3d_tpu_torch.tools.kernel_report [--source FILE]...
[--time]`` on a machine with the CUDA toolkit (nvcc, cuobjdump); ``--time``
needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
from typing import Dict, List, Tuple

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
# (name, M, N, bf16) of the single-pair cases
PAIR_CASES = (("k2_f32", 4000, 3001, False), ("k2_bf16", 4000, 3001, True))

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


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn`` (CUDA events around ``reps``
    calls issued back to back, after ``warmup`` calls)."""
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


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per call of ``fn`` issued back to back (one
    synchronize after the timed calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def _pair_inputs(M: int, N: int):
    """Unit-norm (M, DIM) and (N, DIM) descriptors from ``default_rng(0)``,
    every 50th B row masked."""
    rng = np.random.default_rng(0)
    a, b = (rng.random((n, DIM), dtype=np.float32) for n in (M, N))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    mask = np.ones(N, bool)
    mask[::50] = False
    return (torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
            torch.from_numpy(mask).cuda())


MARKER = "spin_kernel"      # torch.cuda._sleep's kernel


def ops_per_call(events) -> List[Tuple[str, float]]:
    """The device operations of one call as (name, microseconds), from
    (start_ns, end_ns, name) events of calls each opened by a ``MARKER``
    kernel: the events are cut at the markers, the names are the list most
    calls gave (a trace can miss an operation at its start), each time the
    median over the calls that gave that list."""
    per_call, cur = [], None
    for t0, t1, name in sorted(events):
        if MARKER in name:
            cur = []
            per_call.append(cur)
        elif cur is not None:
            cur.append((name, (t1 - t0) * 1e-3))
    if not per_call:
        return []
    names = collections.Counter(tuple(n for n, _ in c) for c in per_call)
    top = names.most_common(1)[0][0]
    same = [c for c in per_call if tuple(n for n, _ in c) == top]
    return [(n, float(np.median([c[k][1] for c in same])))
            for k, n in enumerate(top)]


def device_ops(fn, calls: int = 5,
               tries: int = 3) -> List[Tuple[str, float]]:
    """:func:`ops_per_call` of ``calls`` calls of ``fn`` under
    ``torch.profiler``, each opened by ``torch.cuda._sleep``'s spin kernel:
    the device operations (kernels, copies, memsets) that one call issues,
    with their times. A trace that came back with no device events at all
    (seen once in a process's later profiler sessions) is taken again, up
    to ``tries`` times; [] if none held a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                torch.cuda._sleep(1)
                fn()
            torch.cuda.synchronize()
        ops = ops_per_call((e.start_ns(), e.end_ns(), e.name())
                           for e in prof.profiler.kineto_results.events()
                           if e.device_type() == DeviceType.CUDA)
        if ops:
            return ops
    return []


def _host_us_busy(fn, reps: int = 50) -> float:
    """:func:`host_us` with the card kept busy: a spin kernel long enough
    to outlast the timed calls is queued ahead of them, so no launch meets
    an idle card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))             # ~0.1 s at the H100's clocks
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def _on_source(prepared, source: str):
    """``prepared`` (a ``_build.Call`` of this tree) with the same C entry
    of the library built from ``source`` and its outputs as a tuple; the
    call made once (it must succeed)."""
    lib = _build.load_library(source)
    out = prepared.out if isinstance(prepared.out, tuple) else (prepared.out,)
    p = prepared._replace(entry=getattr(lib, prepared.entry.__name__),
                          out=out)
    _build.call_entry(p.entry, *p.args)
    torch.cuda.synchronize()
    return p


def time_pair_cases(sources: List[str]) -> List[dict]:
    """The single-pair cases on each source's library in turns, as in
    :func:`time_cases`; per case also this tree's wrapper and
    ``torch.mm``."""
    order = list(range(len(sources))) + list(reversed(range(len(sources))))
    out = []
    for name, M, N, bf16 in PAIR_CASES:
        a, b, mb = _pair_inputs(M, N)
        want = match_mod.l2_top2_plain(a, b, mb, bf16)
        ops = [t.to(torch.bfloat16) if bf16 else t for t in (a, b)]
        wrap = lambda: match_mod.l2_top2(a, b, mb, bf16=bf16)
        head = {"case": name, "wrapper_ms": cuda_ms(wrap),
                "wrapper_host_us": host_us(wrap),
                "wrapper_host_us_busy": _host_us_busy(wrap),
                "mm_ms": cuda_ms(lambda: torch.mm(ops[0], ops[1].t()))}
        print(json.dumps(head), flush=True)
        calls = [_on_source(match_mod.prepare_pair(a, b, mb, bf16), src)
                 for src in sources]
        for turn, k in enumerate(order):
            call, res = calls[k].c_call, calls[k].out
            ops = device_ops(call)
            row = {"case": name, "source": sources[k], "turn": turn,
                   "call_ms": cuda_ms(call), "call_host_us": host_us(call),
                   "call_host_us_busy": _host_us_busy(call),
                   "device_ops": len(ops),
                   "device_us": sum(us for _, us in ops),
                   "ops": [[n[:60], us] for n, us in ops],
                   "max_abs_err_d1": float((res[0] - want[0]).abs().max()),
                   "i1_agree": float((res[1] == want[1]).float().mean()),
                   "identical_to_first": _identical(res, calls[0].out, 3)}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def _identical(res, first, n: int) -> bool:
    """Whether the first ``n`` outputs of a library are bit for bit the
    first library's (the ablation modes write only d1; compared once both
    have run: the first source runs first)."""
    return all(torch.equal(x, y) for x, y in zip(res[:n], first[:n]))


def time_cases(sources: List[str]) -> List[dict]:
    """Each case on each source's library (in turns: first, second, ...,
    then back), the C call alone, against the plain version and
    ``torch.bmm``."""
    if not torch.cuda.is_available():
        raise RuntimeError("--time needs a CUDA card")
    order = list(range(len(sources))) + list(reversed(range(len(sources))))
    out = []
    for name, images, rows, dtype, mode in CASES:
        desc, mask, pairs = _inputs(images, rows)
        bf16 = dtype == 1
        calls = [_on_source(match_mod.prepare_block(
            desc, mask, pairs, bf16, ("full", *match_mod.ABLATIONS)[mode]),
            src) for src in sources]
        if mode == 0:
            want = match_mod.l2_top2_block_plain(desc, mask, pairs, bf16)
        else:
            want = (match_mod.l2_top2_block_ablated_plain(
                desc, mask, pairs, match_mod.ABLATIONS[mode - 1]),)
        pl = pairs.long().cuda()
        ops = match_mod._kernel_operands(desc, bf16)
        ga, gb = ops[pl[:, 0]], ops[pl[:, 1]]
        bmm_ms = cuda_ms(lambda: torch.bmm(ga, gb.transpose(1, 2)))
        for turn, k in enumerate(order):
            res = calls[k].out
            err = float((res[0] - want[0]).abs().max())
            same = (float((res[1] == want[1]).float().mean())
                    if mode == 0 else None)
            row = {"case": name, "source": sources[k], "turn": turn,
                   "ms": cuda_ms(calls[k].c_call),
                   "bmm_ms": bmm_ms, "max_abs_err_d1": err,
                   "i1_agree": same,
                   "identical_to_first": _identical(res, calls[0].out,
                                                    1 if mode else 3)}
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
    for src in sources:
        for name, row in report(src).items():
            print(json.dumps({"source": src, "kernel": name, **row}))
    if not args.time:
        return None
    return time_cases(sources) + time_pair_cases(sources)


if __name__ == "__main__":
    main()
