"""Readings that set the limits of ``correct``: the program's numbers over
many seeds and the control's over a few, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... \\
        [--control-seeds 11 12 13] [--out readings.jsonl]

For each seed: the cell's views are put in the seed's order, the
program's step runs once on them (the window's own call, at the cell's sizes) and its artifacts are
judged exactly as a run judges them; for each control seed the step kind's
``control`` (the reference in the program's place, in TF32) is judged the
same way, and where the step kind has a ``fault`` (an answer altered where
it is produced), so is that. One JSON line per reading. The limits in
``benchmark/traffic`` sit between the program's largest reading and the
smallest of the control's (or, for a number the control does not move,
the fault's).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device=None) -> int:
    from benchmark import run as bench_run
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench_run._fixed_caches()
    import torch
    bench = bench_run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic = bench_run.resolve(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    from benchmark.scenes.render import shuffled
    step = bench_run.load_module("steps", traffic["step"])
    scene = bench_run.render_scene(config, device)
    sink = open(args.out, "a") if args.out else None
    work = tempfile.mkdtemp(prefix="r3dcal")
    try:
        for seed in sorted(set(args.seeds) | set(args.control_seeds)):
            t0 = time.perf_counter()
            cell = bench_run.Cell(args.workload, config,
                                  dict(traffic, warm_steps=0), seed, device,
                                  os.path.join(work, str(seed)))
            os.makedirs(cell.work)
            cell.scene = shuffled(scene, seed)
            state = step.setup(cell)
            out = os.path.join(cell.work, "step")
            stats = step.run(state, out)
            err, rec = step.check(state, out, stats)
            rows = []
            if seed in args.seeds:
                rows.append(("program", err, step.judge(state, [rec])
                             if rec is not None else []))
            if seed in args.control_seeds:
                rows.append(("control", None,
                             step.judge(state, [step.control(state, rec)])))
                if hasattr(step, "fault"):
                    rows.append(("fault", None,
                                 step.judge(state, [step.fault(state, rec)])))
            for who, e, nums in rows:
                line = {"workload": args.workload, "seed": seed, "who": who,
                        "failed": e, "numbers": {k: v for k, v, _ in nums},
                        "seconds": time.perf_counter() - t0}
                print(json.dumps(line), flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
                    sink.flush()
            step.release(state)
            shutil.rmtree(cell.work, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
