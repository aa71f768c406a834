"""The benchmark of regard3d_tpu_torch: one cell, one run, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:
the cell names its configuration (``benchmark/configs/<config>.json``) and
its traffic (``benchmark/traffic/<traffic>.json``); the traffic names the
step kind (``benchmark/steps/<kind>.py``), the configuration its scene
(``benchmark/scenes/<scene>.py``), and every per-layer metric of the cell
has a reader ``benchmark/metrics/<metric>.py``. Adding a configuration, a
cell or a metric is adding files and entries, never editing these.

Set-up (``setup_s``, from the start of this process): imports, the CUDA
start, the kernels' build or load, the views made from ``--seed`` on the
card, the step's inputs and its warm-up. The window then runs whole steps
back to back, each into a fresh directory, and starts none after
``--seconds``; a step's time is the window's length over the steps it
completed. With ``--trace 1`` one more step runs under the profiler after
the window and the per-layer metrics are read. Once the window has closed
and the peak memory is read, every step's artifacts are judged against the
plain reference (``benchmark/reference``), each number beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "regard3d_tpu")


def _fixed_caches():
    """Every cache the program or its libraries keep lives at a fixed path
    inside the checkout; libraries that would load JAX are told not to."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("R3D_TORCH_BUILD_DIR",
                          os.path.join(build, "torch_kernels"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclasses.dataclass
class Cell:
    """What a step kind is handed: the cell's entry, its configuration and
    traffic, the seed, the device and a scratch directory."""
    name: str
    config: Dict
    traffic: Dict
    seed: int
    device: object
    work: str
    scene: Optional[Dict] = None


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: Dict, workload: str):
    """(cell entry, configuration, traffic) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    return w, config, traffic


def render_scene(config: Dict, device) -> Dict:
    """The configuration's photos: its scene drawn from its own
    ``scene_seed`` (a configuration is one image set)."""
    mod = load_module("scenes", config["scene"])
    return mod.make(config["scene_seed"], config["views"],
                    tuple(config["resolution"]), config["focal_factor"],
                    device)


def cell_metrics(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports: its end-to-end ones, or with tracing
    its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def card() -> Dict:
    import torch
    out = {"kind": torch.cuda.get_device_name(0)}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["power_limit"] = r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        out["power_limit"] = "unknown"
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class GcClock:
    """Seconds the interpreter's cyclic collector ran, as it runs."""

    def __init__(self):
        self.total, self._t = 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.total += time.perf_counter() - self._t
            self._t = None


def phases(stats) -> Dict:
    """A step's phase seconds as the program reports them."""
    if not isinstance(stats, dict):
        return {}
    flat = dict(stats, **stats.get("profile", {}))
    return {k: round(v, 3) for k, v in flat.items()
            if isinstance(v, float) and (k.startswith("time_")
                                         or k.endswith("_s"))}


def run_window(step, state, seconds: float, keep: str):
    """Whole steps back to back until ``seconds`` have passed. Returns
    (window_s, [(out_dir, stats or None, error or None)]). Each step's wall
    and process CPU seconds, the collector's seconds and the program's
    phase seconds go to standard error, to show what a slow step spent."""
    import gc
    done, ends = [], []
    clock = GcClock()
    gc.callbacks.append(clock)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        out = tempfile.mkdtemp(prefix="step", dir=keep)
        w0, c0, g0 = time.perf_counter(), time.process_time(), clock.total
        try:
            stats, err = step.run(state, out), None
        except Exception:                      # a failed step is counted
            stats, err = None, traceback.format_exc(limit=4)
        done.append((out, stats, err))
        ends.append(time.perf_counter() - t0)
        print(f"step {len(done) - 1}: wall "
              f"{time.perf_counter() - w0:.3f} cpu "
              f"{time.process_time() - c0:.3f} gc {clock.total - g0:.3f} "
              f"{phases(stats)}", file=sys.stderr)
    window_s = time.perf_counter() - t0
    gc.callbacks.remove(clock)
    steps = [round(b - a, 3) for a, b in zip([0.0] + ends, ends)]
    print(f"step seconds: {steps}", file=sys.stderr)
    return window_s, done


def main(argv=None, device=None) -> int:
    """One run. ``device`` set: skip the look for a card and run there (the
    harness's own tests drive the CPU this way)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _fixed_caches()
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry, config, traffic = resolve(bench, args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < entry["chips"]:
            print(f"needs {entry['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    from benchmark.scenes.render import shuffled
    step = load_module("steps", traffic["step"])
    keep = tempfile.mkdtemp(prefix="r3dbench")
    try:
        cell = Cell(args.workload, config, traffic, args.seed, device,
                    os.path.join(keep, "setup"))
        os.makedirs(cell.work)
        cell.scene = shuffled(render_scene(config, device), args.seed)
        state = step.setup(cell)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_START

        window_s, done = run_window(step, state, args.seconds, keep)
        attempted = len(done)
        ok_steps = [s for _, s, e in done if e is None]
        profiled = None
        if args.trace:
            from benchmark import trace
            out = tempfile.mkdtemp(prefix="traced", dir=keep)
            profiled = trace.collect(lambda: step.run(state, out),
                                     step.SPANS)
            done.append((out, profiled["result"], None))
        peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)
        t_traced = time.perf_counter()

        # judge every step once the window has closed
        failures, records = [], []
        for k, (out, stats, err) in enumerate(done):
            if err is None:
                err, rec = step.check(state, out, stats)
                if rec is not None:
                    records.append(rec)
            if err is not None:
                failures.append((k, err))
            shutil.rmtree(out, ignore_errors=True)
        step.release(state)
        numbers = step.judge(state, records) if records else []
        correct = (not failures and bool(numbers)
                   and all(v <= lim for _, v, lim in numbers))
        n_failed = len([k for k, _ in failures if k < attempted])

        metrics = {}
        for m in cell_metrics(bench, args.workload, bool(args.trace)):
            if m["name"] == "setup_s":
                val = setup_s
            elif not args.trace:
                val = (window_s / len(ok_steps)
                       if ok_steps and m["name"] == traffic["metric"]
                       else None)
            else:
                reader = load_module("metrics", m["name"])
                val = reader.read({"steps": ok_steps, "profiled": profiled,
                                   "work": step.work(state),
                                   "records": records})
            if val is not None and math.isfinite(val):
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}

        found = forbidden_modules()
        if found:
            print(f"modules that must not load: {found}", file=sys.stderr)
            return 3
        for k, f in failures:
            print(f"step {k} failed: {f}", file=sys.stderr)
        traced = (f"traced step {profiled['host_s']:.1f} and its reading "
                  f"{profiled['read_s']:.1f}, " if profiled else "")
        print(f"seconds: set-up {setup_s:.1f}, window {window_s:.1f}, "
              f"{traced}judging {time.perf_counter() - t_traced:.1f}",
              file=sys.stderr)
        info = card() if on_card else {"kind": device.type}
        dev = {"platform": "gpu" if on_card else device.type,
               "kind": info["kind"], "count": 1,
               "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": attempted,
                  "failed": n_failed, "metrics": metrics, "device": dev}
        if profiled is not None:
            from benchmark import trace
            dev["busy_s"] = trace.union_s(
                [(s, e) for s, e, _ in profiled["ops"]])
            dev["window_s"] = profiled["host_s"]
            result["breakdown"] = {
                "device_ops": trace.top_ops(profiled["ops"]),
                "idle_gaps": trace.idle_gaps(profiled["ops"],
                                             profiled["spans"])}
        result["compared"] = {name: {"value": v, "limit": lim}
                              for name, v, lim in numbers}
        print(f"card: {info}", file=sys.stderr)
        for name, v, lim in numbers:
            print(f"{name} {v!r} <= {lim!r}", file=sys.stderr)
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(keep, ignore_errors=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
