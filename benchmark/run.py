"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration, whose
file names the system that serves it (``benchmark/systems/<system>.py``),
and a traffic mix (``benchmark/traffic/<traffic>.json``).  Each metric is
read by ``benchmark/metrics/<metric>.py``; the limits of the cell's
correctness numbers are in ``benchmark/limits/<workload>.json``.  Adding a
cell, a configuration, a mix or a metric adds files and edits none.

The last line of standard output is the result: end-to-end metrics with
``--trace 0``, per-layer metrics with ``--trace 1``.  Two more modes serve
whoever sizes a cell and print no result: ``--readings s1,s2,..`` reads
the correctness numbers of several seeds in one process (``--control 1``:
of the control), and ``--rates r1,r2,..`` sweeps the offered rate of an
open-loop cell.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pathway_tpu")
# the program's spans that can name an idle gap of the device (a request's
# own spans cover every moment it is open, so they name none)
_GAP_SPANS = ("engine.host_gap", "engine.sync", "engine.device.",
              "serve.batch")


def load_cell(workload: str, root: Path = ROOT, here: Path = HERE) -> dict:
    """The cell's entries and files, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "bench": bench, "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "mix": json.loads((here / "traffic" / f"{cell['traffic']}.json")
                          .read_text()),
        "limits": json.loads((here / "limits" / f"{workload}.json")
                             .read_text()),
    }


def applies(metric: dict, workload: str, end_to_end: list) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = next(m for m in end_to_end if m["name"] == moves)
    return "workloads" not in e2e or workload in e2e["workloads"]


def reader(name: str, here: Path = HERE):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system(config: dict):
    return importlib.import_module(f"benchmark.systems.{config['system']}")


def read_metrics(metrics: list, run, here: Path = HERE) -> dict:
    out = {}
    for m in metrics:
        v = reader(m["name"], here)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(readings, limits: dict) -> tuple[bool, dict]:
    """The numbers that the cell's limits name, each against its limit;
    the others are printed beside them and decide nothing."""
    checks = {}
    ok = True
    for name, value, _what in readings:
        if name not in limits:
            continue
        limit = float(limits[name])
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    missing = set(limits) - set(checks)
    return ok and not missing, checks


def run_once(args, spec: dict, device, t_start: float) -> dict:
    """Set up, measure, read, check: the result object."""
    import torch

    from benchmark.harness.stats import Run, due_in_window
    from benchmark.harness.trace import DeviceTrace

    workload = spec["cell"]["name"]
    bench = spec["bench"]
    cell = system(spec["config"]).Cell(spec["config"], spec["mix"],
                                       args.seed, device)
    cell.setup()
    # a full collection at the end of set-up, as a long-running server's
    # heap has settled: set-up leaves millions of objects (the index's
    # handles), and the collector's next full pass over them would
    # otherwise fall into the window or not by chance
    gc.collect()
    pauses = GcPauses()
    trace = DeviceTrace(device) if args.trace else None
    if trace is not None:
        trace.start()
    state = {}

    def on_open():
        state["setup_s"] = time.perf_counter() - t_start
        pauses.start()
        state["launches0"] = _launches()
        if trace is not None:
            trace.open()

    def on_close():
        if trace is not None:
            trace.close()
        state["launches1"] = _launches()
        pauses.stop()

    result = cell.run_window(float(args.seconds), on_open, on_close)
    if trace is not None:
        trace.finish()
    peak = torch.cuda.max_memory_allocated(device)
    run = Run(spec["config"], spec["mix"], result, trace,
              result["t_close"] - result["t_open"], state["setup_s"])
    if args.trace:
        metrics = [m for m in bench["per_layer"]
                   if applies(m, workload, bench["end_to_end"])]
        _print_lost(trace, state)
    else:
        metrics = [m for m in bench["end_to_end"]
                   if applies(m, workload, bench["end_to_end"])]
    values = read_metrics(metrics, run)
    due = due_in_window(run)
    failed = sum(1 for q in due if q.error is not None)
    cell.stop_program()
    readings = cell.check(result)
    correct, checks = judge(readings, spec["limits"])
    correct = correct and failed == 0 and result["ended"]
    out = {"correct": correct, "attempted": len(due), "failed": failed,
           "metrics": values,
           "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(device),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace is not None:
        out["device"]["busy_s"] = trace.busy_s()
        out["device"]["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.time_by_name(10),
                            "idle_gaps": trace.idle_gaps(_host_spans(), 10)}
    out["checks"] = checks
    return out, readings


class GcPauses:
    """The garbage collector's passes in the window, by generation: each
    stops every thread of the process."""

    def __init__(self):
        self.by_gen: dict = {}
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            n, s = self.by_gen.get(info["generation"], (0, 0.0))
            self.by_gen[info["generation"]] = (
                n + 1, s + time.perf_counter() - self._t)

    def start(self):
        gc.callbacks.append(self._cb)

    def stop(self):
        gc.callbacks.remove(self._cb)
        print("[gc] passes in the window by generation: "
              + ", ".join(f"gen {g}: {n} in {s:.3f} s"
                          for g, (n, s) in sorted(self.by_gen.items())),
              file=sys.stderr)


def _launches() -> dict:
    from pathway_tpu_torch.ops import _cuda

    return dict(_cuda.LAUNCHES)


def _print_lost(trace, state) -> None:
    """Launches counted by the program's wrappers in the window against
    the kernel records of the trace: the trace's lost records."""
    names = {"paged_attention": ("paged_tc_kernel", "paged_f32_kernel"),
             "paged_append_attend": ("append_kernel",),
             "knn_scores": ("knn_gemv_kernel", "knn_gemm_kernel")}
    a, b = state["launches0"], state["launches1"]
    for key, pats in names.items():
        n = sum(v - a.get(k, 0) for k, v in b.items() if k.startswith(key))
        if n:
            seen = trace.kernel_time(pats)[1]
            print(f"[trace] {key}: {n} launches in the window, {seen} in "
                  f"the trace, {n - seen} records lost", file=sys.stderr)


def _host_spans() -> list:
    from pathway_tpu_torch import obs

    return [(s.name, s.t0, s.t1) for s in obs.recorder().snapshot()
            if s.t1 is not None and s.name.startswith(_GAP_SPANS)]


def _print_result(out: dict, readings) -> None:
    for name, value, what in readings:
        if name not in out["checks"]:
            print(f"reading {name} {value!r} ({what}; not compared)",
                  file=sys.stderr)
    for name, value, what in readings:
        c = out["checks"].get(name)
        if c is not None:
            print(f"check {name} {value!r} limit {c['limit']!r} ({what})",
                  file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def readings_mode(args, spec, device, fault=None) -> None:
    """Each seed's correctness numbers in one process (no result line).
    ``fault``, where given, is a context manager that breaks the program
    underneath for the whole of each seed's run."""
    import contextlib

    for seed in [int(s) for s in args.readings.split(",")]:
        cell = system(spec["config"]).Cell(spec["config"], spec["mix"], seed,
                                           device, control=bool(args.control))
        t0 = time.perf_counter()
        with fault(cell) if fault else contextlib.nullcontext():
            cell.setup()
            result = None
            if not args.control or cell.control_runs_program:
                result = cell.run_window(float(args.seconds), lambda: None,
                                         lambda: None)
        cell.stop_program()
        readings = cell.check(result)
        print(json.dumps({"seed": seed, "control": bool(args.control),
                          "seconds": time.perf_counter() - t0,
                          "readings": {n: v for n, v, _w in readings},
                          "detail": getattr(cell, "detail", {})}),
              flush=True)


def rates_mode(args, spec, device) -> None:
    """One set-up, then a window at each offered rate: the latency tail,
    how it moves from the window's first third to its last, and the
    share answered."""
    from benchmark.harness.stats import Run, due_in_window

    cell = system(spec["config"]).Cell(spec["config"], spec["mix"],
                                       args.seed, device)
    cell.setup()
    lat = reader(spec["mix"]["latency_metric"])
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.mix = dict(spec["mix"], rate_per_s=rate)
        result = cell.run_window(float(args.seconds), lambda: None,
                                 lambda: None)
        run = Run(spec["config"], cell.mix, result, None,
                  result["t_close"] - result["t_open"], 0.0)
        due = due_in_window(run)
        t0, t1 = result["t_open"], result["t_close"]
        third = (t1 - t0) / 3

        def part(lo, hi):
            sub = dict(result, t_open=lo, t_close=hi)
            return lat(Run(spec["config"], cell.mix, sub, None, hi - lo, 0.0))

        print(json.dumps({"rate_per_s": rate, "ended": result["ended"],
                          "attempted": len(due),
                          "failed": sum(q.error is not None for q in due),
                          "p95_ms": lat(run),
                          "p95_ms_first_third": part(t0, t0 + third),
                          "p95_ms_last_third": part(t1 - third, t1)}),
              flush=True)
        if not result["ended"]:
            break
    cell.stop_program()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--control", type=int, default=0, choices=(0, 1))
    p.add_argument("--readings", default=None)
    p.add_argument("--rates", default=None)
    args = p.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if args.readings:
        readings_mode(args, spec, device)
        return 0
    if args.rates:
        rates_mode(args, spec, device)
        return 0
    out, readings = run_once(args, spec, device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules loaded that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 3
    _print_result(out, readings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
