"""CLI: the process supervisor with elastic rescaling, the planner and
profile tables, the template runner and the dashboard.

The port of ``pathway_tpu/cli.py`` (reference: python/pathway/cli.py —
``pathway spawn --threads N --processes M program...`` launches the
worker cluster; child exit codes 10/12 request down/up-scaling and the
supervisor respawns with 0.5x/2x processes, cli.py:21-25,211-374).

Usage: ``python -m pathway_tpu_torch spawn --threads 2 --processes 2 --
python app.py`` (or ``... spawn -t 2 -n 2 app.py``: a script runs with
this interpreter).  Every spawned process runs its data plane where the
program's ``pw.run(device=...)`` puts it (default the card, ``cuda:0``
for every process of one host); a child that finds no card raises, and
the supervisor exits with that child's code.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

EXIT_CODE_DOWNSCALE = 10
EXIT_CODE_UPSCALE = 12
MAX_PROCESSES = 64


def _spawn_once(program: list[str], threads: int, processes: int,
                first_port: int, fail_fast: bool = False) -> int:
    """Run the program as `processes` cooperating OS processes.

    A rescale exit code (10/12) from ANY worker terminates the others so the
    supervisor can respawn the whole cluster at the new size.  With
    ``fail_fast`` (the restart supervisor), the first nonzero exit also
    terminates the survivors immediately — peer-death detection makes
    them abort on their own anyway (parallel/comm.py PeerLostError +
    poison broadcast), this just skips waiting out the heartbeat deadline.
    """
    import time

    import secrets as _secrets

    env_base = dict(os.environ)
    env_base["PATHWAY_THREADS"] = str(threads)
    env_base["PATHWAY_PROCESSES"] = str(processes)
    env_base["PATHWAY_FIRST_PORT"] = str(first_port)
    env_base["PATHWAY_SPAWNED"] = "1"  # rescale exits only fire under a supervisor
    # per-run shared secret: workers mutually authenticate fabric peers
    # before accepting (pickle) frames
    env_base["PATHWAY_FABRIC_SECRET"] = (
        os.environ.get("PATHWAY_FABRIC_SECRET") or _secrets.token_hex(32)
    )
    if processes == 1:
        env_base["PATHWAY_PROCESS_ID"] = "0"
        return subprocess.call(program, env=env_base)
    procs = []
    for pid in range(processes):
        env = dict(env_base)
        env["PATHWAY_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(program, env=env))
    code = 0
    running = list(procs)
    while running:
        for p in list(running):
            rc = p.poll()
            if rc is None:
                continue
            running.remove(p)
            if rc in (EXIT_CODE_DOWNSCALE, EXIT_CODE_UPSCALE):
                # propagate the rescale to the whole cluster
                for q in running:
                    q.terminate()
                for q in running:
                    q.wait()
                return rc
            if rc != 0:
                code = rc
                if fail_fast:
                    for q in running:
                        q.terminate()
                    for q in running:
                        q.wait()
                    return code
        time.sleep(0.1)
    return code


def spawn(program: list[str], *, threads: int = 1, processes: int = 1,
          first_port: int = 10000, record: bool = False,
          restart: int = 0, elastic_plan: bool | None = None) -> int:
    """Supervise the program; honor elastic-rescale exit codes.

    ``restart``: how many times a crashed cluster is relaunched.  A worker dying (chaos kill, OOM, segfault) aborts the
    whole mesh at a consistent protocol point (peer-death detection +
    poison broadcast); the supervisor then respawns every worker slot
    and the run resumes from the persistence journal — with a
    persistence backend configured, output is exactly-once across the
    kill (tests/test_torch_chaos_cluster.py pins the squash-check).  Faults
    armed via ``PW_FAULT`` use ``PW_FAULT_STAMP_DIR`` to fire only once
    across incarnations.

    ``elastic_plan`` (or ``PW_ELASTIC_PLAN=1``): before each
    crash relaunch the supervisor consults the auto-planner's measured
    ``pw.cluster.epoch`` rows (obs/planner.py choose_process_count) and
    may relaunch at a DIFFERENT process count — the persistence journal
    replays the union of all per-pid streams re-filtered by the new
    membership's ownership, so exactly-once survives the re-partition
    (tests/test_torch_chaos_cluster.py pins it).

    Worker cap (reference: MAX_WORKERS=8, dataflow/config.rs:11-15): total
    threads x processes above 8 needs the 'unlimited-workers' entitlement;
    without it the supervisor clamps the process count."""
    if threads * processes > 8:
        from .internals.licensing import LicenseError, check_entitlements

        try:
            check_entitlements("unlimited-workers")
        except LicenseError:
            new_procs = max(1, 8 // max(1, threads))
            print(
                f"[pathway-tpu] {threads * processes} workers exceeds the "
                f"8-worker cap without the 'unlimited-workers' entitlement; "
                f"clamping processes {processes} -> {new_procs}",
                file=sys.stderr,
            )
            processes = new_procs
    attempts_left = max(0, int(restart))
    while True:
        code = _spawn_once(program, threads, processes, first_port,
                           fail_fast=attempts_left > 0)
        if code == EXIT_CODE_DOWNSCALE and processes > 1:
            processes = max(1, processes // 2)
            print(f"[pathway-tpu] downscaling to {processes} processes", file=sys.stderr)
            continue
        if code == EXIT_CODE_UPSCALE and processes < MAX_PROCESSES:
            processes = min(MAX_PROCESSES, processes * 2)
            print(f"[pathway-tpu] upscaling to {processes} processes", file=sys.stderr)
            continue
        if code != 0 and attempts_left > 0:
            attempts_left -= 1
            if elastic_plan or (
                elastic_plan is None
                and os.environ.get("PW_ELASTIC_PLAN") == "1"
            ):
                try:
                    from .obs.planner import choose_process_count

                    d = choose_process_count(
                        processes, max_procs=MAX_PROCESSES
                    )
                    if d.source != "default" and int(d.value) != processes:
                        print(
                            f"[pathway-tpu] elastic membership: "
                            f"{processes} -> {d.value} processes "
                            f"({d.why})",
                            file=sys.stderr,
                        )
                        processes = int(d.value)
                except Exception:  # noqa: BLE001 - planning must never
                    pass           # block recovery
            print(
                f"[pathway-tpu] cluster died (exit {code}); relaunching all "
                f"{processes} worker slot(s) "
                f"({restart - attempts_left}/{restart}) — the persistence "
                "journal resumes the mesh",
                file=sys.stderr,
            )
            continue
        return code


def run_cluster(program: list[str], *, threads: int = 1, processes: int = 1,
                first_port: int = 10000, restart: int = 0) -> int:
    """Python entry for a supervised cluster run with kill-and-recover:
    ``run_cluster([...program...], processes=2, restart=2)`` is
    ``pathway-tpu spawn --processes 2 --restart 2 -- program``."""
    return spawn(program, threads=threads, processes=processes,
                 first_port=first_port, restart=restart)


def spawn_from_env() -> int:
    program = os.environ.get("PATHWAY_SPAWN_PROGRAM")
    if not program:
        print("PATHWAY_SPAWN_PROGRAM not set", file=sys.stderr)
        return 2
    args = os.environ.get("PATHWAY_SPAWN_ARGS", "").split()
    return spawn(
        [program, *args],
        threads=int(os.environ.get("PATHWAY_THREADS", "1")),
        processes=int(os.environ.get("PATHWAY_PROCESSES", "1")),
        first_port=int(os.environ.get("PATHWAY_FIRST_PORT", "10000")),
        restart=int(os.environ.get("PATHWAY_RESTART_ATTEMPTS", "0")),
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="pathway-tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("spawn", help="launch a program under the worker supervisor")
    sp.add_argument("--threads", "-t", type=int, default=1)
    sp.add_argument("--processes", "-n", type=int, default=1)
    sp.add_argument("--first-port", type=int, default=10000)
    sp.add_argument("--record", action="store_true")
    sp.add_argument("--restart", type=int, default=0,
                    help="relaunch a crashed cluster up to N times "
                         "(kill-and-recover; resumes from the persistence "
                         "journal)")
    sp.add_argument("--elastic-plan", action="store_true", default=None,
                    help="let the auto-planner pick the process count on "
                         "each crash relaunch from measured epoch costs "
                         "(also PW_ELASTIC_PLAN=1)")
    sp.add_argument("program", nargs=argparse.REMAINDER)

    sub.add_parser("spawn-from-env", help="spawn using PATHWAY_SPAWN_PROGRAM env")

    pl = sub.add_parser(
        "plan",
        help="print the auto-planner's choice for every plane knob "
             "(device-tier crossovers, process count, tp, engine shapes) "
             "with its recorded rationale",
    )
    pl.add_argument("--json", action="store_true",
                    help="machine-readable plan instead of the table")
    pl.add_argument("--calibrate", action="store_true",
                    help="measure the segment-reduce numpy/torch pair across "
                         "the size ladder first, so a fresh host plans from "
                         "ITS costs instead of the documented defaults")
    pl.add_argument("--processes", type=int, default=None,
                    help="current cluster process count (default: "
                         "PATHWAY_PROCESSES or 1)")
    pl.add_argument("--budget-bytes", type=int, default=None,
                    help="HBM budget for the engine-shape what-ifs")

    sub.add_parser("dashboard", add_help=False,
                   help="serve the web dashboard over recorded metrics")

    pp = sub.add_parser(
        "profile",
        help="ranked per-program device cost table from a running "
             "process (fetches its /debug/profile endpoint — the same "
             "plumbing as the SIGUSR1/flight-recorder dumps)",
    )
    pp.add_argument("--url", default="http://127.0.0.1:20000",
                    help="base URL of the process's metrics server or "
                         "webserver (default: the MetricsServer port)")
    pp.add_argument("--memory", action="store_true",
                    help="ask /debug/profile for its memory columns")
    pp.add_argument("--json", action="store_true",
                    help="print the raw /debug/profile JSON instead of "
                         "the table")
    pp.add_argument("--diff", metavar="BEFORE_JSON", default=None,
                    help="diff the live snapshot against a saved "
                         "/debug/profile JSON: per-program ms/MFU/share "
                         "deltas, biggest mover first (the before/after "
                         "view of a kernel-fusion or quantization change)")

    rp = sub.add_parser("run", help="run a YAML app template")
    rp.add_argument("template", help="path to app.yaml")
    rp.add_argument("--host", default="0.0.0.0")
    rp.add_argument("--port", type=int, default=8080)
    rp.add_argument("--timeout-s", type=float, default=None)
    rp.add_argument("--device", default="cuda",
                    help="the data plane's device (default: the card)")

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["dashboard"]:
        # delegate the whole surface (single source of truth incl. --help)
        from .web_dashboard.dashboard import main as dashboard_main

        return dashboard_main(argv[1:])
    args = parser.parse_args(argv)
    if args.command == "spawn":
        program = args.program
        if program and program[0] == "--":
            program = program[1:]
        if not program:
            parser.error("no program given")
        if program[0].endswith(".py"):
            # `spawn app.py` runs the script with this interpreter
            program = [sys.executable, *program]
        return spawn(program, threads=args.threads, processes=args.processes,
                     first_port=args.first_port, record=args.record,
                     restart=args.restart, elastic_plan=args.elastic_plan)
    if args.command == "spawn-from-env":
        return spawn_from_env()
    if args.command == "plan":
        return plan_command(as_json=args.json, calibrate=args.calibrate,
                            processes=args.processes,
                            budget_bytes=args.budget_bytes)
    if args.command == "profile":
        return profile_command(args.url, memory=args.memory,
                               as_json=args.json, diff=args.diff)
    if args.command == "run":
        return run_template(args.template, host=args.host, port=args.port,
                            timeout_s=args.timeout_s, device=args.device)
    return 2


def plan_command(*, as_json: bool = False, calibrate: bool = False,
                 processes: int | None = None,
                 budget_bytes: int | None = None, out=None) -> int:
    """``pathway-tpu plan``: every plane knob the auto-planner owns, with
    the measured (or documented-default) evidence behind each choice —
    the "why is the system configured this way" table.  ``--calibrate``
    first measures the segment-reduce numpy/torch pair across the size
    ladder so a fresh host's crossover comes from ITS device."""
    out = out or sys.stdout
    from .obs import planner

    if calibrate:
        measured = planner.calibrate_mapreduce()
        print(
            f"[pathway-tpu] calibrated segment-reduce dual path: "
            f"{len(measured)} (side, size) samples recorded",
            file=sys.stderr,
        )
    p = planner.plan(current_processes=processes, budget_bytes=budget_bytes)
    if as_json:
        import json

        print(json.dumps(p.as_dict(), indent=1, default=str), file=out)
    else:
        print(p.render(), file=out)
    return 0


def _program_family(name: str) -> str:
    """Family key for the profile rollup: ``pw.<plane>_<op>`` programs
    group by plane (``pw.ssd_chained_decode`` -> ``pw.ssd``,
    ``pw.state_suspend`` -> ``pw.state``, ``pw.chained_decode`` ->
    ``pw.chained``); anything else groups under its leading dotted
    component.  ``_draft``-marked drafter programs fold into
    the family they draft FOR (``pw.prefill_draft`` -> ``pw.prefill``) —
    the rollup answers "what does this plane cost", and a drafter's
    dispatches are part of its target plane's speculative cost."""
    if name.startswith("pw."):
        rest = name[3:]
        stripped = rest.replace("_draft", "").replace("draft_", "")
        rest = stripped or "draft"
        head = rest.split("_", 1)[0] if "_" in rest else rest
        return f"pw.{head}"
    return name.split(".", 1)[0] if "." in name else name


def format_profile_table(data: dict) -> str:
    """The ranked per-program device cost table (): one row per
    (program, bucket), ordered by total dispatch seconds — the "which
    kernel to fuse first" view of ``/debug/profile``.  It appends
    a per-family rollup (``pw.ssd``, ``pw.paged``, ...) so a whole
    decode plane's device share reads off one line."""
    cols = ("program", "disp", "ms p50", "share", "GFLOP", "MB", "AI",
            "MFU", "bound", "compiles", "compile s")
    rows = []
    progs = data.get("programs") or []
    total_disp = sum(r.get("dispatch_s_total") or 0.0 for r in progs) or 1.0

    def fmt(v, scale=1.0, digits=2):
        return f"{v / scale:.{digits}f}" if v not in (None, 0) else "-"

    for r in progs:
        roof = r.get("roofline") or {}
        rows.append((
            (r.get("program") or "?")[:28],
            str(r.get("dispatches") or 0),
            fmt(r.get("dispatch_ms_p50")),
            f"{(r.get('dispatch_s_total') or 0.0) / total_disp:.1%}",
            fmt(r.get("flops"), 1e9, 3),
            fmt(r.get("bytes_accessed"), 1e6, 1),
            fmt(r.get("arithmetic_intensity"), 1, 1),
            fmt(r.get("mfu"), 1, 5),
            roof.get("bound") or "-",
            str(r.get("n_compiles") or 0),
            fmt(r.get("compile_s")),
        ))
    widths = [
        max(len(cols[i]), *(len(row[i]) for row in rows)) if rows
        else len(cols[i])
        for i in range(len(cols))
    ]
    lines = [
        "  ".join(c.ljust(widths[i]) for i, c in enumerate(cols)),
        "  ".join("-" * w for w in widths),
    ]
    lines += [
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row))
        for row in rows
    ]
    totals = (
        f"programs={data.get('n_device_programs')} "
        f"compiles={data.get('n_compiles')} "
        f"(recompiles={data.get('recompiles_total')}) "
        f"compile_s_total={data.get('compile_s_total')} "
        f"peak={fmt(data.get('peak_flops_per_s'), 1e9, 1)} GFLOP/s"
    )
    families: dict[str, dict] = {}
    for r in progs:
        fam = families.setdefault(
            _program_family(r.get("program") or "?"),
            {"programs": 0, "dispatches": 0, "disp_s": 0.0, "compiles": 0},
        )
        fam["programs"] += 1
        fam["dispatches"] += r.get("dispatches") or 0
        fam["disp_s"] += r.get("dispatch_s_total") or 0.0
        fam["compiles"] += r.get("n_compiles") or 0
    if len(families) > 1:
        lines.append("")
        lines.append("by family:")
        ranked = sorted(
            families.items(), key=lambda kv: -kv[1]["disp_s"]
        )
        for fam_name, f in ranked:
            lines.append(
                f"  {fam_name.ljust(12)} programs={f['programs']:<3d} "
                f"disp={f['dispatches']:<6d} "
                f"share={f['disp_s'] / total_disp:6.1%} "
                f"compiles={f['compiles']}"
            )
    events = data.get("recompile_events") or []
    if events:
        lines.append("")
        lines.append("recompile provenance (newest):")
        for e in events[-4:]:
            lines.append(
                f"  #{e.get('seq')} {e.get('program')} "
                f"[{e.get('bucket')}] {e.get('compile_s')}s"
            )
            for frame in e.get("stack") or []:
                lines.append(f"    {frame}")
    return "\n".join(lines + ["", totals])


def format_profile_diff(before: dict, after: dict) -> str:
    """Per-program before→after table for two ``/debug/profile``
    snapshots (): dispatch ms p50, MFU and dispatch-share
    deltas, biggest mover first — the fused-kernel / int8 win as one
    reviewable table instead of two screenshots."""
    from .obs.profiler import profile_diff

    rows = profile_diff(before, after)
    cols = ("program", "bucket", "ms p50", "Δms", "MFU", "ΔMFU",
            "share", "Δshare")

    def fmt(v, digits=2):
        return f"{v:.{digits}f}" if v is not None else "-"

    def arrow(b, a, digits=2):
        if b is None and a is None:
            return "-"
        return f"{fmt(b, digits)}→{fmt(a, digits)}"

    table = []
    for r in rows:
        mark = {"new": " (new)", "gone": " (gone)"}.get(r["status"], "")
        if mark and "_draft" in (r["program"] or ""):
            # a drafter program appearing or disappearing
            # between snapshots means speculative decode was turned
            # on/off or switched drafters — worth its own callout
            mark = " (+drafter)" if r["status"] == "new" else " (-drafter)"
        table.append((
            (r["program"] or "?")[:30] + mark,
            str(r["bucket"] or "-")[:16],
            arrow(r["ms_p50_before"], r["ms_p50_after"]),
            fmt(r["ms_p50_delta"]),
            arrow(r["mfu_before"], r["mfu_after"], 4),
            fmt(r["mfu_delta"], 4),
            f"{r['share_before']:.1%}→{r['share_after']:.1%}",
            f"{r['share_delta']:+.1%}",
        ))
    widths = [
        max(len(cols[i]), *(len(row[i]) for row in table)) if table
        else len(cols[i])
        for i in range(len(cols))
    ]
    lines = [
        "  ".join(c.ljust(widths[i]) for i, c in enumerate(cols)),
        "  ".join("-" * w for w in widths),
    ]
    lines += [
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row))
        for row in table
    ]
    return "\n".join(lines)


def _load_profile_snapshot(source: str, *, memory: bool = False):
    """A ``/debug/profile`` dict from a URL or a saved JSON file path —
    the diff side of ``profile --diff`` always comes from a file, the
    live side from the URL (a file path there too makes the whole diff
    replayable offline)."""
    import json
    import os
    import urllib.request

    if os.path.exists(source):
        with open(source) as f:
            return json.load(f)
    target = source.rstrip("/") + "/debug/profile" + (
        "?memory=1" if memory else ""
    )
    return json.loads(urllib.request.urlopen(target, timeout=30).read())


def profile_command(url: str, *, memory: bool = False,
                    as_json: bool = False, diff: str | None = None,
                    out=None) -> int:
    """``pathway-tpu profile``: fetch ``/debug/profile`` from a running
    process (or read a saved snapshot file) and print the ranked table;
    with ``--diff BEFORE_JSON``, the per-program delta table instead."""
    import json

    out = out or sys.stdout
    try:
        data = _load_profile_snapshot(url, memory=memory)
    except Exception as exc:  # noqa: BLE001 - a CLI prints, not raises
        print(f"cannot fetch {url}: {exc}", file=sys.stderr)
        return 1
    if diff is not None:
        try:
            before = _load_profile_snapshot(diff)
        except Exception as exc:  # noqa: BLE001
            print(f"cannot load {diff}: {exc}", file=sys.stderr)
            return 1
        if as_json:
            from .obs.profiler import profile_diff

            print(json.dumps(profile_diff(before, data), indent=1,
                             default=str), file=out)
        else:
            print(format_profile_diff(before, data), file=out)
        return 0
    if as_json:
        print(json.dumps(data, indent=1, default=str), file=out)
    else:
        print(format_profile_table(data), file=out)
    return 0


def run_template(path: str, *, host: str = "0.0.0.0", port: int = 8080,
                 timeout_s: float | None = None, device="cuda") -> int:
    """Load and run a YAML app template (reference: examples/templates/ run
    via `pathway spawn`), its data plane on ``device``.  Conventions, in
    precedence order:

    - `question_answerer:` → served with QARestServer at host:port
    - `document_store:` (top-level, no answerer) → DocumentStoreServer
    - anything else: the yaml's side effects (io writes) ran at load time;
      pw.run() executes them.  `persistence_config:` is honored.
    """
    from . import load_yaml

    with open(path) as f:
        app = load_yaml(f, host=host, port=port)
    run_kwargs = {"device": device}
    if isinstance(app, dict) and app.get("persistence_config") is not None:
        run_kwargs["persistence_config"] = app["persistence_config"]
    if timeout_s is not None:
        run_kwargs["timeout_s"] = timeout_s
    qa = app.get("question_answerer") if isinstance(app, dict) else None
    store = app.get("document_store") if isinstance(app, dict) else None
    if qa is not None:
        from .xpacks.llm.servers import QARestServer

        QARestServer(host, port, qa).run(**run_kwargs)
    elif store is not None:
        from .xpacks.llm.servers import DocumentStoreServer

        DocumentStoreServer(host, port, store).run(**run_kwargs)
    else:
        from . import run as pw_run

        pw_run(**run_kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
